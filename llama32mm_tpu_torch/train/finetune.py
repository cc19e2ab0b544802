"""LoRA fine-tune command line (counterpart of
``llama32mm_tpu/train/finetune.py``): adapter-only training steps over the
labels / shifted-loss path, with adapter-only saves.

Data: a JSONL file of ``{"image": path, "prompt": str, "answer": str}``
records (``--data``), or a text corpus (``--text-data``: one document per
line, or JSONL with a ``text`` field) packed by ``train/data.py``
(EOS-separated static batches, deterministic shuffling, prefetch to the
device). Without ``--hf-weights`` a tiny random model trains on one
synthetic batch (smoke mode).

``--accum-steps A`` accumulates A microbatches per optimizer update
(``train/accum.py``). ``--run-dir DIR`` turns on rotating step checkpoints
(``io.TrainCheckpointManager``) of the train state and of the data stream's
position; rerunning with the same ``--run-dir`` resumes both from the latest
step. Everything runs on the GPU unless ``--cpu`` is given.

``main`` loads and tokenizes, then calls :func:`finetune_loop`, which takes
the model, its config, the token documents (or a batch iterator), the eos id
and the device; a caller without ``transformers`` drives that function.

Usage:
  python -m llama32mm_tpu_torch.train.finetune --hf-weights weights/11b \\
      --data train.jsonl --rank 16 --steps 100 --save adapters.safetensors
  python -m llama32mm_tpu_torch.train.finetune --hf-weights weights/11b \\
      --text-data corpus.txt --batch-size 4 --accum-steps 4 \\
      --run-dir runs/tune1 --steps 1000
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LoRA fine-tuning for the VLM.")
    p.add_argument("--hf-weights", default=None,
                   help="HF checkpoint dir; omit for a tiny random-init smoke run.")
    p.add_argument("--data", default=None, help="JSONL of {image, prompt, answer}.")
    p.add_argument("--text-data", default=None,
                   help="Text corpus for packed causal-LM tuning: one document "
                        "per line, or JSONL with a 'text' field.")
    p.add_argument("--batch-size", type=int, default=1,
                   help="rows per microbatch (packed text path)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="microbatches accumulated per optimizer update")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches staged on device ahead of the step")
    p.add_argument("--run-dir", default=None,
                   help="rotating step-checkpoint dir; auto-resumes train + "
                        "data state from the latest step")
    p.add_argument("--save-every", type=int, default=50,
                   help="checkpoint cadence in steps (with --run-dir)")
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--save", default="lora_adapters.safetensors")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p.parse_args(argv)


def _iter_jsonl_batches(path, processor, tokenizer, max_seq_len):
    from PIL import Image

    with open(path, encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]
    if not records:
        sys.exit(f"No records in {path}")
    while True:
        for rec in records:
            image = Image.open(rec["image"]).convert("RGB")
            inputs = processor([rec["prompt"]], [image], padding="max_length")
            answer_ids = tokenizer(rec["answer"]).input_ids
            ids = inputs["input_ids"][0].tolist() + list(answer_ids)
            ids = ids[:max_seq_len]
            labels = [-100] * inputs["input_ids"].shape[1] + list(answer_ids)
            labels = labels[:max_seq_len]
            pad = max_seq_len - len(ids)
            mask = [1] * len(ids) + [0] * pad
            ids = ids + [0] * pad
            labels = labels + [-100] * pad
            yield {
                "input_ids": np.asarray([ids], np.int32),
                "pixel_values": np.asarray(inputs["pixel_values"], np.float32),
                "attention_mask": np.asarray([mask], np.int32),
                "labels": np.asarray([labels], np.int32),
            }


def _load_text_docs(path, tokenizer):
    """Tokenize a text corpus: one document per line, or JSONL with 'text'."""
    docs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            text = line
            if line.startswith("{"):
                try:
                    text = json.loads(line).get("text", "")
                except json.JSONDecodeError:
                    pass
            ids = tokenizer(text, add_special_tokens=False).input_ids
            if ids:
                docs.append(ids)
    if not docs:
        sys.exit(f"No non-empty documents in {path}")
    return docs


def _smoke_batches(cfg, device, seed: int) -> Iterator[dict]:
    """The smoke mode's one synthetic batch, forever: 2 rows of 16 ids, the
    first 4 ``<image>``, a random 28x28 image each."""
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    ids = torch.randint(0, cfg.vocab_size - 10, (2, 16), generator=gen)
    ids[:, :4] = cfg.image_token_index
    labels = ids.clone()
    labels[:, :4] = -100
    batch = {
        "input_ids": ids.to(device),
        "pixel_values": torch.randn(2, 3, 28, 28, generator=gen).to(device),
        "attention_mask": torch.ones_like(ids).to(device),
        "labels": labels.to(device),
    }
    while True:
        yield batch


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def finetune_loop(model, cfg, device, args, docs: Optional[Sequence[Sequence[int]]] = None,
                  eos_id: Optional[int] = None, batches: Optional[Iterator[dict]] = None,
                  on_step: Optional[Callable] = None, remat: bool = False,
                  loss_chunk: Optional[int] = None):
    """The training loop of ``main``: LoRA adapters (rank ``args.rank``, the
    default targets and the head) over the frozen ``model`` on ``device``.
    With ``docs`` (token id lists) and ``eos_id`` the packed-text path: a
    ``PackedBatchIterator`` of ``batch_size * accum_steps`` rows of
    ``max_seq_len``, prefetched to the device; otherwise ``batches`` (dicts
    of arrays or tensors). ``args`` is ``parse_args``'s namespace. With
    ``args.run_dir`` the loop resumes the train state and the data state from
    the latest step, and saves both every ``save_every`` steps and at the
    end. ``on_step(i, state, loss)``, when given, is called after each step;
    ``remat`` and ``loss_chunk`` go to ``make_lora_train_step`` (the command
    line leaves them off, as the JAX one does). Returns the final
    ``LoraTrainState``."""
    from llama32mm_tpu_torch.train.data import PackedBatchIterator, prefetch_to_device
    from llama32mm_tpu_torch.train.lora import init_lora_params, make_lora_train_step

    device = torch.device(device)
    use_packed = docs is not None
    rows = args.batch_size * args.accum_steps
    it = None
    if use_packed:
        it = PackedBatchIterator(docs, rows, args.max_seq_len, eos_id, seed=args.seed,
                                 ignore_index=cfg.ignore_index)
    elif batches is None:
        raise ValueError("finetune_loop needs docs and eos_id, or batches")

    lora = init_lora_params(torch.Generator(device=device).manual_seed(args.seed + 1),
                            cfg.text_config, rank=args.rank, alpha=args.alpha, device=device)
    init_state, step_fn = make_lora_train_step(
        cfg, learning_rate=args.lr, lora_dropout=args.dropout,
        accum_steps=args.accum_steps if use_packed else 1, remat=remat, loss_chunk=loss_chunk,
    )
    state = init_state(lora)

    mgr = None
    start_step = 0
    if args.run_dir:
        from llama32mm_tpu_torch.io import TrainCheckpointManager, abstract_state

        mgr = TrainCheckpointManager(args.run_dir, max_to_keep=3)
        if mgr.latest_step() is not None:
            template = {"train": state}
            if use_packed:
                template["data"] = it.state
            restored = mgr.restore(abstract_state(template))
            state = restored["train"]
            start_step = int(state.step)
            if use_packed:
                it = PackedBatchIterator.from_state(
                    docs, rows, args.max_seq_len, eos_id, restored["data"],
                    ignore_index=cfg.ignore_index,
                )
            print(f"Resumed {args.run_dir} at step {start_step}")

    if use_packed:
        def with_state(inner):
            # pair each batch with the stream position AFTER it, so a
            # checkpoint taken at step i resumes at exactly batch i+1 even
            # though the prefetch has already pulled further ahead
            while True:
                b = next(inner)
                yield b, inner.state

        stream = prefetch_to_device(with_state(it), size=args.prefetch, device=device)

    dstate = None
    for i in range(start_step, args.steps):
        if use_packed:
            batch, dstate = next(stream)
            if args.accum_steps > 1:
                batch = {k: v.reshape(args.accum_steps, args.batch_size, *v.shape[1:])
                         for k, v in batch.items()}
        else:
            batch = _to_device(next(batches), device)
        rng = None
        if args.dropout > 0.0:
            rng = torch.Generator(device=device).manual_seed((args.seed + 2) * 1_000_003 + i)
        state, loss = step_fn(model, state, batch, rng)
        if on_step is not None:
            on_step(i, state, loss)
        if mgr is not None and ((i + 1) % args.save_every == 0 or i == args.steps - 1):
            tree = {"train": state}
            if dstate is not None:
                tree["data"] = dstate
            mgr.save(i + 1, tree, force=i == args.steps - 1)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(loss):.4f}")
    if mgr is not None:
        mgr.wait()
    return state


def main(argv=None) -> None:
    args = parse_args(argv)
    from llama32mm_tpu_torch.train.lora import save_lora_adapters

    device = torch.device("cpu" if args.cpu else "cuda")
    docs = eos = batches = None
    if args.hf_weights:
        from llama32mm_tpu_torch.io.checkpoint import load_hf_model
        from llama32mm_tpu_torch.preprocess.processor import MllamaImageProcessor

        model, tokenizer = load_hf_model(args.hf_weights, device)
        cfg = model.config
        processor = MllamaImageProcessor(
            tokenizer, cfg.text_config.num_image_tokens, cfg.vision_config.image_size
        )
        if args.text_data is not None:
            eos = tokenizer.eos_token_id
            if eos is None:
                sys.exit("--text-data needs a tokenizer with an eos token")
            docs = _load_text_docs(args.text_data, tokenizer)
        elif args.data:
            batches = _iter_jsonl_batches(args.data, processor, tokenizer, args.max_seq_len)
        else:
            sys.exit("--data or --text-data is required with --hf-weights")
    else:
        # smoke mode: a tiny random model and one synthetic batch
        from llama32mm_tpu_torch.configs import tiny_mllama_config
        from llama32mm_tpu_torch.models.vlm import init_vlm

        cfg = tiny_mllama_config()
        model = init_vlm(cfg, device, torch.Generator(device=device).manual_seed(args.seed))
        batches = _smoke_batches(cfg, device, args.seed)

    state = finetune_loop(model, cfg, device, args, docs=docs, eos_id=eos, batches=batches)
    save_lora_adapters(args.save, state.lora)
    print(f"Saved adapters to {args.save}")


if __name__ == "__main__":
    main()
