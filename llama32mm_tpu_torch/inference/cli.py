"""Inference CLI (counterpart of ``llama32mm_tpu/inference/cli.py``).

The reference's flags (``--image --prompt --model-id --hf-weights
--max-new-tokens --temperature --top-p --top-k --cpu --dtype``) and its two
paths: the port's model when ``--hf-weights`` is given
(``run_custom_inference``), else the HF transformers baseline
(``run_hf_inference``, which downloads the model). The port runs on the
GPU unless ``--cpu`` is given.

Usage: ``python -m llama32mm_tpu_torch.inference.cli --image cat.png
--prompt "..." --hf-weights /path/to/checkpoint``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

DEFAULT_MODEL_ID = "meta-llama/Llama-3.2-11B-Vision-Instruct"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Inference for LLaMA-3.2 Vision VLM (PyTorch/CUDA).")
    parser.add_argument("--image", required=True, help="Path to the input image.")
    parser.add_argument("--prompt", required=True, help="Text prompt or question.")
    parser.add_argument("--model-id", default=DEFAULT_MODEL_ID,
                        help="HuggingFace model repo ID (used when --hf-weights is not set).")
    parser.add_argument("--hf-weights", default=None,
                        help="Local HF checkpoint dir; when set, uses the port's model.")
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0.0 = greedy decoding (default).")
    parser.add_argument("--top-p", type=float, default=0.9)
    parser.add_argument("--top-k", type=int, default=50)
    parser.add_argument("--min-p", type=float, default=0.0,
                        help="Drop tokens with prob < min_p * max_prob (0 = off).")
    parser.add_argument("--repetition-penalty", type=float, default=1.0,
                        help="CTRL repetition penalty on context tokens (1.0 = off).")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the GPU.")
    parser.add_argument("--dtype", choices=["auto", "float16", "bfloat16", "float32"],
                        default="auto")
    parser.add_argument("--seed", type=int, default=0, help="Sampling generator seed.")
    parser.add_argument("--quantize", choices=["none", "int8", "int4"], default="none",
                        help="Serving quantization: decoder linears quantized on the "
                             "device as checkpoint tensors stream in (with the int8 "
                             "KV cache).")
    parser.add_argument("--spec-lookup", type=int, default=0, metavar="K",
                        help="Prompt-lookup speculative decoding: draft K tokens "
                             "per step and verify them in one forward (exact for "
                             "greedy and sampled decoding).")
    parser.add_argument("--spec-draft", type=int, default=0, metavar="K",
                        help="Draft-model speculative decoding: a smaller LM "
                             "(--draft-weights) proposes K tokens per step, "
                             "verified exactly in one target forward.")
    parser.add_argument("--draft-weights", default=None,
                        help="Checkpoint dir of the draft model for --spec-draft "
                             "(this framework's save layout; must share the "
                             "target's vocab — e.g. 1B drafting for 11B).")
    return parser.parse_args(argv)


def load_image(path: str):
    from PIL import Image

    p = Path(path)
    if not p.exists():
        sys.exit(f"Image not found: {p}")
    return Image.open(p).convert("RGB")


def run_custom_inference(args: argparse.Namespace) -> str:
    import torch

    from llama32mm_tpu_torch.inference.engine import InferenceEngine
    from llama32mm_tpu_torch.io.checkpoint import load_hf_model
    from llama32mm_tpu_torch.preprocess.processor import MllamaImageProcessor

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = args.dtype if args.dtype != "auto" else (
        "float32" if device.type == "cpu" else "bfloat16"
    )
    if not Path(args.hf_weights).is_dir():
        sys.exit(
            f"--hf-weights directory not found: {args.hf_weights}\n"
            "Download a checkpoint first: python -m llama32mm_tpu_torch.io.download "
            f"--output-dir {args.hf_weights}"
        )
    print(f"Loading model from: {args.hf_weights}"
          + (f" ({args.quantize} serving mode)" if args.quantize != "none" else ""))
    model, tokenizer = load_hf_model(
        args.hf_weights, device, dtype=dtype,
        streaming=args.quantize != "none",
        quantize_int8=args.quantize == "int8",
        quantize_int4=args.quantize == "int4",
    )

    num_image_tokens = model.config.text_config.num_image_tokens
    image_size = model.config.vision_config.image_size
    processor = MllamaImageProcessor(tokenizer, num_image_tokens, image_size)

    image = load_image(args.image)
    inputs = processor([args.prompt], [image], padding=True)

    prompt_len = inputs["input_ids"].shape[1]
    draft_params = draft_config = None
    if args.spec_draft:
        if not args.draft_weights or not Path(args.draft_weights).is_dir():
            sys.exit("--spec-draft needs --draft-weights <checkpoint dir>")
        print(f"Loading draft model from: {args.draft_weights}")
        draft_model, _ = load_hf_model(args.draft_weights, device, dtype=dtype)
        draft_params = draft_model.language_model
        draft_config = draft_model.config.text_config

    # the cache stays a multiple of 128 slots; speculation writes K+1 cache
    # entries a verify, so the engine needs K slots past prompt + max_new
    spec_k = max(args.spec_lookup, args.spec_draft)
    cache_len = -(-(prompt_len + args.max_new_tokens + spec_k) // 128) * 128
    engine = InferenceEngine(
        model, model.config, device, max_cache_length=cache_len, prompt_buckets="auto",
        spec_lookup=args.spec_lookup,
        spec_draft=args.spec_draft,
        draft_params=draft_params, draft_config=draft_config,
        kv_dtype="int8" if args.quantize != "none" else None,
    )

    result = engine.generate(
        inputs["input_ids"],
        pixel_values=inputs["pixel_values"],
        attention_mask=inputs["attention_mask"],
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        min_p=args.min_p,
        repetition_penalty=args.repetition_penalty,
        eos_token_id=tokenizer.eos_token_id if tokenizer.eos_token_id is not None else -1,
        rng=torch.Generator(device=device).manual_seed(args.seed),
    )
    return engine.decode_tokens(tokenizer, result)


def run_hf_inference(args: argparse.Namespace) -> str:
    """The HF transformers baseline (downloads ``--model-id``)."""
    import torch
    from transformers import AutoProcessor, MllamaForConditionalGeneration

    torch_dtype = {
        "float16": torch.float16,
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
    }.get(args.dtype, "auto")

    print(f"Loading HF model: {args.model_id}")
    model = MllamaForConditionalGeneration.from_pretrained(
        args.model_id, torch_dtype=torch_dtype, device_map="cpu"
    )
    processor = AutoProcessor.from_pretrained(args.model_id)

    image = load_image(args.image)
    messages = [
        {"role": "user", "content": [{"type": "image"}, {"type": "text", "text": args.prompt}]}
    ]
    prompt = processor.apply_chat_template(messages, add_generation_prompt=True)
    model_inputs = processor(image, prompt, add_special_tokens=False, return_tensors="pt")

    gen_kwargs = {"max_new_tokens": args.max_new_tokens, "do_sample": args.temperature > 0}
    if args.temperature > 0:
        gen_kwargs.update(temperature=args.temperature, top_p=args.top_p, top_k=args.top_k)
        if getattr(args, "min_p", 0.0) > 0:
            gen_kwargs["min_p"] = args.min_p
    if getattr(args, "repetition_penalty", 1.0) != 1.0:
        gen_kwargs["repetition_penalty"] = args.repetition_penalty

    output = model.generate(**model_inputs, **gen_kwargs)
    continuation = output[:, model_inputs["input_ids"].shape[-1]:]
    return processor.decode(continuation[0], skip_special_tokens=True).strip()


def main(argv=None) -> None:
    args = parse_args(argv)
    result = run_custom_inference(args) if args.hf_weights else run_hf_inference(args)
    print(result)


if __name__ == "__main__":
    main()
