"""The port's fine-tune command line (``train/finetune.py``) and the
evaluation command line (``evaluate.py``) with ``--cpu``, on a tiny
checkpoint saved beside ``tests/assets/tiny_tokenizer``:

- the flags and defaults equal the JAX CLI's (plus ``--cpu``);
- the packed-text path's first batch equals the JAX CLI's (the JAX
  package's tokenization of the corpus and its ``PackedBatchIterator``);
- a run interrupted at step 3 and resumed from its run dir to step 6 lands
  on the adapters of an uninterrupted 6-step run (bit for bit: the same
  batches in the same order on the CPU), and the run dir keeps 3 steps;
- the smoke mode (no checkpoint) trains and saves;
- ``evaluate.main`` prints the perplexity of the corpus.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from llama32mm_tpu.train import data as jax_data
from llama32mm_tpu.train import finetune as jax_finetune
from llama32mm_tpu_torch import evaluate
from llama32mm_tpu_torch.configs import LLAMA32Config, MLLAMAConfig, VisionEncoderConfig
from llama32mm_tpu_torch.io import TrainCheckpointManager
from llama32mm_tpu_torch.io.checkpoint import save_checkpoint_params
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.train import finetune
from llama32mm_tpu_torch.train import lora as lora_mod
from llama32mm_tpu_torch.utils.st_file import load_file

ASSET = os.path.join(os.path.dirname(__file__), "assets", "tiny_tokenizer")


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    cfg = MLLAMAConfig(
        vision_config=VisionEncoderConfig(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=2, num_attention_heads=2,
                                          image_size=28, patch_size=14),
        text_config=LLAMA32Config(vocab_size=1280, hidden_size=64, n_heads=4, n_layers=2,
                                  hidden_dim=96, n_kv_groups=2, dtype="float32",
                                  max_cache_length=96),
        projection_dim=64, hidden_size=64, image_token_index=1024, vocab_size=1280,
    )
    tmp = tmp_path_factory.mktemp("ft_ckpt")
    model = init_vlm(cfg, "cpu", torch.Generator().manual_seed(0), tie_weights=False)
    save_checkpoint_params(str(tmp), model, cfg)
    for f in os.listdir(ASSET):
        shutil.copy(os.path.join(ASSET, f), tmp / f)
    return tmp


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("corpus") / "docs.txt"
    rng = np.random.default_rng(0)
    lines = [" ".join(rng.choice(["the", "cat", "sat", "on", "a", "mat", "dog ran"],
                                 size=int(rng.integers(8, 30)))) for _ in range(24)]
    p.write_text("\n".join(lines), encoding="utf-8")
    return p


def _argv(ckpt, corpus, save, steps, run_dir=None):
    argv = ["--hf-weights", str(ckpt), "--text-data", str(corpus), "--batch-size", "2",
            "--accum-steps", "2", "--max-seq-len", "32", "--rank", "2", "--lr", "1e-2",
            "--steps", str(steps), "--save", str(save), "--save-every", "2",
            "--log-every", "100", "--cpu"]
    return argv + (["--run-dir", str(run_dir)] if run_dir is not None else [])


def test_parse_args_match_jax(checkpoint_dir, corpus, tmp_path):
    for argv in ([], _argv(checkpoint_dir, corpus, tmp_path / "a", 6, tmp_path / "r")):
        got = vars(finetune.parse_args(argv + ["--cpu"]))
        assert got.pop("cpu") is True
        assert got == vars(jax_finetune.parse_args([a for a in argv if a != "--cpu"]))


def test_packed_cli_first_batch_resume_and_rotation(checkpoint_dir, corpus, tmp_path,
                                                    monkeypatch, capsys):
    seen = []
    make = lora_mod.make_lora_train_step

    def recording(*a, **kw):
        init, step = make(*a, **kw)

        def step_and_record(model, state, batch, rng=None):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(model, state, batch, rng)

        return init, step_and_record

    monkeypatch.setattr(lora_mod, "make_lora_train_step", recording)
    finetune.main(_argv(checkpoint_dir, corpus, tmp_path / "a.safetensors", 6))
    # the first batch against the JAX CLI's tokenization and packing
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(str(checkpoint_dir))
    jdocs = jax_finetune._load_text_docs(str(corpus), tok)
    want = next(jax_data.PackedBatchIterator(jdocs, 4, 32, tok.eos_token_id, seed=0))
    assert len(seen) == 6
    for key in ("input_ids", "labels"):
        got = seen[0][key]
        assert tuple(got.shape) == (2, 2, 32)
        np.testing.assert_array_equal(got.reshape(4, 32).numpy(), want[key])

    run = tmp_path / "run"
    finetune.main(_argv(checkpoint_dir, corpus, tmp_path / "b3.safetensors", 3, run))
    finetune.main(_argv(checkpoint_dir, corpus, tmp_path / "b6.safetensors", 6, run))
    assert "Resumed" in capsys.readouterr().out
    a, b = load_file(str(tmp_path / "a.safetensors")), load_file(str(tmp_path / "b6.safetensors"))
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    b3 = load_file(str(tmp_path / "b3.safetensors"))
    assert any(not torch.equal(a[k], b3[k]) for k in a)  # the first run stopped early
    mgr = TrainCheckpointManager(str(run), max_to_keep=3)
    assert mgr.all_steps() == [3, 4, 6] and mgr.latest_step() == 6  # step 2 rotated out


def test_smoke_mode_trains_and_saves(tmp_path, capsys):
    finetune.main(["--steps", "2", "--rank", "2", "--log-every", "1", "--cpu",
                   "--save", str(tmp_path / "s.safetensors")])
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "Saved adapters" in out
    assert load_file(str(tmp_path / "s.safetensors"))["blocks.W_query.lora_a"].shape[-1] == 2


def test_evaluate_main_cpu(checkpoint_dir, corpus, capsys):
    evaluate.main(["--hf-weights", str(checkpoint_dir), "--text", str(corpus), "--window", "64",
                   "--dtype", "float32", "--cpu"])
    out = capsys.readouterr().out
    assert "evaluating" in out and "'perplexity'" in out
