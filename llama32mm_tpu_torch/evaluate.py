"""Quality evaluation: teacher-forced perplexity and cross-mode agreement
(counterpart of ``llama32mm_tpu/evaluate.py``).

Serving ships quantized modes (int8 weights, int8 KV cache, int4); this is
their quality side:

- ``perplexity(model, config, ids)``: windowed teacher-forced NLL over a
  token stream through the text decoder (fp32 log-softmax);
- ``agreement(model_a, model_b, config, ids)``: per-position top-1
  next-token agreement and mean |Δlogit| between two models (e.g. bf16
  against int8) on the same stream, each window reduced to two scalars on
  the device;
- CLI: ``python -m llama32mm_tpu_torch.evaluate --hf-weights DIR --text FILE
  [--quantize int8|int4] [--compare] [--cpu]`` (the card unless ``--cpu``).

The loss follows the reference's shifted cross entropy; windows are
independent (no context crosses a window).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from llama32mm_tpu_torch.configs import MLLAMAConfig


def _window_fn(config: MLLAMAConfig, impl: str, kv_dtype: Optional[str] = None):
    """``fn(model, ids [1, W], n_valid) -> (sum NLL over the next-token
    predictions, count, logits [1, W, V] fp32)``. ``kv_dtype="int8"`` prefills
    through an int8 KV cache of ``max_length=W``, so the cache's rounding is
    part of the measured quality (the int8-KV serving mode's numerics)."""
    from llama32mm_tpu_torch.models.language import causal_lm_forward
    from llama32mm_tpu_torch.ops.attention import AttnMask
    from llama32mm_tpu_torch.utils.kvcache import init_kv_cache

    tc = config.text_config
    cache_dtype = None if kv_dtype is None else getattr(torch, kv_dtype)

    @torch.inference_mode()
    def fn(model, ids: torch.Tensor, n_valid: int):
        lm = getattr(model, "language_model", model)
        w = ids.shape[1]
        arange = torch.arange(w, device=ids.device)
        mask = AttnMask(kv_valid=(arange[None, :] < n_valid).to(torch.int32), q_offset=0)
        kv = None
        if cache_dtype is not None:
            kv = init_kv_cache(tc, ids.shape[0], ids.device, max_length=w, dtype=cache_dtype)
        logits, _ = causal_lm_forward(lm, tc, input_ids=ids, attention_mask=mask, kv_cache=kv,
                                      impl=impl)
        logits = logits.float()
        logp = torch.log_softmax(logits, dim=-1)
        # predict ids[t+1] from position t; positions >= n_valid-1 are padding
        tgt = ids[:, 1:].long()
        tok_logp = torch.gather(logp[:, :-1], -1, tgt[..., None])[..., 0]
        valid = (arange[None, : w - 1] < (n_valid - 1)).float()
        return -(tok_logp * valid).sum(), valid.sum(), logits

    return fn


def _windows(ids: np.ndarray, window: int):
    """Split a 1-D token stream into (padded window, n_valid) pieces."""
    n = ids.shape[0]
    for start in range(0, n, window):
        piece = ids[start:start + window]
        n_valid = piece.shape[0]
        if n_valid < 2:
            break  # a single token predicts nothing
        if n_valid < window:
            piece = np.pad(piece, (0, window - n_valid))
        yield piece[None].astype(np.int32), n_valid


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def perplexity(
    model,
    config: MLLAMAConfig,
    token_ids,
    window: int = 2048,
    impl: str = "auto",
    kv_dtype: Optional[str] = None,
) -> dict:
    """Teacher-forced perplexity of the text decoder over ``token_ids`` (a
    1-D array or list), on the device of ``model`` (a VLM or its causal
    LM). Windows are independent (the standard strided-eval
    simplification). ``kv_dtype="int8"`` includes the int8-KV rounding."""
    ids = np.asarray(token_ids).reshape(-1)
    window = int(min(window, max(2, ids.shape[0])))
    fn = _window_fn(config, impl, kv_dtype)
    device = _device_of(model)
    total_nll, total_tok = 0.0, 0.0
    for piece, n_valid in _windows(ids, window):
        nll, cnt, _ = fn(model, torch.from_numpy(piece).to(device), n_valid)
        total_nll += float(nll)
        total_tok += float(cnt)
    if total_tok == 0:
        raise ValueError("need at least 2 tokens to evaluate perplexity")
    mean_nll = total_nll / total_tok
    return {
        "nll_per_token": mean_nll,
        "perplexity": float(np.exp(mean_nll)),
        "tokens": int(total_tok),
        "window": window,
    }


@torch.inference_mode()
def _pair_stats(la: torch.Tensor, lb: torch.Tensor, n_valid: int):
    """On the device: Σ over the first ``n_valid - 1`` positions of
    (argmax_a == argmax_b), and of the mean over the vocabulary of
    |Δlogit|."""
    w = la.shape[1]
    valid = (torch.arange(w, device=la.device) < (n_valid - 1)).float()
    hit = (la[0].argmax(-1) == lb[0].argmax(-1)).float()
    dmean = (la[0] - lb[0]).abs().mean(dim=-1)
    return (hit * valid).sum(), (dmean * valid).sum()


def agreement(
    model_a,
    model_b,
    config: MLLAMAConfig,
    token_ids,
    window: int = 2048,
    impl: str = "auto",
    kv_dtype_b: Optional[str] = None,
) -> dict:
    """Greedy next-token top-1 agreement and mean |Δlogit| between two
    models on the same stream (the quantization-quality metric).
    ``kv_dtype_b`` runs the B side through a quantized KV cache (the serving
    mode's numerics; the A side stays the clean reference). Each window's
    ``[1, W, V]`` logits are reduced to two scalars on the device."""
    ids = np.asarray(token_ids).reshape(-1)
    window = int(min(window, max(2, ids.shape[0])))
    fn = _window_fn(config, impl)
    fn_b = _window_fn(config, impl, kv_dtype_b) if kv_dtype_b else fn
    dev_a, dev_b = _device_of(model_a), _device_of(model_b)

    match, total, dsum = 0.0, 0.0, 0.0
    for piece, n_valid in _windows(ids, window):
        t = torch.from_numpy(piece)
        _, _, la = fn(model_a, t.to(dev_a), n_valid)
        _, _, lb = fn_b(model_b, t.to(dev_b), n_valid)
        m, d = _pair_stats(la, lb.to(la.device), n_valid)
        del la, lb
        match += float(m)
        dsum += float(d)
        total += n_valid - 1
    return {
        "top1_agreement": match / total,
        "mean_abs_dlogit": dsum / total,
        "tokens": int(total),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Perplexity / quantization-quality eval.")
    p.add_argument("--hf-weights", required=True)
    p.add_argument("--text", required=True, help="UTF-8 text file to evaluate on.")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--max-tokens", type=int, default=32768)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantize", choices=["none", "int8", "int4"], default="none")
    p.add_argument(
        "--compare", action="store_true",
        help="also evaluate the unquantized model and report agreement "
        "(loads both: needs the device memory for two copies).",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from llama32mm_tpu_torch.io.checkpoint import load_hf_model

    device = torch.device("cpu" if args.cpu else "cuda")
    model, tokenizer = load_hf_model(
        args.hf_weights, device, dtype=args.dtype,
        streaming=args.quantize != "none",
        quantize_int8=args.quantize == "int8",
        quantize_int4=args.quantize == "int4",
    )
    with open(args.text, encoding="utf-8") as f:
        ids = np.asarray(tokenizer(f.read()).input_ids[: args.max_tokens])
    print(f"evaluating {ids.shape[0]} tokens, window {args.window}, "
          f"quantize={args.quantize}")
    res = perplexity(model, model.config, ids, window=args.window)
    print({k: round(v, 4) if isinstance(v, float) else v for k, v in res.items()})
    if args.compare and args.quantize != "none":
        ref, _ = load_hf_model(args.hf_weights, device, dtype=args.dtype)
        agr = agreement(ref, model, model.config, ids, window=args.window)
        print({k: round(v, 4) if isinstance(v, float) else v for k, v in agr.items()})


if __name__ == "__main__":
    main()
