"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds the port's CUDA kernels from ``llama32mm_tpu_torch/csrc`` (nvcc,
   sm_90a);
3. compares every kernel with its plain PyTorch version at the shapes the
   bf16 and the quantized paths give it, in bf16, and times both (and the
   effective weight GB/s of the gemvs);
4. checks, on a tiny fp32 model, that the kernel path and the plain path
   generate the same tokens: in float, and quantized to int8 and to the
   int4-mixed recipe with an int8 KV cache;
5. builds Llama-3.2-11B-Vision shapes in bf16 from a seed, preprocesses a
   560x560 uint8 image on the card and runs ``InferenceEngine.generate``
   greedily for 64 tokens after a 1600-image-token + 32-text-token prompt,
   checking the output and that every kernel of the path, and no plain
   version, ran; prints, as information, the prefill logits' distance to
   the plain path;
6. does the same with an untied head, quantized to int8 and (from the same
   bf16 weights) to ``INT4_MIXED_RECIPE`` at g=128, each served with
   ``kv_dtype="int8"``.

The second-to-last line is a JSON summary of the kernels, the last line
``{"ok": true, "device": ...}``. A kernel's ``launches`` there sums the 11B
generates of every path (bf16, int8, int4-mixed), each counted from 0 just
before its 64-token run (``launches_by_path`` splits them). Any failure
raises before that line and exits non-zero; without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from llama32mm_tpu_torch.configs import llama32_11b_vision_config, tiny_mllama_config
from llama32mm_tpu_torch.inference.engine import InferenceEngine, structured_prefill_mask
from llama32mm_tpu_torch.models.vlm import init_vlm, vlm_forward
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.cuda.build import build_library
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE, quantize_weight, quantize_weight_int4
from llama32mm_tpu_torch.preprocess.image import preprocess_image_device
from llama32mm_tpu_torch.utils.kvcache import init_kv_cache, quantize_kv

# bf16 comparisons: |kernel - plain| <= TOL * max|plain|. 1.6e-2 is about two
# bf16 ulps (2^-7 each, relative) of the output rounding: the kernel and the
# plain version round intermediates at different places (fp32 vs bf16 gate
# and up in SwiGLU, bf16 vs fp32 probabilities in attention) and sum in
# different orders.
TOL = 1.6e-2

KERNEL_INFO = {
    "rmsnorm": ("llama32mm_tpu_torch/csrc/rmsnorm.cu", "llama32mm_tpu/ops/pallas/rmsnorm.py:55"),
    "gemv": ("llama32mm_tpu_torch/csrc/gemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:655"),
    "swiglu": ("llama32mm_tpu_torch/csrc/swiglu.cu", "llama32mm_tpu/ops/pallas/swiglu.py:69"),
    "flash_attention": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                        "llama32mm_tpu/ops/pallas/attention.py:36"),
    "gemv_int8": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:162"),
    "gemv_int4": ("llama32mm_tpu_torch/csrc/qgemv.cu", "llama32mm_tpu/ops/pallas/gemv.py:272"),
    "qmatmul": ("llama32mm_tpu_torch/csrc/qmatmul.cu",
                "llama32mm_tpu/ops/pallas/quant_matmul.py:29"),
    "flash_attention_int8kv": ("llama32mm_tpu_torch/csrc/flash_attention.cu",
                               "llama32mm_tpu/ops/pallas/attention.py:36"),
}
# Pallas functions a kernel folds in beside the one it is listed against.
ALSO_REPLACES = {
    "gemv": ["llama32mm_tpu/ops/pallas/gemv.py:55", "llama32mm_tpu/ops/pallas/gemv.py:105"],
    "gemv_int8": ["llama32mm_tpu/ops/pallas/gemv.py:701"],
    "gemv_int4": ["llama32mm_tpu/ops/pallas/gemv.py:216"],
    "qmatmul": ["llama32mm_tpu/ops/pallas/quant_matmul.py:99"],
}
# The kernels each 11B path must launch.
PATH_KERNELS = {
    "bf16": ("rmsnorm", "gemv", "swiglu", "flash_attention"),
    "int8": ("rmsnorm", "flash_attention", "flash_attention_int8kv", "gemv_int8", "qmatmul"),
    "int4_mixed": ("rmsnorm", "flash_attention", "flash_attention_int8kv", "gemv_int8",
                   "gemv_int4", "qmatmul"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of one call, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(dev, gen):
    """(kernel, label, args, main-path representative?) at the main path's
    shapes (Llama-3.2-11B-Vision, bf16) plus ragged edges."""
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    def valid(b, tk, n):
        kvv = torch.zeros(b, tk, dtype=torch.int32, device=dev)
        kvv[:, :n] = 1
        return kvv

    def q8(n, k):
        qw = quantize_weight(rnd(n, k, scale=0.02))
        return qw["q"], qw["scale"]

    def q4(n, k, g):
        qw = quantize_weight_int4(rnd(n, k, scale=0.02), g)
        return qw["q4"], qw["scale"]

    def kv8(*shape):
        """int8 K, V and their scales, as the int8 cache holds them."""
        (kq, ks), (vq, vs) = quantize_kv(rnd(*shape)), quantize_kv(rnd(*shape))
        return kq, vq, ks, vs

    h, inter, vocab = 4096, 14336, 128256
    cases = [
        ("rmsnorm", "prefill norm2 R=1632 C=4096 +residual",
         (rnd(1632, h), rnd(h), 1e-5, rnd(1632, h)), True),
        ("rmsnorm", "decode norm1 R=1 C=4096", (rnd(1, h), rnd(h), 1e-5, None), False),
        ("rmsnorm", "ragged R=3 C=100 +residual", (rnd(3, 100), rnd(100), 1e-5, rnd(3, 100)), False),
        ("gemv", "lm_head R=1 N=128256 K=4096", (rnd(1, h), rnd(vocab, h)), True),
        ("gemv", "W_query R=1 N=4096 K=4096", (rnd(1, h), rnd(h, h, scale=0.02)), False),
        ("gemv", "W_key R=1 N=1024 K=4096", (rnd(1, h), rnd(1024, h, scale=0.02)), False),
        ("gemv", "w_down R=1 N=4096 K=14336", (rnd(1, inter), rnd(h, inter, scale=0.01)), False),
        ("gemv", "ragged R=5 N=1000 K=4100", (rnd(5, 4100), rnd(1000, 4100, scale=0.02)), False),
        ("swiglu", "prefill R=1632 H=4096 I=14336",
         (rnd(1632, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), True),
        ("swiglu", "decode R=1 H=4096 I=14336",
         (rnd(1, h), rnd(inter, h, scale=0.02), rnd(inter, h, scale=0.02)), False),
        ("swiglu", "ragged R=33 H=100 I=200",
         (rnd(33, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("swiglu", "ragged decode rows R=3 H=100 I=200",
         (rnd(3, 100), rnd(200, 100, scale=0.1), rnd(200, 100, scale=0.1)), False),
        ("flash_attention", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1632), 0, True), True),
        ("flash_attention", "ViT-H nq=nkv=16 T=1600 hd=80 non-causal",
         (rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
          valid(1, 1600, 1600), 0, False), False),
        ("flash_attention", "decode Tq=1 Tk=2048 q_offset=1700 hd=128",
         (rnd(1, 32, 1, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
          valid(1, 2048, 1701), 1700, True), False),
        ("flash_attention", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), rnd(2, 2, 100, 16), rnd(2, 2, 100, 16),
          valid(2, 100, 90), 5, True), False),
        ("gemv_int8", "int8 lm_head R=1 N=128256 K=4096", (rnd(1, h), *q8(vocab, h)), True),
        ("gemv_int8", "w_gate R=1 N=14336 K=4096", (rnd(1, h), *q8(inter, h)), False),
        ("gemv_int8", "w_down R=1 N=4096 K=14336", (rnd(1, inter), *q8(h, inter)), False),
        ("gemv_int8", "ragged R=5 N=1000 K=4100", (rnd(5, 4100), *q8(1000, 4100)), False),
        ("gemv_int4", "int4 lm_head R=1 N=128256 K=4096 g=128",
         (rnd(1, h), *q4(vocab, h, 128)), True),
        ("gemv_int4", "w_gate R=1 N=14336 K=4096 g=128", (rnd(1, h), *q4(inter, h, 128)), False),
        ("gemv_int4", "ragged R=5 N=1000 K=4160 g=32", (rnd(5, 4160), *q4(1000, 4160, 32)), False),
        ("gemv_int4", "scalar path R=3 N=200 K=192 g=24", (rnd(3, 192), *q4(200, 192, 24)), False),
        ("qmatmul", "int4 w_gate R=1632 N=14336 K=4096 g=128",
         (rnd(1632, h), *q4(inter, h, 128)), True),
        ("qmatmul", "int8 w_down R=1632 N=4096 K=14336", (rnd(1632, inter), *q8(h, inter)), False),
        ("qmatmul", "int8 W_query R=33 N=4096 K=4096", (rnd(33, h), *q8(h, h)), False),
        ("qmatmul", "int4 w_up R=33 N=14336 K=4096 g=128", (rnd(33, h), *q4(inter, h, 128)), False),
        ("qmatmul", "ragged int8 R=100 N=1000 K=4100", (rnd(100, 4100), *q8(1000, 4100)), False),
        ("qmatmul", "ragged int4 R=70 N=1000 K=4160 g=32",
         (rnd(70, 4160), *q4(1000, 4160, 32)), False),
        ("qmatmul", "int4 element path R=40 N=200 K=192 g=24", (rnd(40, 192), *q4(200, 192, 24)),
         False),
        ("flash_attention_int8kv", "decoder prefill nq=32 nkv=8 Tq=1632 Tk=2048 hd=128 causal",
         (rnd(1, 32, 1632, 128), *kv8(1, 8, 2048, 128), valid(1, 2048, 1632), 0, True), True),
        ("flash_attention_int8kv", "decode Tq=1 Tk=2048 q_offset=1700 hd=128",
         (rnd(1, 32, 1, 128), *kv8(1, 8, 2048, 128), valid(1, 2048, 1701), 1700, True), False),
        ("flash_attention_int8kv", "ragged B=2 Tq=37 Tk=100 q_offset=5 hd=16 padded keys",
         (rnd(2, 4, 37, 16), *kv8(2, 2, 100, 16), valid(2, 100, 90), 5, True), False),
    ]
    return cases


def compare_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    summary = {}
    for name, label, args, main in kernel_cases(dev, gen):
        wrapper, plain = kernels.KERNELS[name]
        got, want = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ms, plain_ms = time_ms(lambda: wrapper(*args)), time_ms(lambda: plain(*args))
        rate = ""
        if name.startswith("gemv"):  # weight (and scale) bytes streamed per call
            wbytes = sum(t.numel() * t.element_size() for t in args[1:])
            rate = f" weight_GB/s={wbytes / ms / 1e6:.6g} plain_weight_GB/s={wbytes / plain_ms / 1e6:.6g}"
        log(f"kernel {name} [{label}]: max_abs_err={err:.6g} max_abs_plain={scale:.6g} "
            f"ms={ms:.6g} plain_ms={plain_ms:.6g}{rate}")
        if not err <= TOL * scale:
            raise RuntimeError(f"{name} [{label}] disagrees with its plain version: "
                               f"{err} > {TOL} * {scale}")
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if main:  # the summary line reports the main-path shape's times
            s.update(ms=ms, plain_ms=plain_ms)
    return summary


def check_tiny_paths_agree(dev) -> None:
    """On a tiny fp32 model, the kernel path and the plain path agree."""
    cfg = tiny_mllama_config(max_cache_length=64)
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, 240, (1, 12), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    raw = torch.randint(0, 256, (1, 28, 28, 3), generator=gen, device=dev, dtype=torch.uint8)
    px = preprocess_image_device(raw, cfg.vision_config.image_size)
    res = {impl: InferenceEngine(model, cfg, dev, impl=impl).generate(ids, px, max_new_tokens=8)
           for impl in ("cuda", "torch")}
    dl = (res["cuda"].prefill_logits - res["torch"].prefill_logits).abs().max().item()
    log(f"tiny fp32: tokens cuda={res['cuda'].tokens.tolist()} torch={res['torch'].tokens.tolist()} "
        f"max_abs_dlogit={dl:.3g}")
    if dl > 1e-4 or not torch.equal(res["cuda"].tokens, res["torch"].tokens):
        raise RuntimeError("tiny model: kernel path and plain path disagree")

    # Quantized, with the int8 cache. The 40-token prompt puts the prefill's
    # linears above the gemv limit, on the dequantizing GEMM.
    ids = torch.randint(0, 240, (1, 40), generator=gen, device=dev)
    ids[:, :4] = cfg.image_token_index
    for mode, kw in (("int8", dict(bits=8)),
                     ("int4_mixed", dict(bits=4, group_size=32, recipe=INT4_MIXED_RECIPE))):
        qmodel = quantize_llama_params(model, **kw)
        res = {}
        for impl in ("cuda", "torch"):
            kernels.reset_counters()
            res[impl] = InferenceEngine(qmodel, cfg, dev, impl=impl, kv_dtype="int8").generate(
                ids, px, max_new_tokens=8)
            if impl == "cuda":
                launches = kernels.launch_counts()
        dl = (res["cuda"].prefill_logits - res["torch"].prefill_logits).abs().max().item()
        log(f"tiny fp32 {mode}, int8 KV: tokens cuda={res['cuda'].tokens.tolist()} "
            f"torch={res['torch'].tokens.tolist()} max_abs_dlogit={dl:.3g} launches {launches}")
        missing = [k for k in PATH_KERNELS[mode] if launches[k] == 0]
        if dl > 1e-4 or not torch.equal(res["cuda"].tokens, res["torch"].tokens) or missing:
            raise RuntimeError(f"tiny {mode} model: kernel path and plain path disagree "
                               f"(or skipped {missing})")


def build_11b(dev, tie_weights: bool):
    cfg = llama32_11b_vision_config()
    t0 = time.perf_counter()
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0), tie_weights=tie_weights)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"11B model ({'tied' if tie_weights else 'untied'} head): {n_params} parameters, bf16, "
        f"init {time.perf_counter() - t0:.3f} s, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return cfg, model


def run_11b(dev, cfg, model, path: str, kv_dtype=None) -> dict:
    """Generate 64 tokens on the 11B model, check the result and that the
    path's kernels, and no plain version, ran; return the launch counts."""
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
    image = torch.full((1, vc.num_patches), cfg.image_token_index, device=dev)
    ids = torch.cat([image, text], dim=1)  # S = 1632
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048, kv_dtype=kv_dtype)

    def generate(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
        res = engine.generate(ids, px, max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    generate(2)  # warm-up: library handles, allocator
    _, ttft = generate(1)
    kernels.reset_counters()
    res, t64 = generate(64)
    launches, plain_calls = kernels.launch_counts(), kernels.plain_counts()
    decode_tps = 63 / (t64 - ttft)
    log(f"[{path}] generate 64: {t64:.4f} s; TTFT (preprocess+prefill+first token) "
        f"{ttft * 1e3:.2f} ms; decode {decode_tps:.2f} tok/s (63 tokens after the first); "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{path}] launches {launches} plain calls {plain_calls}")
    log(f"[{path}] tokens {res.tokens[0].tolist()}")

    if tuple(res.tokens.shape) != (1, 64) or int(res.num_generated[0]) != 64:
        raise RuntimeError(f"expected 64 tokens, got {tuple(res.tokens.shape)} / {res.num_generated}")
    if not bool(((res.tokens >= 0) & (res.tokens < tc.vocab_size)).all()):
        raise RuntimeError("generated ids outside the vocabulary")
    if tuple(res.prefill_logits.shape) != (1, tc.vocab_size) or not bool(
            torch.isfinite(res.prefill_logits).all()):
        raise RuntimeError("prefill logits are not finite [1, vocab]")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing or any(plain_calls.values()):
        raise RuntimeError(f"[{path}] skipped kernels {missing} or ran plain versions {plain_calls}")

    # Information: the same prefill on the plain path (random-init greedy
    # tokens are near-ties, so token equality is not asserted).
    with torch.inference_mode():
        px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
        pos = torch.tensor([[ids.shape[1] - 1]], device=dev)
        if kv_dtype is None:
            plain = vlm_forward(model, cfg, input_ids=ids, pixel_values=px, impl="torch",
                                logits_positions=pos)
        else:  # through an int8 cache, as the engine's prefill
            cache = init_kv_cache(tc, 1, dev, max_length=2048, dtype=torch.int8)
            mask = structured_prefill_mask(torch.ones_like(ids, dtype=torch.int32), 2048)
            plain = vlm_forward(model, cfg, input_ids=ids, pixel_values=px, impl="torch",
                                attention_mask=mask, kv_cache=cache, logits_positions=pos)
            del cache
    dl = (plain.logits[:, 0].float() - res.prefill_logits.float()).abs().max().item()
    log(f"[{path}] prefill logits, kernel path vs impl='torch': max_abs_dlogit={dl:.6g} "
        f"max_abs_logit={res.prefill_logits.float().abs().max().item():.6g}")
    return launches


def run_11b_paths(dev) -> dict:
    """The bf16 path (tied head), then int8 and int4-mixed quantized copies
    of one untied bf16 model, each served from an int8 KV cache."""
    by_path = {}
    cfg, model = build_11b(dev, tie_weights=True)
    by_path["bf16"] = run_11b(dev, cfg, model, "bf16")
    del model
    torch.cuda.empty_cache()
    cfg, model = build_11b(dev, tie_weights=False)
    for path, kw in (("int8", dict(bits=8)),
                     ("int4_mixed", dict(bits=4, group_size=128, recipe=INT4_MIXED_RECIPE))):
        t = time.perf_counter()
        qmodel = quantize_llama_params(model, **kw)
        torch.cuda.synchronize()
        log(f"[{path}] quantize {time.perf_counter() - t:.3f} s, "
            f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        torch.cuda.reset_peak_memory_stats()
        by_path[path] = run_11b(dev, cfg, qmodel, path, kv_dtype="int8")
        del qmodel
        torch.cuda.empty_cache()
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    lib = build_library()
    log(f"kernel build {time.perf_counter() - t:.3f} s: {lib.name}")

    summary = compare_kernels(dev)
    torch.cuda.empty_cache()
    check_tiny_paths_agree(dev)
    by_path = run_11b_paths(dev)

    out = []
    for name, (source, replaces) in KERNEL_INFO.items():
        s = summary[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "also_replaces": ALSO_REPLACES.get(name, []),
                    "launches": sum(counts[name] for counts in by_path.values()),
                    "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
                    "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"]})
    print(json.dumps({"kernels": out}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
