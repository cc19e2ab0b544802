"""Device time of the decode gemvs on one NVIDIA GPU, beside PyTorch's
calls on the same weights:

    python3 profile_qgemv.py          # the bf16 gemvs, the int8 gemvs, then the int4 gemvs
    python3 profile_qgemv.py --bf16   # the bf16 gemvs alone
    python3 profile_qgemv.py --int8   # the int8 gemvs alone
    python3 profile_qgemv.py --int4   # the int4 gemvs alone
    python3 profile_qgemv.py --fp32 [--tree DIR]   # the int4 gemvs' other calls, fp32 gemvs

bf16: the decode linears of Llama-3.2-11B-Vision, ``lm_head`` (N=128256,
K=4096), ``W_query`` (N=4096, K=4096), ``W_key`` (N=1024, K=4096) and
``w_down`` (N=4096, K=14336), at R = 1, 5, 8, 16 and 32 rows (5 and 32: the
verify steps of speculative decoding at B=1 and in the 8-slot server). For each it
times the tensor-core gemv (``gemv_tc_cuda``, what ``gemv_cuda`` routes
these shapes to) and ``F.linear`` on the same tensors (a yardstick the port
never calls).

int8: the same four shapes and ``w_gate`` (N=14336, K=4096) with int8
weights and per-channel scales (``quantize_weight``), the int8 head among
them, at R = 1, 8, 16 and 32. For each it times the tensor-core int8 gemv
(``gemv_int8_tc_cuda``, what ``gemv_int8_cuda`` routes these shapes to) and
``torch._weight_int8pack_mm`` on the same weights (a yardstick the port
never calls).

int4: the shapes of the int4-mixed decode path (g=128), the untied int4
head (R=1, N=128256, K=4096) and ``w_gate`` (N=14336, K=4096) at R = 1, 8,
16 and 32 rows. For each it times the W4A16 gemv (``gemv_int4_cuda``),
``torch._weight_int4pack_mm`` on the same weights in PyTorch's own layout (a
yardstick the port never calls), and the W4A8 gemv on the same bytes
(``gemv_int4_w4a8_cuda``, with its row quantization: two launches a call).

``--fp32``: the calls that once ran on CUDA-core gemvs, beside the bf16
calls that never did: W4A16 on fp32 x (three bf16 planes after a
pre-pass) at ``w_gate`` R = 1, 8 and 32 and the int4 head at R = 1; W4A16
and W4A8 at g=16 (spans that straddle groups) on ``w_gate`` at R = 8;
W4A16 and W4A8 at g=128 on bf16 x (``w_gate`` R = 1, 8, 32, the head at R
= 1); the int8 gemv (``gemv_int8_cuda``: three bf16 planes) and the float
gemv (``gemv_cuda``, fp32 weights: 3xTF32) on fp32 x at ``lm_head`` and
``w_gate`` at R = 1, 8 and 32; and both on bf16 x at ``lm_head`` and
``w_down`` at R = 1 and 8 (the tensor-core kernels on x as it is, the
decode path). Each through the entry the model calls, beside the library
call where it takes the inputs (``torch._weight_int4pack_mm``: bf16 x only;
fp32 ``F.linear`` with ``torch.backends.cuda.matmul.allow_tf32`` False, as
by default, checked; ``torch._weight_int8pack_mm``) and the bound (bytes
over 3.35 TB/s; fp32 x in W4A16 and int8 as three bf16 products a weight at
989 / 3 TFLOP/s, in the float gemv as three TF32 products at 494.7 / 3).
``--tree DIR`` imports the port package and
``chip_smoke`` from another checkout (built into its own ``build/``), so
that one chip call times a parent commit's kernels beside this tree's on
the same shapes: run parent, tree, tree, parent.

Each time stands beside its bound (``chip_smoke.bound``: bytes over 3.35
TB/s, operations over the dense peak).

Each time is CUDA events around 20 back-to-back calls queued behind a
``torch.cuda._sleep``, so that the host's launch overhead is hidden and the
number is device time. A decode step reads each layer's weights once, so
they come from device memory, not from the 50 MB L2: a shape whose weights
are smaller than 150 MB is held in several copies, and the calls cycle
through them. Then ``torch.profiler`` lists the kernels of the tensor-core
(bf16 and int8), W4A16 and W4A8 (int4) calls with their device time. The last line is one JSON object with every time.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

if __name__ == "__main__" and "--tree" in sys.argv[1:]:  # another checkout's port package
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()))

import chip_smoke as cs  # noqa: E402
from llama32mm_tpu_torch.ops import cuda as kernels  # noqa: E402
from llama32mm_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4  # noqa: E402

REPS = 20
L2_SPAN = 150e6  # bytes the copies of one shape's weights cover, 3x the L2
SHAPES = [  # (label, rows, N, K, g)
    ("int4 lm_head R=1 N=128256 K=4096 g=128", 1, 128256, 4096, 128),
    ("w_gate R=1 N=14336 K=4096 g=128", 1, 14336, 4096, 128),
    ("w_gate R=8 N=14336 K=4096 g=128", 8, 14336, 4096, 128),
    ("w_gate R=16 N=14336 K=4096 g=128", 16, 14336, 4096, 128),
    ("w_gate R=32 N=14336 K=4096 g=128", 32, 14336, 4096, 128),
]
BF16_SHAPES = {  # label: (N, K)
    "lm_head N=128256 K=4096": (128256, 4096),
    "W_query N=4096 K=4096": (4096, 4096),
    "W_key N=1024 K=4096": (1024, 4096),
    "w_down N=4096 K=14336": (4096, 14336),
}
BF16_ROWS = (1, 5, 8, 16, 32)  # 5: a B=1 verify of K=4 drafts; 32: the 8-slot server's of K=3
INT8_SHAPES = dict(BF16_SHAPES, **{"w_gate N=14336 K=4096": (14336, 4096)})
F32, BF = torch.float32, torch.bfloat16
FP32_MODE_SHAPES = [  # (label, entry, rows, N, K, g, x dtype)
    *[(f"W4A16 fp32 x w_gate R={r} N=14336 K=4096 g=128", "int4", r, 14336, 4096, 128, F32)
      for r in (1, 8, 32)],
    ("W4A16 fp32 x int4 lm_head R=1 N=128256 K=4096 g=128", "int4", 1, 128256, 4096, 128, F32),
    ("W4A16 w_gate R=8 N=14336 K=4096 g=16", "int4", 8, 14336, 4096, 16, BF),
    ("W4A8 w_gate R=8 N=14336 K=4096 g=16", "w4a8", 8, 14336, 4096, 16, BF),
    *[(f"W4A16 w_gate R={r} N=14336 K=4096 g=128", "int4", r, 14336, 4096, 128, BF)
      for r in (1, 8, 32)],
    ("W4A16 int4 lm_head R=1 N=128256 K=4096 g=128", "int4", 1, 128256, 4096, 128, BF),
    *[(f"W4A8 w_gate R={r} N=14336 K=4096 g=128", "w4a8", r, 14336, 4096, 128, BF)
      for r in (1, 8, 32)],
    *[(f"{entry} fp32 x {name} R={r} N={n} K=4096", entry, r, n, 4096, 0, F32)
      for entry in ("int8", "float") for name, n in (("lm_head", 128256), ("w_gate", 14336))
      for r in (1, 8, 32)],
    *[(f"{entry} bf16 x {name} R={r} N={n} K={k}", entry, r, n, k, 0, BF)
      for entry in ("int8", "float") for name, n, k in (("lm_head", 128256, 4096),
                                                        ("w_down", 4096, 14336))
      for r in (1, 8)],
]
BF16X3_OPS = 989e12 / 3  # an fp32 x value as three bf16 planes, three bf16 products
TF32X3_OPS = 494.7e12 / 3  # an fp32 product as three TF32 products


def device_ms(fns) -> float:
    """Device time of one call: the mean of REPS calls, cycling through
    ``fns`` (one per weight copy), queued behind a sleep."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e6))  # keeps the device busy while the host queues the calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(REPS):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_rows(fns) -> list:
    """``(name, device us per call)`` of the kernels one call launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(REPS):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return [(e.key, e.device_time_total / REPS) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def profile_bf16(dev, gen) -> dict:
    """The bf16 gemvs at ``BF16_SHAPES`` x ``BF16_ROWS``, as the module
    docstring says."""
    results = {}
    for label, (n, k) in BF16_SHAPES.items():
        copies = [(torch.randn(n, k, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
                  for _ in range(max(1, math.ceil(L2_SPAN / (n * k * 2))))]
        for rows in BF16_ROWS:
            x = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
            args = (x, copies[0])
            want = kernels.gemv_plain(*args)
            bound_ms, bound_by = cs.bound("gemv_tc", args, want)
            calls = {
                "gemv_tc": [partial(kernels.gemv_tc_cuda, x, w) for w in copies],
                "F.linear": [partial(F.linear, x, w) for w in copies],
            }
            err = (kernels.gemv_tc_cuda(*args).float() - want.float()).abs().max().item()
            row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
            print(f"== bf16 {label} R={rows}: bound {bound_ms:.6g} ms ({bound_by}), "
                  f"{len(copies)} weight copies; gemv_tc max_abs_err vs plain {err:.6g} "
                  f"(max {want.float().abs().max().item():.6g})")
            for what, fns in calls.items():
                ms = device_ms(fns)
                row[what] = ms
                print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
            for key, us in kernel_rows(calls["gemv_tc"]):
                print(f"    {us:9.2f} us  {key[:100]}")
            results[f"{label} R={rows}"] = row
        del copies
        torch.cuda.empty_cache()
    return results


def profile_int8(dev, gen) -> dict:
    """The int8 gemvs at ``INT8_SHAPES`` x ``BF16_ROWS``, as the module
    docstring says."""
    results = {}
    for label, (n, k) in INT8_SHAPES.items():
        copies = []
        for _ in range(max(1, math.ceil(L2_SPAN / (n * k + 4 * n)))):
            qw = quantize_weight((torch.randn(n, k, generator=gen, device=dev) * 0.02)
                                 .to(torch.bfloat16))
            copies.append((qw["q"], qw["scale"]))
        scales = [sc.to(torch.bfloat16) for _, sc in copies]  # _weight_int8pack_mm's
        for rows in BF16_ROWS:
            x = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
            args = (x, *copies[0])
            want = kernels.gemv_int8_plain(*args)
            bound_ms, bound_by = cs.bound("gemv_int8_tc", args, want)
            calls = {
                "gemv_int8_tc": [partial(kernels.gemv_int8_tc_cuda, x, q, sc) for q, sc in copies],
                "_weight_int8pack_mm": [partial(torch._weight_int8pack_mm, x, q, sc)
                                        for (q, _), sc in zip(copies, scales)],
            }
            err, scale = cs.max_err(kernels.gemv_int8_tc_cuda(*args), want)
            row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
            print(f"== int8 {label} R={rows}: bound {bound_ms:.6g} ms ({bound_by}), "
                  f"{len(copies)} weight copies; gemv_int8_tc max_abs_err vs plain {err:.6g} "
                  f"(max {scale:.6g})")
            for what, fns in calls.items():
                ms = device_ms(fns)
                row[what] = ms
                print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
            for key, us in kernel_rows(calls["gemv_int8_tc"]):
                print(f"    {us:9.2f} us  {key[:100]}")
            results[f"{label} R={rows}"] = row
        del copies, scales
        torch.cuda.empty_cache()
    return results


def _fp32_mode_weights(entry, n, k, g, dtype, dev, gen):
    """One copy of a shape's weights as its entry takes them (the float
    gemv's in x's dtype), and its bytes."""
    w = torch.randn(n, k, generator=gen, device=dev) * 0.02
    if entry == "float":
        return (w.to(dtype),), (2 if dtype == BF else 4) * n * k
    if entry == "int8":
        qw = quantize_weight(w.to(BF))
        return (qw["q"], qw["scale"]), n * k + 4 * n
    qw = quantize_weight_int4(w.to(BF), g)
    return (qw["q4"], qw["scale"]), n * k // 2 + 4 * n * (k // g)


def profile_fp32(dev, gen) -> dict:
    """``FP32_MODE_SHAPES`` through the model's entries, as the module
    docstring says."""
    tree = Path(kernels.__file__).resolve().parents[3]
    print(f"kernels of {tree}")
    entries = {"int4": (kernels.gemv_int4_cuda, kernels.gemv_int4_plain),
               "w4a8": (kernels.gemv_int4_w4a8_cuda, kernels.gemv_int4_w4a8_plain),
               "int8": (kernels.gemv_int8_cuda, kernels.gemv_int8_plain),
               "float": (kernels.gemv_cuda, kernels.gemv_plain)}
    results, weights = {}, {}
    for label, entry, rows, n, k, g, dtype in FP32_MODE_SHAPES:
        key = (entry, n, k, g, dtype if entry == "float" else None)
        if key not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            first, nbytes = _fp32_mode_weights(entry, n, k, g, dtype, dev, gen)
            weights[key] = [first] + [_fp32_mode_weights(entry, n, k, g, dtype, dev, gen)[0]
                                      for _ in range(max(1, math.ceil(L2_SPAN / nbytes)) - 1)]
        copies = weights[key]
        x = torch.randn(rows, k, generator=gen, device=dev).to(dtype)
        wrapper, plain = entries[entry]
        kernels.reset_counters()
        got = wrapper(x, *copies[0])
        launched = {name: c for name, c in kernels.launch_counts().items() if c}
        err, scale = cs.max_err(got, plain(x, *copies[0]))
        nbytes = sum(t.numel() * t.element_size() for t in (x, *copies[0], got))
        ops = 2 * rows * n * k
        peak = None
        if dtype == F32:
            peak = {"int4": BF16X3_OPS, "int8": BF16X3_OPS, "float": TF32X3_OPS}.get(entry)
        bound_ms = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S, ops / peak if peak else 0.0)
        row = {"launched": launched, "max_abs_err": err, "max_abs_plain": scale,
               "bound_ms": bound_ms, "copies": len(copies)}
        print(f"== {label}: entry launched {launched}; max_abs_err vs plain {err:.6g} (max "
              f"{scale:.6g}, {err / scale:.3g}); bound {bound_ms:.6g} ms, {len(copies)} "
              f"weight copies")
        calls = {"entry": [partial(wrapper, x, *w) for w in copies]}
        if entry == "int4" and dtype == BF:
            try:  # it takes g = 32, 64, 128 and 256 only
                packed = [cs._int4pack(q4, sc, x) for q4, sc in copies]
                torch._weight_int4pack_mm(x, *packed[0])
                calls["_weight_int4pack_mm"] = [partial(torch._weight_int4pack_mm, x, *p)
                                                for p in packed]
            except RuntimeError as e:
                print(f"  _weight_int4pack_mm unavailable: {str(e).splitlines()[0][:100]}")
        if entry == "float":
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("fp32 F.linear would run on TF32: allow_tf32 is set")
            calls["F.linear"] = [partial(F.linear, x, *w) for w in copies]
        if entry == "int8":
            try:
                scales = [sc.to(dtype) for _, sc in copies]
                torch._weight_int8pack_mm(x, copies[0][0], scales[0])
                torch.cuda.synchronize()
                calls["_weight_int8pack_mm"] = [partial(torch._weight_int8pack_mm, x, q, sc)
                                                for (q, _), sc in zip(copies, scales)]
            except RuntimeError as e:
                print(f"  _weight_int8pack_mm unavailable: {str(e).splitlines()[0][:100]}")
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for name, us in kernel_rows(calls["entry"]):
            print(f"    {us:9.2f} us  {name[:100]}")
        results[label] = row
        del calls
    return {"tree": str(tree), "fp32_mode_device_ms": results}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_qgemv: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cs.build_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    if "--fp32" in sys.argv[1:]:
        print(json.dumps({"card": card, **profile_fp32(dev, gen)}))
        return 0
    only = [a for a in sys.argv[1:] if a in ("--bf16", "--int8", "--int4")]
    bf16 = profile_bf16(dev, gen) if not only or "--bf16" in only else {}
    int8 = profile_int8(dev, gen) if not only or "--int8" in only else {}
    if only and "--int4" not in only:
        print(json.dumps({"card": card, "bf16_device_ms": bf16, "int8_device_ms": int8}))
        return 0
    results = {}
    weights = {}  # (N, K, g) -> list of (q4, scale) copies
    for label, rows, n, k, g in SHAPES:
        if (n, k, g) not in weights:
            one = n * k // 2 + n * (k // g) * 4
            copies = max(1, math.ceil(L2_SPAN / one))
            weights[n, k, g] = []
            for _ in range(copies):
                w = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
                qw = quantize_weight_int4(w, g)
                weights[n, k, g].append((qw["q4"], qw["scale"]))
                del w
        copies = weights[n, k, g]
        x = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
        args = (x, *copies[0])
        bound_ms, bound_by = cs.bound("gemv_int4", args, kernels.gemv_int4_cuda(*args))
        packed = [cs._int4pack(q4, sc, x) for q4, sc in copies]
        calls = {
            "gemv_int4": [partial(kernels.gemv_int4_cuda, x, q4, sc) for q4, sc in copies],
            "_weight_int4pack_mm": [partial(torch._weight_int4pack_mm, x, *p) for p in packed],
            "gemv_int4_w4a8": [partial(kernels.gemv_int4_w4a8_cuda, x, q4, sc)
                               for q4, sc in copies],
        }
        want = kernels.gemv_int4_w4a8_plain(*args)
        err, scale = cs.max_err(kernels.gemv_int4_w4a8_cuda(*args), want)
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
        print(f"== {label}: bound {bound_ms:.6g} ms ({bound_by}), {len(copies)} weight copies; "
              f"gemv_int4_w4a8 max_abs_err vs plain {err:.6g} (max {scale:.6g})")
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for what in ("gemv_int4", "gemv_int4_w4a8"):
            for key, us in kernel_rows(calls[what]):
                print(f"    {us:9.2f} us  {key[:100]}")
        results[label] = row
        del packed, calls
    print(json.dumps({"card": card, "bf16_device_ms": bf16, "int8_device_ms": int8,
                      "device_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
