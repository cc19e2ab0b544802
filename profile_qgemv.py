"""Device time of the decode gemvs on one NVIDIA GPU, beside PyTorch's
calls on the same weights:

    python3 profile_qgemv.py          # the bf16 gemvs, the int8 gemvs, then the int4 gemvs
    python3 profile_qgemv.py --bf16   # the bf16 gemvs alone
    python3 profile_qgemv.py --int8   # the int8 gemvs alone
    python3 profile_qgemv.py --int4   # the int4 gemvs alone

bf16: the decode linears of Llama-3.2-11B-Vision, ``lm_head`` (N=128256,
K=4096), ``W_query`` (N=4096, K=4096), ``W_key`` (N=1024, K=4096) and
``w_down`` (N=4096, K=14336), at R = 1, 5, 8, 16 and 32 rows (5 and 32: the
verify steps of speculative decoding at B=1 and in the 8-slot server). For each it
times the tensor-core gemv (``gemv_tc_cuda``, what ``gemv_cuda`` routes
these shapes to), the CUDA-core gemv (``gemv_simt_cuda``) and ``F.linear``
on the same tensors (a yardstick the port never calls).

int8: the same four shapes and ``w_gate`` (N=14336, K=4096) with int8
weights and per-channel scales (``quantize_weight``), the int8 head among
them, at R = 1, 8, 16 and 32. For each it times the tensor-core int8 gemv
(``gemv_int8_tc_cuda``, what ``gemv_int8_cuda`` routes these shapes to), the
CUDA-core one (``gemv_int8_simt_cuda``) and ``torch._weight_int8pack_mm`` on
the same weights (a yardstick the port never calls).

int4: the shapes of the int4-mixed decode path (g=128), the untied int4
head (R=1, N=128256, K=4096) and ``w_gate`` (N=14336, K=4096) at R = 1, 8,
16 and 32 rows. For each it times the W4A16 gemv (``gemv_int4_cuda``),
``torch._weight_int4pack_mm`` on the same weights in PyTorch's own layout (a
yardstick the port never calls), and the W4A8 gemv on the same bytes: the
tensor-core kernel (``gemv_int4_w4a8_tc_cuda``, what the model's entry
routes these shapes to) and the CUDA-core one (``gemv_int4_w4a8_simt_cuda``),
each with its row quantization (two launches a call).

Each time stands beside its bound (``chip_smoke.bound``: bytes over 3.35
TB/s, operations over the dense peak).

Each time is CUDA events around 20 back-to-back calls queued behind a
``torch.cuda._sleep``, so that the host's launch overhead is hidden and the
number is device time. A decode step reads each layer's weights once, so
they come from device memory, not from the 50 MB L2: a shape whose weights
are smaller than 150 MB is held in several copies, and the calls cycle
through them. Then ``torch.profiler`` lists the kernels of the tensor-core
(bf16 and int8), W4A16 and tensor-core W4A8 (int4) calls with their device
time. The last line is one JSON object with every time.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from functools import partial

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.quant import quantize_weight, quantize_weight_int4

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
                "gemv_simt": [partial(kernels.gemv_simt_cuda, x, w) for w in copies],
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
                "gemv_int8 (CUDA cores)": [partial(kernels.gemv_int8_simt_cuda, x, q, sc)
                                           for q, sc in copies],
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
            "gemv_int4_w4a8_tc": [partial(kernels.gemv_int4_w4a8_tc_cuda, x, q4, sc)
                                  for q4, sc in copies],
            "gemv_int4_w4a8 (CUDA cores)": [partial(kernels.gemv_int4_w4a8_simt_cuda, x, q4, sc)
                                            for q4, sc in copies],
        }
        want = kernels.gemv_int4_w4a8_plain(*args)
        err, scale = cs.max_err(kernels.gemv_int4_w4a8_tc_cuda(*args), want)
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
        print(f"== {label}: bound {bound_ms:.6g} ms ({bound_by}), {len(copies)} weight copies; "
              f"gemv_int4_w4a8_tc max_abs_err vs plain {err:.6g} (max {scale:.6g})")
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for what in ("gemv_int4", "gemv_int4_w4a8_tc"):
            for key, us in kernel_rows(calls[what]):
                print(f"    {us:9.2f} us  {key[:100]}")
        results[label] = row
        del packed, calls
    print(json.dumps({"card": card, "bf16_device_ms": bf16, "int8_device_ms": int8,
                      "device_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
