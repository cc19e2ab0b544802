"""Device time of the RMSNorm kernels on one NVIDIA GPU, beside their plain
versions and, where one PyTorch call computes the same function, that call:

    python3 profile_rmsnorm.py

Shapes of Llama-3.2-11B-Vision (C = 4096): the fused add-RMSNorm forward
(``rmsnorm``, inference) at the prefill's R = 1632 with a residual (norm2 of
every layer), at the server's decode R = 8 with a residual and at R = 1
without (``F.rms_norm`` computes that one); the training forward
(``rmsnorm_fwd_train``) and the backward (``rmsnorm_bwd``) at R = 1632, the
backward with ``dw`` (full fine-tuning), with a frozen weight (``dw`` not
asked for: the LoRA step), and at the 3B width C = 3072 both ways; the
backward with ``dw`` at C = 4096 also with its block count
(``ops.cuda.rmsnorm.BWD_PARTS``) set to each of ``PARTS_SWEEP``. Each stands
beside its bound (``chip_smoke.bound``: bytes over 3.35 TB/s).

Each time is CUDA events around 20 back-to-back calls queued behind a
``torch.cuda._sleep`` (device time, ``profile_qgemv.device_ms``), so the
wrappers' host time is hidden. The calls cycle through copies of the inputs
that cover 150 MB where 20 copies reach that (R = 1632: each call reads its
inputs from device memory); a decode call's few KB stay in L2 as they do
behind the previous kernel of a decode step. Then ``torch.profiler`` lists
the kernels of the call. The last line is one JSON object with every time.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from functools import partial

import torch
import torch.nn.functional as F

import chip_smoke as cs
from llama32mm_tpu_torch.ops import cuda as kernels
from llama32mm_tpu_torch.ops.cuda import rmsnorm as rmsnorm_mod
from profile_qgemv import L2_SPAN, REPS, device_ms, kernel_rows

EPS = 1e-5
CASES = [  # (kernel, label, rows, C, forward: with a residual / backward: with dw)
    ("rmsnorm", "fwd R=1632 C=4096 +residual", 1632, 4096, True),
    ("rmsnorm", "fwd R=8 C=4096 +residual", 8, 4096, True),
    ("rmsnorm", "fwd R=1 C=4096", 1, 4096, False),
    ("rmsnorm_fwd_train", "train fwd R=1632 C=4096 +residual", 1632, 4096, True),
    ("rmsnorm_bwd", "bwd R=1632 C=4096", 1632, 4096, True),
    ("rmsnorm_bwd", "bwd R=1632 C=4096 frozen weight", 1632, 4096, False),
    ("rmsnorm_bwd", "bwd 3B R=1632 C=3072", 1632, 3072, True),
    ("rmsnorm_bwd", "bwd 3B R=1632 C=3072 frozen weight", 1632, 3072, False),
]
PARTS_SWEEP = (132, 264, 528)


def make_args(name, rows, cols, flag, gen, dev):
    """One copy of a case's inputs, in ``chip_smoke.kernel_cases``' order."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    if name == "rmsnorm_bwd":
        t = rnd(rows, cols)
        rms = t.float().square().mean(-1).add(EPS).sqrt()
        return (rnd(rows, cols), t, rnd(cols), rms, flag)
    return (rnd(rows, cols), rnd(cols), EPS, rnd(rows, cols) if flag else None)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_rmsnorm: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cs.build_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, label, rows, cols, flag in CASES:
        wrapper, plain = kernels.KERNELS[name]
        one = make_args(name, rows, cols, flag, gen, dev)
        copies = [one] + [make_args(name, rows, cols, flag, gen, dev) for _ in range(
            min(REPS, math.ceil(L2_SPAN / cs._nbytes(one))) - 1)]
        want = plain(*one)
        err, scale = cs.max_err(wrapper(*one), want)
        bound_ms, bound_by = cs.bound(name, one, want)
        calls = {name: [partial(wrapper, *a) for a in copies],
                 "plain": [partial(plain, *a) for a in copies]}
        if name == "rmsnorm" and not flag:
            calls["F.rms_norm"] = [partial(F.rms_norm, a[0], (cols,), a[1], EPS) for a in copies]
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
        print(f"== {label}: bound {bound_ms:.6g} ms ({bound_by}), {len(copies)} input copies; "
              f"max_abs_err vs plain {err:.6g} (max {scale:.6g})")
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for key, us in kernel_rows(calls[name]):
            print(f"    {us:9.2f} us  {key[:100]}")
        if name == "rmsnorm_bwd" and flag and cols == 4096:
            default = rmsnorm_mod.BWD_PARTS
            try:
                for parts in PARTS_SWEEP:
                    rmsnorm_mod.BWD_PARTS = parts
                    row[f"parts={parts}"] = ms = device_ms(calls[name])
                    print(f"  {name} parts={parts:<6d} {ms:.6g} ms  (share of bound "
                          f"{bound_ms / ms:.4g})")
            finally:
                rmsnorm_mod.BWD_PARTS = default
        results[label] = row
        del copies, calls, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "device_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
