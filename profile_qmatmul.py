"""Device time of the dequantizing prefill GEMM on one NVIDIA GPU, beside
PyTorch's quantized matmuls and cuBLAS on the same weights:

    python3 profile_qmatmul.py

Shapes of the quantized prefill of Llama-3.2-11B-Vision (R = 1632 rows: a
560x560 image's 1600 tokens and 32 text tokens): ``w_gate``/``w_up``
(N=14336, K=4096) in int4 at g=128 and in int8, ``w_down`` (N=4096,
K=14336), ``W_query``/``out_proj`` (N=4096, K=4096) and ``W_key``/
``W_value`` (N=1024, K=4096) in int8. For each it times

- ``qmatmul_cuda``, the entry ``ops/gemv.py::qlinear`` calls (it routes by
  shape to one of the kernels of ``csrc/qmatmul.cu``);
- each ``qmatmul*`` kernel of ``ops.cuda.KERNELS`` on its own;
- ``qmatmul_plain`` (dequantize, then one matmul);
- the library call, ``torch._weight_int4pack_mm`` or
  ``torch._weight_int8pack_mm`` on the same weights (``chip_smoke.
  library_call``);
- ``torch.matmul`` on a bf16 copy of the dequantized weight: cuBLAS's bf16
  GEMM at the same shape, a ceiling the port never calls;

each beside its bound (``chip_smoke.bound``: operations over the bf16 dense
peak, bytes over 3.35 TB/s). Each time is CUDA events around 20
back-to-back calls queued behind a ``torch.cuda._sleep`` (device time,
``profile_qgemv.device_ms``). A prefill reads each layer's weights once, so
a shape whose weights are smaller than 150 MB is held in several copies and
the calls cycle through them. Then ``torch.profiler`` lists the kernels of
the routed call. Last, the sum over one prefill of each recipe (launches x
time: int8, and ``INT4_MIXED_RECIPE`` with ``w_gate``/``w_up`` in int4).
The last line is one JSON object with every time.

    python3 profile_qmatmul.py --ttft

instead times what a user sees: the 11B model (untied head, random weights
from a seed) quantized to int8 and to ``INT4_MIXED_RECIPE`` at g=128, each
served with the int8 KV cache as ``chip_smoke.py`` serves them; per recipe,
after a warm-up, 5 greedy one-token generates of a 560x560 image and 32
text ids (S = 1632), host clock around preprocess, prefill and first token,
ending in a synchronize. It prints each time and the median (TTFT).
``--kernels-only`` times the routed call and the kernels alone (for A/B
runs of kernel variants).

    python3 profile_qmatmul.py --fp32 [--general] [--rows R] [--tree DIR]

times other shape sets at R = 1632 (or ``--rows``), each through the entry
the model calls
(``qmatmul_cuda``), beside ``qmatmul_plain``, the library call where it
takes the inputs and the bound: ``--fp32`` fp32 x (``w_gate`` N=14336
K=4096 in int8 and in int4 at g=128; the bound counts three bf16 products
a weight, ``chip_smoke.bound``), ``--general`` bf16 x that the wgmma
kernel's tiles do not take as it is (int4 ``w_gate`` at g=32, int8
``w_gate`` at a ragged K=4100, and the int4 ``w_up`` of the set above forced
onto the general route, ``qmatmul_general_cuda``, where the parent's
``qmatmul`` entry forces its wmma kernel). A call slower than 50 ms (a CUDA-core loop) is timed
with 2 launches, not 20, and is not profiled. ``--tree DIR`` (here and with
``--kernels-only``) imports the port package and ``chip_smoke`` from
another checkout (built into its own ``build/``), so that one chip call
times a parent commit's kernels beside this tree's on the same shapes: run
parent, tree, tree, parent.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import torch

if __name__ == "__main__" and "--tree" in sys.argv[1:]:  # another checkout's port package
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()))

import chip_smoke as cs  # noqa: E402
from llama32mm_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from llama32mm_tpu_torch.models.quantize import quantize_llama_params  # noqa: E402
from llama32mm_tpu_torch.ops import cuda as kernels  # noqa: E402
from llama32mm_tpu_torch.ops.quant import (  # noqa: E402
    INT4_MIXED_RECIPE,
    dequantize_weight,
    quantize_weight,
    quantize_weight_int4,
)
from llama32mm_tpu_torch.preprocess.image import preprocess_image_device  # noqa: E402
from profile_qgemv import L2_SPAN, device_ms, kernel_rows  # noqa: E402

ROWS = 1632
SHAPES = {  # label: (N, K, group size; 0 for int8)
    "int4 w_gate N=14336 K=4096 g=128": (14336, 4096, 128),
    "int8 w_gate N=14336 K=4096": (14336, 4096, 0),
    "int8 w_down N=4096 K=14336": (4096, 14336, 0),
    "int8 W_query N=4096 K=4096": (4096, 4096, 0),
    "int8 W_key N=1024 K=4096": (1024, 4096, 0),
}
# Other shape sets: label -> (N, K, group size, x dtype, entry: the routed
# call, or "qmatmul", the KERNELS entry that forces the general route).
BF, F32 = torch.bfloat16, torch.float32
SETS = {
    "--fp32": {"fp32 int8 w_gate N=14336 K=4096": (14336, 4096, 0, F32, "routed"),
               "fp32 int4 w_gate N=14336 K=4096 g=128": (14336, 4096, 128, F32, "routed")},
    "--general": {"int4 w_gate N=14336 K=4096 g=32": (14336, 4096, 32, BF, "routed"),
                  "ragged int8 w_gate N=14336 K=4100": (14336, 4100, 0, BF, "routed"),
                  "forced int4 w_up N=14336 K=4096 g=128": (14336, 4096, 128, BF, "qmatmul")},
}
SLOW_MS = 50.0  # a call above this is timed with 2 launches
# Launches of each shape in one prefill of the 40-layer decoder, per recipe.
PREFILL = {
    "int8": {"int8 w_gate N=14336 K=4096": 80, "int8 w_down N=4096 K=14336": 40,
             "int8 W_query N=4096 K=4096": 80, "int8 W_key N=1024 K=4096": 80},
    "int4_mixed": {"int4 w_gate N=14336 K=4096 g=128": 80, "int8 w_down N=4096 K=14336": 40,
                   "int8 W_query N=4096 K=4096": 80, "int8 W_key N=1024 K=4096": 80},
}


def quantized_copies(n, k, g, gen, dev):
    """Enough ``(q, scale)`` copies of one random weight shape to cover
    ``L2_SPAN`` bytes."""
    one = n * k // 2 + n * (k // g) * 4 if g else n * k + n * 4
    copies = []
    for _ in range(max(1, math.ceil(L2_SPAN / one))):
        w = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        qw = quantize_weight_int4(w, g) if g else quantize_weight(w)
        copies.append((qw["q4"] if g else qw["q"], qw["scale"]))
        del w
    return copies


def ttft(dev, card: str, reps: int = 5) -> None:
    """TTFT of the int8 and int4-mixed 11B prefill, as the module docstring
    says."""
    cfg, model = cs.build_11b(dev, tie_weights=False)
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
    ids = torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev), text], 1)
    out = {}
    for recipe, kw in (("int8", dict(bits=8)),
                       ("int4_mixed", dict(bits=4, group_size=128, recipe=INT4_MIXED_RECIPE))):
        qmodel = quantize_llama_params(model, **kw)
        engine = InferenceEngine(qmodel, cfg, dev, max_cache_length=2048, kv_dtype="int8")

        def generate():
            torch.cuda.synchronize()
            t = time.perf_counter()
            px = preprocess_image_device(raw, vc.image_size, dtype=tc.torch_dtype)
            engine.generate(ids, px, max_new_tokens=1, temperature=0.0)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t)

        generate()  # warm-up: library handles, allocator
        kernels.reset_counters()
        times = [generate() for _ in range(reps)]
        launches = {k: v // reps for k, v in kernels.launch_counts().items() if v}
        out[recipe] = {"ms": times, "ttft_ms": statistics.median(times)}
        print(f"[{recipe}] TTFT ms {[round(t, 3) for t in times]}, median "
              f"{out[recipe]['ttft_ms']:.3f}; launches per generate {launches}")
        del engine, qmodel
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ttft": out}))


def timed_ms(fns) -> float:
    """Device time of one call (``device_ms``), or for a call slower than
    ``SLOW_MS`` the mean of 2 launches queued behind a sleep."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fns[0]()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) < SLOW_MS:
        return device_ms(fns)
    torch.cuda._sleep(int(4e6))
    start.record()
    for i in range(2):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 2


def shape_sets(dev, card: str, flags, rows: int) -> None:
    """The ``SETS`` the flags name, through the routed entry, as the module
    docstring says."""
    tree = Path(kernels.__file__).resolve().parents[3]
    print(f"kernels of {tree}")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for flag in flags:
        for label, (n, k, g, dtype, name) in SETS[flag].items():
            copies = quantized_copies(n, k, g, gen, dev)
            x = torch.randn(rows, k, generator=gen, device=dev).to(dtype)
            args = (x, *copies[0])
            want = kernels.qmatmul_plain(*args)
            entry = kernels.qmatmul_cuda if name == "routed" else kernels.KERNELS[name][0]
            got = entry(*args)
            err = (got.float() - want.float()).abs().max().item()
            bound_ms, bound_by = cs.bound("qmatmul", args, want)
            row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
            print(f"== {label} R={rows}: bound {bound_ms:.6g} ms ({bound_by}), {len(copies)} weight "
                  f"copies; qmatmul_cuda max_abs_err vs plain {err:.6g} "
                  f"(max {want.float().abs().max().item():.6g})")
            calls = {"qmatmul_cuda": [partial(entry, x, *c) for c in copies],
                     "qmatmul_plain": [partial(kernels.qmatmul_plain, *args)]}
            try:
                library = cs.library_call("qmatmul", args)
                if library is not None:
                    library()
                    calls["_weight_int4pack_mm" if g else "_weight_int8pack_mm"] = [library]
            except (RuntimeError, NotImplementedError) as e:
                print(f"  library call unavailable: {str(e).splitlines()[0][:160]}")
            for what, fns in calls.items():
                ms = timed_ms(fns)
                row[what] = ms
                print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
            if row["qmatmul_cuda"] < SLOW_MS:
                for key, us in kernel_rows(calls["qmatmul_cuda"]):
                    print(f"    {us:9.2f} us  {key[:100]}")
            results[label] = row
            del copies, calls, want, got
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": str(tree), "rows": rows, "device_ms": results}))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_qmatmul: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cs.build_library()
    if "--ttft" in sys.argv[1:]:
        ttft(dev, card)
        return 0
    flags = [f for f in SETS if f in sys.argv[1:]]
    if flags:
        argv = sys.argv[1:]
        shape_sets(dev, card, flags, int(argv[argv.index("--rows") + 1]) if "--rows" in argv else ROWS)
        return 0
    kernels_only = "--kernels-only" in sys.argv[1:]
    gen = torch.Generator(device=dev).manual_seed(0)
    x_by_k = {}
    results = {}
    for label, (n, k, g) in SHAPES.items():
        copies = quantized_copies(n, k, g, gen, dev)
        if k not in x_by_k:
            x_by_k[k] = torch.randn(ROWS, k, generator=gen, device=dev).to(torch.bfloat16)
        x = x_by_k[k]
        args = (x, *copies[0])
        want = kernels.qmatmul_plain(*args)
        bound_ms, bound_by = cs.bound("qmatmul", args, want)
        calls = {"qmatmul_cuda": [partial(kernels.qmatmul_cuda, x, *c) for c in copies]}
        for name, (wrapper, _) in kernels.KERNELS.items():
            if name.startswith("qmatmul"):
                got = wrapper(*args)
                err = (got.float() - want.float()).abs().max().item()
                print(f"  {name}: max_abs_err vs plain {err:.6g} "
                      f"(max {want.float().abs().max().item():.6g})")
                calls[name] = [partial(wrapper, x, *c) for c in copies]
        if not kernels_only:
            calls["qmatmul_plain"] = [partial(kernels.qmatmul_plain, x, *copies[0])]
            library = cs.library_call("qmatmul", args)
            if library is not None:
                calls["_weight_int4pack_mm" if g else "_weight_int8pack_mm"] = [library]
            w_t = dequantize_weight({"q4" if g else "q": copies[0][0], "scale": copies[0][1]},
                                    torch.bfloat16).t()
            calls["cuBLAS bf16 matmul"] = [partial(torch.matmul, x, w_t)]
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
        print(f"== {label} R={ROWS}: bound {bound_ms:.6g} ms ({bound_by}), "
              f"{len(copies)} weight copies")
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for key, us in kernel_rows(calls["qmatmul_cuda"]):
            print(f"    {us:9.2f} us  {key[:100]}")
        results[label] = row
        del copies, calls, want
        torch.cuda.empty_cache()
    sums = {}
    for recipe, launches in PREFILL.items():
        sums[recipe] = {what: sum(n * results[label][what] for label, n in launches.items())
                        for what in results[next(iter(launches))] if what not in
                        ("bound_ms", "bound_by", "copies")
                        and all(what in results[label] for label in launches)}
        sums[recipe]["bound_ms"] = sum(n * results[label]["bound_ms"]
                                       for label, n in launches.items())
        print(f"== one {recipe} prefill ({sum(launches.values())} launches), ms: "
              + ", ".join(f"{what} {ms:.6g}" for what, ms in sums[recipe].items()))
    print(json.dumps({"card": card, "rows": ROWS, "device_ms": results, "prefill_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
