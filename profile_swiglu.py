"""Device time of the SwiGLU prefill tile on one NVIDIA GPU, beside its
plain version and cuBLAS on the same tensors:

    python3 profile_swiglu.py

Shapes of the bf16 prefill and full fine-tuning (R = 1632 rows: a 560x560
image's 1600 tokens and 32 text tokens): the 11B forward (H=4096,
I=14336), the 3B bench configuration's forward and backward (H=3072,
I=8192). For each it times

- the routed entry the model calls (``fused_swiglu_cuda`` /
  ``fused_swiglu_bwd_cuda``: the TMA tile at these shapes);
- the TMA tile (``swiglu_tc`` / ``swiglu_bwd_tc`` of ``ops.cuda.KERNELS``)
  and the general route (``swiglu`` / ``swiglu_bwd``: every operand copied
  by the pad pre-pass, then the same tile) on their own;
- the plain version (two matmuls, then silu and the product);
- two cuBLAS bf16 GEMMs, ``x @ w_gate.T`` and ``x @ w_up.T``: the products
  alone, a ceiling the port never calls;

each beside its bound (``chip_smoke.bound``: operations over the bf16
dense peak). Each time is CUDA events around 20 back-to-back calls queued
behind a ``torch.cuda._sleep`` (device time, ``profile_qgemv.device_ms``).
A prefill reads each layer's weights once, so a shape whose weights are
smaller than 150 MB is held in several copies and the calls cycle through
them. Then ``torch.profiler`` lists the kernels of the routed call, and the
sums over one 11B prefill (40 launches) follow. The last line is one JSON
object with every time. ``--kernels-only`` times the routed call, the
tile and the general route alone (for A/B runs of kernel variants).

    python3 profile_swiglu.py --ttft

instead times what a user sees: the bf16 11B model (tied head, random
weights from a seed) as ``chip_smoke.py`` serves it; after a warm-up, 5
greedy one-token generates of a 560x560 image and 32 text ids (S = 1632),
host clock around preprocess, prefill and first token, ending in a
synchronize. It prints each time, the median (TTFT) and the launches of
one generate.

    python3 profile_swiglu.py --rows

instead times the decode SwiGLU at R = 1 (a B=1 decode step) and R = 8
(the 8-slot server) at the 11B (H=4096, I=14336) and 3B (H=3072, I=8192)
widths: the routed entry (the tensor-core rows kernel at these shapes), the
tensor-core rows kernel and the CUDA-core rows kernel (which takes fp32 and
ragged calls) on their own, the plain version and two ``F.linear`` calls
(the products alone, a yardstick the port never calls), each beside its bound (the
weights' bytes), the weights cycled past the L2 as above; then the sums
over one decode step's 40 launches at 11B.

    python3 profile_swiglu.py --fp32 [--tree DIR]

instead times the fp32 SwiGLU at R = 1632, forward and backward, at the 11B
(H=4096, I=14336) and 3B (H=3072, I=8192) widths: the routed entry
(``fused_swiglu_cuda`` / ``fused_swiglu_bwd_cuda``, which the fp32 models
call; it prints the kernel it launched) beside two fp32 ``F.linear`` calls
on the same tensors (``x @ w_gate.T`` and ``x @ w_up.T`` in full fp32,
``allow_tf32`` off as PyTorch's default: the products alone, a yardstick the
port never calls) and the bound (operations as three TF32 products at 494.7
TFLOP/s), with the same device timing. ``--tree DIR`` imports the port
package and this script's helpers from another checkout (built into its own
``build/``), so that one chip call can time a parent commit's kernels beside
this tree's: run parent, tree, tree, parent. One call of a slow parent
kernel may take a few hundred ms: the 20 timed calls then take seconds.

    python3 profile_swiglu.py --down [--tree DIR]

instead times the SwiGLU + down fusion (``swiglu_down_cuda``) in bf16 and
fp32 at R = 1 and R = 8 at the 11B widths (H=4096, I=14336) and in bf16 at
R = 8 at the 3B widths (H=3072, I=8192), beside its plain version and the
unfused pair a decode step would run instead (the routed SwiGLU entry, then
the routed gemv on ``w_down``), each beside the bound (the bytes of the three
weights, x and the output), with the same device timing and the weights
cycled past the L2; then the kernels of one call (the tiles' kernel and the
reduce) by ``torch.profiler``.

    python3 profile_swiglu.py --rows --fp32 [--tree DIR]

instead times the rows kernel that takes the SwiGLU calls of at most 8 rows
the tensor-core rows kernel does not: fp32 at the 11B widths at R = 1, 2, 5
and 8, and a bf16 ragged-H call (R = 8, H = 4100, I = 14336), through the
routed entry (which prints the kernel it launched), beside the plain version
and two ``F.linear`` calls on the same tensors (the products alone, in full
fp32; a yardstick the port never calls) and the bound (the bytes).

Both modes first print ``ptxas -v``'s registers, stack and spills of their
kernels (``swiglu_down.cu``; ``swiglu.cu``'s rows kernel), compiled from the
sources of the tree they import.

    python3 profile_swiglu.py --general [--tree DIR]
    python3 profile_swiglu.py --rows --bwd [--tree DIR]

instead time the bf16 calls that no main-path shape makes, each beside the
main-path calls it must leave as they were. ``--general``: R = 1632
forwards that the TMA tile cannot read as they are (H=4104, where TMA
zero-fills the last 64-k box, and x one element into its buffer, which
the pre-pass copies), the 11B forward and backward forced onto the general
route (``swiglu`` / ``swiglu_bwd`` of ``ops.cuda.KERNELS``: every operand
copied), and the TMA tile at the 11B and 3B widths, forward and backward
(``swiglu_tc`` / ``swiglu_bwd_tc``). ``--rows --bwd``: the backward at R = 8
and R = 1 at the 11B widths and at R = 8 with H=4100, through the routed
entry, and the tensor-core rows kernel's forward at R = 1 and 8
(``swiglu_rows_tc``). Each case is reached only through the routed entries
and those registry keys, which a parent commit has too, so ``--tree DIR``
times the parent's kernels on the same cases; each prints the kernels its
call launched, its error against the plain version, the entry's time beside
the plain version's and two ``F.linear`` calls' (the products alone, a
yardstick the port never calls) with the same device timing and the weights
cycled past the L2, and the kernels of one call by ``torch.profiler``.

    python3 profile_swiglu.py --sass DIR

compiles ``csrc/swiglu.cu`` of this tree and of the checkout DIR to cubins
and compares the SASS of the TMA tile's functions instruction by instruction
(addresses and encodings left out).
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import torch
import torch.nn.functional as F

if __name__ == "__main__" and "--tree" in sys.argv[1:]:  # another checkout's port package
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()))

import chip_smoke as cs  # noqa: E402
from llama32mm_tpu_torch.inference.engine import InferenceEngine  # noqa: E402
from llama32mm_tpu_torch.ops import cuda as kernels  # noqa: E402
from llama32mm_tpu_torch.preprocess.image import preprocess_image_device  # noqa: E402
from profile_qgemv import L2_SPAN, device_ms, kernel_rows  # noqa: E402

ROWS = 1632
SHAPES = {  # label: (H, I, backward?)
    "11B forward H=4096 I=14336": (4096, 14336, False),
    "3B forward H=3072 I=8192": (3072, 8192, False),
    "3B backward H=3072 I=8192": (3072, 8192, True),
}
PREFILL = {"11B forward H=4096 I=14336": 40}  # launches in one 11B prefill
DECODE_SHAPES = {"11B H=4096 I=14336": (4096, 14336), "3B H=3072 I=8192": (3072, 8192)}
DECODE_ROWS = (1, 8)
FP32_SHAPES = {  # label: (H, I, backward?)
    "11B forward H=4096 I=14336": (4096, 14336, False),
    "11B backward H=4096 I=14336": (4096, 14336, True),
    "3B forward H=3072 I=8192": (3072, 8192, False),
    "3B backward H=3072 I=8192": (3072, 8192, True),
}
TF32X3_OPS = 494.7e12 / 3  # an fp32 product as three TF32 products at the dense TF32 rate
HBM_BYTES_PER_S = 3.35e12
DOWN_CASES = [  # (label, H, I, dtype, rows)
    ("11B bf16 R=1 H=4096 I=14336", 4096, 14336, torch.bfloat16, 1),
    ("11B bf16 R=8 H=4096 I=14336", 4096, 14336, torch.bfloat16, 8),
    ("11B fp32 R=1 H=4096 I=14336", 4096, 14336, torch.float32, 1),
    ("11B fp32 R=8 H=4096 I=14336", 4096, 14336, torch.float32, 8),
    ("3B bf16 R=8 H=3072 I=8192", 3072, 8192, torch.bfloat16, 8),
]
ROWS_CASES = [  # (label, H, I, dtype, rows)
    *[(f"11B fp32 R={r} H=4096 I=14336", 4096, 14336, torch.float32, r) for r in (1, 2, 5, 8)],
    ("bf16 ragged H R=8 H=4100 I=14336", 4100, 14336, torch.bfloat16, 8),
]


BF = torch.bfloat16
TARGET_CASES = {  # mode: [(label, H, I, rows, backward, entry, x offset by one element)]
    "general": [
        ("fwd R=1632 H=4104 I=14336 routed", 4104, 14336, 1632, False, "routed", False),
        ("fwd R=1632 H=4096 I=14336 x offset by one element routed", 4096, 14336, 1632, False,
         "routed", True),
        ("fwd 11B R=1632 H=4096 I=14336 forced general", 4096, 14336, 1632, False, "swiglu",
         False),
        ("bwd 11B R=1632 H=4096 I=14336 forced general", 4096, 14336, 1632, True, "swiglu_bwd",
         False),
        ("TMA fwd 11B R=1632 H=4096 I=14336", 4096, 14336, 1632, False, "swiglu_tc", False),
        ("TMA bwd 11B R=1632 H=4096 I=14336", 4096, 14336, 1632, True, "swiglu_bwd_tc", False),
        ("TMA fwd 3B R=1632 H=3072 I=8192", 3072, 8192, 1632, False, "swiglu_tc", False),
        ("TMA bwd 3B R=1632 H=3072 I=8192", 3072, 8192, 1632, True, "swiglu_bwd_tc", False),
    ],
    "rows_bwd": [
        ("bwd R=8 H=4096 I=14336 routed", 4096, 14336, 8, True, "routed", False),
        ("bwd R=1 H=4096 I=14336 routed", 4096, 14336, 1, True, "routed", False),
        ("bwd R=8 H=4100 I=14336 routed", 4100, 14336, 8, True, "routed", False),
        ("rows_tc fwd R=1 H=4096 I=14336", 4096, 14336, 1, False, "swiglu_rows_tc", False),
        ("rows_tc fwd R=8 H=4096 I=14336", 4096, 14336, 8, False, "swiglu_rows_tc", False),
    ],
}


def target_cases(dev, card: str, mode: str) -> None:
    """The cases of ``TARGET_CASES[mode]``, as the module docstring says."""
    tree = Path(kernels.__file__).resolve().parents[3]
    print(f"kernels of {tree}")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, h, inter, rows, bwd, entry, offset in TARGET_CASES[mode]:
        copies = copies_of(gen, dev, [(inter, h), (inter, h)], BF, 0.02)
        x = torch.randn(rows * h + offset, generator=gen, device=dev).to(BF)[offset:].view(rows, h)
        extra = (torch.randn(rows, inter, generator=gen, device=dev).to(BF),) if bwd else ()
        name = "swiglu_bwd" if bwd else "swiglu"
        plain = kernels.KERNELS[name][1]
        if entry == "routed":
            fn = kernels.fused_swiglu_bwd_cuda if bwd else kernels.fused_swiglu_cuda
        else:
            fn = kernels.KERNELS[entry][0]
        args = (x, *copies[0], *extra)
        want = plain(*args)
        kernels.reset_counters()
        got = fn(*args)
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        err, scale = cs.max_err(got, want)
        bound_ms, bound_by = cs.bound(name, args, want)
        row = {"launched": launched, "max_abs_err": err, "max_abs_plain": scale,
               "bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
        print(f"== {label}: {entry} launched {launched}, |kernel - plain| {err:.6g} of "
              f"{scale:.6g}; bound {bound_ms:.6g} ms ({bound_by}), {len(copies)} weight copies")
        calls = {
            entry: [partial(fn, x, *c, *extra) for c in copies],
            "plain": [partial(plain, x, *c, *extra) for c in copies],
            "F.linear x2": [partial(lambda wg, wu: (F.linear(x, wg), F.linear(x, wu)), *c)
                            for c in copies],
        }
        timed_calls(calls, bound_ms, row)
        for key, us in kernel_rows(calls[entry]):
            print(f"    {us:9.2f} us  {key[:100]}")
        results[label] = row
        del copies, calls, args, x, extra, want, got
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": str(tree), "mode": mode, "device_ms": results}))


def sass_functions(src: Path, pattern: str) -> dict:
    """SASS of the functions of ``src`` (compiled alone to a cubin) whose
    names match ``pattern``: name -> instruction lines, without addresses
    and encodings."""
    from llama32mm_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-cubin", str(src), "-o", str(cubin)],
                       check=True, capture_output=True)
        dump = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                              text=True).stdout
    funcs, name = {}, None
    # the anonymous namespace's mangled name hashes the source's path
    dump = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", dump)
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                funcs[name] = []
            continue
        ins = re.sub(r"/\*\s*[0-9a-fx]*\s*\*/", "", line).strip()
        if name and ins and not ins.startswith("."):
            funcs[name].append(ins)
    return funcs


def sass_compare(other: Path) -> None:
    """The TMA tile's SASS in this tree and in ``other``, as the module
    docstring says."""
    here = Path(__file__).resolve().parent
    mine = sass_functions(here / "llama32mm_tpu_torch/csrc/swiglu.cu", "swiglu_tma_kernel")
    theirs = sass_functions(other / "llama32mm_tpu_torch/csrc/swiglu.cu", "swiglu_tma_kernel")
    for fn in sorted(set(mine) | set(theirs)):
        a, b = mine.get(fn), theirs.get(fn)
        if a is None or b is None:
            print(f"sass {fn}: only in {'this tree' if b is None else other}")
            continue
        diff = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
        print(f"sass {fn}: {len(a)} instructions here, {len(b)} in {other}; "
              f"{len(diff)} lines differ{' (identical)' if not diff and len(a) == len(b) else ''}")
        for i, x, y in diff[:10]:
            print(f"    {i}: {x}  |  {y}")


def ttft(dev, card: str, reps: int = 5) -> None:
    """TTFT of the bf16 11B prefill, as the module docstring says."""
    cfg, model = cs.build_11b(dev, tie_weights=True)
    tc, vc = cfg.text_config, cfg.vision_config
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 256, (1, vc.image_size, vc.image_size, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    text = torch.randint(0, tc.vocab_size, (1, 32), generator=gen, device=dev)
    ids = torch.cat([torch.full((1, vc.num_patches), cfg.image_token_index, device=dev), text], 1)
    engine = InferenceEngine(model, cfg, dev, max_cache_length=2048)

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
    out = {"ms": times, "ttft_ms": statistics.median(times)}
    print(f"[bf16] TTFT ms {[round(t, 3) for t in times]}, median {out['ttft_ms']:.3f}; "
          f"launches per generate {launches}")
    print(json.dumps({"card": card, "ttft": {"bf16": out}}))


def weight_copies(gen, dev, h, inter) -> list:
    """(w_gate, w_up) copies covering ``L2_SPAN`` bytes."""
    return [tuple((torch.randn(inter, h, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
                  for _ in range(2))
            for _ in range(max(1, math.ceil(L2_SPAN / (2 * inter * h * 2))))]


def decode_rows(dev, card: str) -> None:
    """The decode SwiGLU at ``DECODE_ROWS``, as the module docstring says."""
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, (h, inter) in DECODE_SHAPES.items():
        copies = weight_copies(gen, dev, h, inter)
        for rows in DECODE_ROWS:
            x = torch.randn(rows, h, generator=gen, device=dev).to(torch.bfloat16)
            args = (x, *copies[0])
            want = kernels.fused_swiglu_plain(*args)
            bound_ms, bound_by = cs.bound("swiglu_rows_tc", args, want)
            calls = {}
            for what, fn in (("routed", kernels.fused_swiglu_cuda),
                             ("swiglu_rows_tc", kernels.fused_swiglu_rows_tc_cuda),
                             ("rows kernel (CUDA cores)", kernels.fused_swiglu_rows_cuda),
                             ("plain", kernels.fused_swiglu_plain)):
                calls[what] = [partial(fn, x, *c) for c in copies]
                err, scale = cs.max_err(fn(*args), want)
                print(f"  {what}: max_abs_err vs plain {err:.6g} (max {scale:.6g})")
            calls["F.linear x2"] = [
                partial(lambda wg, wu: (F.linear(x, wg), F.linear(x, wu)), *c) for c in copies]
            row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
            print(f"== decode {label} R={rows}: bound {bound_ms:.6g} ms ({bound_by}), "
                  f"{len(copies)} weight copies")
            for what, fns in calls.items():
                ms = device_ms(fns)
                row[what] = ms
                print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
            for key, us in kernel_rows(calls["routed"]):
                print(f"    {us:9.2f} us  {key[:100]}")
            results[f"{label} R={rows}"] = row
        del copies
        torch.cuda.empty_cache()
    label = next(iter(DECODE_SHAPES))
    steps = {f"R={r}": {what: 40 * ms for what, ms in results[f"{label} R={r}"].items()
                        if isinstance(ms, float)} for r in DECODE_ROWS}
    for r, sums in steps.items():
        print(f"== one 11B decode step at {r} (40 launches), ms: "
              + ", ".join(f"{what} {ms:.6g}" for what, ms in sums.items()))
    print(json.dumps({"card": card, "decode_device_ms": results, "decode_step_ms": steps}))


def fp32_tiles(dev, card: str) -> None:
    """The fp32 SwiGLU at R = 1632, as the module docstring says."""
    torch.backends.cuda.matmul.allow_tf32 = False  # F.linear in full fp32 (PyTorch's default)
    tree = Path(kernels.__file__).resolve().parents[3]
    print(f"kernels of {tree}")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, (h, inter, bwd) in FP32_SHAPES.items():
        x = torch.randn(ROWS, h, generator=gen, device=dev)
        wg, wu = (torch.randn(inter, h, generator=gen, device=dev) * 0.02 for _ in range(2))
        args = (x, wg, wu) + ((torch.randn(ROWS, inter, generator=gen, device=dev),) if bwd
                              else ())
        routed = kernels.fused_swiglu_bwd_cuda if bwd else kernels.fused_swiglu_cuda
        plain = kernels.fused_swiglu_bwd_plain if bwd else kernels.fused_swiglu_plain
        kernels.reset_counters()
        got = routed(*args)
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        err, scale = cs.max_err(got, plain(*args))
        ops = 4 * ROWS * h * inter
        nbytes = 4 * (sum(t.numel() for t in args) + (2 if bwd else 1) * ROWS * inter)
        bound_ms = 1e3 * max(ops / TF32X3_OPS, nbytes / 3.35e12)
        row = {"launched": launched, "max_abs_err": err, "max_abs_plain": scale,
               "bound_ms": bound_ms}
        print(f"== fp32 {label} R={ROWS}: routed entry launched {launched}, |routed - plain| "
              f"{err:.6g} of {scale:.6g} ({err / scale:.3g}); bound {bound_ms:.6g} ms "
              f"(three TF32 products a product)")
        calls = {"routed": [partial(routed, *args)],
                 "F.linear x2 (fp32)": [lambda: (F.linear(x, wg), F.linear(x, wu))]}
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        results[label] = row
        del x, wg, wu, args, got
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": str(tree), "rows": ROWS, "fp32_device_ms": results}))


def ptxas_report(sources: dict) -> None:
    """``ptxas -v``'s registers, stack and spills of the kernels whose names
    match, compiled from the imported tree's ``csrc`` (one nvcc a source, in
    parallel). ``sources``: file name -> kernel name pattern."""
    from llama32mm_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    procs = {src: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(build.CSRC / src), "-o", "/dev/null"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in sources}
    for src, proc in procs.items():
        lines = proc.communicate()[0].splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if not m or not re.search(sources[src], m.group(1)):
                continue
            short = re.search(r"\d(swiglu_\w*?kernel)(I\w*?E)E", m.group(1))
            name = short.group(1) + short.group(2) if short else m.group(1)
            props = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                             if "stack frame" in x or "Used" in x)
            print(f"ptxas {src} {name[:70]}: {props}")


def copies_of(gen, dev, shapes, dtype, scale) -> list:
    """Tuples of random weights of ``shapes`` covering ``L2_SPAN`` bytes."""
    size = sum(math.prod(sh) for sh in shapes) * torch.finfo(dtype).bits // 8
    return [tuple((torch.randn(*sh, generator=gen, device=dev) * scale).to(dtype) for sh in shapes)
            for _ in range(max(1, math.ceil(L2_SPAN / size)))]


def bytes_bound_ms(args, out) -> float:
    """Each input read once and the output written once, over the HBM rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, out))
    return 1e3 * nbytes / HBM_BYTES_PER_S


def timed_calls(calls: dict, bound_ms: float, row: dict) -> None:
    """Device time of each entry of ``calls`` into ``row``, printed beside
    its share of the bound."""
    for what, fns in calls.items():
        ms = device_ms(fns)
        row[what] = ms
        print(f"  {what:24s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")


def down_cases(dev, card: str) -> None:
    """The SwiGLU + down fusion, as the module docstring says."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain version in full fp32
    tree = Path(kernels.__file__).resolve().parents[3]
    print(f"kernels of {tree}")
    ptxas_report({"swiglu_down.cu": "swiglu_down"})
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, h, inter, dtype, rows in DOWN_CASES:
        copies = copies_of(gen, dev, [(inter, h), (inter, h), (h, inter)], dtype, 0.02)
        x = torch.randn(rows, h, generator=gen, device=dev).to(dtype)
        args = (x, *copies[0])
        want = kernels.swiglu_down_plain(*args)
        got = kernels.swiglu_down_cuda(*args)
        err, scale = cs.max_err(got, want)
        bound_ms = bytes_bound_ms(args, want)
        row = {"max_abs_err": err, "max_abs_plain": scale, "bound_ms": bound_ms,
               "copies": len(copies)}
        print(f"== swiglu_down {label}: |kernel - plain| {err:.6g} of {scale:.6g} "
              f"({err / scale:.3g}); bound {bound_ms:.6g} ms (bytes), {len(copies)} weight copies")
        calls = {
            "swiglu_down": [partial(kernels.swiglu_down_cuda, x, *c) for c in copies],
            "unfused pair": [partial(lambda wg, wu, wd: kernels.gemv_cuda(
                kernels.fused_swiglu_cuda(x, wg, wu), wd), *c) for c in copies],
            "plain": [partial(kernels.swiglu_down_plain, x, *c) for c in copies],
        }
        kernels.reset_counters()
        calls["unfused pair"][0]()
        row["unfused launched"] = {k: n for k, n in kernels.launch_counts().items() if n}
        print(f"  unfused pair launches {row['unfused launched']}")
        timed_calls(calls, bound_ms, row)
        for key, us in kernel_rows(calls["swiglu_down"]):
            print(f"    {us:9.2f} us  {key[:100]}")
        results[label] = row
        del copies, calls, args, x, want, got
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": str(tree), "down_device_ms": results}))


def rows_fp32_cases(dev, card: str) -> None:
    """The rows kernel, as the module docstring says."""
    torch.backends.cuda.matmul.allow_tf32 = False  # F.linear in full fp32 (PyTorch's default)
    tree = Path(kernels.__file__).resolve().parents[3]
    print(f"kernels of {tree}")
    ptxas_report({"swiglu.cu": "swiglu_rows_kernel"})
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, h, inter, dtype, rows in ROWS_CASES:
        copies = copies_of(gen, dev, [(inter, h), (inter, h)], dtype, 0.02)
        x = torch.randn(rows, h, generator=gen, device=dev).to(dtype)
        args = (x, *copies[0])
        want = kernels.fused_swiglu_plain(*args)
        kernels.reset_counters()
        got = kernels.fused_swiglu_cuda(*args)
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        err, scale = cs.max_err(got, want)
        bound_ms = bytes_bound_ms(args, want)
        row = {"launched": launched, "max_abs_err": err, "max_abs_plain": scale,
               "bound_ms": bound_ms, "copies": len(copies)}
        print(f"== rows {label}: routed entry launched {launched}, |routed - plain| {err:.6g} "
              f"of {scale:.6g} ({err / scale:.3g}); bound {bound_ms:.6g} ms (bytes)")
        calls = {
            "routed": [partial(kernels.fused_swiglu_cuda, x, *c) for c in copies],
            "plain": [partial(kernels.fused_swiglu_plain, x, *c) for c in copies],
            "F.linear x2": [partial(lambda wg, wu: (F.linear(x, wg), F.linear(x, wu)), *c)
                            for c in copies],
        }
        timed_calls(calls, bound_ms, row)
        results[label] = row
        del copies, calls, args, x, want, got
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": str(tree), "rows_device_ms": results}))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_swiglu: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    if "--sass" in sys.argv[1:]:
        sass_compare(Path(sys.argv[sys.argv.index("--sass") + 1]).resolve())
        return 0
    cs.build_library()
    if "--general" in sys.argv[1:]:
        target_cases(dev, card, "general")
        return 0
    if "--rows" in sys.argv[1:] and "--bwd" in sys.argv[1:]:
        target_cases(dev, card, "rows_bwd")
        return 0
    if "--down" in sys.argv[1:]:
        down_cases(dev, card)
        return 0
    if "--rows" in sys.argv[1:] and "--fp32" in sys.argv[1:]:
        rows_fp32_cases(dev, card)
        return 0
    if "--fp32" in sys.argv[1:]:
        fp32_tiles(dev, card)
        return 0
    if "--ttft" in sys.argv[1:]:
        ttft(dev, card)
        return 0
    if "--rows" in sys.argv[1:]:
        decode_rows(dev, card)
        return 0
    kernels_only = "--kernels-only" in sys.argv[1:]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, (h, inter, bwd) in SHAPES.items():
        copies = weight_copies(gen, dev, h, inter)
        x = torch.randn(ROWS, h, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(ROWS, inter, generator=gen, device=dev).to(torch.bfloat16) if bwd else None
        extra = (g,) if bwd else ()
        name = "swiglu_bwd" if bwd else "swiglu"
        routed = kernels.fused_swiglu_bwd_cuda if bwd else kernels.fused_swiglu_cuda
        args = (x, *copies[0], *extra)
        want = kernels.KERNELS[name][1](*args)
        bound_ms, bound_by = cs.bound(name, args, want)
        calls = {"routed": [partial(routed, x, *c, *extra) for c in copies]}
        for kname in (name + "_tc", name):
            wrapper = kernels.KERNELS[kname][0]
            err, scale = cs.max_err(wrapper(*args), want)
            print(f"  {kname}: max_abs_err vs plain {err:.6g} (max {scale:.6g})")
            calls[kname] = [partial(wrapper, x, *c, *extra) for c in copies]
        if not kernels_only:
            calls["plain"] = [partial(kernels.KERNELS[name][1], x, *copies[0], *extra)]
            calls["cuBLAS bf16 x2"] = [
                partial(lambda wg, wu: (torch.matmul(x, wg.t()), torch.matmul(x, wu.t())), *c)
                for c in copies]
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "copies": len(copies)}
        print(f"== {label} R={ROWS}: bound {bound_ms:.6g} ms ({bound_by}), "
              f"{len(copies)} weight copies")
        for what, fns in calls.items():
            ms = device_ms(fns)
            row[what] = ms
            print(f"  {what:22s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for key, us in kernel_rows(calls["routed"]):
            print(f"    {us:9.2f} us  {key[:100]}")
        results[label] = row
        del copies, calls, want
        torch.cuda.empty_cache()
    sums = {label: {what: n * ms for what, ms in results[label].items()
                    if isinstance(ms, float)} for label, n in PREFILL.items()}
    for label, n in PREFILL.items():
        print(f"== one 11B prefill ({n} launches of {label}), ms: "
              + ", ".join(f"{what} {ms:.6g}" for what, ms in sums[label].items()))
    print(json.dumps({"card": card, "rows": ROWS, "device_ms": results, "prefill_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
