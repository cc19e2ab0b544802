"""Profile one training step of each training path of ``chip_smoke.py`` on
one NVIDIA GPU: 11B LoRA and 3B full fine-tuning, at the same shapes,
weights and batch; with ``--qlora``, instead, one QLoRA step over the untied
11B quantized to int8 and to ``INT4_MIXED_RECIPE`` (rank 16, ``remat``,
``loss_chunk=512``, 2 packed microbatches of 1632, as ``chip_smoke.py``'s
``qlora_11b_*`` phases).

    python3 profile_train.py [--qlora]

For each path it times one step without the profiler, then one step under
``torch.profiler`` and sums the kernel rows of ``key_averages()`` (the
``aten::`` rows repeat their kernels' device time) into categories, then
lists the 25 largest kernels. The busy share is the kernels' summed device
time over the step's wall time.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from llama32mm_tpu_torch.models.quantize import quantize_llama_params
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.ops.quant import INT4_MIXED_RECIPE
from llama32mm_tpu_torch.train.data import PackedBatchIterator
from llama32mm_tpu_torch.train.full import make_train_step
from llama32mm_tpu_torch.train.lora import init_lora_params, make_lora_train_step

# (substring of a kernel's name, category); the first match wins
CATEGORIES = (
    ("flash_bwd_dq_tc", "flash bwd dq (tensor cores)"),
    ("flash_bwd_dkv_tc", "flash bwd dk/dv (tensor cores)"),
    ("flash_bwd_dq", "flash bwd dq (SIMT)"), ("flash_tf32_bwd_dkv", "flash bwd dk/dv (3xTF32)"),
    ("flash_tc", "flash fwd (tensor cores)"), ("flash_decode_combine", "flash decode combine"),
    ("flash_decode", "flash decode (split-KV)"),
    ("flash_tf32_fwd", "flash fwd (3xTF32)"), ("rmsnorm_bwd", "rmsnorm bwd"), ("dw_sum", "rmsnorm bwd"),
    ("rmsnorm_fwd", "rmsnorm fwd"), ("swiglu_tma", "swiglu (TMA tile)"),
    ("swiglu_rows_tc", "swiglu rows (tensor cores)"),
    ("swiglu_rows", "swiglu rows (decode)"), ("swiglu", "swiglu (fp32 tile, other)"),
    ("gemv_w4a8", "W4A8 gemv (tensor cores)"), ("quantize_rows", "W4A8 row quantize"),
    ("split_rows", "int4/int8 gemv x planes"), ("pad_rows", "gemv/swiglu padding pre-pass"),
    ("gemv_int8_tc", "int8 gemv (tensor cores)"), ("gemv_int4", "int4 gemv"),
    ("gemv_tc_kernel<float", "fp32 gemv (3xTF32)"), ("gemv_tc", "bf16 gemv (tensor cores)"),
    ("qmatmul", "qmatmul"), ("scatter", "cache writes (scatter)"),
    ("log_softmax", "softmax/CE"),
    ("nvjet", "GEMM (cuBLAS)"), ("gemm", "GEMM (cuBLAS)"), ("xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"), ("copy", "copies/casts"), ("reduce", "reductions"),
    ("softmax", "softmax/CE"), ("elementwise", "elementwise"), ("index", "indexing/embedding"),
)


def category(name: str) -> str:
    n = name.lower()
    return next((cat for key, cat in CATEGORIES if key in n), "other")


def profile_step(label: str, fn, tokens: int) -> float:
    """Time one call of ``fn`` (a step), profile another; print them and
    return the profiled call's kernel time in ms."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    ms, launches = collections.Counter(), collections.Counter()
    for e in rows:
        ms[category(e.key)] += e.self_device_time_total / 1e3
        launches[category(e.key)] += e.count
    print(f"== {label}: unprofiled step {wall_plain * 1e3:.2f} ms ({tokens / wall_plain:.1f} "
          f"tokens/s), profiled {wall * 1e3:.2f} ms, kernel time {total:.2f} ms (busy share "
          f"{total / (wall_plain * 1e3):.3f} of the unprofiled step, {total / (wall * 1e3):.3f} "
          f"of the profiled one), {sum(e.count for e in rows)} kernel launches")
    for cat, t_ms in ms.most_common():
        print(f"  {cat:22s} {t_ms:9.2f} ms  {100 * t_ms / total:5.1f}%  launches {launches[cat]}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:5d}  {e.key[:110]}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cs.build_library()
    if "--qlora" in sys.argv[1:]:
        return profile_qlora(dev)

    cfg, model = cs.build_11b(dev, tie_weights=True)
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), cfg, rank=16, alpha=16.0)
    init_state, step = make_lora_train_step(cfg, learning_rate=1e-4)
    box = [init_state(lora)]
    batch = cs.train_batch(cfg, dev)

    def lora_step():
        box[0], _ = step(model, box[0], batch)

    profile_step("lora_11b", lora_step, batch["input_ids"].numel())
    del model, lora, box
    torch.cuda.empty_cache()

    cfg = cs.bench_3b_config("float32")
    model = init_vlm(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    init_state, step = make_train_step(cfg, learning_rate=1e-5, max_grad_norm=1.0,
                                       freeze_vision=True, compute_dtype="bfloat16")
    box = [init_state(model)]
    batch = cs.train_batch(cs.bench_3b_config("bfloat16"), dev)

    def full_step():
        box[0], _ = step(box[0], batch)

    profile_step("full_ft_3b", full_step, batch["input_ids"].numel())
    return 0


def profile_qlora(dev) -> int:
    """One QLoRA step (``chip_smoke.py``'s settings) over each quantized copy
    of the untied 11B; the batch is the first packed one of that phase."""
    cfg, model = cs.build_11b(dev, tie_weights=False)
    tc = cfg.text_config
    rows = next(PackedBatchIterator(cs.qlora_docs(tc.vocab_size), cs.QLORA_ACCUM, cs.QLORA_SEQ,
                                    cs.QLORA_EOS, ignore_index=cfg.ignore_index))
    batch = {k: torch.from_numpy(v).to(dev).reshape(cs.QLORA_ACCUM, 1, cs.QLORA_SEQ)
             for k, v in rows.items()}
    for label, kw in (("qlora_11b_int8", dict(bits=8)),
                      ("qlora_11b_int4_mixed", dict(bits=4, group_size=128,
                                                    recipe=INT4_MIXED_RECIPE))):
        qmodel = quantize_llama_params(model, **kw)
        lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), tc, rank=16,
                                alpha=16.0, device=dev)
        init_state, step = make_lora_train_step(cfg, learning_rate=1e-4, remat=True,
                                                loss_chunk=cs.QLORA_CHUNK,
                                                accum_steps=cs.QLORA_ACCUM)
        box = [init_state(lora)]

        def qlora_step():
            box[0], _ = step(qmodel, box[0], batch)

        profile_step(label, qlora_step, batch["input_ids"].numel())
        del qmodel, lora, box
        cs.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
