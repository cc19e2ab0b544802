"""Profile one training step of each training path of ``chip_smoke.py`` on
one NVIDIA GPU: 11B LoRA and 3B full fine-tuning, at the same shapes,
weights and batch.

    python3 profile_train.py

For each path it times one step without the profiler, then one step under
``torch.profiler`` and sums the kernel rows of ``key_averages()`` (the
``aten::`` rows repeat their kernels' device time) into categories, then
lists the 25 largest kernels. The busy share is the kernels' summed device
time over the step's wall time.
"""

from __future__ import annotations

import collections
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from llama32mm_tpu_torch.models.vlm import init_vlm
from llama32mm_tpu_torch.train.full import make_train_step
from llama32mm_tpu_torch.train.lora import init_lora_params, make_lora_train_step

# (substring of a kernel's name, category); the first match wins
CATEGORIES = (
    ("flash_bwd_dq", "flash bwd dq"), ("flash_bwd_dkv", "flash bwd dk/dv"),
    ("flash_tc", "flash fwd (tensor cores)"), ("flash_decode_combine", "flash decode combine"),
    ("flash_decode", "flash decode (split-KV)"),
    ("flash_fwd", "flash fwd (SIMT)"), ("rmsnorm_bwd", "rmsnorm bwd"), ("dw_sum", "rmsnorm bwd"),
    ("rmsnorm_fwd", "rmsnorm fwd"), ("swiglu", "swiglu (kernel)"),
    ("gemv_w4a8", "W4A8 gemv"), ("quantize_rows", "W4A8 row quantize"),
    ("gemv_int8", "int8 gemv"), ("gemv_int4", "int4 gemv"), ("gemv_kernel", "bf16 gemv"),
    ("qmatmul", "qmatmul"), ("scatter", "cache writes (scatter)"),
    ("nvjet", "GEMM (cuBLAS)"), ("gemm", "GEMM (cuBLAS)"), ("xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"), ("copy", "copies/casts"), ("reduce", "reductions"),
    ("softmax", "softmax/CE"), ("elementwise", "elementwise"), ("index", "indexing/embedding"),
)


def category(name: str) -> str:
    n = name.lower()
    return next((cat for key, cat in CATEGORIES if key in n), "other")


def profile_step(label: str, fn, tokens: int) -> None:
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


def main() -> None:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cs.build_library()

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


if __name__ == "__main__":
    main()
