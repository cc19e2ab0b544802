"""Device time of the flash attention kernels on one NVIDIA GPU, at the
main paths' shapes, beside SDPA on the same inputs:

    python3 profile_flash.py

Forwards: for each shape (the 11B decoder prefill, ViT-H, the server's
8-slot decode with per-row offsets, a B=1 decode) it times the routed
kernel, the SIMT forward and ``F.scaled_dot_product_attention`` (a
yardstick the port never calls). Backwards: for each training shape (the
11B and 3B decoders at T=1632, ViT-H) the tensor-core dq and dk/dv kernels,
the SIMT pair and SDPA's autograd backward (dq, dk, dv). Each time is CUDA
events around 20 back-to-back calls queued behind a ``torch.cuda._sleep``,
so that the host's launch overhead is hidden and the number is device time;
then it lists the routed calls' kernels with their device time from
``torch.profiler``. The forwards include speculative decoding's verify
shapes, Tq = K+1 query rows a head: a B=1 verify of K=4 drafts and the
8-slot server's verify of K=3 (per-row offsets ``wp``, valid keys below
``wp`` and the K+1 new ones).
"""

from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from llama32mm_tpu_torch.ops import cuda as kernels

REPS = 20


def device_ms(fn) -> float:
    """Device time of one call: the mean of REPS calls queued behind a sleep."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e6))  # keeps the device busy while the host queues the calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_rows(fn) -> list:
    """``(name, device us per call)`` of the kernels one call launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.device_time_total / REPS) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cs.build_library()
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def valid(b, tk, n):
        kvv = torch.zeros(b, tk, dtype=torch.int32, device=dev)
        kvv[:, :n] = 1
        return kvv

    offsets = torch.tensor([1664, 1700, 1727, 1690, 1665, 1800, 2047, 1900], dtype=torch.int32,
                           device=dev)
    kvv8 = (torch.arange(2048, device=dev)[None, :] <= offsets[:, None].long()).to(torch.int32)
    kvv8[:, 1632:1664] = 0
    wp = offsets.clamp(max=2048 - 4)  # the server's verify writes wp..wp+3
    karr = torch.arange(2048, device=dev)[None, :]
    kvv_verify = (((kvv8 != 0) & (karr < wp[:, None]))
                  | ((karr >= wp[:, None]) & (karr <= wp[:, None] + 3))).to(torch.int32)
    shapes = {  # label: (routed kernel, args)
        "decoder prefill Tq=1632 Tk=2048 hd=128 causal": ("flash_attention_tc", (
            rnd(1, 32, 1632, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
            valid(1, 2048, 1632), 0, True)),
        "ViT-H T=1600 hd=80 non-causal": ("flash_attention_tc", (
            rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
            valid(1, 1600, 1600), 0, False)),
        "server decode B=8 per-row offsets Tk=2048": ("flash_decode", (
            rnd(8, 32, 1, 128), rnd(8, 8, 2048, 128), rnd(8, 8, 2048, 128), kvv8, offsets, True)),
        "decode B=1 Tk=2048 q_offset=1700": ("flash_decode", (
            rnd(1, 32, 1, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
            valid(1, 2048, 1701), 1700, True)),
        "verify B=1 Tq=5 Tk=2048 q_offset=1700": ("flash_decode", (
            rnd(1, 32, 5, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128),
            valid(1, 2048, 1705), 1700, True)),
        "server verify B=8 Tq=4 per-row offsets Tk=2048": ("flash_decode", (
            rnd(8, 32, 4, 128), rnd(8, 8, 2048, 128), rnd(8, 8, 2048, 128), kvv_verify,
            wp, True)),
    }
    for label, (name, args) in shapes.items():
        q, k, v, kvv, q_offset, causal = args
        mask = cs._allowed(kvv, q_offset, causal, q.shape[2])[:, None]
        calls = {name: lambda: kernels.KERNELS[name][0](*args),
                 "flash_attention (SIMT)": lambda: kernels.flash_attention_cuda(*args),
                 "SDPA": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                enable_gqa=True)}
        bound_ms, bound_by = cs.bound(name, args, q)
        print(f"== {label}: bound {bound_ms:.6g} ms ({bound_by})")
        for what, fn in calls.items():
            ms = device_ms(fn)
            print(f"  {what:24s} {ms:.6g} ms  (share of bound {bound_ms / ms:.4g})")
        for key, us in kernel_rows(calls[name]):
            print(f"    {us:9.2f} us  {key[:100]}")

    train = {  # label: (q, k, v, kv_valid, q_offset, causal)
        "11B decoder T=1632 nq=32 nkv=8 hd=128 causal": (
            rnd(1, 32, 1632, 128), rnd(1, 8, 1632, 128), rnd(1, 8, 1632, 128),
            valid(1, 1632, 1632), 0, True),
        "3B decoder T=1632 nq=24 nkv=8 hd=128 causal": (
            rnd(1, 24, 1632, 128), rnd(1, 8, 1632, 128), rnd(1, 8, 1632, 128),
            valid(1, 1632, 1632), 0, True),
        "ViT-H T=1600 hd=80 non-causal": (
            rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80), rnd(1, 16, 1600, 80),
            valid(1, 1600, 1600), 0, False),
    }
    for label, fwd in train.items():
        out, lse = kernels.flash_attention_tc_lse_cuda(*fwd)
        dout = rnd(*fwd[0].shape)
        args = (*fwd, lse, (dout.float() * out.float()).sum(-1), dout)
        tc = ("flash_attention_bwd_dq_tc", "flash_attention_bwd_dkv_tc")
        calls = {name: (lambda name=name: kernels.KERNELS[name][0](*args)) for name in tc}
        calls["SIMT dq + dk/dv"] = lambda: (kernels.flash_attention_bwd_dq_cuda(*args),
                                            kernels.flash_attention_bwd_dkv_cuda(*args))
        calls["SDPA backward (dq, dk, dv)"] = cs.library_call(tc[0], args)
        print(f"== backward, {label}")
        pair = 0.0
        for what, fn in calls.items():
            ms = device_ms(fn)
            share = ""
            if what in tc:
                pair += ms
                bound_ms, bound_by = cs.bound(what, args, fn())
                share = f"  bound {bound_ms:.6g} ms ({bound_by}), share {bound_ms / ms:.4g}"
            print(f"  {what:28s} {ms:.6g} ms{share}")
        print(f"  tensor-core pair {pair:.6g} ms")
        for name in tc:
            for key, us in kernel_rows(calls[name]):
                print(f"    {us:9.2f} us  {key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
