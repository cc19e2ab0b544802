"""Device time of the flash attention kernels on one NVIDIA GPU, at the
main paths' shapes, beside SDPA on the same inputs:

    python3 profile_flash.py

Forwards: for each shape (the 11B decoder prefill, ViT-H, the server's
8-slot decode with per-row offsets, a B=1 decode) it times the routed
kernel, the fp32 (3xTF32) forward on the same bf16 inputs and
``F.scaled_dot_product_attention`` (a yardstick the port never calls).
Backwards: for each training shape (the 11B and 3B decoders at T=1632,
ViT-H) the tensor-core dq and dk/dv kernels, the fp32 pair (3xTF32 dq and
dk/dv) and SDPA's autograd backward (dq, dk, dv). Each time is CUDA
events around 20 back-to-back calls queued behind a ``torch.cuda._sleep``,
so that the host's launch overhead is hidden and the number is device time;
then it lists the routed calls' kernels with their device time from
``torch.profiler``. The forwards include speculative decoding's verify
shapes, Tq = K+1 query rows a head: a B=1 verify of K=4 drafts and the
8-slot server's verify of K=3 (per-row offsets ``wp``, valid keys below
``wp`` and the K+1 new ones).

    python3 profile_flash.py --fp32 [--tree DIR]

times the fp32 flash kernels on fp32 inputs, the dtype that the route sends
them: the forward, its LSE and int8-KV (fp32 q) instantiations at the 11B
decoder prefill (Tq 1632, Tk 2048, 32 / 8 heads, hd 128, causal), dk/dv and
dq at the training shape (T = 1632), beside SDPA forward and backward on
the same fp32 inputs, with the same device timing. ``--tree DIR`` imports
the port package from another checkout (built into its own ``build/``),
so that one call can time a parent commit's kernels beside this tree's:
run parent, tree, tree, parent.

    python3 profile_flash.py --mma-peak

measures the ceiling of the 3xTF32 kernels' instruction: a kernel of nothing
but independent ``mma.sync.m16n8k8`` TF32 products (4, 8 or 16 accumulators
a warp, 4-16 warps a block, two blocks an SM), built by ``nvcc`` into
``build/`` at run time, its TFLOP/s against the card's 494.7 dense TF32 (the
rate of ``wgmma``).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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


def fp32_main(tree) -> int:
    """The ``--fp32`` timings (the module's notes), of the kernels of the
    port package under ``tree`` (this checkout when None)."""
    if tree is not None:
        sys.path.insert(0, str(Path(tree).resolve()))
    from llama32mm_tpu_torch.ops import cuda as kernels
    from llama32mm_tpu_torch.ops.cuda.build import build_library
    from llama32mm_tpu_torch.utils.kvcache import quantize_kv

    print(f"kernels of {Path(kernels.__file__).resolve().parents[3]}")
    print(f"library {build_library().name}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def causal_rows(t, tk):
        valid = torch.zeros(1, tk, dtype=torch.int32, device=dev)
        valid[:, :t] = 1
        mask = (torch.arange(tk, device=dev)[None] <= torch.arange(t, device=dev)[:, None]) & (
            valid[0, None] != 0)
        return valid, mask[None, None]

    q, k, v = rnd(1, 32, 1632, 128), rnd(1, 8, 2048, 128), rnd(1, 8, 2048, 128)
    valid, mask = causal_rows(1632, 2048)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    fwd = (q, k, v, valid, 0, True)
    tq, tk, tv = rnd(1, 32, 1632, 128), rnd(1, 8, 1632, 128), rnd(1, 8, 1632, 128)
    tvalid, tmask = causal_rows(1632, 1632)
    train = (tq, tk, tv, tvalid, 0, True)
    out, lse = kernels.flash_attention_fwd_lse_plain(*train)
    dout = rnd(1, 32, 1632, 128)
    bwd = (*train, lse, (dout * out).sum(-1), dout)
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=tmask, enable_gqa=True)
    calls = {
        "flash_attention, decoder prefill": lambda: kernels.flash_attention_cuda(*fwd),
        "flash_attention_int8kv, decoder prefill (fp32 q)":
            lambda: kernels.flash_attention_int8kv_cuda(q, kq, vq, ks, vs, valid, 0, True),
        "SDPA, decoder prefill": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True),
        "flash_attention_lse, training T=1632":
            lambda: kernels.flash_attention_fwd_lse_cuda(*train),
        "SDPA, training T=1632": lambda: F.scaled_dot_product_attention(
            tq, tk, tv, attn_mask=tmask, enable_gqa=True),
        "flash_attention_bwd_dkv, training T=1632":
            lambda: kernels.flash_attention_bwd_dkv_cuda(*bwd),
        "flash_attention_bwd_dq, training T=1632":
            lambda: kernels.flash_attention_bwd_dq_cuda(*bwd),
        "SDPA backward (dq, dk, dv), training T=1632":
            lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True),
    }
    times = {}
    for what, fn in calls.items():
        times[what] = device_ms(fn)
        print(f"  {what:48s} {times[what]:.6g} ms")
    pair = (times["flash_attention_bwd_dq, training T=1632"]
            + times["flash_attention_bwd_dkv, training T=1632"])
    print(f"  {'fp32 backward pair dq + dk/dv, training T=1632':48s} {pair:.6g} ms")
    return 0


MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int ACC>
__global__ void mma_peak(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) mma_tf32(c[j], a, it + j, it * 3 + j);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mma_peak_ms(int acc, int warps, int blocks, int iters, float* out) {
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {  // the second launch is timed
    cudaEventRecord(s);
    if (acc == 4) mma_peak<4><<<blocks, warps * 32>>>(out, iters);
    else if (acc == 8) mma_peak<8><<<blocks, warps * 32>>>(out, iters);
    else mma_peak<16><<<blocks, warps * 32>>>(out, iters);
    cudaEventRecord(e);
    cudaEventSynchronize(e);
    cudaEventElapsedTime(&ms, s, e);
  }
  return ms;
}
"""


def mma_peak_main() -> int:
    """The ``--mma-peak`` ceiling (the module's notes)."""
    import ctypes

    from llama32mm_tpu_torch.ops.cuda.build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = BUILD_DIR / "mma_peak.cu", BUILD_DIR / "mma_peak.so"
    src.write_text(MMA_PEAK_CU)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", str(src), "-o", str(lib_path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_peak_ms.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mma_peak_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20000
    for acc in (4, 8, 16):
        for warps in (4, 8, 16):
            out = torch.empty(2 * sms * warps * 32, device="cuda")
            ms = lib.mma_peak_ms(acc, warps, 2 * sms, iters, out.data_ptr())
            flops = 2 * sms * warps * iters * acc * 2 * 16 * 8 * 8
            print(f"  {acc:2d} accumulators a warp, {warps:2d} warps a block, 2 blocks an SM: "
                  f"{flops / ms / 1e9:.1f} TFLOP/s TF32 ({flops / ms / 1e9 / 494.7:.3f} of 494.7)")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if "--mma-peak" in sys.argv:
        return mma_peak_main()
    if "--fp32" in sys.argv:
        tree = sys.argv[sys.argv.index("--tree") + 1] if "--tree" in sys.argv else None
        return fp32_main(tree)
    import chip_smoke as cs
    from llama32mm_tpu_torch.ops import cuda as kernels

    dev = torch.device("cuda", 0)
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
                 "flash_attention (3xTF32)": lambda: kernels.flash_attention_cuda(*args),
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
        calls["fp32 dq + dk/dv"] = lambda: (kernels.flash_attention_bwd_dq_cuda(*args),
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
