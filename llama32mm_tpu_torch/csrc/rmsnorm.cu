// Fused add-RMSNorm forward.
//
// Replaces the TPU kernel llama32mm_tpu/ops/pallas/rmsnorm.py::_fwd_only_kernel
// (called from _rmsnorm_fwd_only_call): t = x + residual in fp32,
// out = t * rsqrt(mean(t^2) + eps) * w, rounded once to the input type.
//
// Bound on the H100: device-memory bytes. Each row is read once from DRAM
// (x, the residual when given, w from L2) and written once; there are ~4
// FLOPs per element. The design reads with 16-byte vector loads, keeps the
// sum of squares in fp32 (a warp shuffle, then shared memory across warps),
// and takes a null residual for norm1 and the final norm instead of
// streaming a tensor of zeros. The second pass over the row re-reads x and
// the residual; a row is at most a few tens of KB and is served from L1/L2.
// One block per row: at decode (1 row) the kernel is launch-bound, at
// prefill (1632 rows) there are enough blocks to fill the 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const T* __restrict__ w, T* __restrict__ out, int cols,
                   float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * cols;
  const T* rr = res ? res + row * cols : nullptr;
  T* outr = out + row * cols;
  constexpr int V = Vec16<T>::N;

  float ss = 0.f;
  if (kVec) {
    for (int c = threadIdx.x * V; c < cols; c += kThreads * V) {
      Vec16<T> a = load16(xr + c);
      Vec16<T> b;
      if (rr) b = load16(rr + c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = to_f32(a[j]) + (rr ? to_f32(b[j]) : 0.f);
        ss += t * t;
      }
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      float t = to_f32(xr[c]) + (rr ? to_f32(rr[c]) : 0.f);
      ss += t * t;
    }
  }

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) inv_rms = rsqrtf(v / cols + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  if (kVec) {
    for (int c = threadIdx.x * V; c < cols; c += kThreads * V) {
      Vec16<T> a = load16(xr + c);
      Vec16<T> b;
      if (rr) b = load16(rr + c);
      Vec16<T> g = load16(w + c);
      Vec16<T> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = to_f32(a[j]) + (rr ? to_f32(b[j]) : 0.f);
        o[j] = from_f32<T>(t * inv * to_f32(g[j]));
      }
      store16(outr + c, o);
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      float t = to_f32(xr[c]) + (rr ? to_f32(rr[c]) : 0.f);
      outr[c] = from_f32<T>(t * inv * to_f32(w[c]));
    }
  }
}

template <typename T>
void launch(const void* x, const void* res, const void* w, void* out, int rows,
            int cols, float eps, cudaStream_t stream) {
  const bool vec = cols % Vec16<T>::N == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out) && (res == nullptr || aligned16(res));
  auto kernel = vec ? rmsnorm_fwd_kernel<T, true> : rmsnorm_fwd_kernel<T, false>;
  kernel<<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<T*>(out), cols, eps);
}

}  // namespace

extern "C" int l32_rmsnorm_fwd(const void* x, const void* res, const void* w,
                               void* out, int rows, int cols, float eps,
                               int dtype, void* stream) {
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == L32_BF16)
    launch<__nv_bfloat16>(x, res, w, out, rows, cols, eps, s);
  else if (dtype == L32_F32)
    launch<float>(x, res, w, out, rows, cols, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
