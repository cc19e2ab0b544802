// Fused add-RMSNorm: the forward (inference and training) and the backward.
//
// Forward. Replaces the TPU kernels llama32mm_tpu/ops/pallas/rmsnorm.py::
// _fwd_only_kernel (inference: t = x + residual in fp32, out = t *
// rsqrt(mean(t^2) + eps) * w, rounded once to the input type) and, with the
// kTrain template flag, ::_fwd_kernel (training: the same out with
// rms = sqrt(mean(t^2) + eps) and inv = 1 / rms, and two more outputs for the
// backward: t rounded to x's type and the fp32 rms of each row).
//
// Bound on the H100: device-memory bytes. Each row is read once from DRAM
// (x, the residual when given, w from L2) and written once (twice with
// kTrain); there are ~4 FLOPs per element. The design reads with 16-byte
// vector loads, keeps the sum of squares in fp32 (a warp shuffle, then shared
// memory across warps), and takes a null residual for norm1 and the final
// norm instead of streaming a tensor of zeros. The second pass over the row
// re-reads x and the residual; a row is at most a few tens of KB and is
// served from L1/L2. One block per row: at decode (1 row) the kernel is
// launch-bound, at prefill (1632 rows) there are enough blocks to fill the
// 132 SMs.
//
// Backward. Replaces ::_bwd_kernel: with g the output's cotangent,
//   dt = (g*w - t * sum(g*w*t) / (C * rms^2)) / rms      (x's type)
//   dw = sum over rows of g * t / rms                      (fp32, cast to w's type)
// and x and the residual both get dt (t = x + residual), without the
// reference CUDA backward's extra +1e-6 on rms. Bound: bytes, as the forward
// (g and t read, dt written). P = min(rows, 256) blocks stride over the rows:
// each row is one block reduction for sum(g*w*t) and one pass writing dt.
// With the kDw flag each block also sums g*t/rms for its rows into a
// [C] fp32 accumulator in shared memory (every column owned by one thread, so
// no atomics) and writes it to its row of a [P, C] fp32 workspace; a second
// kernel sums the P rows of each column in a fixed order. dw is therefore
// deterministic, and with a frozen weight (kDw false) that work is skipped.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxDynSmem = 227 * 1024;

// Block-wide sum of one float per thread; every thread gets the result.
// `partial` holds kThreads / 32 floats, `result` one; both are reused across
// calls, which the two barriers inside make safe.
__device__ __forceinline__ float block_sum(float v, float* partial, float* result) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.f;
    s = warp_sum(s);
    if (threadIdx.x == 0) *result = s;
  }
  __syncthreads();
  return *result;
}

template <typename T, bool kVec, bool kTrain>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const T* __restrict__ w, T* __restrict__ out, T* __restrict__ t_out,
                   float* __restrict__ rms_out, int cols, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * cols;
  const T* rr = res ? res + row * cols : nullptr;
  T* outr = out + row * cols;
  T* tr = kTrain ? t_out + row * cols : nullptr;
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
  __shared__ float total;
  const float ms = block_sum(ss, partial, &total) / cols + eps;
  // training: inv = 1 / sqrt(ms), as _fwd_kernel; inference: rsqrt, as _fwd_only_kernel
  const float rms = kTrain ? sqrtf(ms) : 0.f;
  const float inv = kTrain ? 1.f / rms : rsqrtf(ms);
  if (kTrain && threadIdx.x == 0) rms_out[row] = rms;

  if (kVec) {
    for (int c = threadIdx.x * V; c < cols; c += kThreads * V) {
      Vec16<T> a = load16(xr + c);
      Vec16<T> b;
      if (rr) b = load16(rr + c);
      Vec16<T> g = load16(w + c);
      Vec16<T> o, tv;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = to_f32(a[j]) + (rr ? to_f32(b[j]) : 0.f);
        o[j] = from_f32<T>(t * inv * to_f32(g[j]));
        if (kTrain) tv[j] = from_f32<T>(t);
      }
      store16(outr + c, o);
      if (kTrain) store16(tr + c, tv);
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      float t = to_f32(xr[c]) + (rr ? to_f32(rr[c]) : 0.f);
      outr[c] = from_f32<T>(t * inv * to_f32(w[c]));
      if (kTrain) tr[c] = from_f32<T>(t);
    }
  }
}

template <typename T, bool kVec, bool kDw>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ t, const T* __restrict__ w,
                   const float* __restrict__ rms, T* __restrict__ dt,
                   float* __restrict__ dw_part, int rows, int cols) {
  extern __shared__ float dw_acc[];  // [cols] when kDw
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  constexpr int V = Vec16<T>::N;
  if (kDw) {
    for (int c = threadIdx.x; c < cols; c += kThreads) dw_acc[c] = 0.f;
    __syncthreads();
  }

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * cols;
    const T* gr = g + off;
    const T* tr = t + off;
    T* dr = dt + off;
    const float inv = 1.f / rms[row];

    float dot = 0.f;
    if (kVec) {
      for (int c = threadIdx.x * V; c < cols; c += kThreads * V) {
        const Vec16<T> gv = load16(gr + c), tv = load16(tr + c), wv = load16(w + c);
#pragma unroll
        for (int j = 0; j < V; ++j) dot += to_f32(gv[j]) * to_f32(wv[j]) * to_f32(tv[j]);
      }
    } else {
      for (int c = threadIdx.x; c < cols; c += kThreads)
        dot += to_f32(gr[c]) * to_f32(w[c]) * to_f32(tr[c]);
    }
    const float coef = block_sum(dot, partial, &total) * inv * inv / cols;

    if (kVec) {
      for (int c = threadIdx.x * V; c < cols; c += kThreads * V) {
        const Vec16<T> gv = load16(gr + c), tv = load16(tr + c), wv = load16(w + c);
        Vec16<T> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gf = to_f32(gv[j]), tf = to_f32(tv[j]);
          o[j] = from_f32<T>(inv * (gf * to_f32(wv[j]) - tf * coef));
          if (kDw) dw_acc[c + j] += gf * tf * inv;
        }
        store16(dr + c, o);
      }
    } else {
      for (int c = threadIdx.x; c < cols; c += kThreads) {
        const float gf = to_f32(gr[c]), tf = to_f32(tr[c]);
        dr[c] = from_f32<T>(inv * (gf * to_f32(w[c]) - tf * coef));
        if (kDw) dw_acc[c] += gf * tf * inv;
      }
    }
  }

  if (kDw) {
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += kThreads)
      dw_part[static_cast<size_t>(blockIdx.x) * cols + c] = dw_acc[c];
  }
}

// dw[c] = sum_p part[p, c], in a fixed order.
template <typename T>
__global__ void dw_sum_kernel(const float* __restrict__ part, T* __restrict__ dw, int parts,
                              int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[static_cast<size_t>(p) * cols + c];
  dw[c] = from_f32<T>(s);
}

template <typename T, bool kTrain>
void launch_fwd(const void* x, const void* res, const void* w, void* out, void* t_out,
                float* rms_out, int rows, int cols, float eps, cudaStream_t stream) {
  const bool vec = cols % Vec16<T>::N == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out) && (res == nullptr || aligned16(res)) &&
                   (!kTrain || aligned16(t_out));
  auto kernel = vec ? rmsnorm_fwd_kernel<T, true, kTrain> : rmsnorm_fwd_kernel<T, false, kTrain>;
  kernel<<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(t_out), rms_out, cols, eps);
}

template <typename T, bool kDw>
int launch_bwd(const void* g, const void* t, const void* w, const float* rms, void* dt,
               float* part, int rows, int cols, int parts, cudaStream_t stream) {
  const bool vec = cols % Vec16<T>::N == 0 && aligned16(g) && aligned16(t) && aligned16(w) &&
                   aligned16(dt);
  auto kernel = vec ? rmsnorm_bwd_kernel<T, true, kDw> : rmsnorm_bwd_kernel<T, false, kDw>;
  const size_t smem = kDw ? static_cast<size_t>(cols) * sizeof(float) : 0;
  if (smem > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<parts, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(t), static_cast<const T*>(w), rms,
      static_cast<T*>(dt), part, rows, cols);
  return 0;
}

}  // namespace

// t_out and rms_out both null: the inference forward; both given: training.
extern "C" int l32_rmsnorm_fwd(const void* x, const void* res, const void* w, void* out,
                               void* t_out, void* rms_out, int rows, int cols, float eps,
                               int dtype, void* stream) {
  if (rows == 0) return 0;
  if ((t_out == nullptr) != (rms_out == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  float* rms = static_cast<float*>(rms_out);
  const bool train = t_out != nullptr;
  if (dtype == L32_BF16 && train)
    launch_fwd<__nv_bfloat16, true>(x, res, w, out, t_out, rms, rows, cols, eps, s);
  else if (dtype == L32_BF16)
    launch_fwd<__nv_bfloat16, false>(x, res, w, out, t_out, rms, rows, cols, eps, s);
  else if (dtype == L32_F32 && train)
    launch_fwd<float, true>(x, res, w, out, t_out, rms, rows, cols, eps, s);
  else if (dtype == L32_F32)
    launch_fwd<float, false>(x, res, w, out, t_out, rms, rows, cols, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dw null: the weight is frozen and the dw work is skipped (workspace unused).
// Otherwise workspace is [parts, cols] fp32 with 1 <= parts <= rows.
extern "C" int l32_rmsnorm_bwd(const void* g, const void* t, const void* w, const void* rms,
                               void* dt, void* dw, void* workspace, int rows, int cols,
                               int parts, int dtype, void* stream) {
  if (cols == 0) return 0;
  if (dtype != L32_BF16 && dtype != L32_F32) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && (parts < 1 || parts > rows)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rms);
  float* part = static_cast<float*>(workspace);
  const bool want_dw = dw != nullptr;
  int err = 0;
  if (rows > 0) {
    if (dtype == L32_BF16 && want_dw)
      err = launch_bwd<__nv_bfloat16, true>(g, t, w, r, dt, part, rows, cols, parts, s);
    else if (dtype == L32_BF16)
      err = launch_bwd<__nv_bfloat16, false>(g, t, w, r, dt, part, rows, cols, parts, s);
    else if (dtype == L32_F32 && want_dw)
      err = launch_bwd<float, true>(g, t, w, r, dt, part, rows, cols, parts, s);
    else
      err = launch_bwd<float, false>(g, t, w, r, dt, part, rows, cols, parts, s);
  }
  if (err) return err;
  if (want_dw) {
    const int n = rows > 0 ? parts : 0;  // no rows: dw is a column sum of nothing
    if (dtype == L32_BF16)
      dw_sum_kernel<__nv_bfloat16><<<(cols + 255) / 256, 256, 0, s>>>(
          part, static_cast<__nv_bfloat16*>(dw), n, cols);
    else
      dw_sum_kernel<float><<<(cols + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(dw),
                                                              n, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
