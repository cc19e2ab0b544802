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
// (g and t read, dt written: 3 bytes-of-T per element, ~40 MB at R=1632
// C=4096 in bf16). What held the first version (a block reduction with two
// barriers, then a second pass reloading g, t and w for every row; dw read-
// modify-written in shared memory with 8-way bank conflicts) at 30% of the
// bound was too few bytes in flight. rmsnorm_bwd_kernel holds each row in
// registers: a block of up to 256 threads owns fixed 16-byte chunks of the
// columns (CH a thread), loads g and t once, reduces sum(g*w*t) with one
// barrier, writes dt, and keeps the loads of the next D - 1 rows in flight
// meanwhile (D CH <= 8 chunks of g and t a thread, two blocks an SM). With
// the kDw flag each thread adds g*t/rms of its own columns into registers
// over its block's rows (no shared memory, no atomics) and writes them once, as the block's
// row of a [P, C] fp32 workspace; dw_sum_kernel then sums the P rows of each
// column in a fixed order (32 columns a block, 8 warps in warp order). dw is
// bit-deterministic, and with a frozen weight (kDw false) that work and the
// second launch are skipped. Measured (profile_rmsnorm.py, device time, R =
// 1632; NVIDIA H100 80GB HBM3, 700.00 W): C = 4096 with dw 0.0235 ms (51% of
// its 0.0120 bound; the first version 0.0400), frozen 0.0181 (0.0237); C =
// 3072 with dw 0.0193 (0.0349), frozen 0.0145 (0.0197).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBwdMaxThreads = 256;
constexpr int kBwdMinBlocks = 2;  // blocks an SM holds at once: at most 128 registers a thread

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

// ---- the backward ----

// The row chunks a thread owns: chunk i of thread x covers the V columns from
// (i * blockDim.x + x) * V, so a warp's loads of one chunk are coalesced.
template <typename T> struct RowChunk {
  Vec16<T> g, t;
};

// Loads chunk c (V columns from column c) of a row, element by element when
// kVec is false (misaligned rows or C % V != 0), zeros past the row's end.
template <typename T, bool kVec>
__device__ __forceinline__ Vec16<T> load_chunk(const T* row, int c, int cols) {
  constexpr int V = Vec16<T>::N;
  Vec16<T> v;
  if (kVec && c < cols) return load16(row + c);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = c + j < cols ? row[c + j] : from_f32<T>(0.f);
  return v;
}

// Chunks col[i] of a row (at `off`) of g and t into b.
template <typename T, bool kVec, int CH>
__device__ __forceinline__ void load_row(RowChunk<T> (&b)[CH], const T* g, const T* t,
                                         size_t off, const int (&col)[CH], int cols) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    b[i].g = load_chunk<T, kVec>(g + off, col[i], cols);
    b[i].t = load_chunk<T, kVec>(t + off, col[i], cols);
  }
}

// One block walks the rows blockIdx.x, blockIdx.x + gridDim.x, ... with each
// row held in registers (CH chunks a thread): g and t are read once and dt
// written once, and the loads of the next D - 1 rows are in flight while a
// row is reduced and written. dot = sum(g w t) is a warp sum, then the
// warps' sums in warp order (one barrier a row; the partials alternate
// between two buffers). With kDw each thread adds g t / rms of its own
// columns into registers over the block's rows and writes them once, as its
// block's row of the [gridDim.x, C] fp32 workspace.
template <typename T, bool kVec, bool kDw, int CH, int D>
__global__ void __launch_bounds__(kBwdMaxThreads, kBwdMinBlocks)
rmsnorm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ t, const T* __restrict__ w,
                   const float* __restrict__ rms, T* __restrict__ dt,
                   float* __restrict__ dw_part, int rows, int cols) {
  constexpr int V = Vec16<T>::N;
  __shared__ float partial[2][kBwdMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

  int col[CH];
  float wf[CH][V], dwa[CH][V];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    col[i] = (i * blockDim.x + threadIdx.x) * V;
    const Vec16<T> wv = load_chunk<T, kVec>(w, col[i], cols);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      wf[i][j] = to_f32(wv[j]);
      dwa[i][j] = 0.f;
    }
  }

  const int first = blockIdx.x, step = gridDim.x;
  const int n = rows > first ? (rows - 1 - first) / step + 1 : 0;  // this block's rows
  RowChunk<T> buf[D][CH];  // rows j .. j + D - 1 of the block: row j in buf[j % D]
  float rbuf[D];
#pragma unroll
  for (int s = 0; s < D - 1; ++s) {
    if (s < n) {
      load_row<T, kVec, CH>(buf[s], g, t, static_cast<size_t>(first + s * step) * cols, col, cols);
      rbuf[s] = rms[first + s * step];
    }
  }

  for (int j0 = 0; j0 < n; j0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int j = j0 + s;
      if (j >= n) break;  // the same for every thread of the block
      if (j + D - 1 < n) {
        const int row = first + (j + D - 1) * step;
        load_row<T, kVec, CH>(buf[(s + D - 1) % D], g, t, static_cast<size_t>(row) * cols, col,
                              cols);
        rbuf[(s + D - 1) % D] = rms[row];
      }
      const RowChunk<T>(&b)[CH] = buf[s];
      const float inv = 1.f / rbuf[s];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) dot += to_f32(b[i].g[e]) * wf[i][e] * to_f32(b[i].t[e]);
      dot = warp_sum(dot);
      float* part = partial[j & 1];
      if (lane == 0) part[warp] = dot;
      __syncthreads();
      dot = 0.f;
      for (int v = 0; v < warps; ++v) dot += part[v];
      const float coef = dot * inv * inv / cols;
      T* dr = dt + static_cast<size_t>(first + j * step) * cols;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        Vec16<T> o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gf = to_f32(b[i].g[e]), tf = to_f32(b[i].t[e]);
          o[e] = from_f32<T>(inv * (gf * wf[i][e] - tf * coef));
          if (kDw) dwa[i][e] += gf * tf * inv;
        }
        if (kVec && col[i] < cols) {
          store16(dr + col[i], o);
        } else if (!kVec) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (col[i] + e < cols) dr[col[i] + e] = o[e];
        }
      }
    }
  }

  if (kDw) {
    float* pr = dw_part + static_cast<size_t>(blockIdx.x) * cols;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (kVec && col[i] < cols) {  // C % V == 0: 16-byte aligned rows of the workspace
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(pr + col[i] + e) =
              make_float4(dwa[i][e], dwa[i][e + 1], dwa[i][e + 2], dwa[i][e + 3]);
      } else if (!kVec) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (col[i] + e < cols) pr[col[i] + e] = dwa[i][e];
      }
    }
  }
}

constexpr int kSumWarps = 8;

// dw[c] = sum_p part[p, c] in a fixed order: a block of 32 columns (a lane
// each), warp v summing the rows p = v, v + 8, ... in order, then the 8 warp
// sums in warp order.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
dw_sum_kernel(const float* __restrict__ part, T* __restrict__ dw, int parts, int cols) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < cols)
    for (int p = warp; p < parts; p += kSumWarps) s += part[static_cast<size_t>(p) * cols + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    s = red[0][lane];
#pragma unroll
    for (int v = 1; v < kSumWarps; ++v) s += red[v][lane];
    dw[c] = from_f32<T>(s);
  }
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

// CH chunks a thread, D rows in flight a block: D CH chunks of g and of t in
// registers (8 D CH words), within the 128 registers a thread that two
// blocks an SM leave (D = 3 at CH = 2 beat 2 and 4: PERF.md §6).
template <typename T, bool kVec, bool kDw, int CH>
void launch_bwd_ch(const void* g, const void* t, const void* w, const float* rms, void* dt,
                   float* part, int rows, int cols, int parts, int threads, cudaStream_t stream) {
  constexpr int D = CH >= 4 ? 2 : CH == 2 ? 3 : 8;
  rmsnorm_bwd_kernel<T, kVec, kDw, CH, D><<<parts, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(t), static_cast<const T*>(w), rms,
      static_cast<T*>(dt), part, rows, cols);
}

// Chunks of V columns over at most kBwdMaxThreads threads: CH = 1, 2, 4 or 8
// chunks a thread (C up to 16384 in bf16, 8192 in fp32).
template <typename T, bool kDw>
int launch_bwd(const void* g, const void* t, const void* w, const float* rms, void* dt,
               float* part, int rows, int cols, int parts, cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  const bool vec = cols % V == 0 && aligned16(g) && aligned16(t) && aligned16(w) &&
                   aligned16(dt);
  const int chunks = (cols + V - 1) / V;
  int ch = 1;
  while (ch < 8 && chunks > ch * kBwdMaxThreads) ch *= 2;
  if (chunks > ch * kBwdMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((chunks + ch - 1) / ch + 31) / 32 * 32;
#define L32_CH(C)                                                                          \
  if (ch == C) {                                                                           \
    auto fn = vec ? launch_bwd_ch<T, true, kDw, C> : launch_bwd_ch<T, false, kDw, C>;      \
    fn(g, t, w, rms, dt, part, rows, cols, parts, threads, stream);                       \
  }
  L32_CH(1)
  L32_CH(2)
  L32_CH(4)
  L32_CH(8)
#undef L32_CH
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
    const int blocks = (cols + 31) / 32;
    if (dtype == L32_BF16)
      dw_sum_kernel<__nv_bfloat16><<<blocks, kSumWarps * 32, 0, s>>>(
          part, static_cast<__nv_bfloat16*>(dw), n, cols);
    else
      dw_sum_kernel<float><<<blocks, kSumWarps * 32, 0, s>>>(part, static_cast<float*>(dw), n,
                                                             cols);
  }
  return static_cast<int>(cudaGetLastError());
}
