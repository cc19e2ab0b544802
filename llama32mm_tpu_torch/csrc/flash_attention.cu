// Flash GQA attention backward, dq, SIMT fp32 (CUDA cores, no tensor cores).
//
// Replaces the TPU kernel llama32mm_tpu/ops/pallas/attention.py::
// _flash_bwd_dq_kernel (via _flash_backward) for fp32 (and fp64-checked)
// training calls; bf16 calls take the tensor-core dq
// (flash_attention_bwd_tc.cu). The forward and the dk/dv backward for fp32
// are in flash_attention_tf32.cu (3xTF32 tensor cores). The function: q
// [B, nq, Tq, hd], k/v [B, nkv, Tk, hd], query head h reads kv head
// h / (nq / nkv); a key is allowed iff kv_valid[b, key] != 0, key < Tk and,
// when causal, key <= q_offset + q. From the forward's lse [B*nq, Tq] (the
// row's log-sum-exp in logit space, -0.7 * FLT_MAX for a row with no allowed
// key) and delta = rowsum(dO * O) [B*nq, Tq] fp32, computed by the caller:
// p = exp(s/sqrt(d) - lse) on allowed keys, dp = dO . v,
// ds = p (dp - delta) / sqrt(d) and dq = sum ds k.
//
// Bound on the H100: operations (6 hd per allowed pair). This version is
// SIMT fp32: one block per (batch * q head, 16 query rows), four warps of
// four rows each, looping over 32-key tiles of K and V staged in shared
// memory as fp32 (rows padded by one float so that lane j reading key j hits
// distinct banks) up to the block's causal limit; lane j owns key j for the
// scores and head-dim slice j, j + 32, ... for the sum. No atomics. Keys past
// Tk and query rows past Tq are staged as zeros and never allowed. With
// hd = 128 the kernel takes more than 48 KB of shared memory, so it is
// dynamic.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int BQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int BKV = 32;                     // keys per tile: one per lane

template <int HD>
float inv_sqrt_hd() {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Shared-memory layout of the dq kernel, in floats: query-side rows qs, dos
// [BQ][HD]; key tiles ks, vs [BKV][HD + 1] (padded: lane j reads row j).
template <int HD>
struct BwdSmem {
  static constexpr int kQ = BQ * HD;
  static constexpr int kK = BKV * (HD + 1);
  static constexpr int kDq = 2 * kQ + 2 * kK;
};

// Stage rows [row0, row0 + n) of a [rows_total, HD] matrix as fp32 into
// dst[n][LD], zero past rows_total.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int n,
                                           int rows_total) {
  for (int e = threadIdx.x; e < n * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] =
        row0 + r < rows_total ? to_f32(src[static_cast<size_t>(row0 + r) * HD + d]) : 0.f;
  }
}

// For this warp's kRowsPerWarp query rows and key `lane` of the staged tile:
// p = exp(s / sqrt(d) - lse) on allowed keys (else 0) and
// ds = p * (dO . v - delta) / sqrt(d).
template <int HD>
__device__ __forceinline__ void bwd_scores(const float* qs, const float* dos, const float* ks,
                                           const float* vs, const float* lse_s,
                                           const float* delta_s, bool key_ok, int key,
                                           int q_first, int row0, int tq, int q_offset,
                                           int causal, float scale, float* p, float* ds) {
  const int lane = threadIdx.x & 31;
  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float kd = ks[lane * (HD + 1) + d], vd = vs[lane * (HD + 1) + d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(qs[(row0 + r) * HD + d], kd, s[r]);
      dp[r] = fmaf(dos[(row0 + r) * HD + d], vd, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q_first + row0 + r;
    const bool allowed = key_ok && qi < tq && (!causal || key <= q_offset + qi);
    p[r] = allowed ? expf(s[r] * scale - lse_s[row0 + r]) : 0.f;
    ds[r] = p[r] * (dp[r] - delta_s[row0 + r]) * scale;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kv_valid, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    T* __restrict__ dq, int nq, int nkv, int tq, int tk, int q_offset,
                    int causal, float scale) {
  constexpr int NC = (HD + 31) / 32;
  using L = BwdSmem<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + L::kQ;
  float* ks = dos + L::kQ;
  float* vs = ks + L::kK;
  __shared__ int valid[BKV];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.y;
  const int b = bh / nq, h = bh % nq;
  const int kvh = h / (nq / nkv);
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t q_base = static_cast<size_t>(bh) * tq;
  const T* kb = k + static_cast<size_t>(b * nkv + kvh) * tk * HD;
  const T* vb = v + static_cast<size_t>(b * nkv + kvh) * tk * HD;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;

  stage_rows<T, HD, HD>(qs, q + q_base * HD, q0, BQ, tq);
  stage_rows<T, HD, HD>(dos, dout + q_base * HD, q0, BQ, tq);
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < tq ? lse[q_base + qi] : 0.f;
    delta_s[threadIdx.x] = qi < tq ? delta[q_base + qi] : 0.f;
  }

  int n_keys = tk;
  if (causal) {
    const int last_q = q_offset + min(q0 + BQ, tq) - 1;
    n_keys = max(0, min(tk, last_q + 1));
  }

  float acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  const int row0 = warp * kRowsPerWarp;

  for (int k0 = 0; k0 < n_keys; k0 += BKV) {
    __syncthreads();  // previous tile consumed (and the query side staged, first time)
    stage_rows<T, HD, HD + 1>(ks, kb, k0, BKV, tk);
    stage_rows<T, HD, HD + 1>(vs, vb, k0, BKV, tk);
    if (threadIdx.x < BKV) {
      const int key = k0 + threadIdx.x;
      valid[threadIdx.x] = key < tk ? validb[key] : 0;
    }
    __syncthreads();

    const int key = k0 + lane;
    float p[kRowsPerWarp], ds[kRowsPerWarp];
    bwd_scores<HD>(qs, dos, ks, vs, lse_s, delta_s, key < tk && valid[lane] != 0, key, q0, row0,
                   tq, q_offset, causal, scale, p, ds);

    // dq[r][d] += sum_j ds_j[r] * k[j][d], lane owning d = lane + 32 c.
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float dsj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dsj[r] = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) {
          const float kd = ks[j * (HD + 1) + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(dsj[r], kd, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= tq) continue;
    T* row = dq + (q_base + qi) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) row[d] = from_f32<T>(acc[r][c]);
    }
  }
}

// Launch a kernel with `floats` of dynamic shared memory, raising the
// 48 KB default where needed.
template <typename Kernel, typename... Args>
int launch_dyn(Kernel kernel, dim3 grid, int floats, cudaStream_t s, Args... args) {
  const int bytes = floats * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kWarps * 32, bytes, s>>>(args...);
  return 0;
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const int* kv_valid;
  const float *lse, *delta;
  void* dq;
  int b, nq, nkv, tq, tk, q_offset, causal;
};

template <typename T, int HD>
int launch_bwd(const BwdArgs& a, cudaStream_t s) {
  return launch_dyn(flash_bwd_dq_kernel<T, HD>, dim3((a.tq + BQ - 1) / BQ, a.b * a.nq),
                    BwdSmem<HD>::kDq, s, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                    static_cast<const T*>(a.v), a.kv_valid, a.lse, a.delta,
                    static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.nq, a.nkv, a.tq, a.tk,
                    a.q_offset, a.causal, inv_sqrt_hd<HD>());
}

template <typename T>
int launch_bwd_hd(const BwdArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_bwd<T, 8>(a, s);
    case 16: return launch_bwd<T, 16>(a, s);
    case 32: return launch_bwd<T, 32>(a, s);
    case 64: return launch_bwd<T, 64>(a, s);
    case 80: return launch_bwd<T, 80>(a, s);
    case 96: return launch_bwd<T, 96>(a, s);
    case 128: return launch_bwd<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bwd(const BwdArgs& a, int hd, int dtype, void* stream) {
  if (a.b == 0 || a.tq == 0 || a.tk == 0) return 0;
  if (a.nkv <= 0 || a.nq % a.nkv != 0 || a.b * a.nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == L32_BF16)
    err = launch_bwd_hd<__nv_bfloat16>(a, hd, s);
  else if (dtype == L32_F32)
    err = launch_bwd_hd<float>(a, hd, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq [b, nq, tq, hd] from q, k, v, the forward's lse [b * nq, tq], delta =
// rowsum(dO * O) [b * nq, tq] (both fp32) and dout; all of q's dtype.
extern "C" int l32_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* kv_valid, const void* lse, const void* delta,
                                     const void* dout, void* dq, int b, int nq, int nkv, int tq,
                                     int tk, int hd, int q_offset, int causal, int dtype,
                                     void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(kv_valid), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, b, nq, nkv, tq, tk, q_offset, causal};
  return dispatch_bwd(a, hd, dtype, stream);
}
