// Flash GQA attention forward with the structured mask.
//
// Replaces the TPU kernel llama32mm_tpu/ops/pallas/attention.py::_flash_kernel
// (via _flash_forward): q [B, nq, Tq, hd], k/v [B, nkv, Tk, hd], query head
// h reads kv head h / (nq / nkv). A key is allowed iff kv_valid[b, key] != 0,
// key < Tk and, when causal, key <= q_offset + q. Allowed logits are
// s / sqrt(hd) (the mask-then-scale numerics of the reference), blocked keys
// get probability exactly 0 and a row with no allowed key outputs 0. The
// online softmax runs in fp32.
//
// The query offset is one int for the batch, or (q_offsets non-null) one
// per row, int32 [B] on the device: the continuous-batching server decodes
// every slot at its own fill level in one call. A block serves one batch row,
// so it reads its row's offset once; the causal limit is that row's.
//
// Two instantiations: K/V in q's float dtype, or the int8 KV cache with fp32
// per-position scales k_scale/v_scale [B, nkv, Tk] (the Pallas kernel's
// scaled_kv inputs). With int8 K/V the logit is (q . k_q) * k_scale[key]
// before the mask and the 1/sqrt(hd); the softmax denominator sums p without
// v_scale, and the PV product takes p * v_scale[key], re-masked so that the
// scales of blocked or padded slots never reach the sum. int8 tiles are
// converted to fp32 as they are staged, so the shared-memory layout, the
// math and the limits below are the float instantiation's.
//
// Bound on the H100: at prefill, FLOPs (decoder: ~1.4 TFLOP over 40 layers
// with the causal skip; ViT-H: ~0.2 TFLOP); at decode (Tq = 1), the bytes of
// the KV cache. This first version is SIMT fp32, no tensor cores: each block
// owns 16 query rows of one (batch, head), four warps own four rows each, and
// 32-key tiles of K and V are staged through shared memory as fp32 (K rows
// padded by one float so that lane j reading key j hits distinct banks). Lane
// j computes the four rows' logits for key j, the warp reduces max and sum
// with shuffles, and each lane then accumulates its slice of the head
// dimension for all four rows, so every staged V value serves four rows. KV
// tiles wholly beyond the causal limit of the block's last query are never
// loaded. Tq = 1 (decode) runs the same kernel with one live row; a split-KV
// decode variant and a wgmma/TMA pipeline are later work. Shared memory stays
// below 48 KB for every supported head size (largest: 41 KB at hd = 128).
// At decode over an int8 cache the bytes read from the cache halve.
//
// Training. The float forward optionally writes lse [B*nq, Tq] fp32, the
// row's log-sum-exp in logit (already /sqrt(hd)) space, m + log(l), as the
// Pallas kernel's emit_lse output; a row with no allowed key gets
// -0.7 * FLT_MAX (_NEG_BIG), so the backward's p is 0 there. The backward is
// two kernels, mirroring the Pallas grids (_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel), with no atomics and no per-q-head partials:
//   - dq: one block per (batch * q head, 16 query rows), looping over 32-key
//     tiles up to the causal limit, recomputing p = exp(s/sqrt(d) - lse) on
//     allowed keys, dp = dO . v, ds = p (dp - delta) / sqrt(d) and summing
//     dq += ds k, the forward's layout (lane j owns key j for the logits and
//     head-dim slice j, j + 32, ... for the sum);
//   - dk/dv: one block per (batch * kv head, 32 keys). It stages its K and V
//     once, then sweeps the GQA group's q heads x 16-row query tiles from the
//     first tile the causal mask lets see its keys; per tile the warps form p
//     and ds as above into shared memory, and each thread then sums
//     dv += p^T dO and dk += ds^T q for 8 keys x its head-dim slice. The
//     group's sum stays inside the block.
// delta = rowsum(dO * O) is computed by the caller in fp32. Keys past Tk and
// query rows past Tq are staged as zeros and never allowed, so no padded
// value reaches a product. Same bound and same SIMT fp32 design as the
// forward (the backward does 5 products to the forward's 2); with hd = 128
// both kernels take more than 48 KB of shared memory, so it is dynamic.
#include <float.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int BQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int BKV = 32;                     // keys per tile: one per lane
constexpr float kNegBig = -0.7f * FLT_MAX;  // lse of a row with no allowed key

// KV = T: float K/V, the scale pointers unused; KV = int8_t: the int8 cache.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                 const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                 const int* __restrict__ kv_valid, const int* __restrict__ q_offsets,
                 T* __restrict__ out, float* __restrict__ lse, int nq, int nkv, int tq, int tk,
                 int q_offset, int causal, float scale) {
  constexpr bool kScaled = std::is_same<KV, int8_t>::value;
  constexpr int NC = (HD + 31) / 32;  // head-dim slots per lane
  __shared__ float qs[BQ][HD];
  __shared__ float ks[BKV][HD + 1];
  __shared__ float vs[BKV][HD];
  __shared__ int valid[BKV];
  __shared__ float kscale[BKV], vscale[BKV];

  const int bh = blockIdx.y;
  const int b = bh / nq, h = bh % nq;
  const int kvh = h / (nq / nkv);
  const int q0 = blockIdx.x * BQ;
  if (q_offsets != nullptr) q_offset = q_offsets[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qb = q + static_cast<size_t>(bh) * tq * HD;
  const KV* kb = k + static_cast<size_t>(b * nkv + kvh) * tk * HD;
  const KV* vb = v + static_cast<size_t>(b * nkv + kvh) * tk * HD;
  const size_t scale_row = static_cast<size_t>(b * nkv + kvh) * tk;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;

  for (int e = threadIdx.x; e < BQ * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD;
    qs[r][d] = q0 + r < tq ? to_f32(qb[static_cast<size_t>(q0 + r) * HD + d]) : 0.f;
  }

  // Keys past the causal limit of this block's last query are never needed.
  int n_keys = tk;
  if (causal) {
    const int last_q = q_offset + min(q0 + BQ, tq) - 1;
    n_keys = max(0, min(tk, last_q + 1));
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;

  for (int k0 = 0; k0 < n_keys; k0 += BKV) {
    __syncthreads();  // previous tile fully consumed (and qs written, first time)
    for (int e = threadIdx.x; e < BKV * HD; e += kWarps * 32) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < tk;
      const size_t g = static_cast<size_t>(k0 + r) * HD + d;
      ks[r][d] = in ? to_f32(kb[g]) : 0.f;
      vs[r][d] = in ? to_f32(vb[g]) : 0.f;
    }
    if (threadIdx.x < BKV) {
      const int key = k0 + threadIdx.x;
      valid[threadIdx.x] = key < tk ? validb[key] : 0;
      if (kScaled) {
        kscale[threadIdx.x] = key < tk ? k_scale[scale_row + key] : 0.f;
        vscale[threadIdx.x] = key < tk ? v_scale[scale_row + key] : 0.f;
      }
    }
    __syncthreads();

    // Lane j: logits of key k0 + j for this warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qs[row0 + r][d], kd, s[r]);
    }

    const int key = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      const bool allowed = qi < tq && key < tk && valid[lane] != 0 &&
                           (!causal || key <= q_offset + qi);
      const float sk = kScaled ? s[r] * kscale[lane] : s[r];
      const float logit = allowed ? sk * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(logit));
      if (m_new == -INFINITY) {  // nothing allowed yet in this row (warp-uniform)
        p[r] = 0.f;
        continue;
      }
      p[r] = allowed ? expf(logit - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);  // 0 when m[r] is -inf
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
      if (kScaled) p[r] = allowed ? p[r] * vscale[lane] : 0.f;  // PV weight, not in l
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }

    // acc[r][d] += sum_j p_j[r] * v[j][d], lane owning d = lane + 32 c.
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) {
          const float vd = vs[j][d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(pj[r], vd, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= tq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // fully masked row -> 0
    if (lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bh) * tq + qi] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegBig;
    T* orow = out + (static_cast<size_t>(bh) * tq + qi) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) orow[d] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <int HD>
float inv_sqrt_hd() {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
}

template <typename T, typename KV, int HD>
void launch(const void* q, const void* k, const void* v, const float* k_scale,
            const float* v_scale, const int* kv_valid, const int* q_offsets, void* out, float* lse,
            int b, int nq, int nkv, int tq, int tk, int q_offset, int causal,
            cudaStream_t stream) {
  dim3 grid((tq + BQ - 1) / BQ, b * nq);
  flash_fwd_kernel<T, KV, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, kv_valid, q_offsets, static_cast<T*>(out), lse, nq, nkv, tq, tk, q_offset, causal,
      inv_sqrt_hd<HD>());
}

template <typename T, typename KV>
int launch_hd(const void* q, const void* k, const void* v, const float* k_scale,
              const float* v_scale, const int* kv_valid, const int* q_offsets, void* out,
              float* lse, int b, int nq, int nkv, int tq, int tk, int hd, int q_offset,
              int causal, cudaStream_t s) {
#define L32_HD(N)                                                                        \
  case N:                                                                                \
    launch<T, KV, N>(q, k, v, k_scale, v_scale, kv_valid, q_offsets, out, lse, b, nq, nkv, \
                     tq, tk, q_offset, causal, s);                                       \
    return 0;
  switch (hd) {
    L32_HD(8)
    L32_HD(16)
    L32_HD(32)
    L32_HD(64)
    L32_HD(80)
    L32_HD(96)
    L32_HD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef L32_HD
}

template <typename KVF, typename KVB>  // K/V element type for fp32 / bf16 q
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* kv_valid, const void* q_offsets, void* out,
             void* lse_out, int b, int nq, int nkv, int tq, int tk, int hd, int q_offset,
             int causal, int dtype, void* stream) {
  if (b == 0 || tq == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || b * nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int* kvv = static_cast<const int*>(kv_valid);
  const int* qo = static_cast<const int*>(q_offsets);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* lse = static_cast<float*>(lse_out);
  int err;
  if (dtype == L32_BF16)
    err = launch_hd<__nv_bfloat16, KVB>(q, k, v, ks, vs, kvv, qo, out, lse, b, nq, nkv, tq, tk,
                                        hd, q_offset, causal, s);
  else if (dtype == L32_F32)
    err = launch_hd<float, KVF>(q, k, v, ks, vs, kvv, qo, out, lse, b, nq, nkv, tq, tk, hd,
                                q_offset, causal, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Shared-memory layout of the backward kernels, in floats: query-side rows
// qs, dos [BQ][HD]; key tiles ks, vs [BKV][HD + 1] (padded: lane j reads row
// j); dk/dv only: ps, dss [BQ][BKV].
template <int HD>
struct BwdSmem {
  static constexpr int kQ = BQ * HD;
  static constexpr int kK = BKV * (HD + 1);
  static constexpr int kDq = 2 * kQ + 2 * kK;
  static constexpr int kDkv = kDq + 2 * BQ * BKV;
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

constexpr int kKeysPerWarp = BKV / kWarps;  // 8 keys of the block's 32 per warp

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ kv_valid, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int nq, int nkv, int tq, int tk,
                     int q_offset, int causal, float scale) {
  constexpr int NC = (HD + 31) / 32;
  using L = BwdSmem<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + L::kQ;
  float* ks = dos + L::kQ;
  float* vs = ks + L::kK;
  float* ps = vs + L::kK;     // [BQ][BKV]
  float* dss = ps + BQ * BKV;  // [BQ][BKV]
  __shared__ int valid[BKV];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bkv = blockIdx.y;
  const int b = bkv / nkv, kvh = bkv % nkv;
  const int group = nq / nkv;
  const int k0 = blockIdx.x * BKV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t kv_base = static_cast<size_t>(bkv) * tk;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;

  stage_rows<T, HD, HD + 1>(ks, k + kv_base * HD, k0, BKV, tk);
  stage_rows<T, HD, HD + 1>(vs, v + kv_base * HD, k0, BKV, tk);
  if (threadIdx.x < BKV) {
    const int key = k0 + threadIdx.x;
    valid[threadIdx.x] = key < tk ? validb[key] : 0;
  }

  float adk[kKeysPerWarp][NC], adv[kKeysPerWarp][NC];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[j][c] = adv[j][c] = 0.f;
  const int row0 = warp * kRowsPerWarp;
  const int key = k0 + lane;

  // Query row i sees key k0 only if k0 <= q_offset + i: earlier tiles are skipped.
  const int first_q = causal ? max(0, k0 - q_offset) : 0;
  for (int g = 0; g < group; ++g) {
    const size_t q_base = static_cast<size_t>(b * nq + kvh * group + g) * tq;
    for (int q0 = (first_q / BQ) * BQ; q0 < tq; q0 += BQ) {
      __syncthreads();  // previous tile consumed (and K/V staged, first time)
      stage_rows<T, HD, HD>(qs, q + q_base * HD, q0, BQ, tq);
      stage_rows<T, HD, HD>(dos, dout + q_base * HD, q0, BQ, tq);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < tq ? lse[q_base + qi] : 0.f;
        delta_s[threadIdx.x] = qi < tq ? delta[q_base + qi] : 0.f;
      }
      __syncthreads();

      float p[kRowsPerWarp], ds[kRowsPerWarp];
      bwd_scores<HD>(qs, dos, ks, vs, lse_s, delta_s, key < tk && valid[lane] != 0, key, q0,
                     row0, tq, q_offset, causal, scale, p, ds);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        ps[(row0 + r) * BKV + lane] = p[r];
        dss[(row0 + r) * BKV + lane] = ds[r];
      }
      __syncthreads();

      // dv[j][d] += sum_r p[r][j] dO[r][d]; dk[j][d] += sum_r ds[r][j] q[r][d]
      // for this warp's keys j and this lane's d = lane + 32 c.
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float qd[NC], dod[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          qd[c] = d < HD ? qs[r * HD + d] : 0.f;
          dod[c] = d < HD ? dos[r * HD + d] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kKeysPerWarp; ++jj) {
          const int j = warp * kKeysPerWarp + jj;
          const float pj = ps[r * BKV + j], dsj = dss[r * BKV + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[jj][c] = fmaf(pj, dod[c], adv[jj][c]);
            adk[jj][c] = fmaf(dsj, qd[c], adk[jj][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
    const int kj = k0 + warp * kKeysPerWarp + jj;
    if (kj >= tk) continue;
    T* dkr = dk + (kv_base + kj) * HD;
    T* dvr = dv + (kv_base + kj) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
        dkr[d] = from_f32<T>(adk[jj][c]);
        dvr[d] = from_f32<T>(adv[jj][c]);
      }
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
  void *dq, *dk, *dv;  // dq for the dq kernel, dk and dv for the dk/dv kernel
  int b, nq, nkv, tq, tk, q_offset, causal;
};

template <typename T, int HD>
int launch_bwd(const BwdArgs& a, bool want_dq, cudaStream_t s) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (want_dq)
    return launch_dyn(flash_bwd_dq_kernel<T, HD>, dim3((a.tq + BQ - 1) / BQ, a.b * a.nq),
                      BwdSmem<HD>::kDq, s, q, k, v, a.kv_valid, a.lse, a.delta, dout,
                      static_cast<T*>(a.dq), a.nq, a.nkv, a.tq, a.tk, a.q_offset, a.causal,
                      inv_sqrt_hd<HD>());
  return launch_dyn(flash_bwd_dkv_kernel<T, HD>, dim3((a.tk + BKV - 1) / BKV, a.b * a.nkv),
                    BwdSmem<HD>::kDkv, s, q, k, v, a.kv_valid, a.lse, a.delta, dout,
                    static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.nq, a.nkv, a.tq, a.tk,
                    a.q_offset, a.causal, inv_sqrt_hd<HD>());
}

template <typename T>
int launch_bwd_hd(const BwdArgs& a, int hd, bool want_dq, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_bwd<T, 8>(a, want_dq, s);
    case 16: return launch_bwd<T, 16>(a, want_dq, s);
    case 32: return launch_bwd<T, 32>(a, want_dq, s);
    case 64: return launch_bwd<T, 64>(a, want_dq, s);
    case 80: return launch_bwd<T, 80>(a, want_dq, s);
    case 96: return launch_bwd<T, 96>(a, want_dq, s);
    case 128: return launch_bwd<T, 128>(a, want_dq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bwd(const BwdArgs& a, int hd, bool want_dq, int dtype, void* stream) {
  if (a.b == 0 || a.tq == 0 || a.tk == 0) return 0;
  if (a.nkv <= 0 || a.nq % a.nkv != 0 || a.b * a.nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == L32_BF16)
    err = launch_bwd_hd<__nv_bfloat16>(a, hd, want_dq, s);
  else if (dtype == L32_F32)
    err = launch_bwd_hd<float>(a, hd, want_dq, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse: null, or [b * nq, tq] fp32 (the training forward). q_offsets: null
// (every row at q_offset), or int32 [b] (one offset per row).
extern "C" int l32_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* q_offsets, void* out,
                                  void* lse, int b, int nq, int nkv, int tq, int tk, int hd,
                                  int q_offset, int causal, int dtype, void* stream) {
  return dispatch<float, __nv_bfloat16>(q, k, v, nullptr, nullptr, kv_valid, q_offsets, out, lse,
                                        b, nq, nkv, tq, tk, hd, q_offset, causal, dtype, stream);
}

extern "C" int l32_flash_attn_fwd_int8kv(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* kv_valid, const void* q_offsets, void* out,
                                         int b, int nq, int nkv, int tq, int tk, int hd,
                                         int q_offset, int causal, int dtype, void* stream) {
  return dispatch<int8_t, int8_t>(q, k, v, k_scale, v_scale, kv_valid, q_offsets, out, nullptr,
                                  b, nq, nkv, tq, tk, hd, q_offset, causal, dtype, stream);
}

// dq [b, nq, tq, hd] from q, k, v, the forward's lse [b * nq, tq], delta =
// rowsum(dO * O) [b * nq, tq] (both fp32) and dout; all of q's dtype.
extern "C" int l32_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* kv_valid, const void* lse, const void* delta,
                                     const void* dout, void* dq, int b, int nq, int nkv, int tq,
                                     int tk, int hd, int q_offset, int causal, int dtype,
                                     void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(kv_valid), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr, b, nq, nkv, tq, tk,
                  q_offset, causal};
  return dispatch_bwd(a, hd, true, dtype, stream);
}

// dk, dv [b, nkv, tk, hd], summed over each kv head's group of q heads.
extern "C" int l32_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* kv_valid, const void* lse, const void* delta,
                                      const void* dout, void* dk, void* dv, int b, int nq, int nkv,
                                      int tq, int tk, int hd, int q_offset, int causal, int dtype,
                                      void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(kv_valid), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv, b, nq, nkv, tq, tk, q_offset,
                  causal};
  return dispatch_bwd(a, hd, false, dtype, stream);
}
