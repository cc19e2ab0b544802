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
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int BQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int BKV = 32;                     // keys per tile: one per lane

// KV = T: float K/V, the scale pointers unused; KV = int8_t: the int8 cache.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                 const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                 const int* __restrict__ kv_valid, T* __restrict__ out, int nq, int nkv,
                 int tq, int tk, int q_offset, int causal, float scale) {
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
    T* orow = out + (static_cast<size_t>(bh) * tq + qi) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) orow[d] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, typename KV, int HD>
void launch(const void* q, const void* k, const void* v, const float* k_scale,
            const float* v_scale, const int* kv_valid, void* out, int b, int nq, int nkv,
            int tq, int tk, int q_offset, int causal, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  dim3 grid((tq + BQ - 1) / BQ, b * nq);
  flash_fwd_kernel<T, KV, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, kv_valid, static_cast<T*>(out), nq, nkv, tq, tk, q_offset, causal, scale);
}

template <typename T, typename KV>
int launch_hd(const void* q, const void* k, const void* v, const float* k_scale,
              const float* v_scale, const int* kv_valid, void* out, int b, int nq, int nkv,
              int tq, int tk, int hd, int q_offset, int causal, cudaStream_t s) {
#define L32_HD(N)                                                                      \
  case N:                                                                              \
    launch<T, KV, N>(q, k, v, k_scale, v_scale, kv_valid, out, b, nq, nkv, tq, tk,      \
                     q_offset, causal, s);                                             \
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
             const void* v_scale, const void* kv_valid, void* out, int b, int nq, int nkv,
             int tq, int tk, int hd, int q_offset, int causal, int dtype, void* stream) {
  if (b == 0 || tq == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || b * nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int* kvv = static_cast<const int*>(kv_valid);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  int err;
  if (dtype == L32_BF16)
    err = launch_hd<__nv_bfloat16, KVB>(q, k, v, ks, vs, kvv, out, b, nq, nkv, tq, tk, hd,
                                        q_offset, causal, s);
  else if (dtype == L32_F32)
    err = launch_hd<float, KVF>(q, k, v, ks, vs, kvv, out, b, nq, nkv, tq, tk, hd, q_offset,
                                causal, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l32_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* kv_valid, void* out, int b, int nq, int nkv,
                                  int tq, int tk, int hd, int q_offset, int causal,
                                  int dtype, void* stream) {
  return dispatch<float, __nv_bfloat16>(q, k, v, nullptr, nullptr, kv_valid, out, b, nq, nkv,
                                        tq, tk, hd, q_offset, causal, dtype, stream);
}

extern "C" int l32_flash_attn_fwd_int8kv(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* kv_valid, void* out, int b, int nq,
                                         int nkv, int tq, int tk, int hd, int q_offset,
                                         int causal, int dtype, void* stream) {
  return dispatch<int8_t, int8_t>(q, k, v, k_scale, v_scale, kv_valid, out, b, nq, nkv, tq, tk,
                                  hd, q_offset, causal, dtype, stream);
}
