// Flash GQA attention forward and backward (dq, dk/dv) on Hopper's tensor
// cores at fp32 precision: every fp32 product is three TF32 mma.sync products
// (3xTF32, tf32.cuh).
//
// Replaces llama32mm_tpu/ops/pallas/attention.py::_flash_kernel (its
// pallas_call through _flash_forward, the emit_lse output included),
// ::_flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (through
// _flash_backward) for every call that ops/attention.py routes to the float
// kernels: fp32 prefill and ViT calls with more than a few query rows per kv
// head, and the fp32 training forward, dq and dk/dv. The function is the
// Pallas kernels': q [B, nq, Tq, hd], k/v [B, nkv, Tk, hd], query head h
// reads kv head h / (nq / nkv); key `key` is allowed for query i of batch row
// b iff kv_valid[b, key] != 0, key < Tk and, when causal, key <= q_offset + i
// (q_offset one int, or int32 [B] per row in the forward). Allowed logits are
// s / sqrt(hd) (mask-then-scale), blocked keys get probability exactly 0, and
// a row with no allowed key outputs 0 and lse -0.7 * FLT_MAX (a negative
// q_offset, a ring chunk wholly in the future, masks every row; its dq is 0).
// int8 K/V carry fp32 per-position scales [B, nkv, Tk]: k_scale multiplies the
// score before the mask and the 1/sqrt(hd), v_scale multiplies p in the PV
// product but not in the denominator. q is fp32 or bf16 (staged as fp32); K/V
// are q's dtype or int8. No atomics: a second call gives the same bits.
//
// Bound on the H100: operations. The fp32 decoder prefill (Tq 1632, Tk 2048,
// 32/8 heads, hd 128, causal) is 21.8 GFLOP a call: 0.326 ms at the 67
// TFLOP/s of the CUDA cores, 0.133 ms as three TF32 products at 494.7 TFLOP/s.
//
// Design, shared by the three kernels:
//  - mma.sync m16n8k8 tf32 (tf32.cuh): the first product (product_rows) of
//    each kernel leaves its C registers as the second's (product_p) A
//    fragment. The second's B operand is rows 2t and 2t + 1 of a shared tile;
//    a lane loads VW (4, 2 or 1) adjacent columns of each with one
//    instruction and they feed VW n8 tiles, so a lane's outputs are 2 VW
//    adjacent columns of its two rows.
//  - Every shared tile is fp32 with rows of hd + 4 floats: the first
//    product's loads (8 rows x 4 columns a warp) and the second's (4 row
//    pairs x 8 VW columns) are both free of bank conflicts at every hd.
//  - The tensor cores round their fp32 accumulation toward zero, so the
//    second product sums each 32 keys (or queries) in fresh registers and
//    adds them to the running accumulator in fp32; the first product's chain
//    is hd / 8 k-steps, short.
//  - fp32 tiles arrive by 16-byte cp.async, double-buffered one tile ahead of
//    the math; bf16 and int8 tiles are loaded, converted and stored.
// Forward: a block of 8 warps owns 128 query rows of one (b, q head), 16 a
// warp, the longest causal rows first and a kv head's q heads side by side
// (their K/V tiles shared in L2). 64-key tiles of K and V; tiles wholly past
// the block's last causal limit are never loaded, and a warp skips tiles past
// its own rows' limit. S = Q K^T (Q from shared memory), an online softmax in
// registers (exp2 of logits prescaled by log2(e) / sqrt(hd)), O += P V with
// P straight from S's registers. O takes 64 floats a thread at hd 128.
// Shared memory at hd 128: Q 66 KB, two stages of K and V 132 KB.
// dq: the forward's grid and warps (128 query rows of one (b, q head), the
// longest causal rows first), Q and dO staged once (132 KB at hd 128) and
// 32-key tiles of K and V double-buffered (66 KB), a warp skipping tiles past
// its rows' limit. S = Q K^T and dP = dO V^T (32 keys: 16 floats each), then
// P = exp(S / sqrt(hd) - lse) on allowed pairs, dS = P (dP - delta) /
// sqrt(hd) in S's registers, and dQ += dS K in one fresh 32-key chunk a tile
// (64 floats a thread at hd 128).
// dk/dv: a block of 8 warps owns 64 keys of one (b, kv head), 16 a warp pair;
// it stages K and V once and sweeps the GQA group's q heads x 32-query tiles
// from the first tile that the causal mask lets see its keys. The block's two
// halves (4 warps, one of each pair) take alternate tiles, each half with its
// own double-buffered ring and named barrier, so that one half's softmax can
// run beside the other's products. S^T = K Q^T and dP^T = V dO^T, then
// P^T = exp(S^T / sqrt(hd) - lse) on allowed pairs and dS^T = P^T (dP^T -
// delta) / sqrt(hd), and dV += P^T dO, dK += dS^T Q accumulate in registers
// (128 floats a thread at hd 128). At the end each pair sums its two halves
// through shared memory in a fixed order: the group's sum stays in the block.
// delta = rowsum(dO * O) comes from the caller in fp32.
#include <float.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr float kNegBig = -0.7f * FLT_MAX;  // lse of a row with no allowed key
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 2;  // cp.async ring depth: one tile ahead

// Write a warp's 16 x HD accumulator rows (row0 + gid, row0 + gid + 8, those
// below `rows`) to dst rows of HD elements.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[HD / 8][4], int row0,
                                           int rows, int gid, int t4, float inv0 = 1.f,
                                           float inv1 = 1.f) {
  using G = Geom<HD>;
  constexpr int VW = G::VW;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = row0 + gid + 8 * ri;
    if (r >= rows) continue;
    const float inv = ri ? inv1 : inv0;
    T* row = dst + static_cast<size_t>(r) * HD;
#pragma unroll
    for (int g = 0; g < G::NG; ++g)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < VW; ++i)
          row[8 * VW * g + VW * (2 * t4 + c) + i] = from_f32<T>(acc[VW * g + i][2 * ri + c] * inv);
  }
}

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void load8_f32(const T* p, float (&f)[8]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(e[i]);
  } else {
    const Vec16<T> r = load16(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = to_f32(r[i]);
  }
}

// Rows [row0, row0 + n) of a [rows_total, HD] matrix into dst[n][LD] as fp32,
// zeros past rows_total, by `threads` threads of which this is `tid`. fp32 by
// 16-byte cp.async (the caller commits and waits); bf16 and int8 loaded,
// converted and stored.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int row0, int n,
                                           int rows_total, int tid, int threads) {
  constexpr int LD = Geom<HD>::LD;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int C = HD / 4;
    for (int u = tid; u < n * C; u += threads) {
      const int r = u / C, c = u % C;
      const bool in = row0 + r < rows_total;
      const size_t off = static_cast<size_t>(in ? row0 + r : 0) * HD + 4 * c;
      async_copy<16>(dst + r * LD + 4 * c, src + off, in);
    }
  } else {
    constexpr int C = HD / 8;
    for (int u = tid; u < n * C; u += threads) {
      const int r = u / C, c = u % C;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row0 + r < rows_total) load8_f32(src + static_cast<size_t>(row0 + r) * HD + 8 * c, f);
      float4* d = reinterpret_cast<float4*>(dst + r * LD + 8 * c);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// n 4-byte values src[i0 + i] into dst[i], zeros at or past `total`, by
// cp.async of `threads` threads of which this is `tid`.
template <typename U>
__device__ __forceinline__ void stage_row(U* dst, const U* src, int i0, int n, int total, int tid,
                                          int threads) {
  for (int i = tid; i < n; i += threads) {
    const bool in = i0 + i < total;
    async_copy<4>(dst + i, src + (in ? i0 + i : 0), in);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kBM = 16 * kFwdWarps;  // query rows a block
constexpr int kBN = 64;              // keys a tile
constexpr int kNT = kBN / 8;         // n8 tiles of S

template <int HD>
constexpr int fwd_smem_bytes() {
  return ((kBM + 2 * kStages * kBN) * Geom<HD>::LD + 3 * kStages * kBN) * 4;
}

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_tf32_fwd_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                      const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                      const int* __restrict__ kv_valid, const int* __restrict__ q_offsets,
                      T* __restrict__ out, float* __restrict__ lse, int bh_total, int nq, int nkv,
                      int tq, int tk, int q_offset, int causal, int n_qtiles, float scale_log2) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr bool kSplitQ = std::is_same<T, float>::value;
  constexpr bool kSplitKV = std::is_same<KV, float>::value;
  using G = Geom<HD>;
  constexpr int LD = G::LD;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kBM][LD]
  float* ks = qs + kBM * LD;                      // [kStages][kBN][LD]
  float* vs = ks + kStages * kBN * LD;
  int* valid_s = reinterpret_cast<int*>(vs + kStages * kBN * LD);  // [kStages][kBN]
  float* ksc = reinterpret_cast<float*>(valid_s + kStages * kBN);
  float* vsc = ksc + kStages * kBN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x % bh_total;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / bh_total;  // longest rows first
  const int b = bh / nq, kvh = bh % nq / (nq / nkv);
  const int q0 = qt * kBM, q_rows = min(kBM, tq - q0);
  if (q_offsets != nullptr) q_offset = q_offsets[b];
  const int n_keys = causal ? max(0, min(tk, q_offset + q0 + q_rows)) : tk;
  const int n_tiles = (n_keys + kBN - 1) / kBN;
  // This warp's rows: r0 .. r0 + warp_rows - 1; the causal limit only grows along them.
  const int r0 = 16 * warp;
  const int warp_rows = max(0, min(16, q_rows - r0));
  const int warp_keys = causal ? max(0, min(tk, q_offset + q0 + r0 + warp_rows)) : tk;
  const int warp_tiles = warp_rows == 0 ? 0 : (warp_keys + kBN - 1) / kBN;
  const size_t kvrow0 = static_cast<size_t>(b * nkv + kvh) * tk;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;

  stage_tile<T, HD>(qs, q + static_cast<size_t>(bh) * tq * HD, q0, kBM, tq, tid, kFwdThreads);
  auto issue = [&](int t) {  // K/V tile t (keys 64 t ...) into stage t % kStages
    const int st = t % kStages, k0 = t * kBN;
    stage_tile<KV, HD>(ks + st * kBN * LD, k + kvrow0 * HD, k0, kBN, tk, tid, kFwdThreads);
    stage_tile<KV, HD>(vs + st * kBN * LD, v + kvrow0 * HD, k0, kBN, tk, tid, kFwdThreads);
    stage_row(valid_s + st * kBN, validb, k0, kBN, tk, tid, kFwdThreads);
    if constexpr (kInt8) {
      stage_row(ksc + st * kBN, k_scale + kvrow0, k0, kBN, tk, tid, kFwdThreads);
      stage_row(vsc + st * kBN, v_scale + kvrow0, k0, kBN, tk, tid, kFwdThreads);
    }
  };
  if (n_tiles > 0) issue(0);
  async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    async_commit();
    async_wait<1>();  // tile t (and Q) landed
    __syncthreads();
    if (t < warp_tiles) {
      const int st = t % kStages, k0 = t * kBN;
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      product_rows<HD, kNT, kSplitQ, kSplitKV>(s, qs + r0 * LD, ks + st * kBN * LD, gid, t4);

      // Online softmax of this warp's rows gid, gid + 8 over the tile's keys.
      const int* valid_t = valid_s + st * kBN;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int qi = q0 + r0 + gid + 8 * ri;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = 8 * nt + 2 * t4 + e, key = k0 + kl;
            const bool allowed = qi < tq && key < tk && valid_t[kl] != 0 &&
                                 (!causal || key <= q_offset + qi);
            float x = s[nt][2 * ri + e];
            if constexpr (kInt8) x *= ksc[st * kBN + kl];
            x = allowed ? x * scale_log2 : -INFINITY;
            s[nt][2 * ri + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[ri], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key allowed yet: p = 0
        const float alpha = exp2f(m[ri] - m_use);              // 0 while m is -inf
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[nt][2 * ri + e];
            float p = exp2f(x - m_use);  // exactly 0 for a blocked key
            sum += p;
            if constexpr (kInt8)  // the PV weight, re-masked: blocked slots' scales never count
              p = x == -INFINITY ? 0.f : p * vsc[st * kBN + 8 * nt + 2 * t4 + e];
            s[nt][2 * ri + e] = p;
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        l[ri] = l[ri] * alpha + sum;
        m[ri] = m_new;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[j][2 * ri] *= alpha;
          o[j][2 * ri + 1] *= alpha;
        }
      }
      product_p<HD, kNT, kSplitKV>(o, s, vs + st * kBN * LD, gid, t4);
    }
    __syncthreads();  // stage t % kStages consumed before tile t + 2 overwrites it
  }
  async_wait<0>();

  const size_t row0 = static_cast<size_t>(bh) * tq + q0;
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f, inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
  store_rows<T, HD>(out + row0 * HD, o, r0, q_rows, gid, t4, inv0, inv1);
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = r0 + gid + 8 * ri;
      if (r < q_rows) lse[row0 + r] = l[ri] > 0.f ? (m[ri] + log2f(l[ri])) * kLn2 : kNegBig;
    }
  }
}

// ---------------------------------------------------------------------------
// dq backward
// ---------------------------------------------------------------------------

constexpr int kDqN = 32;          // keys a tile: one fresh chunk of product_p
constexpr int kDqNT = kDqN / 8;   // n8 tiles of a warp's S and dP
static_assert(kDqNT == kKC, "a tile is one chunk of dS K");

template <int HD>
constexpr int dq_smem_bytes() {
  return ((2 * kBM + 2 * kStages * kDqN) * Geom<HD>::LD + kStages * kDqN) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_tf32_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ kv_valid, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         T* __restrict__ dq, int bh_total, int nq, int nkv, int tq, int tk,
                         int q_offset, int causal, int n_qtiles, float scale, float scale_log2) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  using G = Geom<HD>;
  constexpr int LD = G::LD;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kBM][LD]
  float* dos = qs + kBM * LD;                     // [kBM][LD]
  float* ks = dos + kBM * LD;                     // [kStages][kDqN][LD]
  float* vs = ks + kStages * kDqN * LD;
  int* valid_s = reinterpret_cast<int*>(vs + kStages * kDqN * LD);  // [kStages][kDqN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x % bh_total;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / bh_total;  // longest rows first
  const int b = bh / nq, kvh = bh % nq / (nq / nkv);
  const int q0 = qt * kBM, q_rows = min(kBM, tq - q0);
  const int n_keys = causal ? max(0, min(tk, q_offset + q0 + q_rows)) : tk;
  const int n_tiles = (n_keys + kDqN - 1) / kDqN;
  // This warp's rows: r0 .. r0 + warp_rows - 1; the causal limit only grows along them.
  const int r0 = 16 * warp;
  const int warp_rows = max(0, min(16, q_rows - r0));
  const int warp_keys = causal ? max(0, min(tk, q_offset + q0 + r0 + warp_rows)) : tk;
  const int warp_tiles = warp_rows == 0 ? 0 : (warp_keys + kDqN - 1) / kDqN;
  const size_t kvrow0 = static_cast<size_t>(b * nkv + kvh) * tk;
  const size_t qrow0 = static_cast<size_t>(bh) * tq;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;

  stage_tile<T, HD>(qs, q + qrow0 * HD, q0, kBM, tq, tid, kFwdThreads);
  stage_tile<T, HD>(dos, dout + qrow0 * HD, q0, kBM, tq, tid, kFwdThreads);
  auto issue = [&](int t) {  // K/V tile t (keys 32 t ...) into stage t % kStages
    const int st = t % kStages, k0 = t * kDqN;
    stage_tile<T, HD>(ks + st * kDqN * LD, k + kvrow0 * HD, k0, kDqN, tk, tid, kFwdThreads);
    stage_tile<T, HD>(vs + st * kDqN * LD, v + kvrow0 * HD, k0, kDqN, tk, tid, kFwdThreads);
    stage_row(valid_s + st * kDqN, validb, k0, kDqN, tk, tid, kFwdThreads);
  };
  if (n_tiles > 0) issue(0);
  async_commit();

  // This lane's rows gid, gid + 8: their lse in log2 units and delta.
  float lse2[2], dlt[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q0 + r0 + gid + 8 * ri;
    lse2[ri] = qi < tq ? lse[qrow0 + qi] * kLog2e : 0.f;
    dlt[ri] = qi < tq ? delta[qrow0 + qi] : 0.f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1);
    async_commit();
    async_wait<1>();  // tile t (and Q, dO) landed
    __syncthreads();
    if (t < warp_tiles) {
      const int st = t % kStages, k0 = t * kDqN;
      const float* kt = ks + st * kDqN * LD;
      float s[kDqNT][4], dp[kDqNT][4];
#pragma unroll
      for (int nt = 0; nt < kDqNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
      product_rows<HD, kDqNT, kSplit, kSplit>(s, qs + r0 * LD, kt, gid, t4);                 // S
      product_rows<HD, kDqNT, kSplit, kSplit>(dp, dos + r0 * LD, vs + st * kDqN * LD, gid, t4);  // dP
      const int* valid_t = valid_s + st * kDqN;
#pragma unroll
      for (int nt = 0; nt < kDqNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // row gid + 8 (c / 2), key 8 nt + 2 t4 + c % 2
          const int ri = c >> 1, kl = 8 * nt + 2 * t4 + (c & 1);
          const int qi = q0 + r0 + gid + 8 * ri, key = k0 + kl;
          const bool allowed = qi < tq && key < tk && valid_t[kl] != 0 &&
                               (!causal || key <= q_offset + qi);
          const float p = allowed ? exp2f(fmaf(s[nt][c], scale_log2, -lse2[ri])) : 0.f;
          s[nt][c] = p * (dp[nt][c] - dlt[ri]) * scale;  // dS
        }
      product_p<HD, kDqNT, kSplit>(acc, s, kt, gid, t4);  // dQ += dS K
    }
    __syncthreads();  // stage t % kStages consumed before tile t + 2 overwrites it
  }
  async_wait<0>();
  store_rows<T, HD>(dq + (qrow0 + q0) * HD, acc, r0, q_rows, gid, t4);
}

// ---------------------------------------------------------------------------
// dk/dv backward
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBK = 64;  // keys a block: 16 a warp pair
constexpr int kBQ = 32;  // queries a tile of one half (4 warps)
constexpr int kQT = kBQ / 8;  // n8 tiles of a warp's S^T

template <int HD>
constexpr int dkv_smem_bytes() {
  return ((2 * kBK + 2 * 2 * kStages * kBQ) * Geom<HD>::LD + 2 * 2 * kStages * kBQ + kBK) * 4;
}

// bar.sync on named barrier `id` for `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_tf32_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_valid,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                          int bkv_total, int nq, int nkv, int tq, int tk, int q_offset, int causal,
                          float scale, float scale_log2) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  using G = Geom<HD>;
  constexpr int LD = G::LD;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);  // [kBK][LD]
  float* vs = ks + kBK * LD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int kw = warp & 3, half = warp >> 2;  // key slice of the pair; the half's own tiles
  // Each half's ring: [kStages][kBQ][LD] of Q and of dO, [kStages][kBQ] of lse and delta.
  float* ring = vs + kBK * LD + half * 2 * kStages * kBQ * LD;
  float* qs = ring;
  float* dos = ring + kStages * kBQ * LD;
  float* rows = vs + kBK * LD + 2 * 2 * kStages * kBQ * LD + half * 2 * kStages * kBQ;
  float* lse_s = rows;
  float* delta_s = rows + kStages * kBQ;
  int* valid_s = reinterpret_cast<int*>(vs + kBK * LD + 2 * 2 * kStages * kBQ * LD +
                                        2 * 2 * kStages * kBQ);  // [kBK]

  const int bkv = blockIdx.x % bkv_total;
  const int k0 = static_cast<int>(blockIdx.x) / bkv_total * kBK;  // low keys (most queries) first
  const int b = bkv / nkv, kvh = bkv % nkv, group = nq / nkv;
  const int wk0 = k0 + 16 * kw;  // this warp's first key
  const size_t kv_base = static_cast<size_t>(bkv) * tk;
  // Query i sees key k0 only if k0 <= q_offset + i: earlier tiles are skipped.
  const int first_q = causal ? max(0, k0 - q_offset) : 0;
  const int q_start = first_q / kBQ * kBQ;
  const int n_qt = first_q < tq ? (tq - q_start + kBQ - 1) / kBQ : 0;
  const int n_tiles = group * n_qt;  // tile u: q head kvh * group + u / n_qt; half u % 2 takes it
  const int my_tiles = (n_tiles - half + 1) / 2;

  stage_tile<T, HD>(ks, k + kv_base * HD, k0, kBK, tk, tid, kBwdThreads);
  stage_tile<T, HD>(vs, v + kv_base * HD, k0, kBK, tk, tid, kBwdThreads);
  stage_row(valid_s, kv_valid + static_cast<size_t>(b) * tk, k0, kBK, tk, tid, kBwdThreads);
  async_commit();
  async_wait<0>();
  __syncthreads();  // K, V and the validity row, staged by every thread, seen by both halves

  const int htid = tid & 127;  // this thread in its half
  auto issue = [&](int i) {  // this half's i-th tile (u = 2 i + half) into stage i % kStages
    const int u = 2 * i + half, st = i % kStages, qq0 = q_start + u % n_qt * kBQ;
    const size_t q_base = static_cast<size_t>(b * nq + kvh * group + u / n_qt) * tq;
    stage_tile<T, HD>(qs + st * kBQ * LD, q + q_base * HD, qq0, kBQ, tq, htid, 128);
    stage_tile<T, HD>(dos + st * kBQ * LD, dout + q_base * HD, qq0, kBQ, tq, htid, 128);
    stage_row(lse_s + st * kBQ, lse + q_base, qq0, kBQ, tq, htid, 128);
    stage_row(delta_s + st * kBQ, delta + q_base, qq0, kBQ, tq, htid, 128);
  };
  if (my_tiles > 0) issue(0);
  async_commit();

  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) adk[j][c] = adv[j][c] = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    if (i + 1 < my_tiles) issue(i + 1);
    async_commit();
    async_wait<1>();  // tile i landed
    named_barrier(1 + half, 128);
    const int st = i % kStages, u = 2 * i + half;
    const int wq0 = q_start + u % n_qt * kBQ;  // the tile's first query
    if (wk0 < tk && (!causal || wk0 <= q_offset + wq0 + kBQ - 1)) {
      const float* qt = qs + st * kBQ * LD;
      const float* dot = dos + st * kBQ * LD;
      const float* lse_t = lse_s + st * kBQ;
      const float* delta_t = delta_s + st * kBQ;
      float s[kQT][4], dp[kQT][4];
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
      product_rows<HD, kQT, kSplit, kSplit>(s, ks + 16 * kw * LD, qt, gid, t4);  // S^T
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // P^T at key gid + 8 (c / 2), query 8 nt + 2 t4 + c % 2
          const int kl = 16 * kw + gid + 8 * (c >> 1), ql = 8 * nt + 2 * t4 + (c & 1);
          const int key = k0 + kl, qi = wq0 + ql;
          const bool allowed = key < tk && valid_s[kl] != 0 && qi < tq &&
                               (!causal || key <= q_offset + qi);
          s[nt][c] = allowed ? exp2f(fmaf(s[nt][c], scale_log2, -lse_t[ql] * kLog2e)) : 0.f;
        }
      product_p<HD, kQT, kSplit>(adv, s, dot, gid, t4);                            // dV += P^T dO
      product_rows<HD, kQT, kSplit, kSplit>(dp, vs + 16 * kw * LD, dot, gid, t4);  // dP^T
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dp[nt][c] = s[nt][c] * (dp[nt][c] - delta_t[8 * nt + 2 * t4 + (c & 1)]) * scale;
      product_p<HD, kQT, kSplit>(adk, dp, qt, gid, t4);  // dK += dS^T Q
    }
    named_barrier(1 + half, 128);  // stage i % kStages consumed before tile i + 2 overwrites it
  }
  async_wait<0>();
  __syncthreads();  // both halves done with their rings

  // Each pair's second warp hands its sums to the first through the rings
  // (free now), which adds them in a fixed order and writes the rows.
  float* red = vs + kBK * LD + kw * (2 * (HD / 8) * 4 * 32);
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[(j * 4 + c) * 32 + lane] = adk[j][c];
        red[((HD / 8 + j) * 4 + c) * 32 + lane] = adv[j][c];
      }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        adk[j][c] += red[(j * 4 + c) * 32 + lane];
        adv[j][c] += red[((HD / 8 + j) * 4 + c) * 32 + lane];
      }
    store_rows<T, HD>(dk + (kv_base + k0) * HD, adk, 16 * kw, tk - k0, gid, t4);
    store_rows<T, HD>(dv + (kv_base + k0) * HD, adv, 16 * kw, tk - k0, gid, t4);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

struct FwdArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *kv_valid, *q_offsets;
  void* out;
  float* lse;
  int b, nq, nkv, tq, tk, q_offset, causal;
};

template <typename T, typename KV, int HD>
int launch_fwd(const FwdArgs& a, cudaStream_t s) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_qtiles = (a.tq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(a.b) * a.nq * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tf32_fwd_kernel<T, KV, HD>;
  constexpr int smem = fwd_smem_bytes<HD>();
  if (const int e = allow_smem(kernel, smem)) return e;
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD)));
  kernel<<<static_cast<int>(blocks), kFwdThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      a.k_scale, a.v_scale, a.kv_valid, a.q_offsets, static_cast<T*>(a.out), a.lse, a.b * a.nq,
      a.nq, a.nkv, a.tq, a.tk, a.q_offset, a.causal, n_qtiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int launch_fwd_hd(const FwdArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_fwd<T, KV, 8>(a, s);
    case 16: return launch_fwd<T, KV, 16>(a, s);
    case 32: return launch_fwd<T, KV, 32>(a, s);
    case 64: return launch_fwd<T, KV, 64>(a, s);
    case 80: return launch_fwd<T, KV, 80>(a, s);
    case 96: return launch_fwd<T, KV, 96>(a, s);
    case 128: return launch_fwd<T, KV, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_fwd(const FwdArgs& a, int hd, bool int8_kv, int dtype, void* stream) {
  if (a.b == 0 || a.tq == 0) return 0;
  if (a.nkv <= 0 || a.nq % a.nkv != 0 || (int8_kv && a.lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == L32_F32)
    return int8_kv ? launch_fwd_hd<float, int8_t>(a, hd, s) : launch_fwd_hd<float, float>(a, hd, s);
  if (dtype == L32_BF16)
    return int8_kv ? launch_fwd_hd<__nv_bfloat16, int8_t>(a, hd, s)
                   : launch_fwd_hd<__nv_bfloat16, __nv_bfloat16>(a, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct DkvArgs {
  const void *q, *k, *v, *dout;
  const int* kv_valid;
  const float *lse, *delta;
  void *dk, *dv;
  int b, nq, nkv, tq, tk, q_offset, causal;
};

template <typename T, int HD>
int launch_dkv(const DkvArgs& a, cudaStream_t s) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_ktiles = (a.tk + kBK - 1) / kBK;
  const long long blocks = static_cast<long long>(a.b) * a.nkv * n_ktiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tf32_bwd_dkv_kernel<T, HD>;
  constexpr int smem = dkv_smem_bytes<HD>();
  if (const int e = allow_smem(kernel, smem)) return e;
  const double inv = 1.0 / sqrt(static_cast<double>(HD));
  kernel<<<static_cast<int>(blocks), kBwdThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.kv_valid, a.lse, a.delta, static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.b * a.nkv, a.nq, a.nkv, a.tq, a.tk, a.q_offset, a.causal,
      static_cast<float>(inv), static_cast<float>(inv * 1.4426950408889634));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const DkvArgs& a, cudaStream_t s) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_qtiles = (a.tq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(a.b) * a.nq * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tf32_bwd_dq_kernel<T, HD>;
  constexpr int smem = dq_smem_bytes<HD>();
  if (const int e = allow_smem(kernel, smem)) return e;
  const double inv = 1.0 / sqrt(static_cast<double>(HD));
  kernel<<<static_cast<int>(blocks), kFwdThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.kv_valid, a.lse, a.delta, static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
      a.b * a.nq, a.nq, a.nkv, a.tq, a.tk, a.q_offset, a.causal, n_qtiles,
      static_cast<float>(inv), static_cast<float>(inv * 1.4426950408889634));
  return static_cast<int>(cudaGetLastError());
}

// dk/dv (kDq false) or dq (kDq true, written to a.dk) at head size hd.
template <typename T, bool kDq>
int launch_bwd_hd(const DkvArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 8: return kDq ? launch_dq<T, 8>(a, s) : launch_dkv<T, 8>(a, s);
    case 16: return kDq ? launch_dq<T, 16>(a, s) : launch_dkv<T, 16>(a, s);
    case 32: return kDq ? launch_dq<T, 32>(a, s) : launch_dkv<T, 32>(a, s);
    case 64: return kDq ? launch_dq<T, 64>(a, s) : launch_dkv<T, 64>(a, s);
    case 80: return kDq ? launch_dq<T, 80>(a, s) : launch_dkv<T, 80>(a, s);
    case 96: return kDq ? launch_dq<T, 96>(a, s) : launch_dkv<T, 96>(a, s);
    case 128: return kDq ? launch_dq<T, 128>(a, s) : launch_dkv<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int dispatch_bwd(const DkvArgs& a, int hd, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == L32_F32) return launch_bwd_hd<float, kDq>(a, hd, s);
  if (dtype == L32_BF16) return launch_bwd_hd<__nv_bfloat16, kDq>(a, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [b, nq, tq, hd] fp32 or bf16 (dtype), k/v [b, nkv, tk, hd] of q's dtype;
// q_offsets null (every row at q_offset) or int32 [b]; lse null or fp32
// [b * nq, tq]. Every pointer but kv_valid and q_offsets 16-byte aligned.
extern "C" int l32_flash_attn_tf32_fwd(const void* q, const void* k, const void* v,
                                       const void* kv_valid, const void* q_offsets, void* out,
                                       void* lse, int b, int nq, int nkv, int tq, int tk, int hd,
                                       int q_offset, int causal, int dtype, void* stream) {
  const FwdArgs a{q, k, v, nullptr, nullptr, static_cast<const int*>(kv_valid),
                  static_cast<const int*>(q_offsets), out, static_cast<float*>(lse), b, nq, nkv,
                  tq, tk, q_offset, causal};
  return dispatch_fwd(a, hd, false, dtype, stream);
}

// As l32_flash_attn_tf32_fwd over int8 K/V with fp32 scales [b, nkv, tk]; no lse.
extern "C" int l32_flash_attn_tf32_fwd_int8kv(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* kv_valid, const void* q_offsets,
                                              void* out, int b, int nq, int nkv, int tq, int tk,
                                              int hd, int q_offset, int causal, int dtype,
                                              void* stream) {
  const FwdArgs a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                  static_cast<const int*>(kv_valid), static_cast<const int*>(q_offsets), out,
                  nullptr, b, nq, nkv, tq, tk, q_offset, causal};
  return dispatch_fwd(a, hd, true, dtype, stream);
}

// dk, dv [b, nkv, tk, hd], summed over each kv head's group of q heads, from
// q, k, v, dout (fp32 or bf16, dtype), the forward's lse and delta =
// rowsum(dO * O), both fp32 [b * nq, tq].
extern "C" int l32_flash_attn_tf32_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* kv_valid, const void* lse,
                                           const void* delta, const void* dout, void* dk,
                                           void* dv, int b, int nq, int nkv, int tq, int tk,
                                           int hd, int q_offset, int causal, int dtype,
                                           void* stream) {
  if (b == 0 || tq == 0 || tk == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const DkvArgs a{q, k, v, dout, static_cast<const int*>(kv_valid),
                  static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, b, nq,
                  nkv, tq, tk, q_offset, causal};
  return dispatch_bwd<false>(a, hd, dtype, stream);
}

// dq [b, nq, tq, hd] from the same operands as l32_flash_attn_tf32_bwd_dkv
// (0 for every row when tk is 0).
extern "C" int l32_flash_attn_tf32_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* kv_valid, const void* lse,
                                          const void* delta, const void* dout, void* dq, int b,
                                          int nq, int nkv, int tq, int tk, int hd, int q_offset,
                                          int causal, int dtype, void* stream) {
  if (b == 0 || tq == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const DkvArgs a{q, k, v, dout, static_cast<const int*>(kv_valid),
                  static_cast<const float*>(lse), static_cast<const float*>(delta), dq, nullptr,
                  b, nq, nkv, tq, tk, q_offset, causal};
  return dispatch_bwd<true>(a, hd, dtype, stream);
}
