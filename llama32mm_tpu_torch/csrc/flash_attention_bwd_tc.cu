// Flash GQA attention backward on Hopper's tensor cores (wgmma), bf16.
//
// Replaces llama32mm_tpu/ops/pallas/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel for every bf16 training call (the decoder's
// attention in LoRA and full fine-tuning, a trained ViT). The function is
// flash_attention.cu's backward: q, dout [B, nq, Tq, hd] bf16, k, v [B, nkv,
// Tk, hd] bf16, the forward's lse [B * nq, Tq] and delta = rowsum(dO * O)
// [B * nq, Tq] fp32; on allowed keys (kv_valid[b, key] != 0 and, when
// causal, key <= q_offset + i) p = exp(s / sqrt(hd) - lse), dp = dO . v,
// ds = p (dp - delta) / sqrt(hd); dq = ds k, dk = ds^T q and dv = p^T dO,
// dk and dv summed over each kv head's group of query heads. As in the
// Pallas kernels, p and ds are rounded to bf16 before the three products
// that take them; every product sums in fp32. A row with no allowed key
// (lse = -0.7 * FLT_MAX) gets p = 0 by a select, never by arithmetic on
// its lse, so its dq is exactly 0.
//
// Bound on the H100: operations. At the 11B decoder's T = 1632 (nq 32, nkv
// 8, hd 128, causal) dq is 3 products of 2 hd flops per allowed (query,
// key) pair (0.033 ms at 989 TFLOP/s), dk/dv 4 (0.044 ms). Every product
// runs on the tensor cores with fp32 accumulators; tiles sit in the
// no-swizzle canonical layout of wgmma.cuh and stream through a 2-stage
// cp.async ring one tile ahead of the math:
//  - dq: one warpgroup (128 threads) a block, two blocks an SM. A block owns
//    64 query rows of one (b, q head) and sweeps 64-key K/V tiles up to its
//    last row's causal limit. Q and dO sit in registers as A fragments
//    (ldmatrix, once); S = Q K^T and dP = dO V^T take K and V as K-major B;
//    dS is formed in the accumulator registers and, rounded to bf16, is the
//    A operand of dQ += dS K, K read again through the MN-major descriptor.
//    The grid runs the longest causal rows first, the G query heads of a kv
//    head side by side.
//  - dk/dv: two warpgroups a block, one block an SM. A block owns 64 keys of
//    one (b, kv head), K and V resident in shared memory, and sweeps the
//    group's query heads x 64-row query tiles from the first tile whose rows
//    see its keys; the warpgroups take alternate tiles, each with its own
//    ring of Q, dO, lse and delta, and their dK and dV are added at the end
//    (warpgroup 0's + warpgroup 1's, through shared memory). Splitting the
//    sweep halves the longest block's time: under the causal mask the first
//    key tile sees every query row and the last only 64. S^T = K Q^T and
//    dP^T = V dO^T are SS products (K and V as A from shared memory, which
//    keeps the 128 dK and dV accumulators per thread in registers); P^T and
//    dS^T, rounded to bf16, are the A operands of dV += P^T dO and
//    dK += dS^T Q, dO and Q read again as MN-major B. The grid runs the
//    first key tiles (the longest sweeps) first.
// No atomics and no partial sums in device memory: two calls give the same
// bits. hd 8 is zero-padded to the k16 step in shared memory. At hd 128
// ptxas reports 231 (dq) and 236 (dk/dv) registers a thread and no spills.
#include <float.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;       // query rows (dq) or keys (dk/dv) a block owns: one wgmma M
constexpr int kTileN = 64;      // keys (dq) or query rows (dk/dv) per streamed tile
constexpr int kStages = 2;      // ring depth of the streamed tiles (one tile ahead)
constexpr int kThreads = 128;   // one warpgroup
constexpr int kDkvWarpgroups = 2;  // a dk/dv block's warpgroups, each on half of its sweep
constexpr float kNegBig = -0.7f * FLT_MAX;  // lse of a row with no allowed key
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct BwdGeom {
  static constexpr int kHdp = (HD + 15) / 16 * 16;  // head dim padded to the k16 step
  static constexpr int kGroup = kHdp * 16;           // bytes of one 8-row group
  static constexpr int kTile = 64 * kHdp * 2;        // one 64-row bf16 tile
  static constexpr int kChunks = HD / 8;             // 16-byte chunks per row
  // Two resident tiles (Q and dO, or K and V) and a ring of two tiles a
  // stage (per warpgroup in dk/dv).
  static constexpr int kDqTiles = 2 + 2 * kStages;
  static constexpr int kDkvTiles = 2 + 2 * kStages * kDkvWarpgroups;
  static __device__ __forceinline__ int at(int row, int chunk) {
    return canonical_at(row, chunk, kGroup);
  }
};

// Copy rows row0 .. row0 + 63 of a [rows_total, HD] bf16 matrix into a
// canonical tile, zero-filling rows past rows_total (cp.async, uncommitted),
// by threads t of 0 .. nt - 1.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst, const __nv_bfloat16* src, int row0,
                                          int rows_total, int t, int nt) {
  using G = BwdGeom<HD>;
  for (int u = t; u < 64 * G::kChunks; u += nt) {
    const int r = (u >> 3) / G::kChunks * 8 + (u & 7), c = (u >> 3) % G::kChunks;
    const bool in = row0 + r < rows_total;
    async_copy<16>(dst + G::at(r, c), src + static_cast<size_t>(in ? row0 + r : 0) * HD + c * 8,
                   in);
  }
}

// Zero the head-dim padding chunks of the block's tiles, once: bytes no
// copy writes.
template <int HD, int kTiles>
__device__ __forceinline__ void zero_padding(unsigned char* smem) {
  using G = BwdGeom<HD>;
  constexpr int kPad = G::kHdp / 8 - G::kChunks;
  if constexpr (kPad > 0) {
    for (int u = threadIdx.x; u < kTiles * 64 * kPad; u += blockDim.x) {
      const int tile = u / (64 * kPad), r = u % 64, c = G::kChunks + u / 64 % kPad;
      *reinterpret_cast<uint4*>(smem + tile * G::kTile + G::at(r, c)) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_valid,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                       int nq, int nkv, int tq, int tk, int q_offset, int causal, int n_qtiles,
                       int n_bkv, float scale, float scale_log2) {
  using G = BwdGeom<HD>;
  constexpr int HDP = G::kHdp, NO = HDP / 2, KS = HDP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* dos = qs + G::kTile;
  unsigned char* kst = dos + G::kTile;  // K/V tile t in stage t % kStages
  unsigned char* vst = kst + kStages * G::kTile;
  __shared__ int valid_s[kStages][kTileN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = nq / nkv;
  int idx = blockIdx.x;  // (q tile from the last, b * kv head, q head in the group)
  const int g = idx % group;
  idx /= group;
  const int bkv = idx % n_bkv, qt = n_qtiles - 1 - idx / n_bkv;
  const int b = bkv / nkv, kvh = bkv % nkv;
  const int q0 = qt * kRows, q_rows = min(kRows, tq - q0);
  const int n_keys = causal ? max(0, min(tk, q_offset + q0 + q_rows)) : tk;  // last limit + 1
  const int n_tiles = (n_keys + kTileN - 1) / kTileN;
  const size_t head_row0 = static_cast<size_t>(b * nq + kvh * group + g) * tq;
  const size_t kvrow0 = static_cast<size_t>(bkv) * tk;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;
  zero_padding<HD, G::kDqTiles>(smem);

  auto issue = [&](int t) {  // K/V tile t and its keys' validity (0 past Tk)
    const int st = t % kStages, k0 = t * kTileN;
    load_tile<HD>(kst + st * G::kTile, k + kvrow0 * HD, k0, tk, tid, kThreads);
    load_tile<HD>(vst + st * G::kTile, v + kvrow0 * HD, k0, tk, tid, kThreads);
    if (tid < kTileN) {
      const bool in = k0 + tid < tk;
      async_copy<4>(&valid_s[st][tid], validb + (in ? k0 + tid : 0), in);
    }
  };

  // This thread's rows r_lo and r_lo + 8 of the accumulator layout.
  const int r_lo = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  float lse2[2], dlt[2];
  int limit[2];
  bool row_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r_lo + 8 * half;
    const bool in = qi < tq;
    const float l = in ? lse[head_row0 + qi] : kNegBig;
    row_ok[half] = l > 0.5f * kNegBig;  // an empty row (or past Tq): p = 0
    lse2[half] = l * kLog2e;            // read only where row_ok
    dlt[half] = in ? delta[head_row0 + qi] : 0.f;
    limit[half] = q_offset + qi;
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  uint32_t qa[KS][4], da[KS][4];  // Q and dO rows as A fragments
  if (n_tiles > 0) {
    load_tile<HD>(qs, q + head_row0 * HD, q0, tq, tid, kThreads);
    load_tile<HD>(dos, dout + head_row0 * HD, q0, tq, tid, kThreads);
    issue(0);
    async_commit();
    async_wait<0>();
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int off = G::at(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7), 2 * kk + (lane >> 4));
      ldmatrix_x4(qa[kk], qs + off);
      ldmatrix_x4(da[kk], dos + off);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, k0 = t * kTileN;
    if (t + 1 < n_tiles) issue(t + 1);  // its stage was freed by the barrier ending t - 1
    async_commit();
    const unsigned char* kt = kst + st * G::kTile;
    const unsigned char* vt = vst + st * G::kTile;

    // S = Q K^T and dP = dO V^T: 64 x 64 fp32, this thread's (row r_lo + 8
    // (i/2 % 2), key 8 (i/4) + cq + i%2) in s[i], dp[i].
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_m64n64k16<0>(s, qa[kk], smem_desc(kt + kk * 256, 128, G::kGroup), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_m64n64k16<0>(dp, da[kk], smem_desc(vt + kk * 256, 128, G::kGroup), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS, rounded to bf16, as the A operand of k-step kk (keys 16 kk ...):
    // the accumulator layout of S columns 16 kk .. 16 kk + 15.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int half = r & 1;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * r + e, col = 8 * (2 * kk + (r >> 1)) + cq + e;
          const bool ok = row_ok[half] && valid_s[st][col] != 0 &&
                          (!causal || k0 + col <= limit[half]);
          const float p = ok ? fast_exp2(s[i] * scale_log2 - lse2[half]) : 0.f;
          w[e] = p * (dp[i] - dlt[half]) * scale;
        }
        a[kk][r] = pack_bf16(w[0], w[1]);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HDP>(acc, a[kk], smem_desc(kt + kk * 2 * G::kGroup, G::kGroup, 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    async_wait<0>();  // tile t + 1 has landed ...
    fence_proxy_async();
    __syncthreads();  // ... everyone's copies; tile t is consumed, its stage free
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= q_rows) continue;
    __nv_bfloat16* row = dq + (head_row0 + q0 + r) * HD;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < HD)
        *reinterpret_cast<uint32_t*>(row + col) =
            pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// Barrier of one warpgroup's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(kDkvWarpgroups * kThreads, 1)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_valid,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int nq, int nkv, int tq, int tk,
                        int q_offset, int causal, int n_bkv, float scale, float scale_log2) {
  using G = BwdGeom<HD>;
  constexpr int HDP = G::kHdp, NO = HDP / 2, KS = HDP / 16;
  constexpr int kRing = 2 * kStages * G::kTile;  // one warpgroup's Q and dO stages
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float lse_s[kDkvWarpgroups][kStages][kTileN];
  __shared__ float delta_s[kDkvWarpgroups][kStages][kTileN];

  const int tid = threadIdx.x, wg = tid / kThreads, wtid = tid % kThreads;
  const int lane = tid & 31, warp = wtid >> 5;
  unsigned char* ks = smem;
  unsigned char* vs = ks + G::kTile;
  unsigned char* qst = vs + G::kTile + wg * kRing;  // this warpgroup's stages
  unsigned char* dost = qst + kStages * G::kTile;
  const int group = nq / nkv;
  const int bkv = blockIdx.x % n_bkv, k0 = blockIdx.x / n_bkv * kRows;  // first key tiles first
  const int b = bkv / nkv, kvh = bkv % nkv;
  const size_t kvrow0 = static_cast<size_t>(bkv) * tk;
  const size_t head0 = static_cast<size_t>(b * nq + kvh * group);  // the group's first q head
  // Query row i sees key k0 only if k0 <= q_offset + i: earlier tiles are skipped.
  const int n_qtiles = (tq + kTileN - 1) / kTileN;
  const int first_qt = causal ? min(n_qtiles, max(0, k0 - q_offset) / kTileN) : 0;
  const int per_head = n_qtiles - first_qt, n_iters = group * per_head;
  // Iteration it (head it / per_head, query tile first_qt + it % per_head)
  // belongs to warpgroup it % 2, as its (it / 2)-th.
  const int my_iters = n_iters > wg ? (n_iters - wg + 1) / kDkvWarpgroups : 0;
  zero_padding<HD, G::kDkvTiles>(smem);

  auto issue = [&](int it, int st) {  // by this warpgroup, into its stage st
    const int q0 = (first_qt + it % per_head) * kTileN;
    const size_t row0 = (head0 + it / per_head) * tq;
    load_tile<HD>(qst + st * G::kTile, q + row0 * HD, q0, tq, wtid, kThreads);
    load_tile<HD>(dost + st * G::kTile, dout + row0 * HD, q0, tq, wtid, kThreads);
    if (wtid < kTileN) {
      const bool in = q0 + wtid < tq;
      const size_t at = row0 + (in ? q0 + wtid : 0);
      async_copy<4>(&lse_s[wg][st][wtid], lse + at, in);
      async_copy<4>(&delta_s[wg][st][wtid], delta + at, in);
    }
  };

  load_tile<HD>(ks, k + kvrow0 * HD, k0, tk, tid, kDkvWarpgroups * kThreads);
  load_tile<HD>(vs, v + kvrow0 * HD, k0, tk, tid, kDkvWarpgroups * kThreads);
  if (my_iters > 0) issue(wg, 0);
  async_commit();

  // This thread's keys: rows r_lo and r_lo + 8 of the accumulator layout.
  const int r_lo = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    key[half] = k0 + r_lo + 8 * half;
    key_ok[half] = key[half] < tk && kv_valid[static_cast<size_t>(b) * tk + key[half]] != 0;
  }
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  for (int j = 0; j < my_iters; ++j) {
    const int it = wg + kDkvWarpgroups * j, st = j % kStages;
    const int q0 = (first_qt + it % per_head) * kTileN;
    // Its stage was freed by the barrier ending iteration j - 1.
    if (j + 1 < my_iters) issue(it + kDkvWarpgroups, (j + 1) % kStages);
    async_commit();
    const unsigned char* qt = qst + st * G::kTile;
    const unsigned char* dt = dost + st * G::kTile;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows, this thread's
    // (key r_lo + 8 (i/2 % 2), query 8 (i/4) + cq + i%2) in s[i], dp[i].
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_m64n64k16(s, smem_desc(ks + kk * 256, 128, G::kGroup),
                         smem_desc(qt + kk * 256, 128, G::kGroup), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_m64n64k16(dp, smem_desc(vs + kk * 256, 128, G::kGroup),
                         smem_desc(dt + kk * 256, 128, G::kGroup), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T, rounded to bf16, as A operands of k-step kk (query rows
    // 16 kk ...).
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int half = r & 1;
        float pw[2], dw[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * kk + 2 * r + e, col = 8 * (2 * kk + (r >> 1)) + cq + e;
          const int qi = q0 + col;
          const float l = lse_s[wg][st][col];
          const bool ok = key_ok[half] && qi < tq && l > 0.5f * kNegBig &&
                          (!causal || key[half] <= q_offset + qi);
          pw[e] = ok ? fast_exp2(s[i] * scale_log2 - l * kLog2e) : 0.f;
          dw[e] = pw[e] * (dp[i] - delta_s[wg][st][col]) * scale;
        }
        pa[kk][r] = pack_bf16(pw[0], pw[1]);
        dsa[kk][r] = pack_bf16(dw[0], dw[1]);
      }
    }
    fence_regs(dka);
    fence_regs(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HDP>(dva, pa[kk], smem_desc(dt + kk * 2 * G::kGroup, G::kGroup, 128));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HDP>(dka, dsa[kk], smem_desc(qt + kk * 2 * G::kGroup, G::kGroup, 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dka);
    fence_regs(dva);
    async_wait<0>();  // the next tile has landed ...
    fence_proxy_async();
    warpgroup_sync(wg);  // ... the warpgroup's copies; this tile is consumed, its stage free
  }

  // dK, dV = warpgroup 0's sums + warpgroup 1's, through warpgroup 1's stages
  // (exactly 2 * 64 * HDP fp32 values), each thread its own elements.
  float* part = reinterpret_cast<float*>(vs + G::kTile + kRing);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      part[i * kThreads + wtid] = dka[i];
      part[(NO + i) * kThreads + wtid] = dva[i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    dka[i] += part[i * kThreads + wtid];
    dva[i] += part[(NO + i) * kThreads + wtid];
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= tk) continue;
    __nv_bfloat16* dkr = dk + (kvrow0 + key[half]) * HD;
    __nv_bfloat16* dvr = dv + (kvrow0 + key[half]) * HD;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < HD) {
        *reinterpret_cast<uint32_t*>(dkr + col) =
            pack_bf16(dka[4 * j + 2 * half], dka[4 * j + 2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dvr + col) =
            pack_bf16(dva[4 * j + 2 * half], dva[4 * j + 2 * half + 1]);
      }
    }
  }
}

struct BwdTcArgs {
  const void *q, *k, *v, *dout;
  const int* kv_valid;
  const float *lse, *delta;
  void *dq, *dk, *dv;  // dq for the dq kernel, dk and dv for the dk/dv kernel
  int b, nq, nkv, tq, tk, q_offset, causal;
};

// Allow the dynamic shared memory: the 48 KB default counts the static
// arrays too, so the attribute is set for every head size.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch(const BwdTcArgs& a, bool want_dq, cudaStream_t s) {
  using G = BwdGeom<HD>;
  using bf16 = __nv_bfloat16;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  if (ptrs % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const double inv = 1.0 / sqrt(static_cast<double>(HD));
  const float scale = static_cast<float>(inv), scale_log2 = static_cast<float>(inv * 1.4426950408889634);
  const int n_bkv = a.b * a.nkv;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  if (want_dq) {
    const int n_qtiles = (a.tq + kRows - 1) / kRows;
    const long long blocks = static_cast<long long>(n_qtiles) * a.b * a.nq;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks == 0) return 0;
    constexpr int smem = G::kDqTiles * G::kTile;
    auto kernel = flash_bwd_dq_tc_kernel<HD>;
    if (int e = set_smem(kernel, smem)) return e;
    kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(
        q, k, v, a.kv_valid, a.lse, a.delta, dout, static_cast<bf16*>(a.dq), a.nq, a.nkv, a.tq,
        a.tk, a.q_offset, a.causal, n_qtiles, n_bkv, scale, scale_log2);
  } else {
    const long long blocks = static_cast<long long>((a.tk + kRows - 1) / kRows) * n_bkv;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks == 0) return 0;
    constexpr int smem = G::kDkvTiles * G::kTile;
    auto kernel = flash_bwd_dkv_tc_kernel<HD>;
    if (int e = set_smem(kernel, smem)) return e;
    kernel<<<static_cast<int>(blocks), kDkvWarpgroups * kThreads, smem, s>>>(
        q, k, v, a.kv_valid, a.lse, a.delta, dout, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.nq, a.nkv, a.tq, a.tk, a.q_offset, a.causal, n_bkv, scale,
        scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const BwdTcArgs& a, int hd, bool want_dq, void* stream) {
  if (a.nkv <= 0 || a.nq % a.nkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(a, want_dq, s);
    case 16: return launch<16>(a, want_dq, s);
    case 32: return launch<32>(a, want_dq, s);
    case 64: return launch<64>(a, want_dq, s);
    case 80: return launch<80>(a, want_dq, s);
    case 96: return launch<96>(a, want_dq, s);
    case 128: return launch<128>(a, want_dq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq [b, nq, tq, hd] bf16 from bf16 q, k, v, dout, the forward's lse and
// delta = rowsum(dO * O) (both [b * nq, tq] fp32).
extern "C" int l32_flash_attn_bwd_dq_tc(const void* q, const void* k, const void* v,
                                        const void* kv_valid, const void* lse, const void* delta,
                                        const void* dout, void* dq, int b, int nq, int nkv, int tq,
                                        int tk, int hd, int q_offset, int causal, void* stream) {
  const BwdTcArgs a{q, k, v, dout, static_cast<const int*>(kv_valid),
                    static_cast<const float*>(lse), static_cast<const float*>(delta), dq, nullptr,
                    nullptr, b, nq, nkv, tq, tk, q_offset, causal};
  return dispatch(a, hd, true, stream);
}

// dk, dv [b, nkv, tk, hd] bf16, summed over each kv head's group of q heads.
extern "C" int l32_flash_attn_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                         const void* kv_valid, const void* lse, const void* delta,
                                         const void* dout, void* dk, void* dv, int b, int nq,
                                         int nkv, int tq, int tk, int hd, int q_offset, int causal,
                                         void* stream) {
  const BwdTcArgs a{q, k, v, dout, static_cast<const int*>(kv_valid),
                    static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr, dk,
                    dv, b, nq, nkv, tq, tk, q_offset, causal};
  return dispatch(a, hd, false, stream);
}
