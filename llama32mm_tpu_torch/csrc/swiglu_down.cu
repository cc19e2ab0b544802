// SwiGLU + down projection for a few rows (decode):
//   out[r, h] = sum_i inter[r, i] * wd[h, i],
//   inter[r, i] = T(silu(sum_k x[r,k] wg[i,k]) * sum_k x[r,k] wu[i,k]),
// with x [R, H], w_gate and w_up [I, H] and w_down [H, I] (nn.Linear's
// layouts), fp32 accumulation, the intermediate rounded to x's type T before
// the down product, as the TPU kernel does.
//
// Replaces llama32mm_tpu/ops/pallas/swiglu.py::_down_kernel (via
// swiglu_down_pallas): the [R, I] intermediate never reaches device memory.
// The TPU kernel walks the I tiles in order and carries the [R, H] sum in a
// VMEM scratch across grid steps; blocks on the card run in no order, so each
// block owns one tile of BI intermediate columns, a cluster of 8 blocks (8
// adjacent tiles) sums its partial [R, H] products through distributed shared
// memory into an fp32 workspace [clusters, R, H], and a second kernel sums
// the clusters of each output in a fixed order (deterministic, no atomics).
//
// Bound on the H100: the bytes of the three weights, 3 H I sizeof(T) (bf16 at
// the 11B widths 352 MB, 0.1052 ms at 3.35 TB/s; fp32 0.2103 ms); every weight
// byte is read once whatever R is. At R <= 8 the products are 6 R H I
// operations: a few per weight byte.
//
// Tiles. BI (32, 64, 96 or 128 columns) comes from I alone
// (ops/cuda/swiglu.py::swiglu_down_tiles passes it in): the fewest 32-column
// spans a tile that keep the tile count at most 112, i.e. 14 clusters of 8
// blocks at one block an SM, as many as the H100 holds at once (16 took two
// waves: the 3B's 128 tiles ran in 0.0903 ms against 0.0704 at 86 tiles).
// I = 14336: 112 tiles of 128 columns; I = 8192: 86 of 96.
//
// bf16 (swiglu_down_tc_kernel, 16 warps). Phase 1 is the tensor-core SwiGLU
// rows kernel's swap-AB mma.sync m16n8k16 body (swiglu_rows.cuh::gate_up_tc):
// the tile's m16 tiles of intermediate columns are the M side, the <= 8 rows
// of x the N side; each m16 tile is split into fixed parts of H's 32-k spans
// so that every warp takes as many (m16 tile, part) items; the parts are
// summed in order in shared memory, silu(gate) * up is formed in fp32 and
// rounded once to bf16 into an [8, BI] shared tile (0 past I and R:
// 0 * NaN = NaN). Phase 2 is swap-AB too: 16 rows of w_down (h) are the M
// side, read K-major as stored (16 bytes a lane of each row's contiguous
// BI-column segment), the intermediate tile is the B fragment; each warp
// loads its first w_down rows before the barrier, and the next m16 tile's
// while it multiplies one.
//
// fp32 (swiglu_down_simt_kernel, 8 warps, no tensor cores: at R = 8 the
// 6 R H I operations take 20% of the byte time at 67 TFLOP/s). Phase 1 is the
// fp32 rows kernel's CUDA-core body (swiglu_rows.cuh::gate_up_simt: 4 columns
// a warp, x read once per 4 columns). Phase 2: a lane holds 4 intermediate
// columns of every row in registers and streams 8 w_down rows at a time, 16
// bytes a row (16 in flight), and reduce_scatter sums each batch of 4 rows'
// lane partials over the warp.
//
// The cluster sum. Phase 2 runs in chunks of w_down rows (1024 bf16, 512
// fp32: the fp32 phase 1 wants L1 for x); each block leaves its partials of a
// chunk in shared memory (double-buffered), the cluster synchronises, and
// rank q sums rows q/8 .. (q+1)/8 of the chunk over the 8 ranks in order
// (ld.shared::cluster) into the workspace. This was kept over one partial a
// tile in device memory, the design first built (profile_swiglu.py --down,
// device time, NVIDIA H100 80GB HBM3 at 700 W, H = 4096, I = 14336): at R = 8
// bf16 0.1356-0.1366 ms against 0.1532-0.1600 (the 14.7 MB each way of 112
// partials cost 12 us of the tile kernel's time), at R = 1 0.1247-0.1251
// against 0.1253-0.1254; the unfused pair (the tensor-core rows kernel, then
// the tensor-core gemv on w_down) 0.1243 / 0.1312-0.1317, so the fusion ties
// it at R = 1 and trails it by 3-4% at R = 8 (another call: 0.1269-0.1277 /
// 0.1375-0.1393 against the pair's 0.1267-0.1268 / 0.1333-0.1335). fp32:
// 0.2403 at R = 1, 0.2828-0.2832 at R = 8 (either design). The 3B widths
// (I = 8192) lose: 0.0704-0.0714 at 86 tiles against 0.0652 with a partial a
// tile at 128.
//
// Reduce (swiglu_down_reduce_kernel): 16 groups of 32 threads a block, a thread
// a 16-byte vector of outputs along H; group g sums clusters g, g + 16, .. in
// order, then the block sums the 16 groups in order.
//
// Every summation order is fixed by H and I, never by R: a row's bits do not
// depend on R or on its row block. More than 8 rows take more blocks along y.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "swiglu_rows.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;       // rows of x a block
constexpr int kMaxTile = 128;  // BI: at most 4 spans of 32 intermediate columns
constexpr int kSpans = kMaxTile / 32;
constexpr int kTcWarps = 16;   // bf16 blocks
constexpr int kSimtWarps = 8;  // fp32 blocks (about 190 registers a thread at 8 rows)
constexpr int kRedLd = kRows + 1;              // floats a column of phase-1 sums (padding)
constexpr int kItemFloats = 2 * 16 * kRedLd;   // gate and up sums of one item
constexpr int kDownBatch = 8;                  // w_down rows a lane loads at a time (fp32)
constexpr int kReduceGroups = 16;
constexpr int kCluster = 8;      // tiles a cluster: partials summed in DSMEM
constexpr int kTcChunk = 1024;   // w_down rows a phase-2 chunk (bf16)
constexpr int kSimtChunk = 512;  // (fp32: a smaller one leaves L1 to x)

// Floats a row of a chunk's partials (a bank shift a row), and two chunks'
// partials (double-buffered).
template <int CHUNK> __host__ __device__ constexpr int ps_ld() { return CHUNK + 4; }
template <int CHUNK> __host__ __device__ constexpr int ps_floats() {
  return 2 * kRows * ps_ld<CHUNK>();
}

// Four floats of the block of cluster rank `cta` at the shared address of p.
__device__ __forceinline__ float4 ld_dsmem4(const float* p, uint32_t cta) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(cta));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Once every block of the cluster has its partials of chunk c in buf
// ([kRows][ps_ld]): this rank's CHUNK / kCluster rows of the chunk, summed
// over the ranks (the cluster's tiles) in order, 4 rows of w_down a thread,
// into part[cluster, r0 + r, ...].
template <int CHUNK>
__device__ __forceinline__ void cluster_sum_chunk(const float* buf, float* __restrict__ part,
                                                  int rows, int r0, int nr, int h, int c) {
  constexpr int kSlice = CHUNK / kCluster, kQuads = kSlice / 4, kPsLd = ps_ld<CHUNK>();
  const uint32_t rank = cluster_ctarank();
  const int cl = blockIdx.x / kCluster;
  for (int e = threadIdx.x; e < kRows * kQuads; e += blockDim.x) {
    const int r = e / kQuads, hl = rank * kSlice + 4 * (e % kQuads), hh = c * CHUNK + hl;
    if (r >= nr || hh >= h) continue;
    float4 sum = ld_dsmem4(buf + r * kPsLd + hl, 0);
#pragma unroll
    for (uint32_t j = 1; j < kCluster; ++j) {
      const float4 v = ld_dsmem4(buf + r * kPsLd + hl, j);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    float* dst = part + (static_cast<size_t>(cl) * rows + r0 + r) * h + hh;
    if (h % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = sum;
    } else {
      dst[0] = sum.x;
      if (hh + 1 < h) dst[1] = sum.y;
      if (hh + 2 < h) dst[2] = sum.z;
      if (hh + 3 < h) dst[3] = sum.w;
    }
  }
}

// The parts of H each m16 tile of a BI-column tile is split into: the fewest
// that make the (m16 tile, part) items a multiple of the warps (every warp
// the same number of items).
__host__ __device__ inline int tc_parts(int bi) {
  int a = bi / 16, b = kTcWarps;
  while (b) {  // gcd
    const int r = a % b;
    a = b;
    b = r;
  }
  return kTcWarps / a;
}

// Phase 2's A fragments (bf16): w_down rows 16 hm + gid and + 8, 16 bytes at
// columns i0 + 32 s + 8t of each span s < sb; zeros past H and I, or when !ok.
template <bool kVecI>
__device__ __forceinline__ void load_down(uint4 (&a)[kSpans][2], const bf16* __restrict__ wd,
                                          int hm, int h, int inter, int i0, int sb, bool ok) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 16 * hm + 8 * hh + gid;
    const bool in = ok && row < h;
    const bf16* p = wd + static_cast<size_t>(in ? row : 0) * inter;
#pragma unroll
    for (int s = 0; s < kSpans; ++s)
      a[s][hh] = load8<kVecI, true>(p, i0 + 32 * s + 8 * t, inter, in && s < sb);
  }
}

template <bool kVecH, bool kVecI>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kTcWarps * 32, 1)
swiglu_down_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                      float* __restrict__ part, int rows, int h, int inter, int bi) {
  extern __shared__ float4 smem_f4[];
  const int mt = bi / 16, ks = tc_parts(bi), items = mt * ks;
  float* red = reinterpret_cast<float*>(smem_f4);  // [items][gate, up][16][kRedLd]
  bf16* inter_s = reinterpret_cast<bf16*>(red + items * kItemFloats);  // [kRows][bi + 8]
  const int lds = bi + 8;  // 16-byte-aligned rows
  float* ps = reinterpret_cast<float*>(inter_s + kRows * lds);  // [2][kRows][kPsLd]
  constexpr int kChunk = kTcChunk, kPsLd = ps_ld<kChunk>();
  const int i0 = blockIdx.x * bi;
  const int r0 = blockIdx.y * kRows, nr = min(kRows, rows - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, t = lane & 3;
  const bf16* xb = x + static_cast<size_t>(r0) * h;
  const int spans = (h + 31) / 32, sb = bi / 32, hmc = (h + 15) / 16;

  // Phase 1: item it is m16 tile it % mt over part it / mt of H's spans.
  for (int it = warp; it < items; it += kTcWarps) {
    const int m = it % mt, p = it / mt;
    float accg[4] = {0.f, 0.f, 0.f, 0.f}, accu[4] = {0.f, 0.f, 0.f, 0.f};
    gate_up_tc<kVecH>(xb, wg, wu, nr, h, inter, i0 + 16 * m, p * spans / ks,
                      (p + 1) * spans / ks, accg, accu);
    float* rg = red + it * kItemFloats;
    // C element i of a lane: column gid + 8 (i / 2), x row 2t + i % 2.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rg[(gid + 8 * (i >> 1)) * kRedLd + 2 * t + (i & 1)] = accg[i];
      rg[(16 + gid + 8 * (i >> 1)) * kRedLd + 2 * t + (i & 1)] = accu[i];
    }
  }
  uint4 a[kSpans][2];  // this warp's first w_down rows: they do not wait for phase 1
  load_down<kVecI>(a, wd, warp, h, inter, i0, sb, warp < hmc);
  __syncthreads();

  for (int e = threadIdx.x; e < kRows * bi; e += kTcWarps * 32) {
    const int r = e / bi, j = e % bi;
    float v = 0.f;
    if (r < nr && i0 + j < inter) {
      const float* rg = red + (j / 16) * kItemFloats + (j % 16) * kRedLd + r;
      float g = rg[0], u = rg[16 * kRedLd];
      for (int p = 1; p < ks; ++p) {
        g += rg[p * mt * kItemFloats];
        u += rg[p * mt * kItemFloats + 16 * kRedLd];
      }
      v = silu(g) * u;
    }
    inter_s[r * lds + j] = __float2bfloat16(v);
  }
  __syncthreads();

  // Phase 2: the tile's partial sum_j inter_s[r][j] wd[hh, i0 + j] of a
  // chunk of w_down rows into ps, an m16 tile of rows a warp at a time (B
  // column gid is x row gid), then the cluster's sum of the chunk.
  uint4 b[kSpans];
#pragma unroll
  for (int s = 0; s < kSpans; ++s)
    b[s] = s < sb ? *reinterpret_cast<const uint4*>(inter_s + gid * lds + 32 * s + 8 * t)
                  : make_uint4(0u, 0u, 0u, 0u);
  constexpr int kMt = kChunk / 16;  // m16 tiles a chunk
  for (int c = 0; c * kChunk < h; ++c) {
    float* buf = ps + (c & 1) * kRows * kPsLd;
    for (int m = warp; m < kMt; m += kTcWarps) {
      // the next m16 tile of this warp: in this chunk, else its first of the next
      const int hn = m + kTcWarps < kMt ? c * kMt + m + kTcWarps : (c + 1) * kMt + warp;
      uint4 next[kSpans][2];
      load_down<kVecI>(next, wd, hn, h, inter, i0, sb, hn < hmc);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kSpans; ++s)
        if (s < sb) mma_span(acc, a[s][0], a[s][1], b[s]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        buf[(2 * t + (i & 1)) * kPsLd + 16 * m + gid + 8 * (i >> 1)] = acc[i];
#pragma unroll
      for (int s = 0; s < kSpans; ++s) {
        a[s][0] = next[s][0];
        a[s][1] = next[s][1];
      }
    }
    cluster_sync();  // every rank's partials of chunk c are in place (and c - 1's are read)
    cluster_sum_chunk<kChunk>(buf, part, rows, r0, nr, h, c);
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// Phase 2's w_down rows hb .. hb + kDownBatch - 1 (fp32): 4 columns at i0 + j0
// of each, zeros past H and I, or for a lane with no columns (j0 >= BI).
template <bool kVecI>
__device__ __forceinline__ void load_down_f32(float4 (&w)[kDownBatch], const float* __restrict__ wd,
                                              int hb, int h, int inter, int i0, int j0, bool lin) {
  const int c = i0 + j0;
#pragma unroll
  for (int j = 0; j < kDownBatch; ++j) {
    const int row = hb + j;
    const bool in = lin && row < h;
    const float* p = wd + static_cast<size_t>(in ? row : 0) * inter + c;
    if constexpr (kVecI) {
      const uint4 v = in && c < inter ? load_stream16(p) : make_uint4(0u, 0u, 0u, 0u);
      w[j] = make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                         __uint_as_float(v.w));
    } else {
      w[j] = make_float4(in && c < inter ? p[0] : 0.f, in && c + 1 < inter ? p[1] : 0.f,
                         in && c + 2 < inter ? p[2] : 0.f, in && c + 3 < inter ? p[3] : 0.f);
    }
  }
}

template <int MAXR, bool kVecH, bool kVecI>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kSimtWarps * 32)
swiglu_down_simt_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                        const float* __restrict__ wu, const float* __restrict__ wd,
                        float* __restrict__ part, int rows, int h, int inter, int bi) {
  constexpr int NV = kSimtCols * MAXR;  // a lane's sums: 4 columns (or w_down rows) x MAXR rows
  __shared__ float inter_s[kRows][kMaxTile];
  extern __shared__ float4 smem_f4[];
  float* ps = reinterpret_cast<float*>(smem_f4);  // [2][kRows][kPsLd]
  constexpr int kChunk = kSimtChunk, kPsLd = ps_ld<kChunk>();
  const int i0 = blockIdx.x * bi;
  const int r0 = blockIdx.y * kRows, nr = min(kRows, rows - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xb = x + static_cast<size_t>(r0) * h;

  // Phase 1: groups of kSimtCols columns, a warp each; lane r * 4 + c ends
  // with column c of row r.
  for (int grp = warp; grp < bi / kSimtCols; grp += kSimtWarps) {
    const int col0 = i0 + grp * kSimtCols;
    float g[NV], u[NV];
    gate_up_simt<float, MAXR, kVecH>(xb, wg, wu, nr, h, inter, col0, g, u);
    const float gs = reduce_scatter<NV>(g), us = reduce_scatter<NV>(u);
    const int r = (lane % NV) / kSimtCols, c = lane % kSimtCols;
    if (lane < NV) inter_s[r][grp * kSimtCols + c] = r < nr && col0 + c < inter ? silu(gs) * us : 0.f;
  }
  // This lane's 4 columns of the tile (none where j0 >= BI), and its first
  // w_down rows: they do not wait for phase 1.
  const int j0 = 4 * lane;
  const bool lin = j0 < bi;
  float4 w[kDownBatch];
  load_down_f32<kVecI>(w, wd, warp * kDownBatch, h, inter, i0, j0, lin);
  __syncthreads();
  float iv[MAXR][4];
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) iv[r][e] = lin ? inter_s[r][j0 + e] : 0.f;

  // Phase 2: the tile's partials of a chunk of w_down rows into ps, a batch of
  // kDownBatch rows a warp at a time, summed over the lanes in halves of 4
  // rows (lane r * 4 + j ends with row 4 half + j of the batch, x row r);
  // then the cluster's sum of the chunk.
  constexpr int kBatches = kChunk / kDownBatch;  // a chunk's batches
  for (int c = 0; c * kChunk < h; ++c) {
    float* buf = ps + (c & 1) * kRows * kPsLd;
    for (int bt = warp; bt < kBatches; bt += kSimtWarps) {
      // the next batch of this warp: in this chunk, else its first of the next
      const int hn = bt + kSimtWarps < kBatches ? c * kChunk + (bt + kSimtWarps) * kDownBatch
                                                : (c + 1) * kChunk + warp * kDownBatch;
      float4 next[kDownBatch];
      load_down_f32<kVecI>(next, wd, hn, h, inter, i0, j0, lin && hn < h);
#pragma unroll
      for (int half = 0; half < kDownBatch / 4; ++half) {
        float v[NV];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wv = w[4 * half + j];
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            float p = 0.f;
            p = fmaf(iv[r][0], wv.x, p);
            p = fmaf(iv[r][1], wv.y, p);
            p = fmaf(iv[r][2], wv.z, p);
            p = fmaf(iv[r][3], wv.w, p);
            v[r * 4 + j] = p;
          }
        }
        const float sum = reduce_scatter<NV>(v);
        if (lane < NV)
          buf[(lane / 4) * kPsLd + bt * kDownBatch + 4 * half + lane % 4] = sum;
      }
#pragma unroll
      for (int j = 0; j < kDownBatch; ++j) w[j] = next[j];
    }
    cluster_sync();  // every rank's partials of chunk c are in place (and c - 1's are read)
    cluster_sum_chunk<kChunk>(buf, part, rows, r0, nr, h, c);
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// out[e] = sum over clusters of part[t, e], e = r * H + h: group g of a block
// sums clusters g, g + kReduceGroups, .. in order, then the block sums the
// groups in order; a thread a 16-byte vector of 4 outputs (kVec: H % 4 == 0)
// or one.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kReduceGroups * 32)
swiglu_down_reduce_kernel(const float* __restrict__ part, T* __restrict__ out, int n_tiles,
                          int rh) {
  constexpr int V = kVec ? 4 : 1;
  __shared__ float4 sums[kReduceGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int e = (blockIdx.x * 32 + lane) * V;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < rh) {
#pragma unroll 4
    for (int t = grp; t < n_tiles; t += kReduceGroups) {
      const float* p = part + static_cast<size_t>(t) * rh + e;
      if constexpr (kVec) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      } else {
        s.x += *p;
      }
    }
  }
  sums[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || e >= rh) return;
  float4 tot = sums[0][lane];
#pragma unroll
  for (int g = 1; g < kReduceGroups; ++g) {
    const float4 v = sums[g][lane];
    tot.x += v.x;
    tot.y += v.y;
    tot.z += v.z;
    tot.w += v.w;
  }
  out[e] = from_f32<T>(tot.x);
  if (kVec) {
    out[e + 1] = from_f32<T>(tot.y);
    out[e + 2] = from_f32<T>(tot.z);
    out[e + 3] = from_f32<T>(tot.w);
  }
}

int launch_tc(const void* x, const void* wg, const void* wu, const void* wd, float* part,
              int rows, int h, int inter, int bi, dim3 grid, cudaStream_t s) {
  const bool vec_h = h % 8 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  const bool vec_i = inter % 8 == 0 && aligned16(wd);
  auto kernel = vec_h ? (vec_i ? swiglu_down_tc_kernel<true, true>
                               : swiglu_down_tc_kernel<true, false>)
                      : (vec_i ? swiglu_down_tc_kernel<false, true>
                               : swiglu_down_tc_kernel<false, false>);
  const int smem =
      (bi / 16) * tc_parts(bi) * kItemFloats * 4 + kRows * (bi + 8) * 2 + ps_floats<kTcChunk>() * 4;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kTcWarps * 32, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<const bf16*>(wd), part, rows, h, inter, bi);
  return 0;
}

template <int MAXR>
int launch_simt_r(const void* x, const void* wg, const void* wu, const void* wd, float* part,
                   int rows, int h, int inter, int bi, dim3 grid, cudaStream_t s) {
  const bool vec_h = h % 4 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  const bool vec_i = inter % 4 == 0 && aligned16(wd);
  constexpr int kSmem = ps_floats<kSimtChunk>() * 4;
  auto kernel = vec_h ? (vec_i ? swiglu_down_simt_kernel<MAXR, true, true>
                               : swiglu_down_simt_kernel<MAXR, true, false>)
                      : (vec_i ? swiglu_down_simt_kernel<MAXR, false, true>
                               : swiglu_down_simt_kernel<MAXR, false, false>);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kSimtWarps * 32, kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<const float*>(wd), part, rows, h, inter, bi);
  return 0;
}

// The smallest instantiation that holds a block's rows (registers: the sums).
int launch_simt(const void* x, const void* wg, const void* wu, const void* wd, float* part,
                int rows, int h, int inter, int bi, dim3 grid, cudaStream_t s) {
  if (rows <= 1) return launch_simt_r<1>(x, wg, wu, wd, part, rows, h, inter, bi, grid, s);
  if (rows <= 2) return launch_simt_r<2>(x, wg, wu, wd, part, rows, h, inter, bi, grid, s);
  if (rows <= 4) return launch_simt_r<4>(x, wg, wu, wd, part, rows, h, inter, bi, grid, s);
  return launch_simt_r<kRows>(x, wg, wu, wd, part, rows, h, inter, bi, grid, s);
}

template <typename T>
void launch_reduce(const float* part, void* out, int n_tiles, int rh, bool vec, cudaStream_t s) {
  const int threads = vec ? rh / 4 : rh;
  const int blocks = (threads + 31) / 32;
  if (vec)
    swiglu_down_reduce_kernel<T, true><<<blocks, kReduceGroups * 32, 0, s>>>(
        part, static_cast<T*>(out), n_tiles, rh);
  else
    swiglu_down_reduce_kernel<T, false><<<blocks, kReduceGroups * 32, 0, s>>>(
        part, static_cast<T*>(out), n_tiles, rh);
}

}  // namespace

// tile: the intermediate columns a block owns (a multiple of 32, at most 128;
// ops/cuda/swiglu.py::swiglu_down_tiles); part: an fp32 workspace of
// ceil(ceil(inter / tile) / 8) * rows * h floats (a partial a cluster).
extern "C" int l32_swiglu_down(const void* x, const void* wg, const void* wu, const void* wd,
                               void* part, void* out, int rows, int h, int inter, int tile,
                               int dtype, void* stream) {
  if (rows == 0 || h == 0) return 0;
  if (inter <= 0 || tile < 32 || tile > kMaxTile || tile % 32 != 0 || rows > 65535 * kRows ||
      static_cast<long long>(rows) * h > INT_MAX - 3)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const int clusters = ((inter + tile - 1) / tile + kCluster - 1) / kCluster, rh = rows * h;
  const dim3 grid(clusters * kCluster, (rows + kRows - 1) / kRows);
  int err;
  if (dtype == L32_BF16) {
    err = launch_tc(x, wg, wu, wd, p, rows, h, inter, tile, grid, s);
    if (!err) launch_reduce<bf16>(p, out, clusters, rh, h % 4 == 0, s);
  } else if (dtype == L32_F32) {
    err = launch_simt(x, wg, wu, wd, p, rows, h, inter, tile, grid, s);
    if (!err) launch_reduce<float>(p, out, clusters, rh, h % 4 == 0, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
