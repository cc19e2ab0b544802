// Fused SwiGLU forward: out[r, i] = silu(sum_h x[r,h] wg[i,h]) * sum_h x[r,h] wu[i,h]
// with x [R, H] and both weights stored [I, H] (nn.Linear's layout).
//
// Replaces the TPU kernel llama32mm_tpu/ops/pallas/swiglu.py::_fwd_kernel
// (via _swiglu_fwd_call / _swiglu_grid_call): both products accumulate in
// fp32 inside the kernel and only silu(gate) * up is written; the [R, I]
// gate and up never reach device memory.
//
// Bound on the H100: at prefill (R = 1632, H = 4096, I = 14336) tensor-core
// FLOPs (~383 GFLOP per layer against ~235 MB of weights: 0.3876 ms); at
// decode (R = 1) the bytes of the two weights. l32_swiglu_fwd routes by
// shape (pick), never by failure:
//
// 1. The TMA tile (tma::swiglu_tma_kernel) takes bf16 x with H a multiple
//    of 64, 16-byte-aligned x and weights and more than 8 rows: every
//    prefill and training call of the 11B and 3B models. A dual-B GEMM: a
//    block owns 128 rows of x and 128 intermediate columns; two consumer
//    warpgroups (64 rows each) issue wgmma m64n128k16 twice a k16 step,
//    once on the gate tile and once on the up tile, into fp32 accumulators
//    of one layout (128 registers a thread); silu(gate) * up is formed in
//    registers and rounded once. A producer warp keeps a 4-stage ring of
//    64-k tiles (x, gate, up: 48 KB a stage) filled by TMA in wgmma's
//    128-byte swizzle, guarded by full/empty mbarriers (csrc/tma.cuh), so
//    the consumers spend no issue slots on copies. Two blocks on adjacent
//    row tiles form a cluster: one copies the gate tile and the other the
//    up tile, each multicast to both, which halves the weight bytes a block
//    reads from L2 (PR 9's cp.async wgmma GEMM was bound by that traffic).
//    Ragged R and I read as zeros (TMA) and are bounds-checked at the
//    write. No split-K, a k order fixed by H and tiles fixed by I: a row's
//    bits never depend on R or on its row tile, so a server's prefill equals
//    a solo engine's.
//    Measured (profile_swiglu.py, device time, NVIDIA H100 80GB HBM3 at
//    700 W, R = 1632): 11B forward 0.594 ms (two cuBLAS GEMMs 0.589, the
//    plain version 0.950, the wmma tile 2.550), 3B forward 0.267, 3B
//    backward 0.331 (plain 0.889). The products alone run the 11B forward
//    in 0.57-0.62 ms and the copies alone in 0.55-0.60: the tile runs at
//    the issue rate of its two warpgroups, with no overlap of one tile's
//    epilogue and the next one's loads (a persistent grid would add it). At
//    this speed the multicast gains nothing (0.606 ms without a cluster).
// 2. With at most 8 rows (decode), bf16 x with H a multiple of 32 and
//    16-byte-aligned x and weights take the tensor-core rows kernel
//    (swiglu_rows_tc_kernel): gemv.cu's swap-AB mma.sync m16n8k16 form with
//    two A streams (swiglu_rows.cuh::gate_up_tc, shared with the SwiGLU +
//    down fusion). 16 intermediate columns of gate and of up are the M side
//    of two products and the <= 8 rows of x the N side, so a lane's x
//    fragment feeds four products and x is read once per 16 columns.
//    16-byte weight loads with the L2::256B hint, 4 spans in flight a lane
//    (108 registers, no spills; 2 spans lost 3% at R = 1), warps from
//    tc_warps (8 at I = 14336) taking fixed spans of H, gate and up summed in
//    warp order in shared memory, silu(gate) * up in fp32, one rounding: a
//    row's bits never depend on R.
//    Measured (profile_swiglu.py --rows, device time, NVIDIA H100 80GB HBM3
//    at 700 W, H = 4096, I = 14336): 0.0848 ms at R = 8 (the plain version
//    0.1027, two F.linear 0.0837, bound 0.0702), 0.0813 at R = 1.
//    Other calls of at most 8 rows (fp32, ragged H, misaligned pointers)
//    take the rows kernel (swiglu_rows_kernel) on the CUDA cores: a warp owns
//    4 intermediate columns of gate and of up (swiglu_rows.cuh::
//    gate_up_simt) and streams their 8 weight rows with 16-byte loads (the
//    next span's in flight during this one's products), reading each row of
//    x once a span for all 8 (it replaced a kernel that gave each column its
//    own warp, which re-read x for every column: at R = 8 and the fp32 11B
//    widths 1.88 GB of x through L1/L2 against 470 MB of weights). At R = 8,
//    fp32, 2 R H I FMAs are 20% of the weights' byte time at 67 TFLOP/s: no
//    tensor cores. The partial sums are reduce-scattered over the warp, so
//    each lane writes one output.
//    Measured (profile_swiglu.py --rows --fp32, device time, NVIDIA H100 80GB
//    HBM3 at 700 W, fp32, H = 4096, I = 14336, bound 0.1402 ms): 0.1526-0.1577
//    ms at R = 1, 0.1540-0.1598 at R = 2, 0.1716-0.1755 at R = 5, 0.1943-0.1980
//    at R = 8 (the replaced kernel 0.1531-0.1579 / 0.1558-0.1629 /
//    0.2320-0.2434 / 0.2823-0.2917; two fp32 F.linear 0.1624-0.1685 /
//    0.1919-0.2006 / 0.2023-0.2055 / 0.2868-0.2894). At R = 8 a lane's 64
//    sums and two spans of weights take 151 registers, 12 warps an SM: the
//    loads in flight do not cover the products (2 R H I FMAs, 28 us at the
//    CUDA cores' peak). Tried and slower: L2 prefetches of later spans (254
//    registers), a per-warp cp.async ring (0.45 ms), 128 registers (spills).
// 3. Other bf16 shapes (ragged H, misaligned pointers) take the wmma tile
//    (swiglu_bf16_kernel): a 128 x 64 output tile, eight warps (4 x 2, 32 x
//    32 each) of bf16 16x16x16 mma.sync (nvcuda::wmma) into fp32
//    accumulators for gate and up, 32-wide K slices of x and both weights
//    staged through a two-deep cp.async ring, silu(g) * u through shared
//    memory to one rounded write per element; ragged R, H and I zero-filled
//    at staging, an H that is not a multiple of 8 staged with plain loads.
// 4. fp32 inputs with more rows take the fp32 tile (tf32::swiglu_tf32_kernel):
//    the wmma tile's dual-B GEMM (a 128 x 64 output tile, eight warps of 32 x
//    32) on mma.sync m16n8k8 TF32, every fp32 product as three TF32 products
//    (tf32.cuh). Bound by operations: at R = 1632, H = 4096, I = 14336 the
//    383 GFLOP take 2.325 ms as three TF32 products at 494.7 TFLOP/s, 5.72 ms
//    on the CUDA cores. Both operands are K-major as stored, so x and both
//    weights are staged as they are: 64-k stages of fp32 rows of 68 floats
//    (conflict-free fragment loads) in a three-stage 16-byte cp.async ring
//    (plain zero-filling loads where H % 4 != 0 or a pointer is not 16-byte
//    aligned). A k8 step splits each x fragment once for both weights and
//    each weight fragment once for both of a warp's row tiles. The tensor
//    cores round their accumulation toward zero, so each stage's 64 k go
//    into fresh registers (24 mma adds a chain) and are added to the running
//    fp32 sums: a one-chain 3xTF32 product over H = 4096 errs by ~7e-5 of
//    the output, the staged one by ~1.4e-6 (a CPU emulation against fp64;
//    32-k stages ~6e-7 ran 16% slower, a block barrier every 192 mma a warp).
//    128 sums a thread (running and stage; 195 registers, no spill), one
//    block an SM, silu(gate) * up or the backward's epilogue in fp32 from
//    registers, one write an output.
//
// Backward (l32_swiglu_bwd). Replaces llama32mm_tpu/ops/pallas/swiglu.py::
// _bwd_kernel: with g the output's cotangent, it recomputes gate and up with
// fp32 accumulators and writes d_gate = silu'(gate) * g * up and
// d_up = g * silu(gate), silu'(x) = s (1 + x (1 - s)), s = sigmoid(x), in x's
// type; gate and up never reach device memory. It is the forward's body with
// another epilogue (the kBwd template parameter of the TMA tile, the wmma
// tile and the fp32 tile), routed as the forward above 8 rows (pick), and at
// 8 or fewer to the wmma tile (bf16) or the fp32 tile. The TMA and fp32 tiles
// read g at each accumulator's (row, column) from device memory, in pairs
// where g's pointer allows and one element at a time where it does not (a
// contiguous view may start at an odd element); the wmma tile stages the g
// tile through shared memory into fragments of the accumulators' layout.
// Bound as the forward at R = 1632 (tensor-core FLOPs). dx = d_gate @ w_gate
// + d_up @ w_up and the weight gradients are cuBLAS GEMMs in the wrapper's
// autograd function.
#include <limits.h>
#include <mma.h>

#include "common.cuh"
#include "swiglu_rows.cuh"
#include "tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int LDS = BK + 8;    // bf16 per staged row: 80 bytes, padding vs bank conflicts
constexpr int LDC = BN + 4;    // floats per epilogue row
constexpr int kThreads = 256;  // 8 warps, 4 x 2 over the 128 x 64 tile

constexpr int kStageElems = (BM + 2 * BN) * LDS;       // x, gate and up slices
constexpr int kRingBytes = 2 * kStageElems * 2;        // two stages of bf16
constexpr int kEpilogueBytes = BM * LDC * 4;
constexpr int kSmemBytes = kRingBytes > kEpilogueBytes ? kRingBytes : kEpilogueBytes;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory limit");

// The backward epilogue on one (gate, up, g) triple: d_gate, d_up.
__device__ __forceinline__ void swiglu_grad(float gate, float up, float g, float& d_gate,
                                            float& d_up) {
  const float s = 1.f / (1.f + expf(-gate));
  d_gate = s * (1.f + gate * (1.f - s)) * g * up;
  d_up = g * (gate * s);
}

// Stage a [ROWS, 32] slice of a row-major [rows_total, h] matrix starting at
// (row0, k0), zero-filling everything outside the matrix.
template <int ROWS, bool kVec>
__device__ __forceinline__ void stage_slice(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int row0, int rows_total, int k0, int h) {
  if (kVec) {
    for (int v = threadIdx.x; v < ROWS * (BK / 8); v += kThreads) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const bool in = row0 + r < rows_total && k0 + c < h;
      async_copy<16>(dst + r * LDS + c,
                     in ? src + static_cast<size_t>(row0 + r) * h + k0 + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      dst[r * LDS + c] = (gr < rows_total && gc < h) ? src[static_cast<size_t>(gr) * h + gc]
                                                     : __float2bfloat16(0.f);
    }
  }
}

// kBwd false: out = silu(gate) * up. kBwd true: gin is the cotangent g,
// out = d_gate and out2 = d_up.
template <bool kVec, bool kBwd>
__global__ void __launch_bounds__(kThreads)
swiglu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                   const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ gin,
                   __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ out2,
                   int rows, int h, int inter) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto stage = [&](int buf, int k0) {
    __nv_bfloat16* xs = ring + buf * kStageElems;
    stage_slice<BM, kVec>(xs, x, m0, rows, k0, h);
    stage_slice<BN, kVec>(xs + BM * LDS, wg, n0, inter, k0, h);
    stage_slice<BN, kVec>(xs + (BM + BN) * LDS, wu, n0, inter, k0, h);
    async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accg[2][2], accu[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(accg[i][j], 0.f);
      wmma::fill_fragment(accu[i][j], 0.f);
    }

  const int nk = (h + BK - 1) / BK;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * BK);  // overwrites the slice consumed last iteration
      async_wait<1>();                     // slice kt has landed, kt + 1 may be in flight
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xs = ring + (kt & 1) * kStageElems;
    const __nv_bfloat16* gs = xs + BM * LDS;
    const __nv_bfloat16* us = gs + BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bg, bu;
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the [I, H] weight slice read column-major is the [H, I] B operand
        wmma::load_matrix_sync(bg, gs + (wn + j * 16) * LDS + kk, LDS);
        wmma::load_matrix_sync(bu, us + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(accg[i][j], a[i], bg, accg[i][j]);
          wmma::mma_sync(accu[i][j], a[i], bu, accu[i][j]);
        }
      }
    }
    __syncthreads();  // the next iteration's stage() overwrites this buffer
  }

  // Epilogue, through shared memory (reusing the ring) to one write per
  // element. Forward: silu(g) * u in registers (both fragments have one
  // layout). Backward: the g tile is staged as fp32 and read back into
  // fragments of that same layout, then d_gate replaces gate and d_up up.
  float* cs = reinterpret_cast<float*>(smem);
  auto write_tile = [&](__nv_bfloat16* dst) {  // cs -> dst, bounds-checked
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = m0 + r, gc = n0 + c;
      if (gr < rows && gc < inter)
        dst[static_cast<size_t>(gr) * inter + gc] = __float2bfloat16(cs[r * LDC + c]);
    }
  };
  if (kBwd) {
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = m0 + r, gc = n0 + c;
      cs[r * LDC + c] = (gr < rows && gc < inter)
                            ? __bfloat162float(gin[static_cast<size_t>(gr) * inter + gc])
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> gf;
        wmma::load_matrix_sync(gf, cs + (wm + i * 16) * LDC + wn + j * 16, LDC,
                               wmma::mem_row_major);
#pragma unroll
        for (int t = 0; t < gf.num_elements; ++t)
          swiglu_grad(accg[i][j].x[t], accu[i][j].x[t], gf.x[t], accg[i][j].x[t],
                      accu[i][j].x[t]);
      }
    __syncthreads();  // every warp has read its g fragments
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < accg[i][j].num_elements; ++t)
          accg[i][j].x[t] = silu(accg[i][j].x[t]) * accu[i][j].x[t];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * LDC + wn + j * 16, accg[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  write_tile(out);
  if (kBwd) {
    __syncthreads();  // cs is read out
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm + i * 16) * LDC + wn + j * 16, accu[i][j], LDC,
                                wmma::mem_row_major);
    __syncthreads();
    write_tile(out2);
  }
}

constexpr int kSmallRows = 8;

// ---------------------------------------------------------------------------
// The rows kernel: at most 8 rows of fp32, or of bf16 that the tensor-core
// rows kernel does not take (H not a multiple of 32, misaligned pointers).
// ---------------------------------------------------------------------------
constexpr int kRowWarps = 4;  // warps a block

// A warp owns kSimtCols intermediate columns of gate and of up
// (swiglu_rows.cuh::gate_up_simt): its lanes read x once a span for all of
// them, then the 2 x kSimtCols x MAXR partial sums are reduce-scattered, so
// lane r * kSimtCols + c ends with column c of row r and writes
// silu(gate) * up, formed in fp32 and rounded once.
template <typename T, int MAXR, bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
swiglu_rows_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
                   T* __restrict__ out, int rows, int h, int inter) {
  constexpr int NV = kSimtCols * MAXR;
  const int lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * kSimtCols;
  if (col0 >= inter) return;
  float g[NV], u[NV];
  gate_up_simt<T, MAXR, kVec>(x, wg, wu, rows, h, inter, col0, g, u);
  const float gs = reduce_scatter<NV>(g), us = reduce_scatter<NV>(u);
  const int r = (lane % NV) / kSimtCols, col = col0 + lane % kSimtCols;
  if (lane < NV && r < rows && col < inter)
    out[static_cast<size_t>(r) * inter + col] = from_f32<T>(silu(gs) * us);
}

template <typename T, int MAXR>
void launch_rows_r(const void* x, const void* wg, const void* wu, void* out, int rows, int h,
                   int inter, cudaStream_t s) {
  const bool vec = h % Vec16<T>::N == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  auto kernel = vec ? swiglu_rows_kernel<T, MAXR, true> : swiglu_rows_kernel<T, MAXR, false>;
  constexpr int kCols = kRowWarps * kSimtCols;
  kernel<<<(inter + kCols - 1) / kCols, kRowWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(out), rows, h, inter);
}

// The smallest instantiation that holds the rows (registers: the sums).
template <typename T>
void launch_rows(const void* x, const void* wg, const void* wu, void* out, int rows, int h,
                 int inter, cudaStream_t s) {
  if (rows <= 1) launch_rows_r<T, 1>(x, wg, wu, out, rows, h, inter, s);
  else if (rows <= 2) launch_rows_r<T, 2>(x, wg, wu, out, rows, h, inter, s);
  else if (rows <= 4) launch_rows_r<T, 4>(x, wg, wu, out, rows, h, inter, s);
  else launch_rows_r<T, kSmallRows>(x, wg, wu, out, rows, h, inter, s);
}

// ---------------------------------------------------------------------------
// The tensor-core rows kernel: bf16 x with at most 8 rows, H a multiple of
// 32, 16-byte-aligned x and weights (every decode step of the bf16 models).
// ---------------------------------------------------------------------------

// One m16 tile of 16 intermediate columns (swiglu_rows.cuh::gate_up_tc); the
// W warps take fixed parts of H's spans; both fp32 totals are summed in shared
// memory in warp order, then silu(gate) * up is formed in fp32 and rounded
// once. W comes from I and H alone (tc_warps), so a row's bits never depend on
// R.
template <int W>
__global__ void __launch_bounds__(W * 32)
swiglu_rows_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                      const __nv_bfloat16* __restrict__ wu, __nv_bfloat16* __restrict__ out,
                      int rows, int h, int inter) {
  __shared__ float red[2][W][16][kSmallRows + 1];  // gate, up
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 16;
  const int spans = h / 32;
  float accg[4] = {0.f, 0.f, 0.f, 0.f}, accu[4] = {0.f, 0.f, 0.f, 0.f};
  gate_up_tc<true>(x, wg, wu, rows, h, inter, n0, warp * spans / W, (warp + 1) * spans / W, accg,
                   accu);
  // C element i of a lane: column gid + 8 (i / 2), x row 2t + i % 2.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[0][warp][gid + 8 * (i >> 1)][2 * t + (i & 1)] = accg[i];
    red[1][warp][gid + 8 * (i >> 1)][2 * t + (i & 1)] = accu[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 16 * kSmallRows; idx += W * 32) {
    const int m = idx % 16, r = idx / 16;
    if (r < rows && n0 + m < inter) {
      float g = red[0][0][m][r], u = red[1][0][m][r];
#pragma unroll
      for (int v = 1; v < W; ++v) {
        g += red[0][v][m][r];
        u += red[1][v][m][r];
      }
      out[static_cast<size_t>(r) * inter + n0 + m] = __float2bfloat16(silu(g) * u);
    }
  }
}

void launch_rows_tc(const void* x, const void* wg, const void* wu, void* out, int rows, int h,
                    int inter, cudaStream_t s) {
  using bf = __nv_bfloat16;
  auto xb = static_cast<const bf*>(x);
  auto gb = static_cast<const bf*>(wg);
  auto ub = static_cast<const bf*>(wu);
  auto o = static_cast<bf*>(out);
  const int blocks = (inter + 15) / 16;
  const int warps = tc_warps(inter, h);
  if (warps == 4)
    swiglu_rows_tc_kernel<4><<<blocks, 4 * 32, 0, s>>>(xb, gb, ub, o, rows, h, inter);
  else if (warps == 8)
    swiglu_rows_tc_kernel<8><<<blocks, 8 * 32, 0, s>>>(xb, gb, ub, o, rows, h, inter);
  else
    swiglu_rows_tc_kernel<16><<<blocks, 16 * 32, 0, s>>>(xb, gb, ub, o, rows, h, inter);
}

template <bool kBwd>
int launch_tile(const void* x, const void* wg, const void* wu, const void* g, void* out,
                void* out2, int rows, int h, int inter, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bool vec = h % 8 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  if ((rows + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((inter + BN - 1) / BN, (rows + BM - 1) / BM);
  auto kernel = vec ? swiglu_bf16_kernel<true, kBwd> : swiglu_bf16_kernel<false, kBwd>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf*>(x), static_cast<const bf*>(wg),
                                   static_cast<const bf*>(wu), static_cast<const bf*>(g),
                                   static_cast<bf*>(out), static_cast<bf*>(out2), rows, h, inter);
  return 0;
}

// ---------------------------------------------------------------------------
// The fp32 tile: fp32 x, weights (and cotangent), more than 8 rows (forward)
// or any rows (backward), on 3xTF32 mma.sync (tf32.cuh).
// ---------------------------------------------------------------------------
namespace tf32 {

constexpr int kBM = 128;       // x rows a block: 32 a warp
constexpr int kBN = 64;        // intermediate columns a block, of gate and of up: 32 a warp
constexpr int kBK = 64;        // k a stage: each stage's products summed in fresh registers
constexpr int kStages = 3;     // cp.async ring: two stages ahead of the math
constexpr int kThreads = 256;  // 8 warps, 4 x 2 over the 128 x 64 tile
constexpr int LD = Geom<kBK>::LD;  // 68 floats a staged row: conflict-free fragment loads
constexpr int kStageFloats = (kBM + 2 * kBN) * LD;  // x, gate and up slices
constexpr int kSmem = kStages * kStageFloats * 4;   // 208,896 bytes

// Stage a [ROWS, kBK] slice of a row-major [rows_total, h] fp32 matrix at
// (row0, k0), zeros outside it: by 16-byte cp.async (kVec: h % 4 == 0 and a
// 16-byte-aligned matrix; the caller commits and waits) or plain loads.
template <int ROWS, bool kVec>
__device__ __forceinline__ void stage_slice(float* dst, const float* src, int row0, int rows_total,
                                            int k0, int h) {
  if constexpr (kVec) {
    for (int u = threadIdx.x; u < ROWS * (kBK / 4); u += kThreads) {
      const int r = u / (kBK / 4), c = 4 * (u % (kBK / 4));
      const bool in = row0 + r < rows_total && k0 + c < h;
      async_copy<16>(dst + r * LD + c, in ? src + static_cast<size_t>(row0 + r) * h + k0 + c : src,
                     in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const bool in = row0 + r < rows_total && k0 + c < h;
      dst[r * LD + c] = in ? src[static_cast<size_t>(row0 + r) * h + k0 + c] : 0.f;
    }
  }
}

// kBwd false: out = silu(gate) * up. kBwd true: gin is the cotangent g,
// out = d_gate and out2 = d_up. A warp owns 32 rows x 32 columns: two m16
// row tiles x four n8 column tiles of gate and of up. Each k8 step splits its
// two x fragments once for both weights and each weight fragment once for
// both row tiles.
template <bool kVec, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
swiglu_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                   const float* __restrict__ wu, const float* __restrict__ gin,
                   float* __restrict__ out, float* __restrict__ out2, int rows, int h,
                   int inter) {
  extern __shared__ float4 smem_f4[];
  float* ring = reinterpret_cast<float*>(smem_f4);  // [kStages][x, gate, up rows][LD]
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int nk = (h + kBK - 1) / kBK;

  auto issue = [&](int t) {  // k-stage t into ring slot t % kStages
    float* st = ring + (t % kStages) * kStageFloats;
    stage_slice<kBM, kVec>(st, x, m0, rows, t * kBK, h);
    stage_slice<kBN, kVec>(st + kBM * LD, wg, n0, inter, t * kBK, h);
    stage_slice<kBN, kVec>(st + (kBM + kBN) * LD, wu, n0, inter, t * kBK, h);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) issue(t);
    async_commit();
  }

  // Running fp32 sums: [row tile][n8 tile][C register], rows wm + 16 mi + gid
  // (+ 8 for registers 2, 3), columns wn + 8 nt + 2 t4 (+ 1 for 1, 3).
  float accg[2][4][4], accu[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[mi][nt][e] = accu[mi][nt][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    async_wait<kStages - 2>();  // stage t landed (this thread's copies) ...
    __syncthreads();            // ... and everyone's; slot (t - 1) % kStages is free
    if (t + kStages - 1 < nk) issue(t + kStages - 1);
    async_commit();
    const float* xs = ring + (t % kStages) * kStageFloats;
    const float* gs = xs + kBM * LD;
    const float* us = gs + kBN * LD;
    float pg[2][4][4], pu[2][4][4];  // this stage's products, fresh registers
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pg[mi][nt][e] = pu[mi][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      FragA a[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ap = xs + (wm + 16 * mi + gid) * LD + 8 * kk + t4;
        a[mi] = frag_a<true>(ap[0], ap[8 * LD], ap[4], ap[8 * LD + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = (wn + 8 * nt + gid) * LD + 8 * kk + t4;
        const FragB bg = frag_b<true>(gs[o], gs[o + 4]);
        const FragB bu = frag_b<true>(us[o], us[o + 4]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma3<true, true>(pg[mi][nt], a[mi], bg);
          mma3<true, true>(pu[mi][nt], a[mi], bu);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accg[mi][nt][e] += pg[mi][nt][e];
          accu[mi][nt][e] += pu[mi][nt][e];
        }
  }
  async_wait<0>();

  // Epilogue from registers, one rounding per output; pairs of columns as
  // float2 where the row stride (and for g its pointer) allows.
  const bool pairs = (inter & 1) == 0;
  const bool gpairs = pairs && (reinterpret_cast<uintptr_t>(gin) & 7) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + 8 * nt + 2 * t4;
      if (col >= inter) continue;
      const bool two = col + 1 < inter;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + 16 * mi + gid + 8 * half;
        if (row >= rows) continue;
        const size_t o = static_cast<size_t>(row) * inter + col;
        float a0, a1 = 0.f, b0 = 0.f, b1 = 0.f;
        if (kBwd) {
          float g0, g1 = 0.f;
          if (gpairs && two) {
            const float2 gv = *reinterpret_cast<const float2*>(gin + o);
            g0 = gv.x, g1 = gv.y;
          } else {
            g0 = gin[o];
            if (two) g1 = gin[o + 1];
          }
          swiglu_grad(accg[mi][nt][2 * half], accu[mi][nt][2 * half], g0, a0, b0);
          swiglu_grad(accg[mi][nt][2 * half + 1], accu[mi][nt][2 * half + 1], g1, a1, b1);
        } else {
          a0 = silu(accg[mi][nt][2 * half]) * accu[mi][nt][2 * half];
          a1 = silu(accg[mi][nt][2 * half + 1]) * accu[mi][nt][2 * half + 1];
        }
        if (pairs && two) {
          *reinterpret_cast<float2*>(out + o) = make_float2(a0, a1);
          if (kBwd) *reinterpret_cast<float2*>(out2 + o) = make_float2(b0, b1);
        } else {
          out[o] = a0;
          if (two) out[o + 1] = a1;
          if (kBwd) {
            out2[o] = b0;
            if (two) out2[o + 1] = b1;
          }
        }
      }
    }
}

// Row tiles on the grid's x axis, so that the blocks that run together share
// their weight tiles in L2. Tiles depend on I alone and the k order on H: a
// row's bits never depend on R or on its row tile.
template <bool kBwd>
int launch(const void* x, const void* wg, const void* wu, const void* g, void* out, void* out2,
           int rows, int h, int inter, cudaStream_t s) {
  const bool vec = h % 4 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  const int n_tiles = (inter + kBN - 1) / kBN;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec ? swiglu_tf32_kernel<true, kBwd> : swiglu_tf32_kernel<false, kBwd>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((rows + kBM - 1) / kBM, n_tiles), kThreads, kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<const float*>(g), static_cast<float*>(out), static_cast<float*>(out2), rows, h,
      inter);
  return 0;
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// The TMA tile: bf16 x with H a multiple of 64 and 16-byte-aligned x and
// weights, more than 8 rows (forward) or any rows (backward, when asked).
// ---------------------------------------------------------------------------
namespace tma {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                    // x rows a block: 64 per consumer warpgroup
constexpr int kBN = 128;                    // intermediate columns a block, of gate and of up
constexpr int kBK = 64;                     // k a tile: one 128-byte swizzled row
constexpr int kStages = 4;                  // ring of x, gate and up tiles
constexpr int kConsumerWarps = 8;           // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;  // and the producer warp
constexpr int kCluster = 2;                 // blocks a cluster
constexpr int kTile = kBM * kBK * 2;        // 16 KB: x, gate or up (kBN = kBM rows)
constexpr int kStageBytes = 3 * kTile;
constexpr int kBarriers = kStages * kStageBytes;  // offset of the 2 x kStages barriers
constexpr int kSmem = kBarriers + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kBN == kBM, "one box shape serves x and both weights");

// One block: rows m0 .. m0 + 127 of x and columns n0 .. n0 + 127 of both
// products. A cluster is two blocks on adjacent row tiles of one column
// tile: rank 0 copies the gate tile and rank 1 the up tile, each multicast
// to both, so each block reads half the weight bytes from L2. The producer
// warp keeps kStages - 1 tiles ahead; stage s's "full" barrier completes
// when its x tile and both weight tiles have landed, its "empty" barrier
// when the 2 consumer warpgroups of both blocks have finished reading it (a
// block's next copies into the stage land in the other block too): one
// thread of each warpgroup arrives on each block's barrier.
template <bool kBwd>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
swiglu_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
                  const __grid_constant__ CUtensorMap tu, const bf16* __restrict__ gin,
                  bf16* __restrict__ out, bf16* __restrict__ out2, int rows, int inter, int nk) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte-aligned bases (the same offset
  // in both blocks of the cluster: multicast copies land at it).
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarriers);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCluster * kConsumerWarps / 4);
    }
    fence_mbar_init();
  }
  cluster_sync();  // both blocks' barriers exist before any copy or remote arrival

  if (warp == kConsumerWarps) {
    if (lane == 0) {  // the producer
      const uint32_t rank = cluster_ctarank();
      const CUtensorMap* wmap = rank == 0 ? &tg : &tu;
      const int wofs = rank == 0 ? kTile : 2 * kTile;
      const int xrow = m0 < rows ? m0 : 0;  // the padding block of an odd tile count: any rows
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &tx, &full[s], t * kBK, xrow);
        tma_load_2d_multicast(st + wofs, wmap, &full[s], t * kBK, n0, 0x3);
      }
    }
  } else {
    const int wg = warp >> 2;
    // This warpgroup's 64 x 128 fp32 sums of gate and of up, one layout:
    // thread (warp w, lane) holds rows 16 w + lane / 4 (+ 8) and columns
    // 8 j + 2 (lane % 4) (+ 1) at acc[4 j + 2 half + e].
    float accg[kBN / 2], accu[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) accg[i] = accu[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const unsigned char* st = smem + s * kStageBytes;
      const unsigned char* xa = st + wg * 64 * 128;
      fence_regs(accg);
      fence_regs(accu);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = sw128_desc(xa + kk * 32);
        wgmma_ss_m64n128k16(accg, da, sw128_desc(st + kTile + kk * 32), 1);
        wgmma_ss_m64n128k16(accu, da, sw128_desc(st + 2 * kTile + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // tile t - 1's products are done ...
      fence_regs(accg);
      fence_regs(accu);
      if (t > 0 && (tid & 127) < kCluster)  // ... so its stage is free, in both blocks
        mbar_arrive_cluster(&empty[(t - 1) % kStages], tid & 127);
    }
    wgmma_wait<0>();
    fence_regs(accg);
    fence_regs(accu);

    // Epilogue from registers, one rounding per output, bf16 pairs where
    // the row stride allows; ragged edges checked.
    const int r_lo = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const bool pairs = (inter & 1) == 0;
    // g is the caller's tensor: a contiguous view may start at an odd element
    const bool gpairs = pairs && (reinterpret_cast<uintptr_t>(gin) & 3) == 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= inter) break;
      const bool two = col + 1 < inter;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_lo + 8 * half;
        if (row >= rows) continue;
        const int i = 4 * j + 2 * half;
        const size_t o = static_cast<size_t>(row) * inter + col;
        float a0, a1, b0 = 0.f, b1 = 0.f;
        if (kBwd) {
          float g0, g1 = 0.f;
          if (gpairs && two) {
            const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(gin + o);
            g0 = __low2float(gv);
            g1 = __high2float(gv);
          } else {
            g0 = __bfloat162float(gin[o]);
            if (two) g1 = __bfloat162float(gin[o + 1]);
          }
          swiglu_grad(accg[i], accu[i], g0, a0, b0);
          swiglu_grad(accg[i + 1], accu[i + 1], g1, a1, b1);
        } else {
          a0 = silu(accg[i]) * accu[i];
          a1 = silu(accg[i + 1]) * accu[i + 1];
        }
        if (pairs && two) {
          *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(a0, a1);
          if (kBwd) *reinterpret_cast<uint32_t*>(out2 + o) = pack_bf16(b0, b1);
        } else {
          out[o] = __float2bfloat16(a0);
          if (two) out[o + 1] = __float2bfloat16(a1);
          if (kBwd) {
            out2[o] = __float2bfloat16(b0);
            if (two) out2[o + 1] = __float2bfloat16(b1);
          }
        }
      }
    }
  }
  cluster_sync();  // no block leaves while the other may still arrive on its barriers
}

// The tensor maps of this call (boxes of 128 rows x 64 k), then one launch:
// row tiles rounded up to an even count (clusters of two), column tiles of
// 128 on the grid's y axis, so the blocks that run together share their
// weight tiles in L2. The tiles depend on I alone and the k order on H, so
// a row's bits never depend on R or on its row tile.
template <bool kBwd>
int launch(const void* x, const void* wg, const void* wu, const void* g, void* out, void* out2,
           int rows, int h, int inter, cudaStream_t s) {
  CUtensorMap tx, tg, tu;
  if (!bf16_tile_map(&tx, x, rows, h, kBM) || !bf16_tile_map(&tg, wg, inter, h, kBN) ||
      !bf16_tile_map(&tu, wu, inter, h, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m_tiles = ((rows + kBM - 1) / kBM + kCluster - 1) / kCluster * kCluster;
  const int n_tiles = (inter + kBN - 1) / kBN;
  if (m_tiles > INT_MAX || n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swiglu_tma_kernel<kBwd>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(static_cast<unsigned>(m_tiles), n_tiles), kThreads, kSmem, s>>>(
      tx, tg, tu, static_cast<const bf16*>(g), static_cast<bf16*>(out), static_cast<bf16*>(out2),
      rows, inter, h / kBK);
  return 0;
}

}  // namespace tma

// l32_swiglu_fwd / l32_swiglu_bwd's kernel argument: route by shape, ask
// for the base tile (the wmma tile for bf16, the fp32 tile for fp32: neither
// the TMA tile nor a rows kernel), or ask for the TMA tile, the tensor-core
// rows kernel, the fp32 tile or the rows kernel; and the kernels they report
// in *launched.
enum { kRouted = -1, kRoutedBase = -2 };
enum { kWmma = 1, kTma = 3, kRowsTc = 4, kTf32 = 5, kRows = 6 };

bool tma_takes(const void* x, const void* wg, const void* wu, int h, int dtype) {
  return dtype == L32_BF16 && h > 0 && h % tma::kBK == 0 && aligned16(x) && aligned16(wg) &&
         aligned16(wu);
}

bool rows_tc_takes(const void* x, const void* wg, const void* wu, int rows, int h, int dtype) {
  return dtype == L32_BF16 && rows <= kSmallRows && h > 0 && h % 32 == 0 && aligned16(x) &&
         aligned16(wg) && aligned16(wu);
}

// The kernel a call takes, or -1 for an error. Routed, the forward takes a
// rows kernel at most at 8 rows (the backward has none): the tensor-core
// one where it takes the call, else the CUDA-core one; more rows in bf16
// take the TMA tile where it takes the call, else the wmma tile; fp32 the
// fp32 tile.
int pick(int kernel, const void* x, const void* wg, const void* wu, int rows, int h, int dtype,
         bool bwd) {
  const bool tma = tma_takes(x, wg, wu, h, dtype);
  const bool rows_tc = !bwd && rows_tc_takes(x, wg, wu, rows, h, dtype);
  if (kernel == kTma) return tma ? kTma : -1;
  if (kernel == kRowsTc) return rows_tc ? kRowsTc : -1;
  if (kernel == kTf32) return dtype == L32_F32 ? kTf32 : -1;
  if (dtype != L32_BF16 && dtype != L32_F32) return -1;
  if (kernel == kRows) return !bwd && rows <= kSmallRows ? kRows : -1;
  if (kernel == kRoutedBase) return dtype == L32_F32 ? kTf32 : kWmma;
  if (kernel != kRouted) return -1;
  if (!bwd && rows <= kSmallRows) return rows_tc ? kRowsTc : kRows;
  if (dtype == L32_F32) return kTf32;
  return tma && rows > kSmallRows ? kTma : kWmma;
}

}  // namespace

// kernel: -1 routes by shape (pick), -2 asks for the base tile (the wmma
// tile, or for fp32 the fp32 tile), 3 for the TMA tile, 4 for the tensor-core
// rows kernel, 5 for the fp32 tile, 6 for the rows kernel, and a kernel that
// does not take the call is an error. *launched is set to the kernel launched
// (1 wmma tile, 3 TMA tile, 4 tensor-core rows kernel, 5 fp32 tile, 6 rows
// kernel), or -1 where none was (no rows or no columns, or an error).
extern "C" int l32_swiglu_fwd(const void* x, const void* wg, const void* wu, void* out,
                              int rows, int h, int inter, int dtype, int kernel, int* launched,
                              void* stream) {
  *launched = -1;
  if (rows == 0 || inter == 0) return 0;
  kernel = pick(kernel, x, wg, wu, rows, h, dtype, false);
  if (kernel < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (kernel == kRowsTc)
    launch_rows_tc(x, wg, wu, out, rows, h, inter, s);
  else if (kernel == kRows && dtype == L32_BF16)
    launch_rows<__nv_bfloat16>(x, wg, wu, out, rows, h, inter, s);
  else if (kernel == kRows)
    launch_rows<float>(x, wg, wu, out, rows, h, inter, s);
  else if (kernel == kWmma)
    err = launch_tile<false>(x, wg, wu, nullptr, out, nullptr, rows, h, inter, s);
  else if (kernel == kTf32)
    err = tf32::launch<false>(x, wg, wu, nullptr, out, nullptr, rows, h, inter, s);
  else
    err = tma::launch<false>(x, wg, wu, nullptr, out, nullptr, rows, h, inter, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}

// d_gate, d_up [rows, inter] from x [rows, h], both weights [inter, h] and
// the cotangent g [rows, inter]; kernel and *launched as l32_swiglu_fwd's.
extern "C" int l32_swiglu_bwd(const void* x, const void* wg, const void* wu, const void* g,
                              void* d_gate, void* d_up, int rows, int h, int inter, int dtype,
                              int kernel, int* launched, void* stream) {
  *launched = -1;
  if (rows == 0 || inter == 0) return 0;
  kernel = pick(kernel, x, wg, wu, rows, h, dtype, true);
  if (kernel < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (kernel == kWmma)
    err = launch_tile<true>(x, wg, wu, g, d_gate, d_up, rows, h, inter, s);
  else if (kernel == kTf32)
    err = tf32::launch<true>(x, wg, wu, g, d_gate, d_up, rows, h, inter, s);
  else
    err = tma::launch<true>(x, wg, wu, g, d_gate, d_up, rows, h, inter, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}
