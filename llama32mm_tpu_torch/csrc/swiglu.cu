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
//    of 8, 16-byte-aligned x and weights and more than 8 rows: every
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
//    Ragged R, I and H read as zeros (TMA zero-fills a box past the matrix,
//    so at H % 64 != 0 the last 64-k tile is partly zeros; the stage's
//    barrier still counts the full box's bytes) and R and I are
//    bounds-checked at the write. No split-K, a k order fixed by H and tiles
//    fixed by I: a row's bits never depend on R or on its row tile, so a
//    server's prefill equals a solo engine's.
//    Measured (profile_swiglu.py, device time, NVIDIA H100 80GB HBM3 at
//    700 W, R = 1632): 11B forward 0.594 ms (two cuBLAS GEMMs 0.589, the
//    plain version 0.950, a wmma tile since removed 2.550), 3B forward 0.267, 3B
//    backward 0.331 (plain 0.889). The products alone run the 11B forward
//    in 0.57-0.62 ms and the copies alone in 0.55-0.60: the tile runs at
//    the issue rate of its two warpgroups, with no overlap of one tile's
//    epilogue and the next one's loads (a persistent grid would add it). At
//    this speed the multicast gains nothing (0.606 ms without a cluster).
// 2. With at most 8 rows (decode, forward and backward), bf16 x with H a
//    multiple of 32 and 16-byte-aligned x and weights take the tensor-core
//    rows kernel (swiglu_rows_tc_kernel): gemv.cu's swap-AB mma.sync
//    m16n8k16 form with two A streams (swiglu_rows.cuh::gate_up_tc, shared
//    with the SwiGLU + down fusion). 16 intermediate columns of gate and of up are the M side
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
// 3. Other bf16 calls of more than 8 rows (H not a multiple of 8, or x or a
//    weight not 16-byte aligned, such as a view that starts one element in)
//    take the general route (launch_general): a pre-pass (common.cuh::
//    pad_rows_kernel) copies only the operands TMA cannot read as they are
//    to the caller's workspaces, rows of H rounded up to 8 with zeros past
//    H, 16-byte aligned (all three where H % 8 != 0; x alone for an offset
//    view of x: 13 MB at R = 1632, H = 4096), and the TMA tile of 1 reads
//    them. Copying a weight costs its bytes twice more: at the 11B widths two
//    117 MB workspaces for the call and ~0.14 ms of copies at 3.35 TB/s, so a
//    caller that keeps such weights should keep them padded. Asked for
//    (kernel -2, the registry's "swiglu" / "swiglu_bwd"), the route copies
//    every operand at any row count: its time is this fallback's upper bound.
// 4. fp32 inputs with more rows take the fp32 tile (tf32::swiglu_tf32_kernel):
//    a dual-B GEMM (a 128 x 64 output tile, eight warps of 32 x 32) on
//    mma.sync m16n8k8 TF32, every fp32 product as three TF32 products
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
// another epilogue (the kBwd template parameter of every kernel above),
// routed as the forward: in bf16 at most 8 rows take a rows kernel (the
// tensor-core one where it takes the call, a training microbatch of a few
// tokens: a weight-streaming call, bound by the weights' bytes), more the
// TMA tile or the general route; every fp32 backward takes the fp32 tile.
// The tiles read g at each accumulator's (row, column) from device memory,
// in pairs where g's pointer allows and one element at a time where it does
// not (a contiguous view may start at an odd element); the rows kernels read
// it one element at a time where the forward writes its output. Bound as
// the forward: tensor-core FLOPs at R = 1632, the weights' bytes at 8 rows
// or fewer. dx = d_gate @ w_gate + d_up @ w_up and the weight gradients are
// cuBLAS GEMMs in the wrapper's autograd function.
#include <limits.h>

#include "common.cuh"
#include "swiglu_rows.cuh"
#include "tf32.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// The backward epilogue on one (gate, up, g) triple: d_gate, d_up.
__device__ __forceinline__ void swiglu_grad(float gate, float up, float g, float& d_gate,
                                            float& d_up) {
  const float s = 1.f / (1.f + expf(-gate));
  d_gate = s * (1.f + gate * (1.f - s)) * g * up;
  d_up = g * (gate * s);
}

constexpr int kSmallRows = 8;

// ---------------------------------------------------------------------------
// The rows kernel: at most 8 rows of fp32 (forward), or of bf16 that the
// tensor-core rows kernel does not take (H not a multiple of 32, misaligned
// pointers), forward and backward.
// ---------------------------------------------------------------------------
constexpr int kRowWarps = 4;  // warps a block

// A warp owns kSimtCols intermediate columns of gate and of up
// (swiglu_rows.cuh::gate_up_simt): its lanes read x once a span for all of
// them, then the 2 x kSimtCols x MAXR partial sums are reduce-scattered, so
// lane r * kSimtCols + c ends with column c of row r and writes, formed in
// fp32 and rounded once, silu(gate) * up (kBwd false) or d_gate to out and
// d_up to out2 from the cotangent gin at that (row, column) (kBwd true).
template <typename T, int MAXR, bool kVec, bool kBwd>
__global__ void __launch_bounds__(kRowWarps * 32)
swiglu_rows_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
                   const T* __restrict__ gin, T* __restrict__ out, T* __restrict__ out2, int rows,
                   int h, int inter) {
  constexpr int NV = kSimtCols * MAXR;
  const int lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * kSimtCols;
  if (col0 >= inter) return;
  float g[NV], u[NV];
  gate_up_simt<T, MAXR, kVec>(x, wg, wu, rows, h, inter, col0, g, u);
  const float gs = reduce_scatter<NV>(g), us = reduce_scatter<NV>(u);
  const int r = (lane % NV) / kSimtCols, col = col0 + lane % kSimtCols;
  if (lane < NV && r < rows && col < inter) {
    const size_t o = static_cast<size_t>(r) * inter + col;
    if (kBwd) {
      float d_gate, d_up;
      swiglu_grad(gs, us, to_f32(gin[o]), d_gate, d_up);
      out[o] = from_f32<T>(d_gate);
      out2[o] = from_f32<T>(d_up);
    } else {
      out[o] = from_f32<T>(silu(gs) * us);
    }
  }
}

template <typename T, int MAXR, bool kBwd>
void launch_rows_r(const void* x, const void* wg, const void* wu, const void* g, void* out,
                   void* out2, int rows, int h, int inter, cudaStream_t s) {
  const bool vec = h % Vec16<T>::N == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  auto kernel = vec ? swiglu_rows_kernel<T, MAXR, true, kBwd>
                    : swiglu_rows_kernel<T, MAXR, false, kBwd>;
  constexpr int kCols = kRowWarps * kSimtCols;
  kernel<<<(inter + kCols - 1) / kCols, kRowWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(g), static_cast<T*>(out), static_cast<T*>(out2), rows, h, inter);
}

// The smallest instantiation that holds the rows (registers: the sums).
template <typename T, bool kBwd>
void launch_rows(const void* x, const void* wg, const void* wu, const void* g, void* out,
                 void* out2, int rows, int h, int inter, cudaStream_t s) {
  if (rows <= 1) launch_rows_r<T, 1, kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
  else if (rows <= 2) launch_rows_r<T, 2, kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
  else if (rows <= 4) launch_rows_r<T, 4, kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
  else launch_rows_r<T, kSmallRows, kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
}

// ---------------------------------------------------------------------------
// The tensor-core rows kernel: bf16 x with at most 8 rows, H a multiple of
// 32, 16-byte-aligned x and weights (every decode step of the bf16 models,
// and the backward of a training microbatch that small), forward and
// backward.
// ---------------------------------------------------------------------------

// One m16 tile of 16 intermediate columns (swiglu_rows.cuh::gate_up_tc); the
// W warps take fixed parts of H's spans; both fp32 totals are summed in shared
// memory in warp order, then silu(gate) * up (kBwd false), or d_gate to out
// and d_up to out2 from the cotangent gin at that (row, column), read one
// element at a time (kBwd true), is formed in fp32 and rounded once. W comes
// from I and H alone (tc_warps), so a row's bits never depend on R.
template <int W, bool kBwd>
__global__ void __launch_bounds__(W * 32)
swiglu_rows_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                      const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ gin,
                      __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ out2, int rows,
                      int h, int inter) {
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
      float gate = red[0][0][m][r], up = red[1][0][m][r];
#pragma unroll
      for (int v = 1; v < W; ++v) {
        gate += red[0][v][m][r];
        up += red[1][v][m][r];
      }
      const size_t o = static_cast<size_t>(r) * inter + n0 + m;
      if (kBwd) {
        float d_gate, d_up;
        swiglu_grad(gate, up, __bfloat162float(gin[o]), d_gate, d_up);
        out[o] = __float2bfloat16(d_gate);
        out2[o] = __float2bfloat16(d_up);
      } else {
        out[o] = __float2bfloat16(silu(gate) * up);
      }
    }
  }
}

template <bool kBwd>
void launch_rows_tc(const void* x, const void* wg, const void* wu, const void* g, void* out,
                    void* out2, int rows, int h, int inter, cudaStream_t s) {
  using bf = __nv_bfloat16;
  auto xb = static_cast<const bf*>(x);
  auto gb = static_cast<const bf*>(wg);
  auto ub = static_cast<const bf*>(wu);
  auto gi = static_cast<const bf*>(g);
  auto o = static_cast<bf*>(out);
  auto o2 = static_cast<bf*>(out2);
  const int blocks = (inter + 15) / 16;
  const int warps = tc_warps(inter, h);
  if (warps == 4)
    swiglu_rows_tc_kernel<4, kBwd><<<blocks, 4 * 32, 0, s>>>(xb, gb, ub, gi, o, o2, rows, h, inter);
  else if (warps == 8)
    swiglu_rows_tc_kernel<8, kBwd><<<blocks, 8 * 32, 0, s>>>(xb, gb, ub, gi, o, o2, rows, h, inter);
  else
    swiglu_rows_tc_kernel<16, kBwd><<<blocks, 16 * 32, 0, s>>>(xb, gb, ub, gi, o, o2, rows, h,
                                                               inter);
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
// The TMA tile: bf16 x and weights in rows of whole 16 bytes (H a multiple
// of 8) from 16-byte-aligned bases, as the caller's tensors or as the
// general route's padded copies; more than 8 rows (routed), or any rows
// (forced).
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

// The tensor maps of this call (boxes of 128 rows x 64 k over the operands'
// ld columns; a last box past ld is zero-filled by TMA and still completes
// its full kStageBytes on the stage's barrier), then one launch: row tiles
// rounded up to an even count (clusters of two), column tiles of 128 on the
// grid's y axis, so the blocks that run together share their weight tiles
// in L2. The tiles depend on I alone and the k order on ld, so a row's bits
// never depend on R or on its row tile.
template <bool kBwd>
int launch(const void* x, const void* wg, const void* wu, const void* g, void* out, void* out2,
           int rows, int ld, int inter, cudaStream_t s) {
  CUtensorMap tx, tg, tu;
  if (!bf16_tile_map(&tx, x, rows, ld, kBM) || !bf16_tile_map(&tg, wg, inter, ld, kBN) ||
      !bf16_tile_map(&tu, wu, inter, ld, kBN))
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
      rows, inter, (ld + kBK - 1) / kBK);
  return 0;
}

}  // namespace tma

// Whether TMA reads an operand's rows of h elements as they are: whole 16
// bytes from a 16-byte-aligned base.
bool tma_reads(const void* p, int h) { return h % 8 == 0 && aligned16(p); }

// The general route: each operand that TMA cannot read as it is (every one,
// when asked for the route) copied by the pre-pass to its workspace
// (common.cuh::pad_rows_kernel: rows of ld = H rounded up to 8, zeros past
// H), then the TMA tile on ld columns. A copied operand without a workspace
// is an error. The k order is fixed by ld, so by H: a row's bits never
// depend on R, and equal the TMA tile's on the same values.
template <bool kBwd>
int launch_general(bool copy_all, const void* x, const void* wg, const void* wu,
                   void* const (&ws)[3], const void* g, void* out, void* out2, int rows, int h,
                   int inter, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const int ld = (h + 7) / 8 * 8;
  const void* op[3] = {x, wg, wu};
  const int n[3] = {rows, inter, inter};
  for (int i = 0; i < 3; ++i) {
    if (!copy_all && tma_reads(op[i], h)) continue;
    if (ws[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    pad_rows_kernel<bf><<<n[i], kPadThreads, 0, s>>>(static_cast<const bf*>(op[i]),
                                                     static_cast<bf*>(ws[i]), h, ld);
    op[i] = ws[i];
  }
  return tma::launch<kBwd>(op[0], op[1], op[2], g, out, out2, rows, ld, inter, s);
}

// l32_swiglu_fwd / l32_swiglu_bwd's kernel argument: route by shape, ask
// for the base route (the general route for bf16, the fp32 tile for fp32:
// neither the TMA tile on the caller's tensors nor a rows kernel), or ask
// for the TMA tile, the tensor-core rows kernel, the fp32 tile or the rows
// kernel; and the kernels they report in *launched.
enum { kRouted = -1, kRoutedBase = -2 };
enum { kGeneral = 1, kTma = 3, kRowsTc = 4, kTf32 = 5, kRows = 6 };

bool tma_takes(const void* x, const void* wg, const void* wu, int h, int dtype) {
  return dtype == L32_BF16 && h > 0 && tma_reads(x, h) && tma_reads(wg, h) && tma_reads(wu, h);
}

bool rows_tc_takes(const void* x, const void* wg, const void* wu, int rows, int h, int dtype) {
  return dtype == L32_BF16 && rows <= kSmallRows && h > 0 && h % 32 == 0 && aligned16(x) &&
         aligned16(wg) && aligned16(wu);
}

// The kernel a call takes, or -1 for an error. Routed, a call of at most 8
// rows takes a rows kernel (the backward only in bf16): the tensor-core one
// where it takes the call, else the CUDA-core one; more rows in bf16 take
// the TMA tile where it reads the operands as they are, else the general
// route; fp32 the fp32 tile.
int pick(int kernel, const void* x, const void* wg, const void* wu, int rows, int h, int dtype,
         bool bwd) {
  const bool tma = tma_takes(x, wg, wu, h, dtype);
  const bool rows_tc = rows_tc_takes(x, wg, wu, rows, h, dtype);
  const bool small = rows <= kSmallRows && (!bwd || dtype == L32_BF16);
  if (kernel == kTma) return tma ? kTma : -1;
  if (kernel == kRowsTc) return rows_tc ? kRowsTc : -1;
  if (kernel == kTf32) return dtype == L32_F32 ? kTf32 : -1;
  if (dtype != L32_BF16 && dtype != L32_F32) return -1;
  if (kernel == kRows) return small ? kRows : -1;
  if (kernel == kRoutedBase) return dtype == L32_F32 ? kTf32 : kGeneral;
  if (kernel != kRouted) return -1;
  if (small) return rows_tc ? kRowsTc : kRows;
  if (dtype == L32_F32) return kTf32;
  return tma ? kTma : kGeneral;
}

// One call of the kernel pick chose (kBwd: g, out2 = d_up; else both NULL).
template <bool kBwd>
int launch_picked(int kernel, bool copy_all, const void* x, const void* wg, const void* wu,
                  void* const (&ws)[3], const void* g, void* out, void* out2, int rows, int h,
                  int inter, int dtype, cudaStream_t s) {
  using bf = __nv_bfloat16;
  switch (kernel) {
    case kRowsTc:
      launch_rows_tc<kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
      return 0;
    case kRows:
      if (dtype == L32_BF16)
        launch_rows<bf, kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
      else if constexpr (!kBwd)
        launch_rows<float, false>(x, wg, wu, g, out, out2, rows, h, inter, s);
      return 0;
    case kTf32:
      return tf32::launch<kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
    case kGeneral:
      return launch_general<kBwd>(copy_all, x, wg, wu, ws, g, out, out2, rows, h, inter, s);
    default:
      return tma::launch<kBwd>(x, wg, wu, g, out, out2, rows, h, inter, s);
  }
}

}  // namespace

// kernel: -1 routes by shape (pick), -2 asks for the base route (the general
// route, which copies all three operands, or for fp32 the fp32 tile), 3 for
// the TMA tile on the caller's tensors, 4 for the tensor-core rows kernel, 5
// for the fp32 tile, 6 for the rows kernel, and a kernel that does not take
// the call is an error. xw, gw, uw: the general route's workspaces for x,
// w_gate and w_up, each rows (x) or inter (weights) times H rounded up to 8
// bf16 elements, 16-byte aligned; NULL where the call does not copy that
// operand (the caller mirrors tma_reads). *launched is set to the kernel
// launched (1 the general route, 3 TMA tile, 4 tensor-core rows kernel, 5
// fp32 tile, 6 rows kernel), or -1 where none was (no rows or no columns,
// or an error).
extern "C" int l32_swiglu_fwd(const void* x, const void* wg, const void* wu, void* xw, void* gw,
                              void* uw, void* out, int rows, int h, int inter, int dtype,
                              int kernel, int* launched, void* stream) {
  *launched = -1;
  if (rows == 0 || inter == 0) return 0;
  const int picked = pick(kernel, x, wg, wu, rows, h, dtype, false);
  if (picked < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* const ws[3] = {xw, gw, uw};
  int err = launch_picked<false>(picked, kernel == kRoutedBase, x, wg, wu, ws, nullptr, out,
                                 nullptr, rows, h, inter, dtype, static_cast<cudaStream_t>(stream));
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = picked;
  return err;
}

// d_gate, d_up [rows, inter] from x [rows, h], both weights [inter, h] and
// the cotangent g [rows, inter]; kernel, the workspaces and *launched as
// l32_swiglu_fwd's.
extern "C" int l32_swiglu_bwd(const void* x, const void* wg, const void* wu, void* xw, void* gw,
                              void* uw, const void* g, void* d_gate, void* d_up, int rows, int h,
                              int inter, int dtype, int kernel, int* launched, void* stream) {
  *launched = -1;
  if (rows == 0 || inter == 0) return 0;
  const int picked = pick(kernel, x, wg, wu, rows, h, dtype, true);
  if (picked < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* const ws[3] = {xw, gw, uw};
  int err = launch_picked<true>(picked, kernel == kRoutedBase, x, wg, wu, ws, g, d_gate, d_up,
                                rows, h, inter, dtype, static_cast<cudaStream_t>(stream));
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = picked;
  return err;
}
