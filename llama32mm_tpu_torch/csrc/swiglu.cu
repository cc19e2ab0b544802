// Fused SwiGLU forward: out[r, i] = silu(sum_h x[r,h] wg[i,h]) * sum_h x[r,h] wu[i,h]
// with x [R, H] and both weights stored [I, H] (nn.Linear's layout).
//
// Replaces the TPU kernel llama32mm_tpu/ops/pallas/swiglu.py::_fwd_kernel
// (via _swiglu_fwd_call / _swiglu_grid_call): both products accumulate in
// fp32 inside the kernel and only silu(gate) * up is written; the [R, I]
// gate and up never reach device memory.
//
// Bound on the H100: at prefill (R = 1632, H = 4096, I = 14336) tensor-core
// FLOPs (~380 GFLOP per layer against ~235 MB of weights); at decode (R = 1)
// the bytes of the two weights. The bf16 design is a tiled tensor-core GEMM
// with two B operands: each block owns a 128-row x 64-column output tile,
// eight warps (4 x 2, 32 x 32 each) run bf16 16x16x16 mma.sync
// (nvcuda::wmma) into fp32 accumulators for gate and up, and 32-wide K slices
// of x and both weights are staged through a two-deep shared-memory ring
// with cp.async, so the next slice loads while the current one multiplies.
// The gate and up fragments share one layout, so silu(g) * u is applied in
// registers and only the product goes through shared memory to one rounded
// write per element. Ragged R, H and I are zero-filled at staging (cp.async
// with a zero source size) and bounds-checked at the write, as the Pallas
// kernel masks ragged K; an H that is not a multiple of 8 stages with plain
// loads. No TMA, no wgmma: later work.
//
// With at most 8 rows (decode) the tensor-core tile would stream the weights
// through shared memory for a 128-row tile that holds one live row, so a
// weight-streaming form takes over: one warp per output column i reads
// wg[i, :] and wu[i, :] with 16-byte loads, applies them to every row of x,
// reduces both fp32 sums with shuffles and writes silu(g) * u. It reads
// each weight byte once, as the decode gemv does.
//
// fp32 inputs with more rows take a plain SIMT loop (one thread per output,
// both dot products in fp32): the main path runs bf16, the fp32 kernel
// exists so the wrapper takes both types.
//
// Backward (l32_swiglu_bwd). Replaces llama32mm_tpu/ops/pallas/swiglu.py::
// _bwd_kernel: with g the output's cotangent, it recomputes gate and up with
// fp32 accumulators and writes d_gate = silu'(gate) * g * up and
// d_up = g * silu(gate), silu'(x) = s (1 + x (1 - s)), s = sigmoid(x), in x's
// type; gate and up never reach device memory. It is the forward's body with
// another epilogue (the kBwd template parameter of both the bf16 tile kernel
// and the fp32 loop): the g tile is staged through the epilogue's shared
// memory as fp32 and loaded into accumulator fragments, whose layout is the
// gate and up fragments', so both products are formed in registers; d_gate
// and then d_up go out through shared memory as the forward's output does.
// Bound as the forward at R = 1632 (tensor-core FLOPs); the bf16 backward
// always takes the tile, whatever R. dx = d_gate @ w_gate + d_up @ w_up and the
// weight gradients are cuBLAS GEMMs in the wrapper's autograd function.
#include <mma.h>

#include "common.cuh"

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

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// The backward epilogue on one (gate, up, g) triple: d_gate, d_up.
__device__ __forceinline__ void swiglu_grad(float gate, float up, float g, float& d_gate,
                                            float& d_up) {
  const float s = 1.f / (1.f + expf(-gate));
  d_gate = s * (1.f + gate * (1.f - s)) * g * up;
  d_up = g * (gate * s);
}

// 16-byte global -> shared copy that does not stall the thread; a zero
// source size writes zeros (the ragged edge) and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
      cp_async16(dst + r * LDS + c,
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
    cp_async_commit();
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
      cp_async_wait<1>();                  // slice kt has landed, kt + 1 may be in flight
    } else {
      cp_async_wait<0>();
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
constexpr int kRowWarps = 4;

template <typename T, int MAXR, bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
swiglu_rows_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
                   T* __restrict__ out, int rows, int h, int inter) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (col >= inter) return;
  const T* gr = wg + static_cast<size_t>(col) * h;
  const T* ur = wu + static_cast<size_t>(col) * h;
  constexpr int V = Vec16<T>::N;

  float ag[MAXR], au[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) ag[r] = au[r] = 0.f;

  if (kVec) {
    for (int c = lane * V; c < h; c += 32 * V) {
      const Vec16<T> gv = load16(gr + c), uv = load16(ur + c);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const Vec16<T> xv = load16(x + static_cast<size_t>(r) * h + c);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = to_f32(xv[j]);
            ag[r] = fmaf(xf, to_f32(gv[j]), ag[r]);
            au[r] = fmaf(xf, to_f32(uv[j]), au[r]);
          }
        }
      }
    }
  } else {
    for (int c = lane; c < h; c += 32) {
      const float g = to_f32(gr[c]), u = to_f32(ur[c]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const float xf = to_f32(x[static_cast<size_t>(r) * h + c]);
          ag[r] = fmaf(xf, g, ag[r]);
          au[r] = fmaf(xf, u, au[r]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {
      const float g = warp_sum(ag[r]), u = warp_sum(au[r]);
      if (lane == 0) out[static_cast<size_t>(r) * inter + col] = from_f32<T>(silu(g) * u);
    }
  }
}

template <typename T, int MAXR>
void launch_rows_r(const void* x, const void* wg, const void* wu, void* out, int rows, int h,
                   int inter, cudaStream_t s) {
  const bool vec = h % Vec16<T>::N == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  auto kernel = vec ? swiglu_rows_kernel<T, MAXR, true> : swiglu_rows_kernel<T, MAXR, false>;
  kernel<<<(inter + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(out), rows, h, inter);
}

template <typename T>
void launch_rows(const void* x, const void* wg, const void* wu, void* out, int rows, int h,
                 int inter, cudaStream_t s) {
  if (rows <= 1) launch_rows_r<T, 1>(x, wg, wu, out, rows, h, inter, s);
  else if (rows <= 2) launch_rows_r<T, 2>(x, wg, wu, out, rows, h, inter, s);
  else if (rows <= 4) launch_rows_r<T, 4>(x, wg, wu, out, rows, h, inter, s);
  else launch_rows_r<T, kSmallRows>(x, wg, wu, out, rows, h, inter, s);
}

template <bool kBwd>  // as swiglu_bf16_kernel
__global__ void swiglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                                  const float* __restrict__ wu, const float* __restrict__ gin,
                                  float* __restrict__ out, float* __restrict__ out2, int rows,
                                  int h, int inter) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (i >= inter) return;
  const float* xr = x + static_cast<size_t>(r) * h;
  const float* gr = wg + static_cast<size_t>(i) * h;
  const float* ur = wu + static_cast<size_t>(i) * h;
  float g = 0.f, u = 0.f;
  for (int k = 0; k < h; ++k) {
    g = fmaf(xr[k], gr[k], g);
    u = fmaf(xr[k], ur[k], u);
  }
  const size_t o = static_cast<size_t>(r) * inter + i;
  if (kBwd)
    swiglu_grad(g, u, gin[o], out[o], out2[o]);
  else
    out[o] = silu(g) * u;
}

template <bool kBwd>
void launch_tile(const void* x, const void* wg, const void* wu, const void* g, void* out,
                 void* out2, int rows, int h, int inter, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bool vec = h % 8 == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  dim3 grid((inter + BN - 1) / BN, (rows + BM - 1) / BM);
  auto kernel = vec ? swiglu_bf16_kernel<true, kBwd> : swiglu_bf16_kernel<false, kBwd>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf*>(x), static_cast<const bf*>(wg),
                                   static_cast<const bf*>(wu), static_cast<const bf*>(g),
                                   static_cast<bf*>(out), static_cast<bf*>(out2), rows, h, inter);
}

template <bool kBwd>
void launch_f32(const void* x, const void* wg, const void* wu, const void* g, void* out,
                void* out2, int rows, int h, int inter, cudaStream_t s) {
  dim3 grid((inter + 127) / 128, rows);
  swiglu_f32_kernel<kBwd><<<grid, 128, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<const float*>(g), static_cast<float*>(out), static_cast<float*>(out2), rows, h,
      inter);
}

}  // namespace

extern "C" int l32_swiglu_fwd(const void* x, const void* wg, const void* wu, void* out,
                              int rows, int h, int inter, int dtype, void* stream) {
  if (rows == 0 || inter == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= kSmallRows && dtype == L32_BF16) {
    launch_rows<__nv_bfloat16>(x, wg, wu, out, rows, h, inter, s);
  } else if (rows <= kSmallRows && dtype == L32_F32) {
    launch_rows<float>(x, wg, wu, out, rows, h, inter, s);
  } else if (dtype == L32_BF16) {
    launch_tile<false>(x, wg, wu, nullptr, out, nullptr, rows, h, inter, s);
  } else if (dtype == L32_F32) {
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    launch_f32<false>(x, wg, wu, nullptr, out, nullptr, rows, h, inter, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_gate, d_up [rows, inter] from x [rows, h], both weights [inter, h] and
// the cotangent g [rows, inter]: the tile kernel (bf16) or the loop (fp32),
// at every row count.
extern "C" int l32_swiglu_bwd(const void* x, const void* wg, const void* wu, const void* g,
                              void* d_gate, void* d_up, int rows, int h, int inter, int dtype,
                              void* stream) {
  if (rows == 0 || inter == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == L32_BF16) {
    launch_tile<true>(x, wg, wu, g, d_gate, d_up, rows, h, inter, s);
  } else if (dtype == L32_F32) {
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    launch_f32<true>(x, wg, wu, g, d_gate, d_up, rows, h, inter, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
