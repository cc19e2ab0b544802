// Dequantizing GEMM for more than 32 rows: out[r, n] = sum_k x[r, k] * w[n, k]
// with x [R, K] and the weight quantized in nn.Linear's [N, K] orientation:
//
//   int8: q [N, K] int8, scale [N] fp32; w = q (exact in bf16) and the
//         scale multiplies the fp32 result (JAX's int8 qlinear numerics);
//   int4: q4 [N, K/2] uint8 in the split-half per-group packing (u = q + 8),
//         scale [N, K/g] fp32; w = (u - 8) * scale rounded to bf16, exactly
//         ops/quant.py::dequantize_weight(qw, bf16) (JAX's rows > 64 path).
//
// Replaces the TPU kernels llama32mm_tpu/ops/pallas/quant_matmul.py::_kernel
// (int8_matmul_pallas) and ::_int4_kernel (int4_matmul_pallas). Unlike the
// latter there is no fp32 raw output and no host-side "-8 * xsum @ scale"
// offset correction: the offset is removed per weight before the product.
//
// Bound on the H100: at prefill (R = 1632) tensor-core FLOPs, ~28.5 TFLOP of
// quantized decoder linears per prompt at 11B against ~8.7 GB (int8) of
// weights. Design: swiglu.cu's tile with one B operand. Each block owns a
// 128 x 64 output tile; eight warps (4 x 2, 32 x 32 each) run bf16 16x16x16
// mma.sync (nvcuda::wmma) into fp32 accumulators. A k-step covers 32 k: the
// x slice is staged through a two-deep shared-memory ring with cp.async, and
// the weight slice is read into registers one step ahead (8 int8 or 4 packed
// bytes a thread), dequantized to bf16 and stored into the ring after the
// current step's products, so its load latency hides behind them. An int4
// k-step is one 16-byte chunk of each packed row: the low nibbles of 16
// consecutive k and the high nibbles of the 16 k that sit g/2 later. The
// step's 32 x columns are staged in that same order (two contiguous runs of
// 16), which leaves the sum unchanged. Ragged R and N are zero-filled at
// staging and bounds-checked at the write; a K the vector staging cannot
// take (int8: K % 16 != 0; int4: g/2 % 16 != 0; misaligned pointers) stages
// element by element. fp32 inputs run a plain SIMT loop (one thread per
// output): the main path runs bf16, the fp32 kernel lets the wrapper take
// both types. No TMA, no wgmma: later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int LDS = BK + 8;    // bf16 per staged row: 80 bytes, padding vs bank conflicts
constexpr int LDC = BN + 4;    // floats per epilogue row
constexpr int kThreads = 256;  // 8 warps, 4 x 2 over the 128 x 64 tile

constexpr int kStageElems = (BM + BN) * LDS;  // x and weight slices
constexpr int kRingBytes = 2 * kStageElems * 2;
constexpr int kEpilogueBytes = BM * LDC * 4;
constexpr int kSmemBytes = kRingBytes > kEpilogueBytes ? kRingBytes : kEpilogueBytes;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory limit");

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

// The k of column c (0..31) of k-step kt: two runs of 16 starting at a0 and
// b0. int8 (and any element-wise staging): b0 = a0 + 16. int4 vector
// staging: the packed chunk [16 kt, 16 kt + 16) of group grp at offset p
// holds k = grp*g + p .. +15 (low nibbles) and the same + g/2 (high).
template <int BITS, bool kVec>
__device__ __forceinline__ int step_k0(int kt, int g, int& b0) {
  if (BITS == 4 && kVec) {
    const int c = kt * 16, g2 = g / 2;
    const int grp = c / g2;
    const int a0 = grp * g + (c - grp * g2);
    b0 = a0 + g2;
    return a0;
  }
  b0 = kt * BK + 16;
  return kt * BK;
}

// The dequantized weight w[n, k] as a float (element-wise staging).
template <int BITS>
__device__ __forceinline__ float weight_at(const void* wq, const float* scale, int n, int k,
                                           int kk, int g) {
  if (BITS == 8)
    return static_cast<float>(static_cast<const int8_t*>(wq)[static_cast<size_t>(n) * k + kk]);
  const int g2 = g / 2, grp = kk / g, i = kk - grp * g;
  const int b = static_cast<const uint8_t*>(wq)[static_cast<size_t>(n) * (k / 2) + grp * g2 +
                                                (i < g2 ? i : i - g2)];
  const int u = i < g2 ? (b & 0xF) : (b >> 4);
  return static_cast<float>(u - 8) * scale[static_cast<size_t>(n) * (k / g) + grp];
}

template <int BITS, bool kVec>
__global__ void __launch_bounds__(kThreads)
qmatmul_bf16_kernel(const bf16* __restrict__ x, const void* __restrict__ wq,
                    const float* __restrict__ scale, bf16* __restrict__ out, int rows, int n,
                    int k, int g) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int nk = (BITS == 4 && kVec) ? k / 32 : (k + BK - 1) / BK;

  // x slice [BM, 32] of k-step kt into buffer buf.
  auto stage_x = [&](int buf, int kt) {
    bf16* xs = ring + buf * kStageElems;
    int b0;
    const int a0 = step_k0<BITS, kVec>(kt, g, b0);
    if (kVec) {
      for (int v = tid; v < BM * 4; v += kThreads) {
        const int r = v >> 2, h = v & 3;
        const int kc = (h < 2 ? a0 : b0) + (h & 1) * 8;
        const bool in = m0 + r < rows && kc < k;
        cp_async16(xs + r * LDS + h * 8, in ? x + static_cast<size_t>(m0 + r) * k + kc : x, in);
      }
    } else {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const int kc = (c < 16 ? a0 : b0) + (c & 15);
        xs[r * LDS + c] = (m0 + r < rows && kc < k) ? x[static_cast<size_t>(m0 + r) * k + kc]
                                                    : __float2bfloat16(0.f);
      }
    }
  };

  // Vector weight staging: each thread owns one [row, 8-column] piece of
  // the [BN, 32] slice (int8: 8 bytes; int4: 4 packed bytes = 4 low + 4
  // high weights). fetch_w reads it into registers, store_w dequantizes it
  // into the ring.
  const int wrow = tid >> 2, wq4 = tid & 3;  // row of the slice, quarter
  uint2 wraw8 = make_uint2(0, 0);
  uint32_t wraw4 = 0;
  float wscale = 0.f;
  auto fetch_w = [&](int kt) {
    const int nn = n0 + wrow;
    if (BITS == 8) {
      const int kc = kt * BK + wq4 * 8;
      wraw8 = (nn < n && kc < k)
                  ? *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(wq) +
                                                    static_cast<size_t>(nn) * k + kc)
                  : make_uint2(0, 0);
    } else {
      const int c = kt * 16;
      if (nn < n) {
        wraw4 = *reinterpret_cast<const uint32_t*>(static_cast<const uint8_t*>(wq) +
                                                   static_cast<size_t>(nn) * (k / 2) + c + wq4 * 4);
        wscale = scale[static_cast<size_t>(nn) * (k / g) + c / (g / 2)];
      } else {
        wraw4 = 0x88888888u;  // u = 8 everywhere: a zero weight
        wscale = 0.f;
      }
    }
  };
  auto store_w = [&](int buf) {
    bf16* ws = ring + buf * kStageElems + BM * LDS + wrow * LDS;
    if (BITS == 8) {
      const int8_t* b = reinterpret_cast<const int8_t*>(&wraw8);
      __align__(16) bf16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(static_cast<float>(b[j]));
      *reinterpret_cast<uint4*>(ws + wq4 * 8) = *reinterpret_cast<const uint4*>(v);
    } else {
      __align__(8) bf16 lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bv = (wraw4 >> (8 * j)) & 0xFF;
        lo[j] = __float2bfloat16(static_cast<float>((bv & 0xF) - 8) * wscale);
        hi[j] = __float2bfloat16(static_cast<float>((bv >> 4) - 8) * wscale);
      }
      *reinterpret_cast<uint2*>(ws + wq4 * 4) = *reinterpret_cast<const uint2*>(lo);
      *reinterpret_cast<uint2*>(ws + 16 + wq4 * 4) = *reinterpret_cast<const uint2*>(hi);
    }
  };
  // Element-wise weight staging, for the shapes the vector form cannot take.
  auto fill_w = [&](int buf, int kt) {
    bf16* ws = ring + buf * kStageElems + BM * LDS;
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int kc = kt * BK + c;
      ws[r * LDS + c] = (n0 + r < n && kc < k)
                            ? __float2bfloat16(weight_at<BITS>(wq, scale, n0 + r, k, kc, g))
                            : __float2bfloat16(0.f);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  stage_x(0, 0);
  cp_async_commit();
  if (kVec) {
    fetch_w(0);
    store_w(0);
  } else {
    fill_w(0, 0);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {
      stage_x((kt + 1) & 1, kt + 1);  // the buffer consumed last iteration
      cp_async_commit();
      if (kVec) fetch_w(kt + 1);      // registers only: stored after the products
      else fill_w((kt + 1) & 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = ring + (kt & 1) * kStageElems;
    const bf16* ws = xs + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the [N, K] weight slice read column-major is the [K, N] B operand
        wmma::load_matrix_sync(b, ws + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    if (more && kVec) store_w((kt + 1) & 1);
    __syncthreads();  // the next iteration reads the stored weights / overwrites this buffer
  }

  // Epilogue through shared memory (reusing the ring): the int8 channel
  // scale in fp32, one rounding per element.
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < rows && gc < n) {
      const float v = cs[r * LDC + c] * (BITS == 8 ? scale[gc] : 1.f);
      out[static_cast<size_t>(gr) * n + gc] = __float2bfloat16(v);
    }
  }
}

template <int BITS>
__global__ void qmatmul_f32_kernel(const float* __restrict__ x, const void* __restrict__ wq,
                                   const float* __restrict__ scale, float* __restrict__ out,
                                   int rows, int n, int k, int g) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (col >= n) return;
  const float* xr = x + static_cast<size_t>(r) * k;
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) acc = fmaf(xr[kk], weight_at<BITS>(wq, scale, col, k, kk, g), acc);
  out[static_cast<size_t>(r) * n + col] = BITS == 8 ? acc * scale[col] : acc;
}

template <int BITS>
int launch(const void* x, const void* wq, const float* scale, void* out, int rows, int n, int k,
           int g, int dtype, cudaStream_t s) {
  if (dtype == L32_BF16) {
    const bool aligned = aligned16(x) && aligned16(wq);
    const bool vec = aligned && (BITS == 8 ? k % 16 == 0 : (g / 2) % 16 == 0);
    if ((rows + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + BN - 1) / BN, (rows + BM - 1) / BM);
    auto kernel = vec ? qmatmul_bf16_kernel<BITS, true> : qmatmul_bf16_kernel<BITS, false>;
    kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x), wq, scale,
                                     static_cast<bf16*>(out), rows, n, k, g);
  } else if (dtype == L32_F32) {
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + 127) / 128, rows);
    qmatmul_f32_kernel<BITS><<<grid, 128, 0, s>>>(static_cast<const float*>(x), wq, scale,
                                                  static_cast<float*>(out), rows, n, k, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// g = 0: int8 weights q [N, K]; g > 0: int4 weights q4 [N, K/2], group size g.
extern "C" int l32_qmatmul(const void* x, const void* wq, const void* scale, void* out, int rows,
                           int n, int k, int g, int dtype, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (g < 0 || (g > 0 && (g % 2 || k % g))) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int err = g == 0 ? launch<8>(x, wq, sc, out, rows, n, k, g, dtype, s)
                         : launch<4>(x, wq, sc, out, rows, n, k, g, dtype, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
