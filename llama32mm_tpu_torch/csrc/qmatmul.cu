// Dequantizing GEMM for more than 32 rows: out[r, n] = sum_k x[r, k] * w[n, k]
// with x [R, K] and the weight quantized in nn.Linear's [N, K] orientation:
//
//   int8: q [N, K] int8, scale [N] fp32; w = q (exact in bf16) and the
//         scale multiplies the fp32 result (JAX's int8 qlinear numerics);
//   int4: q4 [N, K/2] uint8 in the split-half per-group packing (u = q + 8),
//         scale [N, K/g] fp32; w = (u - 8) * scale in fp32 rounded to bf16,
//         exactly ops/quant.py::dequantize_weight(qw, bf16) (JAX's rows > 64
//         path).
//
// Replaces the TPU kernels llama32mm_tpu/ops/pallas/quant_matmul.py::_kernel
// (int8_matmul_pallas) and ::_int4_kernel (int4_matmul_pallas). Unlike the
// latter there is no fp32 raw output and no host-side "-8 * xsum @ scale"
// offset correction: the offset is removed per weight before the product.
//
// Bound on the H100: tensor-core operations. The 11B prefill (R = 1632) runs
// 280 of these a prompt, ~28.5 TFLOP (29 ms at 989 TFLOP/s) against ~8.7 GB
// of int8 weights (2.6 ms at 3.35 TB/s); w_gate alone is 191.7 GFLOP, 0.1938
// ms. l32_qmatmul routes by shape (route()), never by failure:
//
// 1. The wgmma kernel (tc::qmatmul_wgmma_kernel) takes bf16 x with int8
//    weights and K % 64 == 0, or int4 weights and (g / 2) % 32 == 0, x and
//    the weight 16-byte aligned: every linear of the 11B prefill, int8 and
//    INT4_MIXED_RECIPE. A block owns 128 rows of x and a column tile of 256
//    outputs (N > 4096: half the x bytes a product reads) or 128 (N <= 4096,
//    where 256-wide tiles would leave most SMs idle); the row tiles of one
//    column tile are adjacent block indices, so a weight tile is read from
//    HBM once and from L2 by the rest. Two consumer warpgroups each own 64
//    rows: wgmma m64n{256,128}k16 with both operands K-major in shared
//    memory in 128-byte swizzled rows (csrc/wgmma.cuh), fp32 accumulators in
//    registers. A k-tile is 64 k: x comes through a 4-stage ring of 16-byte
//    cp.async copies, two tiles ahead, 8 lanes to a row's 128-byte L2 line
//    (rows past R zero-filled); each thread loads its 16-byte pieces of the
//    next weight tile into registers (16 int8, or 32 nibbles) and, while the
//    current tile's wgmmas run, dequantizes them into one of three bf16
//    buffers: int8 exactly with two LOP3s and a bf16x2 subtraction a pair;
//    int4 as the fp32 product (u - 8) * s from an exact 0x4B000000 magic per
//    nibble, rounded once to bf16 as dequantize_weight does. An int4 k-tile
//    is 32 packed bytes of one group: the low nibbles of 32 consecutive k and
//    the high nibbles of the 32 k g/2 later; the tile's x columns are staged
//    in the same order, which leaves the sum unchanged. Rows past N are a
//    zero weight (int4: u = 8). The epilogue multiplies the int8 channel
//    scale in fp32 and rounds once, storing bf16 pairs from the accumulator
//    layout, bounds-checked. No split-K and no atomics: each output's k
//    order is fixed by K and g (and the tile width by N), never by R or by
//    the row tile it falls in, so a row's bits equal those of any other
//    call that holds it, and two calls are bit-equal.
//    Measured (profile_qmatmul.py, device time, NVIDIA H100 80GB HBM3 at
//    700 W, R = 1632): int4 w_gate 0.64 ms, int8 w_gate 0.59, w_down 0.76,
//    W_query 0.24, W_key 0.063, 25-33% of their bounds (the wmma kernel:
//    1.81, 1.34, 1.45, 0.43, 0.14). The products alone, with no copies or
//    dequantization in the loop, run w_gate in 0.24 ms: what holds the
//    kernel back is feeding the SMs from L2 (x copies and weight loads, each
//    a cost of its own; the dequantization arithmetic, the proxy fence and
//    two blocks an SM cost or gain nothing). TMA with multicast across a
//    cluster and a producer warp are the next step.
// 2. The wmma kernel (qmatmul_bf16_kernel) takes every other bf16 call
//    (int8 K % 64 != 0, such as K = 4100; int4 g = 32, 24; misaligned
//    pointers): a 128 x 64 tile, eight warps of nvcuda::wmma 16x16x16
//    mma.sync, BK = 32, x through a two-deep cp.async ring, the weight slice
//    read into registers one step ahead and dequantized after the step's
//    products; shapes the vector staging cannot take (int8: K % 16 != 0;
//    int4: g/2 % 16 != 0) stage element by element.
// 3. fp32 x runs a plain SIMT loop (one thread per output): the tiny fp32
//    checks; the main path runs bf16.
#include <limits.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

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
        async_copy<16>(xs + r * LDS + h * 8, in ? x + static_cast<size_t>(m0 + r) * k + kc : x, in);
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
  async_commit();
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
      async_commit();
      if (kVec) fetch_w(kt + 1);      // registers only: stored after the products
      else fill_w((kt + 1) & 1, kt + 1);
      async_wait<1>();
    } else {
      async_wait<0>();
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

// The wmma kernel (bf16) or the SIMT loop (fp32), any shape.
template <int BITS>
int launch_wmma(const void* x, const void* wq, const float* scale, void* out, int rows, int n,
                int k, int g, int dtype, cudaStream_t s) {
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


// ---------------------------------------------------------------------------
// The wgmma kernel: bf16 x, int8 weights with K % 64 == 0 or int4 weights
// with (g / 2) % 32 == 0, 16-byte-aligned x and weight.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;                 // x rows per block: 64 per consumer warpgroup
constexpr int kBK = 64;                  // k per tile
constexpr int kThreads = 256;            // two warpgroups
constexpr int kXStages = 4;              // x ring: tile t + 2 lands while t and t - 1 are read
constexpr int kWBufs = 3;                // dequantized weight tiles: t, t - 1 read, t + 1 written
constexpr int kXTile = kBM * kBK * 2;    // bytes of one bf16 x tile: 128-byte swizzled rows

template <int BN>
struct Geom {
  static constexpr int kWTile = BN * kBK * 2;  // one dequantized weight tile, the same layout
  static constexpr int kSmem = kXStages * kXTile + kWBufs * kWTile + 1024;  // + alignment
};

// Two exact bf16 values from two int8 bytes of w (sel picks them, zero
// bytes between; int8x2_bf16x2 in common.cuh).
__device__ __forceinline__ uint32_t int8x2_bf16x2(uint32_t w, uint32_t sel) {
  return ::int8x2_bf16x2(__byte_perm(w, 0, sel));
}

// float(u - 8) * s rounded once in fp32, for the nibble u at bit P (<= 12)
// of w, given sp = s * 2^-P: the fp32 0x4B000000 | (u << P) is 2^23 + u 2^P,
// so subtracting 2^23 + 8 2^P leaves (u - 8) 2^P exactly, and the product
// with s 2^-P is the product (u - 8) s, rounded the same way.
template <int P>
__device__ __forceinline__ float nibble_times(uint32_t w, float sp) {
  const float f = __uint_as_float(0x4B000000u | (w & (0xFu << P)));
  return (f - (8388608.f + 8.f * (1 << P))) * sp;
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) wgmma_ss_m64n256k16(d, desc_a, desc_b, 1);
  else wgmma_ss_m64n128k16(d, desc_a, desc_b, 1);
}

template <int BITS, int BN>
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_wgmma_kernel(const bf16* __restrict__ x, const void* __restrict__ wq,
                     const float* __restrict__ scale, bf16* __restrict__ out, int rows, int n,
                     int k, int g, int m_tiles) {
  using G = Geom<BN>;
  constexpr int kUpr = BITS == 8 ? 4 : 2;  // 16-byte weight loads per row of a tile
  constexpr int kUnits = BN * kUpr;
  constexpr int kPer = kUnits / kThreads;   // loads a thread, 1 to 4
  static_assert(kUnits % kThreads == 0, "every thread loads the same number of pieces");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte-aligned bases.
  const uint32_t misalign = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023;
  unsigned char* smem = smem_raw + ((1024 - misalign) & 1023);
  unsigned char* xs = smem;                       // tile t in stage t % kXStages
  unsigned char* ws = smem + kXStages * kXTile;   // tile t in buffer t % kWBufs

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = (blockIdx.x % m_tiles) * kBM;    // the row tiles of one column tile run
  const int n0 = (blockIdx.x / m_tiles) * BN;     // side by side: its weights come from L2
  const int nk = k / kBK;
  const int g2 = g / 2;

  // The k of tile kt's columns: two runs of 32 at a0 and b0. int8: one run
  // of 64. int4: packed bytes [32 kt, 32 kt + 32) lie in one group and
  // hold k = grp g + p .. + 31 (low nibbles) and the same + g/2 (high).
  auto runs = [&](int kt, int& b0) {
    if (BITS == 8) {
      b0 = kt * kBK + 32;
      return kt * kBK;
    }
    const int c = kt * 32, grp = c / g2;
    const int a0 = grp * g + (c - grp * g2);
    b0 = a0 + g2;
    return a0;
  };

  // x tile kt into stage buf: 16-byte cp.async copies, rows past the end
  // zero-filled; 8 lanes copy one row's 128 bytes, one whole L2 line (the
  // swizzle spreads them over the banks).
  auto stage_x = [&](int kt, int buf) {
    unsigned char* dst = xs + buf * kXTile;
    int b0;
    const int a0 = runs(kt, b0);
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int u = tid + kThreads * i;
      const int r = u >> 3, c = u & 7;
      const int kc = (c < 4 ? a0 : b0) + 8 * (c & 3);
      const bool in = m0 + r < rows;
      async_copy<16>(dst + sw128_at(r, c),
                     x + static_cast<size_t>(in ? m0 + r : 0) * k + kc, in);
    }
  };

  // The weight tile: unit u is 16 packed bytes of row (u / (8 kUpr)) * 8 +
  // u % 8, part j = (u / 8) % kUpr. fetch_w reads a tile's units into
  // registers (rows past N: a zero weight), store_w dequantizes them into a
  // bf16 buffer; 8 lanes store one chunk of 8 rows, on 8 banks.
  uint4 raw[kPer];
  float wsc[kPer];
  auto fetch_w = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + kThreads * i;
      const int r = u / (8 * kUpr) * 8 + (u & 7), j = (u >> 3) % kUpr;
      const int nn = n0 + r;
      if (BITS == 8) {
        raw[i] = nn < n ? *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(wq) +
                                                          static_cast<size_t>(nn) * k +
                                                          kt * kBK + 16 * j)
                        : make_uint4(0, 0, 0, 0);
      } else if (nn < n) {
        raw[i] = *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(wq) +
                                                 static_cast<size_t>(nn) * (k / 2) + kt * 32 +
                                                 16 * j);
        wsc[i] = scale[static_cast<size_t>(nn) * (k / g) + kt * 32 / g2];
      } else {
        raw[i] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);  // u = 8: 0
        wsc[i] = 0.f;
      }
    }
  };
  auto store_w = [&](int buf) {
    unsigned char* dst = ws + buf * G::kWTile;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + kThreads * i;
      const int r = u / (8 * kUpr) * 8 + (u & 7), j = (u >> 3) % kUpr;
      const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
      if (BITS == 8) {  // 16 int8 k -> columns 16 j .. 16 j + 15
        uint4 lo, hi;
        lo.x = int8x2_bf16x2(w[0], 0x4140);
        lo.y = int8x2_bf16x2(w[0], 0x4342);
        lo.z = int8x2_bf16x2(w[1], 0x4140);
        lo.w = int8x2_bf16x2(w[1], 0x4342);
        hi.x = int8x2_bf16x2(w[2], 0x4140);
        hi.y = int8x2_bf16x2(w[2], 0x4342);
        hi.z = int8x2_bf16x2(w[3], 0x4140);
        hi.w = int8x2_bf16x2(w[3], 0x4342);
        *reinterpret_cast<uint4*>(dst + sw128_at(r, 2 * j)) = lo;
        *reinterpret_cast<uint4*>(dst + sw128_at(r, 2 * j + 1)) = hi;
      } else {  // byte b: low nibble -> column 16 j + b, high -> 32 + 16 j + b
        const float s = wsc[i];
        const float sp[4] = {s, s * 0.0625f, s * 0.00390625f, s * 0.000244140625f};
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t a = w[q], b = w[q] >> 16;  // bytes 4q, 4q+1 and 4q+2, 4q+3 at bit 0
          lo[2 * q] = pack_bf16(nibble_times<0>(a, sp[0]), nibble_times<8>(a, sp[2]));
          lo[2 * q + 1] = pack_bf16(nibble_times<0>(b, sp[0]), nibble_times<8>(b, sp[2]));
          hi[2 * q] = pack_bf16(nibble_times<4>(a, sp[1]), nibble_times<12>(a, sp[3]));
          hi[2 * q + 1] = pack_bf16(nibble_times<4>(b, sp[1]), nibble_times<12>(b, sp[3]));
        }
        *reinterpret_cast<uint4*>(dst + sw128_at(r, 2 * j)) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(dst + sw128_at(r, 2 * j + 1)) =
            make_uint4(lo[4], lo[5], lo[6], lo[7]);
        *reinterpret_cast<uint4*>(dst + sw128_at(r, 4 + 2 * j)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(dst + sw128_at(r, 5 + 2 * j)) =
            make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
  };

  // acc: this warpgroup's 64 x BN fp32 sums; thread (warp w, lane) holds
  // rows 16 w + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1) at
  // acc[4 j + 2 half + e].
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // acc += x tile t (this warpgroup's 64 rows) times weight tile t:
  // 4 k16 steps, both operands K-major from shared memory.
  auto issue = [&](int t) {
    const unsigned char* xa = xs + (t % kXStages) * kXTile + wg * 64 * 128;
    const unsigned char* wb = ws + (t % kWBufs) * G::kWTile;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<BN>(acc, sw128_desc(xa + kk * 32), sw128_desc(wb + kk * 32));
    wgmma_commit();
  };

  // Prologue: x tiles 0 and 1 in flight (one commit group each), weight
  // tile 0 dequantized, tile 1 in registers.
  stage_x(0, 0);
  async_commit();
  if (nk > 1) stage_x(1, 1);
  async_commit();
  fetch_w(0);
  store_w(0);
  if (nk > 1) fetch_w(1);
  // Iteration t: the products of tile t run on the tensor cores while the
  // threads stage x tile t + 2, dequantize weight tile t + 1 into its
  // buffer and load tile t + 2. Waiting for tile t - 1's products before
  // that, then the next iteration's barrier, frees the buffers tile t - 2
  // used: the ones written here.
  for (int t = 0; t < nk; ++t) {
    async_wait<1>();  // this thread's copies of x tile t have landed
    fence_proxy_async();
    __syncthreads();  // ... everyone's, and weight tile t is stored
    issue(t);
    wgmma_wait<1>();
    fence_regs(acc);
    if (t + 2 < nk) stage_x(t + 2, (t + 2) % kXStages);
    async_commit();
    if (t + 1 < nk) {
      store_w((t + 1) % kWBufs);
      if (t + 2 < nk) fetch_w(t + 2);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: the int8 channel scale in fp32, one rounding per element,
  // bf16 pairs stored from the accumulator layout; ragged edges checked.
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r_lo = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= n) break;
    const bool two = col + 1 < n;
    float s0 = 1.f, s1 = 1.f;
    if (BITS == 8) {
      s0 = scale[col];
      s1 = two ? scale[col + 1] : 0.f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r_lo + 8 * half;
      if (row >= rows) continue;
      bf16* o = out + static_cast<size_t>(row) * n + col;
      const float v0 = acc[4 * j + 2 * half] * s0, v1 = acc[4 * j + 2 * half + 1] * s1;
      if (pairs && two) {
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (two) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

// Column tiles of 256 (m64n256k16) for N > 4096, where they halve the x
// bytes a product reads, else 128 (m64n128k16), where 256-wide tiles would
// leave most SMs idle (W_key: 52 blocks). The choice depends on N alone, so
// a row's bits never depend on R.
template <int BITS>
int launch_wgmma(const void* x, const void* wq, const float* scale, void* out, int rows, int n,
                 int k, int g, cudaStream_t s) {
  auto go = [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    const long long m_tiles = (rows + kBM - 1) / kBM, n_tiles = (n + BN - 1) / BN;
    if (m_tiles * n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = qmatmul_wgmma_kernel<BITS, BN>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<BN>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<int>(m_tiles * n_tiles), kThreads, Geom<BN>::kSmem, s>>>(
        static_cast<const bf16*>(x), wq, scale, static_cast<bf16*>(out), rows, n, k, g,
        static_cast<int>(m_tiles));
    return 0;
  };
  return n > 4096 ? go(std::integral_constant<int, 256>{}) : go(std::integral_constant<int, 128>{});
}

}  // namespace tc

enum { kSimt = 0, kWmma = 1, kWgmma = 2 };

// The kernel a call takes: fp32 x the SIMT loop; bf16 x the wgmma kernel
// when its tiles fit (int8: K a multiple of 64; int4: g/2 a multiple of 32)
// and x and the weight are 16-byte aligned, else the wmma kernel.
int route(const void* x, const void* wq, int k, int g, int dtype) {
  if (dtype == L32_F32) return kSimt;
  if (dtype != L32_BF16) return -1;
  const bool tiles = k > 0 && (g == 0 ? k % tc::kBK == 0 : (g / 2) % 32 == 0);
  return tiles && aligned16(x) && aligned16(wq) ? kWgmma : kWmma;
}

}  // namespace

// g = 0: int8 weights q [N, K]; g > 0: int4 weights q4 [N, K/2], group size
// g. kernel -1 routes by shape (route above); 0 SIMT, 1 wmma, 2 wgmma ask for
// that kernel, and a kernel that does not take the call is an error.
// *launched is set to the kernel launched, or -1 where none was (no rows or
// no columns, or an error).
extern "C" int l32_qmatmul(const void* x, const void* wq, const void* scale, void* out, int rows,
                           int n, int k, int g, int dtype, int kernel, int* launched,
                           void* stream) {
  *launched = -1;
  if (rows == 0 || n == 0) return 0;
  if (g < 0 || (g > 0 && (g % 2 || k % g))) return static_cast<int>(cudaErrorInvalidValue);
  const int routed = route(x, wq, k, g, dtype);
  if (kernel == -1) kernel = routed;
  const bool takes = kernel == routed || (kernel == kWmma && dtype == L32_BF16);
  if (routed < 0 || !takes) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int err;
  if (kernel == kWgmma)
    err = g == 0 ? tc::launch_wgmma<8>(x, wq, sc, out, rows, n, k, g, s)
                 : tc::launch_wgmma<4>(x, wq, sc, out, rows, n, k, g, s);
  else
    err = g == 0 ? launch_wmma<8>(x, wq, sc, out, rows, n, k, g, dtype, s)
                 : launch_wmma<4>(x, wq, sc, out, rows, n, k, g, dtype, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}
