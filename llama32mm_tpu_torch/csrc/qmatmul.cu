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
// ms. Every call runs on one wgmma kernel, tc::qmatmul_wgmma_kernel;
// l32_qmatmul routes by shape (as_is()), never by failure:
//
// 1. The direct route takes bf16 x as it is where the kernel's tiles fit it
//    (int8: K % 64 == 0; int4: (g / 2) % 32 == 0) and x and the weight are
//    16-byte aligned: every linear of the 11B prefill, int8 and
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
//    order is fixed by K and g (and the tile width by N and x's dtype), never
//    by R or by the row tile it falls in, so a row's bits equal those of any
//    other call that holds it, and two calls are bit-equal.
//    Measured (profile_qmatmul.py, device time, NVIDIA H100 80GB HBM3 at
//    700 W, R = 1632): int4 w_gate 0.64 ms, int8 w_gate 0.59, w_down 0.76,
//    W_query 0.24, W_key 0.063, 25-33% of their bounds. The products alone,
//    with no copies or dequantization in the loop, run w_gate in 0.24 ms:
//    what holds the kernel back is feeding the SMs from L2 (x copies and
//    weight loads, each a cost of its own; the dequantization arithmetic,
//    the proxy fence and two blocks an SM cost or gain nothing). TMA with
//    multicast across a cluster and a producer warp are the next step.
// 2. Every other call takes the general route: a pre-pass (split_rows_kernel,
//    common.cuh, one block a row) writes x once a call as bf16 planes whose
//    rows are whole k-tiles, zero-padded, and the same kernel reads them.
//    int8: natural order, rows of K rounded up to 64. int4: packed order
//    (the x of each weight byte's low nibble in one half of the row, of its
//    high nibble in the other), every group given whole 16-byte units
//    (span = g/2 rounded up to 16, zeros past g/2), so that each 16-byte unit
//    of a tile, and each k16 step of the products, lies in one group at
//    every group size (g = 32: two groups a tile; g = 24, 6, 2: one group a
//    unit, with 4, 13 or 15 zero slots). The kernel reads weight unit
//    (group j, unit w) from bytes j g/2 + 16 w of the row with load16_any
//    (any alignment; bytes past the group zeroed: u = 0 against a zero x)
//    and takes the unit's own group scale. An int8 row of any alignment or
//    length is read as aligned 16-byte chunks, one a piece as in an aligned
//    row: a lane loads the chunk that holds its piece's last byte, and the
//    chunk before it comes from the lane that loaded it (a shuffle; a row's
//    first piece: the previous tile's last chunk, kept in registers), then
//    a funnel shift (word loads, load16_any, took 3.01 ms at K = 4100, R =
//    1632; shuffles in the tile that issues the loads stall on them).
//    bf16 x: one plane, the weight bf16((u - 8) s) per unit, as
//    dequantize_weight rounds it. fp32 x: three
//    planes, x = b0 + b1 + b2 exactly (split_bf16x3), against exact bf16
//    weights (int8 q; int4 u - 8, never a rounded (u - 8) s): three wgmma
//    batches a k-tile into fresh fp32 partials (the tensor cores round their
//    fp32 accumulation toward zero, so no chain runs longer than a tile),
//    each partial added to the running fp32 total, the int4 group scale on
//    the partial: once a tile where a tile lies in one group (span a multiple
//    of 32), else once per 16-slot unit (k16 steps 0 and 2, then 1 and 3).
//    fp32 takes 128-wide column tiles (total and partial: 64 + 64 registers a
//    thread), three x stages of 3 x 16 KB and three weight buffers (195 KB of
//    shared memory), and stores fp32. The direct route's instantiations
//    compile from the same source with the general route's loads and
//    partials compiled out (their SASS is the single-route kernel's,
//    instruction for instruction).
//    Measured (profile_qmatmul.py --fp32 --general, device time, NVIDIA H100
//    80GB HBM3 at 700 W, R = 1632; the deleted kernels in parentheses): fp32
//    x int8 w_gate 1.29 ms (a one-thread-an-output SIMT loop: 388.41),
//    int4 w_gate g=128 1.37 (1125.06), 42-45% of the three products' bound;
//    bf16 int4 w_gate g=32 0.70 (wmma: 1.74), int8 w_gate K=4100 0.79
//    (5.56), the pre-pass 11-25 us of each.
#include <limits.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

namespace tc {

constexpr int kBM = 128;                 // x rows per block: 64 per consumer warpgroup
constexpr int kBK = 64;                  // k per tile
constexpr int kThreads = 256;            // two warpgroups
constexpr int kWBufs = 3;                // dequantized weight tiles: t, t - 1 read, t + 1 written
constexpr int kXTile = kBM * kBK * 2;    // bytes of one bf16 x tile: 128-byte swizzled rows

// x as it is (bf16), the general route's one bf16 plane, or three planes of fp32 x.
enum Mode { kDirect = 0, kGeneral = 1, kPlanes = 2 };

template <int BN, int MODE>
struct Geom {
  static constexpr int kP = MODE == kPlanes ? 3 : 1;          // x planes a stage
  // x ring: tile t + 2 lands while t (and, without partials, t - 1) is read
  static constexpr int kXStages = MODE == kPlanes ? 3 : 4;
  static constexpr int kWTile = BN * kBK * 2;  // one dequantized weight tile, the same layout
  static constexpr int kScales = MODE == kPlanes ? kWBufs * 2 * BN * 4 : 0;  // int4 unit scales
  static constexpr int kSmem = kXStages * kP * kXTile + kWBufs * kWTile + kScales + 1024;
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

// The 16 bytes that start sh (0..15) bytes into lo, continuing into hi.
__device__ __forceinline__ uint4 shift_bytes(uint4 lo, uint4 hi, int sh) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = sh >> 2;
  const uint32_t b = static_cast<uint32_t>(sh & 3) * 8;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(v[0], v[1], b), __funnelshift_r(v[1], v[2], b),
                    __funnelshift_r(v[2], v[3], b), __funnelshift_r(v[3], v[4], b));
}

// v with its bytes from `left` on set to 0 (all of them for left <= 0).
__device__ __forceinline__ uint4 bytes_before(uint4 v, long long left) {
  if (left >= 16) return v;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long keep = left - 4 * i;
    w[i] = keep >= 4 ? w[i] : keep <= 0 ? 0u : w[i] & ((1u << (8 * keep)) - 1u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 256) wgmma_ss_m64n256k16(d, desc_a, desc_b, scale_d);
  else wgmma_ss_m64n128k16(d, desc_a, desc_b, scale_d);
}

// The general route's x rows: ld elements a row, nk k-tiles; int4 packed
// halves of 32 nk elements, groups `span` (g/2 rounded up to 16) apart.
struct Layout {
  int nk, ld, units;  // units: 16-byte weight units a group (int4)
};

__host__ __device__ inline Layout general_layout(int k, int g) {
  if (g == 0) {
    const int nk = (k + kBK - 1) / kBK;
    return {nk, nk * kBK, 0};
  }
  const int units = (g / 2 + 15) / 16, nk = ((k / g) * units + 1) / 2;
  return {nk, 64 * nk, units};
}

template <int BITS, int BN, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_wgmma_kernel(const bf16* __restrict__ x, const void* __restrict__ wq,
                     const float* __restrict__ scale,
                     std::conditional_t<MODE == kPlanes, float, bf16>* __restrict__ out, int rows,
                     int n, int k, int g, int m_tiles) {
  using G = Geom<BN, MODE>;
  constexpr bool kGen = MODE != kDirect;
  constexpr int kUpr = BITS == 8 ? 4 : 2;  // 16-byte weight loads per row of a tile
  constexpr int kUnits = BN * kUpr;
  constexpr int kPer = kUnits / kThreads;   // loads a thread, 1 to 4
  static_assert(kUnits % kThreads == 0, "every thread loads the same number of pieces");
  static_assert(MODE != kPlanes || BN == 128, "fp32 x takes 128-wide column tiles");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte-aligned bases.
  const uint32_t misalign = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023;
  unsigned char* smem = smem_raw + ((1024 - misalign) & 1023);
  unsigned char* xs = smem;                                   // tile t in stage t % kXStages
  unsigned char* ws = smem + G::kXStages * G::kP * kXTile;    // tile t in buffer t % kWBufs
  float* scs = reinterpret_cast<float*>(ws + kWBufs * G::kWTile);  // [buffer][unit][row]

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int m0 = (blockIdx.x % m_tiles) * kBM;    // the row tiles of one column tile run
  const int n0 = (blockIdx.x / m_tiles) * BN;     // side by side: its weights come from L2
  const Layout lay = kGen ? general_layout(k, BITS == 8 ? 0 : g) : Layout{k / kBK, k, 0};
  const int nk = lay.nk;
  const int g2 = g / 2;

  // The k of tile kt's columns: two runs of 32 at a0 and b0. int8: one run
  // of 64. Direct int4: packed bytes [32 kt, 32 kt + 32) lie in one group
  // and hold k = grp g + p .. + 31 (low nibbles) and the same + g/2 (high).
  // General int4: the packed row's halves, ld / 2 apart.
  auto runs = [&](int kt, int& b0) {
    if (BITS == 8) {
      b0 = kt * kBK + 32;
      return kt * kBK;
    }
    if (kGen) {
      b0 = lay.ld / 2 + kt * 32;
      return kt * 32;
    }
    const int c = kt * 32, grp = c / g2;
    const int a0 = grp * g + (c - grp * g2);
    b0 = a0 + g2;
    return a0;
  };

  // x tile kt (each plane) into stage buf: 16-byte cp.async copies, rows
  // past the end zero-filled; 8 lanes copy one row's 128 bytes, one whole
  // L2 line (the swizzle spreads them over the banks).
  auto stage_x = [&](int kt, int buf) {
    unsigned char* dst = xs + buf * G::kP * kXTile;
    int b0;
    const int a0 = runs(kt, b0);
#pragma unroll
    for (int p = 0; p < G::kP; ++p) {
#pragma unroll
      for (int i = 0; i < kBM * 8 / kThreads; ++i) {
        const int u = tid + kThreads * i;
        const int r = u >> 3, c = u & 7;
        const int kc = (c < 4 ? a0 : b0) + 8 * (c & 3);
        const bool in = m0 + r < rows;
        async_copy<16>(dst + p * kXTile + sw128_at(r, c),
                       x + (static_cast<size_t>(p) * rows + (in ? m0 + r : 0)) * lay.ld + kc, in);
      }
    }
  };

  // The weight tile: unit u is 16 packed bytes of row (u / (8 kUpr)) * 8 +
  // u % 8, part j = (u / 8) % kUpr. fetch_w reads a tile's units into
  // registers (rows past N: a zero weight), store_w dequantizes them into a
  // bf16 buffer; 8 lanes store one chunk of 8 rows, on 8 banks. General
  // int4: part j of tile kt is unit 2 kt + j of the padded groups.
  uint4 raw[kPer];
  uint4 carry[kGen && BITS == 8 ? kPer : 1];  // general int8: the previous tile's raw
  float wsc[kPer];
  auto fetch_w = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + kThreads * i;
      const int r = u / (8 * kUpr) * 8 + (u & 7), j = (u >> 3) % kUpr;
      const int nn = n0 + r;
      if constexpr (kGen && BITS == 8) {
        // Rows of any alignment and length: the aligned 16 bytes that hold
        // the piece's last byte (all of it, in an aligned row); store_w
        // takes the 16 before from the lane 8 down, which holds the same
        // row's previous piece (a row's first piece: from the previous
        // tile's last, carried in registers).
        const uint8_t* row = static_cast<const uint8_t*>(wq) + static_cast<size_t>(nn) * k;
        const uint8_t* last = row + kt * kBK + 16 * j + 15;
        const uint8_t* e = last - (reinterpret_cast<uintptr_t>(last) & 15);
        raw[i] = nn < n && e < row + k ? load_stream16(e) : make_uint4(0, 0, 0, 0);
      } else if constexpr (kGen) {
        const int v = 2 * kt + j, grp = v / lay.units, w = v - grp * lay.units;
        if (nn < n && grp < k / g) {
          const uint8_t* p = static_cast<const uint8_t*>(wq) + static_cast<size_t>(nn) * (k / 2) +
                             grp * g2 + 16 * w;
          raw[i] = load16_any(p, p + (g2 - 16 * w < 16 ? g2 - 16 * w : 16));
          wsc[i] = scale[static_cast<size_t>(nn) * (k / g) + grp];
        } else {  // past N, or the padding unit after the last group
          raw[i] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);  // u = 8: 0
          wsc[i] = 0.f;
        }
      } else if (BITS == 8) {
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
  // fp32 x: the int4 weight is u - 8 exactly (s = 1) and the unit's scale
  // goes to shared memory, for the partials.
  auto store_w = [&](int buf, int kt) {
    unsigned char* dst = ws + buf * G::kWTile;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + kThreads * i;
      const int r = u / (8 * kUpr) * 8 + (u & 7), j = (u >> 3) % kUpr;
      if constexpr (kGen && BITS == 8) {  // the piece from two aligned chunks
        const uint8_t* row = static_cast<const uint8_t*>(wq) + static_cast<size_t>(n0 + r) * k;
        const uint8_t* at = row + kt * kBK + 16 * j;
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
        // (a warp whose rows are all aligned has K % 16 == 0: raw is the piece)
        if (!__all_sync(~0u, sh == 0)) {
          const uint4 give = j == kUpr - 1 ? carry[i] : raw[i];
          const int from = j == 0 ? lane + 8 * (kUpr - 1) : lane - 8;
          const uint4 lo = make_uint4(__shfl_sync(~0u, give.x, from), __shfl_sync(~0u, give.y, from),
                                      __shfl_sync(~0u, give.z, from), __shfl_sync(~0u, give.w, from));
          carry[i] = raw[i];
          raw[i] = bytes_before(sh ? shift_bytes(lo, raw[i], sh) : raw[i], row + k - at);
        }
      }
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
        if constexpr (MODE == kPlanes) scs[(buf * 2 + j) * BN + r] = wsc[i];
        const float s = MODE == kPlanes ? 1.f : wsc[i];
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
  // acc[4 j + 2 half + e]. fp32 x: acc is the running total and part the
  // current tile's (or unit's) partial, in the same layout.
  float acc[BN / 2];
  float part[BN / 2];  // fp32 x only
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // acc += x tile t (this warpgroup's 64 rows) times weight tile t:
  // 4 k16 steps, both operands K-major from shared memory.
  auto issue = [&](int t) {
    const unsigned char* xa = xs + (t % G::kXStages) * kXTile + wg * 64 * 128;
    const unsigned char* wb = ws + (t % kWBufs) * G::kWTile;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<BN>(acc, sw128_desc(xa + kk * 32), sw128_desc(wb + kk * 32), 1);
    wgmma_commit();
  };
  // part = the three planes of x tile t times weight tile t over the k16
  // steps in the mask `steps` (bit kk), the first product overwriting it.
  auto issue_planes = [&](int t, auto steps) {
    constexpr int kSteps = decltype(steps)::value, kFirst = kSteps & 1 ? 0 : 1;
    const unsigned char* xa = xs + (t % G::kXStages) * G::kP * kXTile + wg * 64 * 128;
    const unsigned char* wb = ws + (t % kWBufs) * G::kWTile;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < G::kP; ++p)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        if (kSteps >> kk & 1)
          wgmma_tile<BN>(part, sw128_desc(xa + p * kXTile + kk * 32), sw128_desc(wb + kk * 32),
                         p == 0 && kk == kFirst ? 0 : 1);
    wgmma_commit();
  };
  auto settle = [&] {
    wgmma_wait<0>();
    fence_regs(part);
  };
  // acc += part, times weight row c's scale of unit j of tile t (int4).
  auto flush = [&](int t, int j) {
    const float* sc = scs + ((t % kWBufs) * 2 + j) * BN;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      float2 s = make_float2(1.f, 1.f);
      if (BITS == 4) s = *reinterpret_cast<const float2*>(sc + 8 * jj + 2 * (lane & 3));
      acc[4 * jj] = fmaf(part[4 * jj], s.x, acc[4 * jj]);
      acc[4 * jj + 1] = fmaf(part[4 * jj + 1], s.y, acc[4 * jj + 1]);
      acc[4 * jj + 2] = fmaf(part[4 * jj + 2], s.x, acc[4 * jj + 2]);
      acc[4 * jj + 3] = fmaf(part[4 * jj + 3], s.y, acc[4 * jj + 3]);
    }
  };

  // Prologue: x tiles 0 and 1 in flight (one commit group each), weight
  // tile 0 dequantized, tile 1 in registers.
  stage_x(0, 0);
  async_commit();
  if (nk > 1) stage_x(1, 1);
  async_commit();
  if constexpr (kGen && BITS == 8) {  // tile -1's last chunk: the one holding the row's start
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = tid + kThreads * i, r = u / (8 * kUpr) * 8 + (u & 7);
      const uint8_t* row = static_cast<const uint8_t*>(wq) + static_cast<size_t>(n0 + r) * k;
      const uintptr_t sh = reinterpret_cast<uintptr_t>(row) & 15;
      carry[i] = n0 + r < n && sh ? load_stream16(row - sh) : make_uint4(0, 0, 0, 0);
    }
  }
  fetch_w(0);
  store_w(0, 0);
  if (nk > 1) fetch_w(1);
  if constexpr (MODE != kPlanes) {
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
      if (t + 2 < nk) stage_x(t + 2, (t + 2) % G::kXStages);
      async_commit();
      if (t + 1 < nk) {
        store_w((t + 1) % kWBufs, t + 1);
        if (t + 2 < nk) fetch_w(t + 2);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    // fp32 x: tile t's partial is added to the total before tile t + 1's
    // products overwrite it, so each iteration waits for its own products,
    // and the barrier at the top of the next frees the stage and buffer
    // that tile t - 1 read: 3 of each suffice. The staging of tiles t + 1
    // and t + 2 runs under the first (or only) batch of products.
    const bool per_unit = BITS == 4 && (lay.units & 1);  // a tile holds two groups
    for (int t = 0; t < nk; ++t) {
      async_wait<1>();
      fence_proxy_async();
      __syncthreads();
      auto stage = [&] {
        if (t + 2 < nk) stage_x(t + 2, (t + 2) % G::kXStages);
        async_commit();
        if (t + 1 < nk) {
          store_w((t + 1) % kWBufs, t + 1);
          if (t + 2 < nk) fetch_w(t + 2);
        }
      };
      if (per_unit) {
        issue_planes(t, std::integral_constant<int, 0b0101>{});  // k16 steps 0, 2: unit 0
        stage();
        settle();
        flush(t, 0);
        issue_planes(t, std::integral_constant<int, 0b1010>{});  // k16 steps 1, 3: unit 1
        settle();
        flush(t, 1);
      } else {
        issue_planes(t, std::integral_constant<int, 0b1111>{});
        stage();
        settle();
        flush(t, 0);
      }
    }
  }

  // Epilogue: the int8 channel scale in fp32, one rounding per element,
  // pairs stored from the accumulator layout; ragged edges checked.
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
      auto* o = out + static_cast<size_t>(row) * n + col;
      const float v0 = acc[4 * j + 2 * half] * s0, v1 = acc[4 * j + 2 * half + 1] * s1;
      if constexpr (MODE == kPlanes) {
        if (pairs && two) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      } else if (pairs && two) {
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (two) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

// Column tiles of 256 (m64n256k16) for bf16 x and N > 4096, where they
// halve the x bytes a product reads, else 128 (m64n128k16), where 256-wide
// tiles would leave most SMs idle (W_key: 52 blocks), and always for fp32 x
// (the partials' registers). The choice depends on N and x's dtype alone,
// so a row's bits never depend on R.
template <int BITS, int MODE>
int launch(const bf16* x, const void* wq, const float* scale, void* out, int rows, int n, int k,
           int g, cudaStream_t s) {
  auto go = [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    const long long m_tiles = (rows + kBM - 1) / kBM, n_tiles = (n + BN - 1) / BN;
    if (m_tiles * n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = qmatmul_wgmma_kernel<BITS, BN, MODE>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<BN, MODE>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    using Out = std::conditional_t<MODE == kPlanes, float, bf16>;
    kernel<<<static_cast<int>(m_tiles * n_tiles), kThreads, Geom<BN, MODE>::kSmem, s>>>(
        x, wq, scale, static_cast<Out*>(out), rows, n, k, g, static_cast<int>(m_tiles));
    return 0;
  };
  if constexpr (MODE == kPlanes) return go(std::integral_constant<int, 128>{});
  else return n > 4096 ? go(std::integral_constant<int, 256>{}) : go(std::integral_constant<int, 128>{});
}

// The general route: the pre-pass writes x's planes into xw (P = 3 for fp32
// x, 1 for bf16; rows of general_layout(k, g).ld), then the kernel reads them.
template <int BITS, typename T, int P>
int launch_general(const void* x, const void* wq, const float* scale, void* xw, void* out,
                   int rows, int n, int k, int g, cudaStream_t s) {
  const Layout lay = general_layout(k, g);
  auto pl = static_cast<uint16_t*>(xw);
  split_rows_kernel<T, P, BITS == 4><<<rows, kPlanesThreads, 0, s>>>(
      static_cast<const T*>(x), pl, rows, k, g, lay.ld, 16 * lay.units);
  return launch<BITS, P == 3 ? kPlanes : kGeneral>(static_cast<const bf16*>(xw), wq, scale, out,
                                                   rows, n, k, g, s);
}

}  // namespace tc

enum { kRouted = -1, kGeneralRoute = 0, kTc = 1 };

// Whether the wgmma kernel reads x as it is (the direct route): bf16 x whose
// tiles fit it (int8: K a multiple of 64; int4: g/2 a multiple of 32), x and
// the weight 16-byte aligned.
bool as_is(const void* x, const void* wq, int k, int g, int dtype) {
  const bool tiles = g == 0 ? k % tc::kBK == 0 : (g / 2) % 32 == 0;
  return dtype == L32_BF16 && tiles && aligned16(x) && aligned16(wq);
}

}  // namespace

// g = 0: int8 weights q [N, K]; g > 0: int4 weights q4 [N, K/2], group size
// g. xw: the general route's workspace, P * rows * ld bf16 (P = 3 for fp32
// x, 1 for bf16; ld: int8 K rounded up to 64, int4 64 * ceil((K/g) *
// ceil(g/32) / 2)), NULL where x is read as it is. kernel -1 routes by shape
// (as_is above); 0 (the general route) or 1 (x as it is) asks for that one,
// and a route that does not take the call is an error. *launched is set to
// the route launched, or -1 where none was (no rows or no columns, or an
// error).
extern "C" int l32_qmatmul(const void* x, const void* wq, const void* scale, void* xw, void* out,
                           int rows, int n, int k, int g, int dtype, int kernel, int* launched,
                           void* stream) {
  *launched = -1;
  if (rows == 0 || n == 0) return 0;
  if (k <= 0 || g < 0 || (g > 0 && (g % 2 || k % g)) || (dtype != L32_BF16 && dtype != L32_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool direct = as_is(x, wq, k, g, dtype);
  if (kernel == kRouted) kernel = direct ? kTc : kGeneralRoute;
  if (kernel != kGeneralRoute && !(kernel == kTc && direct))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == kGeneralRoute && xw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const bool fp32 = dtype == L32_F32;
  int err;
  if (kernel == kTc)
    err = g == 0 ? tc::launch<8, tc::kDirect>(static_cast<const bf16*>(x), wq, sc, out, rows, n,
                                              k, g, s)
                 : tc::launch<4, tc::kDirect>(static_cast<const bf16*>(x), wq, sc, out, rows, n,
                                              k, g, s);
  else if (g == 0)
    err = fp32 ? tc::launch_general<8, float, 3>(x, wq, sc, xw, out, rows, n, k, g, s)
               : tc::launch_general<8, bf16, 1>(x, wq, sc, xw, out, rows, n, k, g, s);
  else
    err = fp32 ? tc::launch_general<4, float, 3>(x, wq, sc, xw, out, rows, n, k, g, s)
               : tc::launch_general<4, bf16, 1>(x, wq, sc, xw, out, rows, n, k, g, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}
