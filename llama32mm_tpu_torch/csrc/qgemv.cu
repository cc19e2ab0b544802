// Quantized decode gemvs for a few rows r <= 32, weights stored [N, K]
// (nn.Linear's orientation), fp32 accumulation, output in x's dtype.
//
// int8 (l32_gemv_int8): out[r, n] = (sum_k x[r, k] * q[n, k]) * scale[n],
// the per-channel scale applied once to the fp32 sum. Replaces two TPU
// kernels of llama32mm_tpu/ops/pallas/gemv.py: _qstacked_kernel
// (int8_gemv_stacked_pallas; a layer of the stack is a pointer here) and
// _qkernel (int8_gemv_pallas, the int8 head). Bound: the weight bytes, K per
// output column (plus a 4-byte scale), the same at R = 1 and 32.
// 1. bf16 x with K a multiple of 64 and 16-byte-aligned x and q (every int8
//    decode linear and the int8 head of the 11B and 3B configs) takes the
//    tensor-core kernel, gemv_int8_tc_kernel, at every R from 1 to 32: the
//    bf16 gemv's swap-AB mma.sync m16n8k16 form (gemv.cu), each int8 weight
//    made an exact bf16 in registers (int8x2_bf16x2: two LOP3s and one
//    bf16x2 subtraction a pair of weights, no byte permute), x read once per
//    16 output columns instead of once per column. It computes what _qkernel
//    computes: bf16 x against the exact weights with fp32 sums, the scale on
//    the fp32 total, one rounding. Warps a block from N and K alone; 2 or 4
//    spans of loads in flight a lane by grid shape (int8_two_spans).
//    Measured (profile_qgemv.py --int8, device time, weights cycled past the
//    L2; NVIDIA H100 80GB HBM3, 700.00 W): the int8 head 0.176 / 0.182 ms at
//    R = 1 / 8 (89% / 87% of its 0.157 bound; the CUDA-core kernel 0.172 /
//    0.577, torch._weight_int8pack_mm 2.34 / 9.28); w_down 0.0242 / 0.0253
//    / 0.0341 / 0.0415 at R = 1 / 8 / 16 / 32 (bound 0.0175-0.0179; CUDA
//    cores 0.0259 / 0.120 / 0.216 / 0.628), w_gate 0.0249 / 0.0276 / 0.0331
//    / 0.0464 (CUDA cores 0.0235 / 0.082 / 0.168 / 0.309), W_query 0.0101 /
//    0.0105 (bound 0.0050; CUDA cores 0.0099 / 0.0273). At R = 1 it is 2-6%
//    behind the CUDA-core kernel except at w_down: a warp's 16-byte loads
//    cover 64 bytes of each of 8 rows where the CUDA-core kernel's cover 512
//    bytes of one (a timing-only copy with 256-byte runs a row was 2-11%
//    faster everywhere but w_gate).
// 2. Every other call takes the same kernel after a pre-pass
//    (split_rows_kernel, one block a row) that writes x once a call as bf16
//    planes padded with zeros to whole 64-k spans: fp32 x as three, x = b0 +
//    b1 + b2 exactly by truncation (every int8 weight is exact in bf16, so
//    each plane's products are exact in fp32), bf16 x with other K or a
//    misaligned pointer as one aligned copy. The planes are more rows of x
//    (virtual rows p * R + r) against the same A fragments, summed apart
//    and added at the end; fp32 x sums each span in fresh registers. At R <=
//    2 the three planes fill one n8 tile; above, blocks take chunks of 8
//    rows (three n8 tiles, two m16 tiles a warp). Weight rows that are not
//    16-byte aligned or end inside a span are read as gemv.cu reads them
//    (load16_any: aligned words joined by a funnel shift where a 16-byte
//    load cannot serve, the bytes past K zeroed).
//
// int4 W4A16 (l32_gemv_int4): q4 [N, K/2] uint8 in the split-half per-group
// packing (byte j*g/2 + i of a row holds k = j*g + i in its low nibble and
// k = j*g + g/2 + i in its high nibble, each as u = q + 8) with fp32 scales
// [N, K/g]: out[r, n] = sum_j scale[n, j] * sum_i (x[r, j*g+i] * (lo - 8) +
// x[r, j*g+g/2+i] * (hi - 8)). Replaces _int4_kernel_post and folds
// _int4_kernel ("pre"); both exist on the TPU only to schedule the unpack
// around Mosaic's missing narrow shifts (x_hi/16 pre-transform, a -8 *
// dot(xsum, scale) correction that cancels a raw sum ~16x the result).
// Here the nibbles are unpacked with masks and shifts, and the offset is
// removed per weight, exactly, as the weight becomes a float.
// Every call of at most 32 rows runs on the tensor cores: x as bf16 against
// exact bf16 nibbles (u - 8) on mma.sync m16n8k16 in the swap-AB form (16
// output columns as M, up to 8 rows of x as N: one B fragment serves 16
// columns; R <= 8 runs one n8 tile, R <= 16 two, R <= 32 four with two m16
// tiles a warp, halving the x reads), fp32 sums per group, each multiplied by
// its fp32 group scale and added to the total. 16-byte weight loads that
// bypass L1, four spans of them in flight a thread; 4 warps a block split K,
// summed in shared memory in warp order, no atomics.
// 1. bf16 x with g/2 a multiple of 16 and 16-byte-aligned x and q4 (the decode
//    path: g=128, and per-channel g=K) is read as it is, by
//    gemv_int4_tc_kernel.
// 2. Otherwise a pre-pass (split_rows_kernel, one block a row) writes x once a
//    call as bf16 planes: fp32 x as three, x = b0 + b1 + b2 by truncation
//    (exact for normal x: each product b_i * (u - 8) is exact in fp32), and
//    misaligned bf16 x as one aligned copy (which gemv_int4_tc_kernel reads).
//    gemv_int4_planes_kernel, the same loop, takes the planes of fp32 x as
//    more rows of x (virtual rows p * R + r), summed apart and added at the
//    end: against the same A fragments, so the weight-side work, which sets
//    the pace, does not grow, and at R <= 2 the three planes fill one n8 tile,
//    no product more than bf16 x. Above 2 rows, blocks take chunks of 8 rows
//    (three n8 tiles) with two m16 tiles a warp, so a block reads its planes
//    once for 32 columns. (2xTF32 on m16n8k8, the weights made fp32, would
//    take four products a k16 against three and twice the A fragments: not
//    tried.)
// 3. Group sizes whose g/2 is not a multiple of 16, and q4 that is not 16-byte
//    aligned (K/2 not a multiple of 16, a view), take the packed order: the
//    pre-pass lays each x row out beside the weight bytes (the x of byte c's
//    low nibble at c, of its high nibble at K/2 rounded up + c), and a span of
//    16 weight bytes, one 4-byte word a lane, may straddle groups. A lane's B
//    slots are its A slots, so the span takes one product a group it touches
//    with the x of the other groups' bytes zeroed in B, each group's sum
//    scaled apart. Words of rows that are not 4-byte aligned are joined from
//    two aligned loads by a funnel shift.
// Bound: the weight bytes (K/2 per output column, plus K/g fp32 scales), the
// same at R = 1 and 32. The tensor cores round their fp32 accumulation
// toward zero: fp32 x sums each span apart (a per-channel group's 256
// products in one chain would drift by ~1e-5 of the sum); bf16 x, held to
// bf16's bar, sums a group in one chain as the Pallas kernel does.
// Measured (profile_qgemv.py, device time, weights from HBM; NVIDIA H100
// 80GB HBM3, 700 W): the int4 head (R=1, N=128256, K=4096, g=128) 0.110 ms,
// 76% of its 0.0834 ms bound (torch._weight_int4pack_mm 0.137); w_gate
// (N=14336) 0.0178 ms at R=1, 0.0195 at R=8, 0.0246 at R=16, 0.0367 at R=32.
// The kernel is bound by its instruction issue more than by its loads:
// taking the two integer divisions by the spans-per-group count out of every
// span cut the head from 0.122 to 0.110 ms, while deeper prefetch was slower
// in every form tried (8 spans in flight a thread, a persistent grid with
// double-buffered registers, cp.async rings in shared memory, warp-wide
// coalesced staging), and so were 8 blocks an SM at 2 spans in flight
// (PERF.md §6). The calls the CUDA-core kernel took before (same timing,
// that kernel's time in parentheses): fp32 x at w_gate R = 1 / 8 / 32
// 0.0222 / 0.0341 / 0.0948 ms (0.0351 / 0.2670 / 1.0821), the fp32 int4
// head at R=1 0.1295 (0.2720), bf16 x at g=16 w_gate R=8 0.0824 (0.2687):
// with two groups a 16-byte span, the masked products, flushes and scale
// loads issue about 2.5x the instructions a byte of g=128.
//
// int4 W4A8 (l32_gemv_int4_w4a8): the same packed weights against int8
// activations. Replaces _int4_kernel_w4a8 and folds _int4_kernel_w4a8b of
// llama32mm_tpu/ops/pallas/gemv.py (the "w4a8" / "w4a8b" variants; w4a8b only
// batches the same dots differently for Mosaic). A first small kernel
// quantizes each row of x: ax[r] = max|x[r, :]| / 127 (1 where that is 0, an
// IEEE division) and xq[r, k] = clamp(rint(x / ax), -127, 127), rint rounding
// half to even as jnp.round. Then out[r, n] = ax[r] * sum_j scale[n, j] *
// sum_{k in group j} xq[r, k] * (u[n, k] - 8), cast to x's type. The TPU's
// 16 * u_hi - 128 top-bit flip and -8 * xqsum_lo correction exist because
// Mosaic lacks narrow shifts; here each nibble is masked out of its 32-bit
// word four at a time and __vsub4 takes 8 off every byte, which leaves u - 8
// as exact signed bytes (nibbles_s8): the same integers as the TPU's algebra.
// The dot reads only xq, so it takes any x dtype, and every call runs on the
// tensor cores: the W4A16 kernel's swap-AB layout and spans on mma.sync
// m16n8k32 s8 (gemv_w4a8_tc_kernel; gemv_w4a8_packed_kernel in packed order).
// A packed word's four low nibbles and its four high ones are each one A word
// as nibbles_s8 leaves them, and four xq bytes one B word as loaded, so
// nothing is repacked or converted to float. Each group's int32 sum is exact
// and takes one fp32 FMA with the group's scale, in k order; the warps' totals
// are summed in warp order and ax[r] multiplies once, so a row's bits never
// depend on R. The row quantization writes xq in natural order where g/2 is a
// multiple of 16 and q4 is 16-byte aligned, else in the packed order above
// (spans that straddle groups: one product a group, the other groups' xq bytes
// zeroed).
// Measured (profile_qgemv.py --int4, device time of both launches, weights
// from HBM; NVIDIA H100 80GB HBM3, 700 W): w_gate 0.0190 / 0.0217 / 0.0238 /
// 0.0326 ms at R = 1 / 8 / 16 / 32 (W4A16 0.0174 / 0.0193 / 0.0242 /
// 0.0365, bound 0.0093-0.0097), the int4 head at R = 1 0.0913 (bound
// 0.0834); the row quantization is 2.6 us of each call. g=16 w_gate R=8 in
// packed order: 0.0697 ms, where the CUDA-core kernel that took it before
// ran 0.3250.
//
// Bound on the H100: device-memory bytes of the weight, K bytes per output
// row in int8 (half of bf16) and K/2 in int4; each weight byte serves r <= 32
// rows, far below the ~295 FLOPs per byte where tensor cores would matter
// for speed (the tensor-core kernels use them to reuse x, above).
#include <type_traits>

#include "common.cuh"

namespace {

// ---- The int4 gemvs on the tensor cores: what W4A16 and W4A8 share ----

constexpr int kTcWarps = 4;   // K slices of a block, one warp each
constexpr int kTcUnroll = 4;  // spans whose weights a thread keeps in flight (8 in packed order)
constexpr int kQuantThreads = 256;

// Bytes of one half (low or high nibbles) of a packed x row: K/2 rounded up
// to whole 16-byte spans, so that every span reads inside the row.
__host__ __device__ constexpr int packed_half(int k) { return (k / 2 + 15) / 16 * 16; }

// The k whose x a packed x row holds at element e (e < packed_half(k): the
// low nibble of weight byte e; from packed_half(k) on: the high nibble of
// byte e - packed_half(k)), or -1 in the padding past K/2.
__device__ __forceinline__ int packed_source(int e, int k, int g) {
  return planes_source(e, k, g, packed_half(k), g / 2);
}

// The group a span starts in and its byte offset there.
struct SpanAt {
  int grp, off;
};

// The group and byte offset where spans u0 .. u0 + U - 1 of SPAN bytes
// start. Natural order (g/2 a multiple of SPAN): one division a batch (an
// integer division by a runtime value costs tens of instructions), then a
// compare a span. Packed order: `next`, the walk's place, carried from span
// to span (a span may cross several small groups).
template <int U, int SPAN, bool kPacked>
__device__ __forceinline__ void span_groups(SpanAt (&at)[U], SpanAt& next, int u0, int g2) {
  if constexpr (kPacked) {
#pragma unroll
    for (int s = 0; s < U; ++s) {
      at[s] = next;
      next.off += SPAN;
      while (next.off >= g2) {
        next.off -= g2;
        ++next.grp;
      }
    }
  } else {
    const int per_group = g2 / SPAN;
    at[0].grp = u0 / per_group;
    at[0].off = (u0 - at[0].grp * per_group) * SPAN;
#pragma unroll
    for (int s = 1; s < U; ++s) {
      const bool nxt = at[s - 1].off + SPAN == g2;
      at[s].grp = at[s - 1].grp + nxt;
      at[s].off = nxt ? 0 : at[s - 1].off + SPAN;
    }
  }
}

// 0xFF in each byte of a lane's 4-byte word that belongs to a group, whose
// first byte lies `at` bytes before the word's byte 0 (at < 0: after it)
// and which holds g2 bytes.
__device__ __forceinline__ uint32_t group_bytes(int at, int g2) {
  if (at >= 0 && at + 4 <= g2) return 0xFFFFFFFFu;  // the whole word (4 | g/2: every word in)
  if (at + 4 <= 0 || at >= g2) return 0u;
  const int lo = min(max(-at, 0), 4), hi = min(max(g2 - at, 0), 4);
  return static_cast<uint32_t>(((1ull << (8 * hi)) - 1) & ~((1ull << (8 * lo)) - 1));
}

// CB packed bytes of one weight row: loaded once, so they bypass L1 (which
// keeps x).
template <int CB> struct Piece { uint32_t w[CB / 4]; };

template <int CB>
__device__ __forceinline__ Piece<CB> load_stream(const uint8_t* p) {
  Piece<CB> r;
  if constexpr (CB == 16)
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]) : "l"(p));
  else if constexpr (CB == 8)
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];\n"
        : "=r"(r.w[0]), "=r"(r.w[1]) : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(r.w[0]) : "l"(p));
  return r;
}

// The lane's CB weight bytes at byte c of a row of k2 bytes: one streaming
// load in natural order; in packed order (CB = 4) a word inside the row,
// aligned (kAny false: K/2 a multiple of 4, q4 4-byte aligned) or not.
template <int CB, bool kPacked, bool kAny>
__device__ __forceinline__ Piece<CB> load_weights(const uint8_t* row, int c, int k2) {
  if constexpr (!kPacked) {
    return load_stream<CB>(row + c);
  } else {
    Piece<CB> r;
    r.w[0] = c >= k2 ? 0u : kAny ? load_word_any(row + c, row + k2) : load_stream<4>(row + c).w[0];
    return r;
  }
}

// ---- W4A16 (bf16 x, or fp32 x as three bf16 planes) ----

// The nibbles u at bits 0-3 and 16-19 of w as two bf16 values u - 8, exactly:
// OR-ing in 0x4300 (bf16 128) makes the mantissa's low bits u, i.e. 128 + u,
// and one bf16x2 FMA, (128 + u) * 1 - 136, leaves u - 8 (small integers, no
// rounding anywhere).
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t w) {
  const uint32_t v = (w & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// CB consecutive bf16 of x (2 CB bytes, aligned to them) as CB / 2 words.
template <int CB>
__device__ __forceinline__ void load_x(uint32_t (&d)[CB / 2], const __nv_bfloat16* p) {
  if constexpr (CB == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < CB / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      d[4 * i] = v.x;
      d[4 * i + 1] = v.y;
      d[4 * i + 2] = v.z;
      d[4 * i + 3] = v.w;
    }
  }
}

// The A fragments of one weight word a lane holds for two rows (w0: row
// gid, w1: row gid + 8): the low nibbles of bytes (0, 2) are the slots (2t,
// 2t + 1) and those of bytes (1, 3) the slots (2t + 8, 2t + 9) of one k16
// step (alo), the high nibbles the same slots of another (ahi).
__device__ __forceinline__ void nibble_frags(uint32_t w0, uint32_t w1, uint32_t (&alo)[4],
                                             uint32_t (&ahi)[4]) {
  alo[0] = nibbles_bf16x2(w0), alo[1] = nibbles_bf16x2(w1);
  alo[2] = nibbles_bf16x2(w0 >> 8), alo[3] = nibbles_bf16x2(w1 >> 8);
  ahi[0] = nibbles_bf16x2(w0 >> 4), ahi[1] = nibbles_bf16x2(w1 >> 4);
  ahi[2] = nibbles_bf16x2(w0 >> 12), ahi[3] = nibbles_bf16x2(w1 >> 12);
}

// The B fragments of x at k, k + 1, k + 2, k + 3 (two words of bf16 pairs,
// low nibbles' x0, x1 and high nibbles' y0, y1): slots (k, k + 2) and
// (k + 1, k + 3), as the A slots hold bytes (0, 2) and (1, 3).
__device__ __forceinline__ void x_frags(uint32_t x0, uint32_t x1, uint32_t y0, uint32_t y1,
                                        uint32_t (&b)[4]) {
  b[0] = __byte_perm(x0, x1, 0x5410), b[1] = __byte_perm(x0, x1, 0x7632);
  b[2] = __byte_perm(y0, y1, 0x5410), b[3] = __byte_perm(y0, y1, 0x7632);
}

// out[r, n] = sum_j scale[n, j] * (the fp32 mma sum over group j), in the
// swap-AB form: the 16 rows of an m16 tile are output columns, the 8 columns
// of an n8 tile rows of x. Lane (gid = lane / 4, t = lane % 4) loads CB bytes
// of weight rows n0 + gid and n0 + gid + 8 at byte t * CB of a span (4 CB
// bytes, inside one group), and x rows 8 nt + gid at the k those bytes hold.
// A dot product is blind to which k sits in which fragment slot, so each of
// the lane's 32-bit weight words w feeds its A slots directly: the low
// nibbles of bytes (0, 2) are the slots (2t, 2t + 1) and those of bytes
// (1, 3) the slots (2t + 8, 2t + 9) of one k16 step, the high nibbles the
// same slots of another at k + g/2; x is permuted to the same k order in
// its B slots. Each group's fp32 mma sum is multiplied by the group's scale
// and added to the total, as the Pallas kernel does. The block's warps take
// fixed quarters of the row's spans (a quarter may end inside a group: each
// part gets the group's scale) and their totals are summed in shared
// memory, warp 0 first. So an output's arithmetic depends on K and g only,
// never on R or on the other rows: a row of an R=8 call equals, bit for
// bit, the R=1 call on that row.
template <int CB, int MT, int NT>
__global__ void __launch_bounds__(kTcWarps * 32)
gemv_int4_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int rows,
                    int n, int k, int g) {
  constexpr int BN = 16 * MT, RB = 8 * NT, W = CB / 4;
  __shared__ float red[kTcWarps][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k2 = k / 2, g2 = g / 2, ng = k / g;
  const int per_group = g2 / (4 * CB), spans = k2 / (4 * CB);
  const int ubeg = warp * spans / kTcWarps, uend = (warp + 1) * spans / kTcWarps;

  // This lane's weight and scale rows (row 0 stands in past N: never read).
  bool in[MT][2];
  const uint8_t* wrow[MT][2];
  const float* srow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      const size_t c = in[mt][h] ? static_cast<size_t>(col) : 0;
      wrow[mt][h] = q4 + c * k2 + t * CB;
      srow[mt][h] = scale + c * ng;
    }

  float tot[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[mt][nt][i] = part[mt][nt][i] = 0.f;

  for (int u0 = ubeg; u0 < uend; u0 += kTcUnroll) {
    // Each span's group and its place there: one division a batch (an
    // integer division by a runtime value costs tens of instructions).
    int grp[kTcUnroll], at[kTcUnroll];
    grp[0] = u0 / per_group;
    at[0] = u0 - grp[0] * per_group;
#pragma unroll
    for (int s = 1; s < kTcUnroll; ++s) {
      const bool next = at[s - 1] + 1 == per_group;
      grp[s] = grp[s - 1] + next;
      at[s] = next ? 0 : at[s - 1] + 1;
    }
    Piece<CB> wp[kTcUnroll][MT][2];
    float sc[kTcUnroll][MT][2];
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s) {
      const int u = u0 + s;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (u < uend && in[mt][h]) {
            wp[s][mt][h] = load_stream<CB>(wrow[mt][h] + u * 4 * CB);
            sc[s][mt][h] = srow[mt][h][grp[s]];
          } else {
#pragma unroll
            for (int j = 0; j < W; ++j) wp[s][mt][h].w[j] = 0u;
            sc[s][mt][h] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      const int klo = grp[s] * g + at[s] * 4 * CB + t * CB;  // k of byte 0's low nibble
      uint32_t xl[NT][CB / 2], xh[NT][CB / 2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + gid;
        if (r < rows) {
          const __nv_bfloat16* xr = x + static_cast<size_t>(r) * k + klo;
          load_x<CB>(xl[nt], xr);
          load_x<CB>(xh[nt], xr + g2);
        } else {
#pragma unroll
          for (int i = 0; i < CB / 2; ++i) xl[nt][i] = xh[nt][i] = 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t w0 = wp[s][mt][0].w[j], w1 = wp[s][mt][1].w[j];
          const uint32_t alo[4] = {nibbles_bf16x2(w0), nibbles_bf16x2(w1),
                                   nibbles_bf16x2(w0 >> 8), nibbles_bf16x2(w1 >> 8)};
          const uint32_t ahi[4] = {nibbles_bf16x2(w0 >> 4), nibbles_bf16x2(w1 >> 4),
                                   nibbles_bf16x2(w0 >> 12), nibbles_bf16x2(w1 >> 12)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (8 * nt < rows) {
              // x at k, k + 1, k + 2, k + 3 -> B slots (k, k + 2) and (k + 1, k + 3)
              const uint32_t x0 = xl[nt][2 * j], x1 = xl[nt][2 * j + 1];
              const uint32_t y0 = xh[nt][2 * j], y1 = xh[nt][2 * j + 1];
              mma_16816(part[mt][nt], alo, __byte_perm(x0, x1, 0x5410), __byte_perm(x0, x1, 0x7632));
              mma_16816(part[mt][nt], ahi, __byte_perm(y0, y1, 0x5410), __byte_perm(y0, y1, 0x7632));
            }
          }
        }
      }
      if (at[s] + 1 == per_group || u + 1 == uend) {  // the group (or this warp's part) ends
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // C rows: gid (i < 2) and gid + 8
              tot[mt][nt][i] = fmaf(part[mt][nt][i], sc[s][mt][i >> 1], tot[mt][nt][i]);
              part[mt][nt][i] = 0.f;
            }
      }
    }
  }
  // C element i of a lane: output column gid + 8 (i / 2) of the m16 tile,
  // x row 2t + i % 2 of the n8 tile.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp][16 * mt + gid + 8 * (i >> 1)][8 * nt + 2 * t + (i & 1)] = tot[mt][nt][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * RB; idx += kTcWarps * 32) {
    const int m = idx % BN, r = idx / BN;
    if (r < rows && n0 + m < n) {
      float acc = red[0][m][r];
#pragma unroll
      for (int w = 1; w < kTcWarps; ++w) acc += red[w][m][r];
      out[static_cast<size_t>(r) * n + n0 + m] = __float2bfloat16(acc);
    }
  }
}

template <int CB>
void launch_int4_tc(const __nv_bfloat16* x, const uint8_t* q4, const float* scale,
                    __nv_bfloat16* out, int rows, int n, int k, int g, cudaStream_t s) {
  const dim3 block(kTcWarps * 32);
  if (rows <= 8)
    gemv_int4_tc_kernel<CB, 1, 1><<<(n + 15) / 16, block, 0, s>>>(x, q4, scale, out, rows, n, k, g);
  else if (rows <= 16)
    gemv_int4_tc_kernel<CB, 1, 2><<<(n + 15) / 16, block, 0, s>>>(x, q4, scale, out, rows, n, k, g);
  else  // two m16 tiles a warp halve the x reads of R=32
    gemv_int4_tc_kernel<CB, 2, 4><<<(n + 31) / 32, block, 0, s>>>(x, q4, scale, out, rows, n, k, g);
}

// gemv_int4_tc_kernel's computation for the calls it does not take, x read
// from the pre-pass's planes: fp32 x (three planes) and packed order. A
// span is 4 CB bytes of a weight row as there: in natural order (fp32 x,
// g/2 a multiple of 16) x at the k the bytes hold; in packed order (CB = 4)
// x at the bytes' own index, so a span of 16 bytes may straddle groups. A
// lane's B slots are its A slots, so zeroing the x of the bytes outside a
// group leaves that group's sum: a span that straddles groups takes one
// product a group it touches, each scaled apart, from A fragments made once
// (nibble_frags, x_frags). The columns of the n8 tiles are rows of x (P = 1:
// bf16 x) or virtual rows v = p * R + r, row r of plane p of fp32 x (P = 3),
// so that the planes of a row are summed apart and added at the end, ((t0 +
// t1) + t2): at R <= 2 the three planes fill one n8 tile and cost no product
// more than bf16 x. Each span is scaled and added to the total apart (the
// tensor cores round their sums toward zero: a per-channel group's 256
// products in one chain would drift by ~1e-5), so no chain adds more than
// one span's 8 products. The warps' totals are summed in warp order, then
// the planes: an output's arithmetic depends on K, g and x's dtype only,
// never on R or on the other rows. Blocks take chunks of `crows` rows
// (consecutive blocks the chunks of one column tile, whose weights the later
// ones find in L2) where the rows' accumulators would not fit one block.
template <int CB, int MT, int NT, int P, bool kPacked, bool kAny>
__global__ void __launch_bounds__(kTcWarps * 32)
gemv_int4_planes_kernel(const __nv_bfloat16* __restrict__ x, int ld, size_t plane,
                        const uint8_t* __restrict__ q4, const float* __restrict__ scale,
                        std::conditional_t<P == 3, float, __nv_bfloat16>* __restrict__ out,
                        int rows, int crows, int n, int k, int g) {
  static_assert(!kPacked || CB == 4, "packed order reads 4-byte words");
  constexpr int BN = 16 * MT, RB = 8 * NT, W = CB / 4, SPAN = 4 * CB;
  constexpr int U = kPacked ? 2 * kTcUnroll : kTcUnroll;
  __shared__ float red[kTcWarps][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  int n0 = blockIdx.x * BN;
  if (crows < rows) {  // this block's chunk of rows
    const int chunks = (rows + crows - 1) / crows, row0 = blockIdx.x % chunks * crows;
    n0 = blockIdx.x / chunks * BN;
    rows = min(crows, rows - row0);
    x += static_cast<size_t>(row0) * ld;
    out += static_cast<size_t>(row0) * n;
  }
  const int k2 = k / 2, g2 = g / 2, ng = k / g, vrows = P * rows;
  const int spans = (k2 + SPAN - 1) / SPAN;
  const int ubeg = warp * spans / kTcWarps, uend = (warp + 1) * spans / kTcWarps;
  const int hi_at = kPacked ? ld / 2 : g2;  // x elements from a byte's low nibble to its high one

  // This lane's weight and scale rows (row 0 stands in past N: never read).
  bool in[MT][2];
  const uint8_t* wrow[MT][2];
  const float* srow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      const size_t c = in[mt][h] ? static_cast<size_t>(col) : 0;
      wrow[mt][h] = q4 + c * k2 + t * CB;
      srow[mt][h] = scale + c * ng;
    }
  // Where this lane's virtual row of each n8 tile starts in x (fp32 x: in
  // its plane).
  size_t xoff[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int v = 8 * nt + gid, p = P == 1 ? 0 : v / rows;
    xoff[nt] = p * plane + static_cast<size_t>(v - p * rows) * ld;
  }

  float tot[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[mt][nt][i] = part[mt][nt][i] = 0.f;

  auto flush = [&](const float (&sc)[MT][2]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // C rows: gid (i < 2) and gid + 8
          tot[mt][nt][i] = fmaf(part[mt][nt][i], sc[mt][i >> 1], tot[mt][nt][i]);
          part[mt][nt][i] = 0.f;
        }
  };
  // part[mt] += word j's products: A fragments alo, ahi of m16 tile mt, B
  // the x of its bytes (xl, xh: the span's); with mask, m02 and m13 keep the
  // bytes (0, 2) and (1, 3) of the group summed.
  uint32_t xl[NT][CB / 2], xh[NT][CB / 2];
  auto products = [&](int j, int mt, const uint32_t (&alo)[4], const uint32_t (&ahi)[4], bool mask,
                      uint32_t m02, uint32_t m13) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt < vrows) {
        uint32_t b[4];
        x_frags(xl[nt][2 * j], xl[nt][2 * j + 1], xh[nt][2 * j], xh[nt][2 * j + 1], b);
        if (mask) b[0] &= m02, b[2] &= m02, b[1] &= m13, b[3] &= m13;
        mma_16816(part[mt][nt], alo, b[0], b[1]);
        mma_16816(part[mt][nt], ahi, b[2], b[3]);
      }
    }
  };

  SpanAt next;  // packed order's walk
  if constexpr (kPacked) {
    next.grp = ubeg * SPAN / g2;
    next.off = ubeg * SPAN - next.grp * g2;
  }
  for (int u0 = ubeg; u0 < uend; u0 += U) {
    SpanAt at[U];
    span_groups<U, SPAN, kPacked>(at, next, u0, g2);
    Piece<CB> wp[U][MT][2];
    float sc[U][MT][2], sc1[U][MT][2];  // scales of the span's first group and the next
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = u0 + s;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (u < uend && in[mt][h]) {
            wp[s][mt][h] = load_weights<CB, kPacked, kAny>(wrow[mt][h], u * SPAN, k2 - t * CB);
            sc[s][mt][h] = srow[mt][h][at[s].grp];
            if constexpr (kPacked)
              sc1[s][mt][h] = at[s].grp + 1 < ng ? srow[mt][h][at[s].grp + 1] : 0.f;
          } else {
#pragma unroll
            for (int j = 0; j < W; ++j) wp[s][mt][h].w[j] = 0u;
            sc[s][mt][h] = sc1[s][mt][h] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      const SpanAt a = at[s];
      // x element of the lane's byte 0's low nibble
      const int xk = kPacked ? u * SPAN + t * CB : a.grp * g + a.off + t * CB;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + gid;
        if (r < vrows) {
          const __nv_bfloat16* xr = x + xoff[nt] + xk;
          load_x<CB>(xl[nt], xr);
          load_x<CB>(xh[nt], xr + hi_at);
        } else {
#pragma unroll
          for (int i = 0; i < CB / 2; ++i) xl[nt][i] = xh[nt][i] = 0u;
        }
      }
      if (!kPacked || a.off + SPAN <= g2) {  // the span lies inside one group
#pragma unroll
        for (int j = 0; j < W; ++j) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t alo[4], ahi[4];
            nibble_frags(wp[s][mt][0].w[j], wp[s][mt][1].w[j], alo, ahi);
            products(j, mt, alo, ahi, false, 0u, 0u);
          }
        }
        flush(sc[s]);
      } else if constexpr (kPacked) {  // one product a group the span touches
        uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          nibble_frags(wp[s][mt][0].w[0], wp[s][mt][1].w[0], alo[mt], ahi[mt]);
#pragma unroll 1
        for (int i = 0, grp = a.grp; i * g2 < a.off + SPAN && grp < ng; ++i, ++grp) {
          const uint32_t m = group_bytes(a.off + t * CB - i * g2, g2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            products(0, mt, alo[mt], ahi[mt], true, __byte_perm(m, 0u, 0x2200),
                     __byte_perm(m, 0u, 0x3311));
          float gsc[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              gsc[mt][h] = i == 0 ? sc[s][mt][h]
                                  : i == 1 ? sc1[s][mt][h] : (in[mt][h] ? srow[mt][h][grp] : 0.f);
          flush(gsc);
        }
      }
    }
  }
  // C element i of a lane: output column gid + 8 (i / 2) of the m16 tile,
  // virtual row 2t + i % 2 of the n8 tile.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp][16 * mt + gid + 8 * (i >> 1)][8 * nt + 2 * t + (i & 1)] = tot[mt][nt][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * RB; idx += kTcWarps * 32) {
    const int m = idx % BN, r = idx / BN;
    if (r < rows && n0 + m < n) {
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float sum = red[0][m][p * rows + r];
#pragma unroll
        for (int w = 1; w < kTcWarps; ++w) sum += red[w][m][p * rows + r];
        acc = p == 0 ? sum : acc + sum;
      }
      out[static_cast<size_t>(r) * n + n0 + m] =
          from_f32<std::conditional_t<P == 3, float, __nv_bfloat16>>(acc);
    }
  }
}

// Row buckets (MT m16 tiles of columns a warp, NT n8 tiles of virtual
// rows). bf16 x: R <= 8 one n8 tile, <= 16 two, <= 32 four with two m16
// tiles a warp (halving the x reads). fp32 x (three planes a row): R <= 2
// one n8 tile; more rows in chunks of 8, three n8 tiles and two m16 tiles a
// warp (a block reads its planes once for 32 columns; more tiles' x and
// accumulators would not fit the registers).
template <int CB, int P, bool kPacked, bool kAny>
void launch_int4_planes(const __nv_bfloat16* x, int ld, size_t plane, const uint8_t* q4,
                        const float* scale, void* out, int rows, int n, int k, int g,
                        cudaStream_t s) {
  using T = std::conditional_t<P == 3, float, __nv_bfloat16>;
  T* o = static_cast<T*>(out);
  const dim3 block(kTcWarps * 32);
#define L32_INT4(MT, NT, CROWS)                                                      \
  gemv_int4_planes_kernel<CB, MT, NT, P, kPacked, kAny>                               \
      <<<(n + 16 * (MT) - 1) / (16 * (MT)) * ((rows + (CROWS) - 1) / (CROWS)), block, 0, \
         s>>>(x, ld, plane, q4, scale, o, rows, CROWS, n, k, g)
  if constexpr (P == 1) {
    if (rows <= 8) L32_INT4(1, 1, rows);
    else if (rows <= 16) L32_INT4(1, 2, rows);
    else L32_INT4(2, 4, rows);
  } else {
    if (rows <= 2) L32_INT4(1, 1, rows);
    else L32_INT4(2, 3, 8);
  }
#undef L32_INT4
}

// Natural order, the widest span (4 CB bytes) whose multiple g/2 is: bf16
// x ([rows][K]: as it is, or the pre-pass's aligned copy) on
// gemv_int4_tc_kernel, the planes of fp32 x on gemv_int4_planes_kernel.
template <int P>
void launch_int4_natural(const __nv_bfloat16* x, int ld, size_t plane, const uint8_t* q4,
                         const float* scale, void* out, int rows, int n, int k, int g,
                         cudaStream_t s) {
  auto launch = [&](auto cb) {
    constexpr int CB = decltype(cb)::value;
    if constexpr (P == 1)
      launch_int4_tc<CB>(x, q4, scale, static_cast<__nv_bfloat16*>(out), rows, n, k, g, s);
    else
      launch_int4_planes<CB, P, false, false>(x, ld, plane, q4, scale, out, rows, n, k, g, s);
  };
  const int g2 = g / 2;
  if (g2 % 64 == 0)
    launch(std::integral_constant<int, 16>());
  else if (g2 % 32 == 0)
    launch(std::integral_constant<int, 8>());
  else
    launch(std::integral_constant<int, 4>());
}

// A span lies inside one group, reading x in its natural k order, when g/2
// is a multiple of 16 and q4 is 16-byte aligned (so is every row then).
bool int4_natural(const void* q4, int g) { return (g / 2) % 16 == 0 && aligned16(q4); }

// Weight words of packed order are 4-byte loads when every row is 4-byte
// aligned.
bool int4_words_aligned(const void* q4, int k) {
  return (reinterpret_cast<uintptr_t>(q4) & 3) == 0 && (k / 2) % 4 == 0;
}

// ---- int8 on the tensor cores ----

// Warps a block: those of the bf16 gemv for the same bytes (a span of 64
// int8 k holds the bytes of 32 bf16 k). N and K alone decide it.
int int8_tc_warps(int n, int k) { return tc_warps(n, k / 2); }

// out[r, n] = scale[n] * sum_k x[r, k] q[n, k] in the swap-AB form of
// gemv_tc_kernel: the 16 rows of an m16 tile are output columns, the 8
// columns of an n8 tile rows of x. A span is 64 k: lane (gid, t) loads 16
// bytes (k 16t .. 16t + 15) of weight rows n0 + gid and n0 + gid + 8 with
// one streaming load each, and x row 8 nt + gid at the same 16 k. A dot
// product is blind to which k sits in which fragment slot, so each of the
// lane's 32-bit weight words feeds one product as loaded: its bytes (0, 2)
// become the A slots (2t, 2t + 1) and its bytes (1, 3) the slots (2t + 8,
// 2t + 9), each pair converted exactly by int8x2_bf16x2 (bytes 1 and 3 after
// one shift), and x is permuted to the same k order in its B slots (one
// byte permute a B word). The W warps of a block (tc_warps: N and K alone)
// take fixed parts of the row's spans; their fp32 totals are summed in
// shared memory in warp order and the channel scale multiplies the sum once.
// So an output's arithmetic depends on K and N only, never on R or on the
// other rows: a row of an R=8 call equals, bit for bit, the R=1 call on it.
// A lane loads U spans at a time (U changes no arithmetic: the spans are
// summed in order either way).
// x comes as P bf16 planes [P][rows][ldx], ldx whole spans: bf16 x as it is
// (P = 1, ldx = K) or the pre-pass's aligned copy padded with zeros, fp32 x
// as split_rows_kernel's three exact planes (P = 3). The planes are more
// rows of x, virtual row v = p * R + r, against the same A fragments, so
// the weight-side work, which sets the pace, does not grow; at R <= 2 they
// fill one n8 tile. Each plane's products are exact in fp32; fp32 x sums
// each span's four products in fresh registers, added to the total in fp32
// (the tensor cores round their accumulation toward zero), and the warps'
// totals are summed in warp order, then the planes, ((t0 + t1) + t2), before
// the scale. Blocks take chunks of `crows` rows (consecutive blocks the
// chunks of one column tile) where the rows' accumulators would not fit one
// block. kAny reads weight rows that are misaligned or end inside a span by
// words (load16_any), the bytes past K zeroed.
template <int W, int MT, int NT, int U, int P, bool kAny>
__global__ void __launch_bounds__(W * 32)
gemv_int8_tc_kernel(const __nv_bfloat16* __restrict__ x, int ldx, size_t plane,
                    const int8_t* __restrict__ q, const float* __restrict__ scale,
                    std::conditional_t<P == 3, float, __nv_bfloat16>* __restrict__ out,
                    int rows, int crows, int n, int k) {
  constexpr int BN = 16 * MT, RB = 8 * NT;
  __shared__ float red[W][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  int n0 = blockIdx.x * BN;
  if constexpr (P == 3) {
    if (crows < rows) {  // this block's chunk of rows
      const int chunks = (rows + crows - 1) / crows, row0 = blockIdx.x % chunks * crows;
      n0 = blockIdx.x / chunks * BN;
      rows = min(crows, rows - row0);
      x += static_cast<size_t>(row0) * ldx;
      out += static_cast<size_t>(row0) * n;
    }
  }
  const int vrows = P * rows;
  const int spans = ldx / 64;
  const int ubeg = warp * spans / W, uend = (warp + 1) * spans / W;
  // The channel scale of this thread's outputs (column n0 + threadIdx.x % BN
  // in the epilogue), loaded before the weights.
  const int scol = n0 + threadIdx.x % BN;
  const float sc = scol < n ? scale[scol] : 0.f;

  // This lane's weight rows (row 0 stands in past N: never loaded) and x rows.
  bool in[MT][2];
  const int8_t* wrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      wrow[mt][h] = q + static_cast<size_t>(in[mt][h] ? col : 0) * k + 16 * t;
    }
  bool xin[NT];
  const __nv_bfloat16* xrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int v = 8 * nt + gid, p = P == 1 ? 0 : v / rows;
    xin[nt] = v < vrows;
    xrow[nt] = x + (xin[nt] ? p * plane + static_cast<size_t>(v - p * rows) * ldx : 0) + 16 * t;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int u0 = ubeg; u0 < uend; u0 += U) {
    uint4 wv[U][MT][2];
#pragma unroll
    for (int s = 0; s < U; ++s)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool live = u0 + s < uend && in[mt][h];
          if constexpr (kAny)
            wv[s][mt][h] = live ? load16_any(wrow[mt][h] + (u0 + s) * 64,
                                                wrow[mt][h] - 16 * t + k)
                                : make_uint4(0u, 0u, 0u, 0u);
          else
            wv[s][mt][h] = live ? load_stream16(wrow[mt][h] + (u0 + s) * 64)
                                : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      // x at k 4j .. 4j + 3 of the lane's 16 -> B words (4j, 4j + 2) and (4j + 1, 4j + 3)
      uint32_t be[NT][4], bo[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
        if (xin[nt]) {
          x0 = *reinterpret_cast<const uint4*>(xrow[nt] + u * 64);
          x1 = *reinterpret_cast<const uint4*>(xrow[nt] + u * 64 + 8);
        }
        const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          be[nt][j] = __byte_perm(xw[2 * j], xw[2 * j + 1], 0x5410);
          bo[nt][j] = __byte_perm(xw[2 * j], xw[2 * j + 1], 0x7632);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 v0 = wv[s][mt][0], v1 = wv[s][mt][1];
        const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w}, w1[4] = {v1.x, v1.y, v1.z, v1.w};
        if constexpr (P == 1) {  // one chain, as the Pallas kernel's bf16 dot
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a[4] = {int8x2_bf16x2(w0[j]), int8x2_bf16x2(w1[j]),
                                   int8x2_bf16x2(w0[j] >> 8), int8x2_bf16x2(w1[j] >> 8)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              if (8 * nt < vrows) mma_16816(acc[mt][nt], a, be[nt][j], bo[nt][j]);
          }
        } else {  // each span's products in fresh registers
          uint32_t a[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j][0] = int8x2_bf16x2(w0[j]), a[j][1] = int8x2_bf16x2(w1[j]);
            a[j][2] = int8x2_bf16x2(w0[j] >> 8), a[j][3] = int8x2_bf16x2(w1[j] >> 8);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (8 * nt < vrows) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_16816(c, a[j], be[nt][j], bo[nt][j]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][nt][i] += c[i];
            }
          }
        }
      }
    }
  }
  // C element i of a lane: output column gid + 8 (i / 2) of the m16 tile,
  // virtual row 2t + i % 2 of the n8 tile.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp][16 * mt + gid + 8 * (i >> 1)][8 * nt + 2 * t + (i & 1)] = acc[mt][nt][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * RB; idx += W * 32) {  // idx % BN == threadIdx.x % BN
    const int m = idx % BN, r = idx / BN;
    if (r < rows && n0 + m < n) {
      float tot = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float sum = red[0][m][p * rows + r];
#pragma unroll
        for (int v = 1; v < W; ++v) sum += red[v][m][p * rows + r];
        tot = p == 0 ? sum : tot + sum;
      }
      out[static_cast<size_t>(r) * n + n0 + m] =
          from_f32<std::conditional_t<P == 3, float, __nv_bfloat16>>(tot * sc);
    }
  }
}

// Spans a lane loads at a time: 2 where at most 8 rows run on a grid of one
// or two 16-column blocks an SM of the H100's 132 (N = 2033 .. 4224: the
// 11B's N = 4096 linears), 4 elsewhere. Measured at R = 1 and 8 (PERF.md
// §6): 2 beat 4 by 10-15% at w_down and 3-6% at W_query, and lost 4-6%
// at W_key (64 blocks, half the SMs idle: fewer round trips win) and 1-13%
// at w_gate (896 blocks, 1.7 waves).
bool int8_two_spans(int rows, int n) {
  const int blocks = (n + 15) / 16;
  return rows <= 8 && blocks >= 128 && blocks <= 264;
}

// Row buckets (MT m16 tiles a warp, NT n8 tiles of virtual rows). One plane:
// R <= 8 one n8 tile, <= 16 two, <= 32 four with two m16 tiles a warp
// (halving the x reads) where the reduction buffer of 32 columns fits (W <=
// 8). Three planes: R <= 2 one n8 tile; more rows in chunks of 8, three n8
// tiles, with two m16 tiles a warp where they fit, one span of loads at a
// time (at 4, 181 registers left one block an SM: the head R=8 0.36 ms
// against 0.23, PERF.md §6).
template <int W, int P, bool kAny>
void launch_int8_w(const __nv_bfloat16* x, int ld, size_t plane, const int8_t* q,
                   const float* scale, void* out, int rows, int n, int k, cudaStream_t s) {
  using T = std::conditional_t<P == 3, float, __nv_bfloat16>;
  T* o = static_cast<T*>(out);
#define L32_INT8(MT, NT, U, CROWS)                                                         \
  gemv_int8_tc_kernel<W, MT, NT, U, P, kAny>                                                \
      <<<(n + 16 * (MT) - 1) / (16 * (MT)) * ((rows + (CROWS) - 1) / (CROWS)), W * 32, 0, s>>>( \
          x, ld, plane, q, scale, o, rows, CROWS, n, k)
  if constexpr (P == 1) {
    if (int8_two_spans(rows, n)) L32_INT8(1, 1, 2, rows);
    else if (rows <= 8) L32_INT8(1, 1, 4, rows);
    else if (rows <= 16) L32_INT8(1, 2, 4, rows);
    else if constexpr (W <= 8) L32_INT8(2, 4, 4, rows);
    else L32_INT8(1, 4, 4, rows);
  } else {
    if (rows <= 2) L32_INT8(1, 1, 4, rows);
    else if constexpr (W <= 8) L32_INT8(2, 3, 1, 8);
    else L32_INT8(1, 3, 1, 8);
  }
#undef L32_INT8
}

template <int P, bool kAny>
void launch_int8(const __nv_bfloat16* x, int ld, size_t plane, const int8_t* q,
                 const float* scale, void* out, int rows, int n, int k, cudaStream_t s) {
  const int warps = int8_tc_warps(n, ld);
  if (warps == 4) launch_int8_w<4, P, kAny>(x, ld, plane, q, scale, out, rows, n, k, s);
  else if (warps == 8) launch_int8_w<8, P, kAny>(x, ld, plane, q, scale, out, rows, n, k, s);
  else launch_int8_w<16, P, kAny>(x, ld, plane, q, scale, out, rows, n, k, s);
}

// The int8 entry's kernel argument and the kernel it reports: route by
// shape, the general route, the tensor-core kernel on x as it is.
enum { kRouted = -1, kGeneral = 0, kTc = 1 };

// x is read as it is where it is bf16, its rows whole 64-k spans and
// 16-byte aligned; the weight rows where they are whole spans and aligned.
bool int8_x_as_is(const void* x, int k, int dtype) {
  return dtype == L32_BF16 && k % 64 == 0 && aligned16(x);
}
bool int8_rows_whole(const void* q, int k) { return k % 64 == 0 && aligned16(q); }

// One block per row of x: ax[r] and xq[r, :] (the W4A8 activations), in
// the dot's natural order (ld = k) or packed order (ld = 2 packed_half(k),
// as split_rows_kernel lays out x).
template <typename T, bool kPacked>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ ax,
                     int k, int g, int ld) {
  __shared__ float red[kQuantThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * k;
  float m = 0.f;
  for (int c = threadIdx.x; c < k; c += kQuantThreads) m = fmaxf(m, fabsf(to_f32(xr[c])));
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kQuantThreads / 32 ? red[lane] : 0.f);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  float a = red[0] / 127.f;  // IEEE division: nvcc's default -prec-div=true
  a = a > 0.f ? a : 1.f;
  if (threadIdx.x == 0) ax[blockIdx.x] = a;
  auto quant = [&](float v) {
    return static_cast<int8_t>(fminf(fmaxf(rintf(v / a), -127.f), 127.f));
  };
  int8_t* qr = xq + static_cast<size_t>(blockIdx.x) * ld;
  if constexpr (kPacked) {
    for (int e = threadIdx.x; e < ld; e += kQuantThreads) {
      const int src = packed_source(e, k, g);
      qr[e] = src < 0 ? 0 : quant(to_f32(xr[src]));
    }
  } else {
    for (int c = threadIdx.x; c < k; c += kQuantThreads) qr[c] = quant(to_f32(xr[c]));
  }
}

// u - 8 for the four low (or, shifted, high) nibbles of w, as signed bytes.
__device__ __forceinline__ int nibbles_s8(uint32_t w) {
  return static_cast<int>(__vsub4(w & 0x0F0F0F0Fu, 0x08080808u));
}

// CB bytes of xq (aligned to them) as CB / 4 words.
template <int CB>
__device__ __forceinline__ void load_xq(uint32_t (&d)[CB / 4], const int8_t* p) {
  if constexpr (CB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else if constexpr (CB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// out[r, n] = ax[r] * sum_j scale[n, j] * (the int32 mma sum over group j),
// gemv_int4_tc_kernel's swap-AB form on mma.sync m16n8k32 s8: the 16 rows of
// an m16 tile are output columns, the 8 columns of an n8 tile rows of xq.
// Lane (gid, t) loads CB bytes of weight rows n0 + gid and n0 + gid + 8 at
// byte t * CB of a span (4 CB bytes, inside one group) and the xq bytes of
// row 8 nt + gid at the k they hold: the low nibbles of packed word j are
// the four k at klo + 4j (klo the k of byte 0's low nibble), the high
// nibbles the four k g/2 later. nibbles_s8 turns a word into those four
// exact signed bytes u - 8, and one product takes, per word, the low plane
// as A slots 4t .. 4t + 3 and the high plane as 4t + 16 .. 4t + 19, with xq
// at the same k as B: four consecutive xq bytes are one B word as loaded,
// so nothing is repacked. Each group's int32 sum (exact) takes one fp32 FMA
// with the group's scale, in k order; the block's warps take fixed parts of
// the row's spans (a part may end inside a group: each part gets the
// group's scale), their totals are summed in shared memory in warp order,
// and ax[r] multiplies the sum once. An output's arithmetic depends on K
// and g only, never on R or on the other rows.
template <typename T, int CB, int MT, int NT>
__global__ void __launch_bounds__(kTcWarps * 32)
gemv_w4a8_tc_kernel(const int8_t* __restrict__ xq, const float* __restrict__ ax,
                    const uint8_t* __restrict__ q4, const float* __restrict__ scale,
                    T* __restrict__ out, int rows, int n, int k, int g) {
  constexpr int BN = 16 * MT, RB = 8 * NT, W = CB / 4;
  __shared__ float red[kTcWarps][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k2 = k / 2, g2 = g / 2, ng = k / g;
  const int per_group = g2 / (4 * CB), spans = k2 / (4 * CB);
  const int ubeg = warp * spans / kTcWarps, uend = (warp + 1) * spans / kTcWarps;

  // This lane's weight and scale rows (row 0 stands in past N: never read).
  bool in[MT][2];
  const uint8_t* wrow[MT][2];
  const float* srow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      const size_t c = in[mt][h] ? static_cast<size_t>(col) : 0;
      wrow[mt][h] = q4 + c * k2 + t * CB;
      srow[mt][h] = scale + c * ng;
    }

  float tot[MT][NT][4];
  int part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[mt][nt][i] = 0.f;
        part[mt][nt][i] = 0;
      }

  for (int u0 = ubeg; u0 < uend; u0 += kTcUnroll) {
    // Each span's group and its place there: one division a batch.
    int grp[kTcUnroll], at[kTcUnroll];
    grp[0] = u0 / per_group;
    at[0] = u0 - grp[0] * per_group;
#pragma unroll
    for (int s = 1; s < kTcUnroll; ++s) {
      const bool next = at[s - 1] + 1 == per_group;
      grp[s] = grp[s - 1] + next;
      at[s] = next ? 0 : at[s - 1] + 1;
    }
    Piece<CB> wp[kTcUnroll][MT][2];
    float sc[kTcUnroll][MT][2];
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s) {
      const int u = u0 + s;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (u < uend && in[mt][h]) {
            if constexpr (CB == 16) {  // with the L2::256B hint: -2.7% at w_gate R=8
              const uint4 v = load_stream16(wrow[mt][h] + u * 4 * CB);
              wp[s][mt][h] = Piece<CB>{{v.x, v.y, v.z, v.w}};
            } else {
              wp[s][mt][h] = load_stream<CB>(wrow[mt][h] + u * 4 * CB);
            }
            sc[s][mt][h] = srow[mt][h][grp[s]];
          } else {
#pragma unroll
            for (int j = 0; j < W; ++j) wp[s][mt][h].w[j] = 0u;
            sc[s][mt][h] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      const int klo = grp[s] * g + at[s] * 4 * CB + t * CB;  // k of byte 0's low nibble
      uint32_t xl[NT][W], xh[NT][W];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + gid;
        if (r < rows) {
          const int8_t* xr = xq + static_cast<size_t>(r) * k + klo;
          load_xq<CB>(xl[nt], xr);
          load_xq<CB>(xh[nt], xr + g2);
        } else {
#pragma unroll
          for (int i = 0; i < W; ++i) xl[nt][i] = xh[nt][i] = 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t w0 = wp[s][mt][0].w[j], w1 = wp[s][mt][1].w[j];
          const uint32_t a[4] = {static_cast<uint32_t>(nibbles_s8(w0)),
                                 static_cast<uint32_t>(nibbles_s8(w1)),
                                 static_cast<uint32_t>(nibbles_s8(w0 >> 4)),
                                 static_cast<uint32_t>(nibbles_s8(w1 >> 4))};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (8 * nt < rows) mma_16832_s8(part[mt][nt], a, xl[nt][j], xh[nt][j]);
        }
      }
      if (at[s] + 1 == per_group || u + 1 == uend) {  // the group (or this warp's part) ends
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // C rows: gid (i < 2) and gid + 8
              tot[mt][nt][i] =
                  fmaf(static_cast<float>(part[mt][nt][i]), sc[s][mt][i >> 1], tot[mt][nt][i]);
              part[mt][nt][i] = 0;
            }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp][16 * mt + gid + 8 * (i >> 1)][8 * nt + 2 * t + (i & 1)] = tot[mt][nt][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * RB; idx += kTcWarps * 32) {
    const int m = idx % BN, r = idx / BN;
    if (r < rows && n0 + m < n) {
      float acc = red[0][m][r];
#pragma unroll
      for (int w = 1; w < kTcWarps; ++w) acc += red[w][m][r];
      out[static_cast<size_t>(r) * n + n0 + m] = from_f32<T>(acc * ax[r]);
    }
  }
}

template <typename T, int CB>
void launch_w4a8_tc(const int8_t* xq, const float* ax, const uint8_t* q4, const float* scale,
                    T* out, int rows, int n, int k, int g, cudaStream_t s) {
  const dim3 block(kTcWarps * 32);
  if (rows <= 8)
    gemv_w4a8_tc_kernel<T, CB, 1, 1><<<(n + 15) / 16, block, 0, s>>>(xq, ax, q4, scale, out, rows,
                                                                     n, k, g);
  else if (rows <= 16)
    gemv_w4a8_tc_kernel<T, CB, 1, 2><<<(n + 15) / 16, block, 0, s>>>(xq, ax, q4, scale, out, rows,
                                                                     n, k, g);
  else  // two m16 tiles a warp halve the xq reads of R=32
    gemv_w4a8_tc_kernel<T, CB, 2, 4><<<(n + 31) / 32, block, 0, s>>>(xq, ax, q4, scale, out, rows,
                                                                     n, k, g);
}

// gemv_w4a8_tc_kernel's computation for the calls it does not take (g/2 not
// a multiple of 16, q4 not 16-byte aligned): xq in packed order, a span of
// 16 weight bytes (one 4-byte word a lane) and xq at the bytes' own index,
// so a span may straddle groups. Such a span takes one product a group it
// touches, the xq bytes of the other groups' weights zeroed in B (a lane's B
// slots are its A slots), from A fragments made once. Each group's int32 sum
// stays exact and apart and takes one fp32 FMA with the group's scale, in k
// order; warps and ax[r] as there, so a row's bits never depend on R.
template <typename T, int MT, int NT, bool kAny>
__global__ void __launch_bounds__(kTcWarps * 32)
gemv_w4a8_packed_kernel(const int8_t* __restrict__ xq, int ld, const float* __restrict__ ax,
                        const uint8_t* __restrict__ q4, const float* __restrict__ scale,
                        T* __restrict__ out, int rows, int n, int k, int g) {
  constexpr int BN = 16 * MT, RB = 8 * NT, SPAN = 16, U = 2 * kTcUnroll;
  __shared__ float red[kTcWarps][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k2 = k / 2, g2 = g / 2, ng = k / g, half = ld / 2;
  const int spans = (k2 + SPAN - 1) / SPAN;
  const int ubeg = warp * spans / kTcWarps, uend = (warp + 1) * spans / kTcWarps;

  // This lane's weight and scale rows (row 0 stands in past N: never read).
  bool in[MT][2];
  const uint8_t* wrow[MT][2];
  const float* srow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      const size_t c = in[mt][h] ? static_cast<size_t>(col) : 0;
      wrow[mt][h] = q4 + c * k2 + 4 * t;
      srow[mt][h] = scale + c * ng;
    }

  float tot[MT][NT][4];
  int part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tot[mt][nt][i] = 0.f;
        part[mt][nt][i] = 0;
      }

  SpanAt next;
  next.grp = ubeg * SPAN / g2;
  next.off = ubeg * SPAN - next.grp * g2;
  for (int u0 = ubeg; u0 < uend; u0 += U) {
    SpanAt at[U];
    span_groups<U, SPAN, true>(at, next, u0, g2);
    uint32_t wp[U][MT][2];
    float sc[U][MT][2], sc1[U][MT][2];  // scales of the span's first group and the next
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = u0 + s;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool live = u < uend && in[mt][h];
          wp[s][mt][h] = live ? load_weights<4, true, kAny>(wrow[mt][h], u * SPAN, k2 - 4 * t).w[0]
                              : 0u;
          sc[s][mt][h] = live ? srow[mt][h][at[s].grp] : 0.f;
          sc1[s][mt][h] = live && at[s].grp + 1 < ng ? srow[mt][h][at[s].grp + 1] : 0.f;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      const SpanAt a = at[s];
      uint32_t xl[NT], xh[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + gid;
        const int8_t* xr = xq + static_cast<size_t>(r) * ld + u * SPAN + 4 * t;
        xl[nt] = r < rows ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
        xh[nt] = r < rows ? *reinterpret_cast<const uint32_t*>(xr + half) : 0u;
      }
      uint32_t af[MT][4];  // the word's four low nibbles, then its four high ones, u - 8
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t w0 = wp[s][mt][0], w1 = wp[s][mt][1];
        af[mt][0] = static_cast<uint32_t>(nibbles_s8(w0));
        af[mt][1] = static_cast<uint32_t>(nibbles_s8(w1));
        af[mt][2] = static_cast<uint32_t>(nibbles_s8(w0 >> 4));
        af[mt][3] = static_cast<uint32_t>(nibbles_s8(w1 >> 4));
      }
      const bool last = u + 1 == uend;  // this warp's part ends: its sums take their scales
#pragma unroll 1
      for (int i = 0, grp = a.grp; i * g2 < a.off + SPAN && grp < ng; ++i, ++grp) {
        const uint32_t m = group_bytes(a.off + 4 * t - i * g2, g2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (8 * nt < rows)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_16832_s8(part[mt][nt], af[mt], xl[nt] & m, xh[nt] & m);
        if ((i + 1) * g2 <= a.off + SPAN || last) {  // the group (or this warp's part) ends
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {  // C rows: gid (e < 2) and gid + 8
                const int h = e >> 1;
                const float gs = i == 0   ? sc[s][mt][h]
                                 : i == 1 ? sc1[s][mt][h]
                                          : (in[mt][h] ? srow[mt][h][grp] : 0.f);
                tot[mt][nt][e] = fmaf(static_cast<float>(part[mt][nt][e]), gs, tot[mt][nt][e]);
                part[mt][nt][e] = 0;
              }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp][16 * mt + gid + 8 * (i >> 1)][8 * nt + 2 * t + (i & 1)] = tot[mt][nt][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * RB; idx += kTcWarps * 32) {
    const int m = idx % BN, r = idx / BN;
    if (r < rows && n0 + m < n) {
      float acc = red[0][m][r];
#pragma unroll
      for (int w = 1; w < kTcWarps; ++w) acc += red[w][m][r];
      out[static_cast<size_t>(r) * n + n0 + m] = from_f32<T>(acc * ax[r]);
    }
  }
}

template <typename T, bool kAny>
void launch_w4a8_packed(const int8_t* xq, int ld, const float* ax, const uint8_t* q4,
                        const float* scale, T* out, int rows, int n, int k, int g,
                        cudaStream_t s) {
  const dim3 block(kTcWarps * 32);
  if (rows <= 8)
    gemv_w4a8_packed_kernel<T, 1, 1, kAny>
        <<<(n + 15) / 16, block, 0, s>>>(xq, ld, ax, q4, scale, out, rows, n, k, g);
  else if (rows <= 16)
    gemv_w4a8_packed_kernel<T, 1, 2, kAny>
        <<<(n + 15) / 16, block, 0, s>>>(xq, ld, ax, q4, scale, out, rows, n, k, g);
  else  // two m16 tiles a warp halve the xq reads of R=32
    gemv_w4a8_packed_kernel<T, 2, 4, kAny>
        <<<(n + 31) / 32, block, 0, s>>>(xq, ld, ax, q4, scale, out, rows, n, k, g);
}

// The row quantization, then the dot: natural order (the widest span whose
// multiple g/2 is) where int4_natural holds, else packed order.
template <typename T>
void launch_w4a8(const void* x, const void* q4, const float* scale, int8_t* xq, float* ax,
                 void* out, int rows, int n, int k, int g, cudaStream_t s) {
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const int g2 = g / 2;
  if (int4_natural(q4, g)) {
    quantize_rows_kernel<T, false><<<rows, kQuantThreads, 0, s>>>(xt, xq, ax, k, g, k);
    if (g2 % 64 == 0)
      launch_w4a8_tc<T, 16>(xq, ax, w, scale, o, rows, n, k, g, s);
    else if (g2 % 32 == 0)
      launch_w4a8_tc<T, 8>(xq, ax, w, scale, o, rows, n, k, g, s);
    else
      launch_w4a8_tc<T, 4>(xq, ax, w, scale, o, rows, n, k, g, s);
    return;
  }
  const int ld = 2 * packed_half(k);
  quantize_rows_kernel<T, true><<<rows, kQuantThreads, 0, s>>>(xt, xq, ax, k, g, ld);
  if (int4_words_aligned(q4, k))
    launch_w4a8_packed<T, false>(xq, ld, ax, w, scale, o, rows, n, k, g, s);
  else
    launch_w4a8_packed<T, true>(xq, ld, ax, w, scale, o, rows, n, k, g, s);
}

}  // namespace

// planes: workspace the caller allocates unless x is read as it is (bf16,
// K a multiple of 64, 16-byte aligned): P * rows * (K rounded up to 64)
// bf16, P = 3 for fp32 x, 1 for bf16; NULL otherwise. kernel -1 routes by
// shape (the tensor-core kernel on x as it is against aligned rows of whole
// spans, else the general route: the pre-pass's planes, weight words where
// the rows need them); 0 (general) or 1 (tensor cores) asks for that one,
// and a kernel that does not take the call is an error. *launched is set to
// the kernel launched, or -1 where none was (no rows or no columns, or an
// error).
extern "C" int l32_gemv_int8(const void* x, const void* q, const void* scale, void* planes,
                             void* out, int rows, int n, int k, int dtype, int kernel,
                             int* launched, void* stream) {
  *launched = -1;
  if (rows == 0 || n == 0) return 0;
  if (rows > 32 || k <= 0 || (dtype != L32_BF16 && dtype != L32_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool as_is = int8_x_as_is(x, k, dtype), whole = int8_rows_whole(q, k);
  if (kernel == kRouted) kernel = as_is && whole ? kTc : kGeneral;
  if (kernel != kGeneral && !(kernel == kTc && as_is && whole))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int8_t* w = static_cast<const int8_t*>(q);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  int ld = k;
  if (!as_is) {
    if (planes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ld = (k + 63) / 64 * 64;
    auto pl = static_cast<uint16_t*>(planes);
    if (dtype == L32_F32)
      split_rows_kernel<float, 3, false><<<rows, kPlanesThreads, 0, s>>>(
          static_cast<const float*>(x), pl, rows, k, 0, ld, 0);
    else
      split_rows_kernel<__nv_bfloat16, 1, false><<<rows, kPlanesThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), pl, rows, k, 0, ld, 0);
    xp = static_cast<const __nv_bfloat16*>(planes);
  }
  const size_t plane = static_cast<size_t>(rows) * ld;
  if (dtype == L32_F32 && whole)
    launch_int8<3, false>(xp, ld, plane, w, sc, out, rows, n, k, s);
  else if (dtype == L32_F32)
    launch_int8<3, true>(xp, ld, plane, w, sc, out, rows, n, k, s);
  else if (whole)
    launch_int8<1, false>(xp, ld, plane, w, sc, out, rows, n, k, s);
  else
    launch_int8<1, true>(xp, ld, plane, w, sc, out, rows, n, k, s);
  const int err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}

// planes: workspace the caller allocates unless x is bf16, x and q4 are
// 16-byte aligned and g/2 is a multiple of 16 (then x is read as it is):
// P * rows * 2 * packed_half(k) bf16, P = 3 for fp32 x, 1 for bf16; NULL
// otherwise.
extern "C" int l32_gemv_int4(const void* x, const void* q4, const void* scale, void* planes,
                             void* out, int rows, int n, int k, int g, int dtype, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (g <= 0 || g % 2 || k % g || rows > 32 || (dtype != L32_BF16 && dtype != L32_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  const bool natural = int4_natural(q4, g);
  if (dtype == L32_BF16 && natural && aligned16(x)) {  // the decode path: x as it is
    launch_int4_natural<1>(static_cast<const __nv_bfloat16*>(x), k, 0, w, sc, out, rows, n, k, g,
                           s);
    return static_cast<int>(cudaGetLastError());
  }
  if (planes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto pl = static_cast<uint16_t*>(planes);
  auto xp = static_cast<const __nv_bfloat16*>(planes);
  const int ld = natural ? k : 2 * packed_half(k);
  const size_t plane = static_cast<size_t>(rows) * ld;
  const bool fp32 = dtype == L32_F32;
  if (fp32 && natural)
    split_rows_kernel<float, 3, false><<<rows, kPlanesThreads, 0, s>>>(
        static_cast<const float*>(x), pl, rows, k, g, ld, g / 2);
  else if (fp32)
    split_rows_kernel<float, 3, true><<<rows, kPlanesThreads, 0, s>>>(
        static_cast<const float*>(x), pl, rows, k, g, ld, g / 2);
  else if (natural)
    split_rows_kernel<__nv_bfloat16, 1, false><<<rows, kPlanesThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pl, rows, k, g, ld, g / 2);
  else
    split_rows_kernel<__nv_bfloat16, 1, true><<<rows, kPlanesThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pl, rows, k, g, ld, g / 2);
  const bool words = int4_words_aligned(q4, k);
  if (fp32 && natural)
    launch_int4_natural<3>(xp, ld, plane, w, sc, out, rows, n, k, g, s);
  else if (fp32 && words)
    launch_int4_planes<4, 3, true, false>(xp, ld, plane, w, sc, out, rows, n, k, g, s);
  else if (fp32)
    launch_int4_planes<4, 3, true, true>(xp, ld, plane, w, sc, out, rows, n, k, g, s);
  else if (natural)
    launch_int4_natural<1>(xp, ld, plane, w, sc, out, rows, n, k, g, s);
  else if (words)
    launch_int4_planes<4, 1, true, false>(xp, ld, plane, w, sc, out, rows, n, k, g, s);
  else
    launch_int4_planes<4, 1, true, true>(xp, ld, plane, w, sc, out, rows, n, k, g, s);
  return static_cast<int>(cudaGetLastError());
}

// xq [rows * 2 * packed_half(k)] int8 and ax [rows] fp32: workspace the
// caller allocates.
extern "C" int l32_gemv_int4_w4a8(const void* x, const void* q4, const void* scale, void* xq,
                                  void* ax, void* out, int rows, int n, int k, int g, int dtype,
                                  void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (g <= 0 || g % 2 || k % g || rows > 32 || (dtype != L32_BF16 && dtype != L32_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int8_t* q = static_cast<int8_t*>(xq);
  float* a = static_cast<float*>(ax);
  if (dtype == L32_BF16)
    launch_w4a8<__nv_bfloat16>(x, q4, sc, q, a, out, rows, n, k, g, s);
  else
    launch_w4a8<float>(x, q4, sc, q, a, out, rows, n, k, g, s);
  return static_cast<int>(cudaGetLastError());
}
