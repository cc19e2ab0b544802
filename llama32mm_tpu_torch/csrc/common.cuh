// Shared helpers for the port's kernels: element types, conversions to and
// from fp32, warp reductions and asynchronous global-to-shared copies. Every
// C entry takes a dtype code (L32_F32 or L32_BF16) and returns
// cudaGetLastError() after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { L32_F32 = 0, L32_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of T: 4 fp32 or 8 bf16 values, loaded with one instruction.
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T& operator[](int i) { return reinterpret_cast<T*>(&raw)[i]; }
  __device__ __forceinline__ const T& operator[](int i) const {
    return reinterpret_cast<const T*>(&raw)[i];
  }
};

template <typename T>
__device__ __forceinline__ Vec16<T> load16(const T* p) {
  Vec16<T> r;
  r.raw = *reinterpret_cast<const uint4*>(p);
  return r;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Vec16<T>& r) {
  *reinterpret_cast<uint4*>(p) = r.raw;
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// D += A B on mma.sync m16n8k16: A 16x16 and B 16x8 bf16, fp32 C in place.
// Fragments: lane (gid = lane / 4, t = lane % 4) holds A rows gid (a[0], a[2])
// and gid + 8 (a[1], a[3]) at k 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9
// (a[2], a[3]); B column gid at k 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1);
// C rows gid (c[0], c[1]) and gid + 8 (c[2], c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two exact bf16 values from the signed bytes at bits 0-7 and 16-23 of v (the
// other bits are ignored): 0x4300 | (b & 0x7F) is the bf16 128 + (b & 0x7F),
// and subtracting 128 (b >= 0) or 256 (b < 0: 0x4300 | 0x80) leaves b, an
// exact bf16 difference. Two LOP3s and one bf16x2 subtraction a pair.
__device__ __forceinline__ uint32_t int8x2_bf16x2(uint32_t v) {
  const uint32_t m = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (v & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                             *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&r);
}

// D += A B on mma.sync m16n8k32 in signed bytes: A 16x32 and B 32x8 s8,
// int32 C in place (exact). Fragments: lane (gid, t) holds A rows gid (a[0],
// a[2]) and gid + 8 (a[1], a[3]) at k 4t .. 4t + 3 (a[0], a[1]) and 4t + 16 ..
// 4t + 19 (a[2], a[3]), four bytes a word, the lowest byte first; B column gid
// at the same two k sets (b0, b1); C as mma_16816's.
__device__ __forceinline__ void mma_16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of a weight row read once: they bypass L1, which keeps x. A warp's
// load covers 64 bytes of each of 8 rows; the L2::256B hint has L2 fetch 256
// bytes of the row at once, which the next spans read (-3.4% at the bf16
// lm_head gemv).
__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// 4 bytes of a weight row read once (bypassing L1), from an aligned address.
__device__ __forceinline__ uint32_t load_stream4(const void* p) {
  uint32_t r;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(r) : "l"(p));
  return r;
}

// The 4 bytes of a weight row at p, at any alignment, from the aligned
// words that hold them (a funnel shift joins two). The row ends at `end`:
// bytes past it are whatever the next row holds, and a word wholly past it
// is not read.
__device__ __forceinline__ uint32_t load_word_any(const uint8_t* p, const uint8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint8_t* w = reinterpret_cast<const uint8_t*>(a & ~static_cast<uintptr_t>(3));
  const uint32_t sh = static_cast<uint32_t>(a & 3) * 8;
  const uint32_t lo = load_stream4(w);
  const uint32_t hi = sh && w + 4 < end ? load_stream4(w + 4) : 0u;
  return __funnelshift_r(lo, hi, sh);
}

// load_word_any with the bytes at or past `end` read as 0 (nothing is read
// where p is past it): a ragged row's last span, whose weights past K would
// otherwise be the next row's (an Inf there times a zero x is NaN).
__device__ __forceinline__ uint32_t load_word_before(const uint8_t* p, const uint8_t* end) {
  if (p >= end) return 0u;
  const uint32_t v = load_word_any(p, end);
  const long long left = end - p;
  return left >= 4 ? v : v & ((1u << (8 * left)) - 1u);
}

// 16 bytes of a weight row at p, the row ending at `end`: one streaming
// load where they are 16-byte aligned and inside the row, else four words
// as load_word_before reads them.
__device__ __forceinline__ uint4 load16_any(const void* p, const void* end) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  const uint8_t* e = static_cast<const uint8_t*>(end);
  if ((reinterpret_cast<uintptr_t>(b) & 15) == 0 && b + 16 <= e) return load_stream16(b);
  return make_uint4(load_word_before(b, e), load_word_before(b + 4, e),
                    load_word_before(b + 8, e), load_word_before(b + 12, e));
}

// Warps a block of the swap-AB tensor-core gemvs (gemv.cu, the SwiGLU rows
// kernel): enough blocks x warps to keep loads in flight on every SM at
// every N (W_key's N = 1024 has 64 groups of 16 columns, w_down's 256 for a
// K of 14336), with at least 8 spans of 32 k a warp. N and K alone decide
// it, so a row's bits never depend on R. (Measured on the bf16 gemv: 8 and
// 16 beat 4 and 8 at every decode shape, -7% at w_down; 2 and 4 lost up to
// 20%.)
static inline int tc_warps(int n, int k) {
  int warps = n >= 8192 ? 8 : 16;
  while (warps > 4 && k / 32 < 8 * warps) warps /= 2;
  return warps;
}

// cp.async of N (4, 8 or 16) bytes into shared memory; with valid false the
// destination is zero-filled and nothing is read.
template <int N>
__device__ __forceinline__ void async_copy(void* smem, const void* gmem, bool valid) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem), "n"(N),
                 "r"(src_bytes));
}

__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// fp32 x = b0 + b1 + b2 in bf16, exactly for every normal x whose low part
// stays normal (|x| above ~2^-110; below, bits under bf16's smallest
// subnormal are lost): each plane is the top 16 bits of what the planes
// before it leave (truncation, so no plane can round up to inf near
// FLT_MAX), and each remainder is exact in fp32. A product b_i * (u - 8) or
// b_i * q (int8) is exact in fp32, so the tensor cores add the three terms
// of every product as fp32 would.
__device__ __forceinline__ void split_bf16x3(float x, uint16_t (&b)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t u = __float_as_uint(x);
    b[i] = static_cast<uint16_t>(u >> 16);
    x -= __uint_as_float(u & 0xFFFF0000u);
  }
}

// The k whose x element e of a packed x row holds, or -1 for a zero. A
// packed row has two halves of `half` elements: element c of the low half
// holds the x of the low nibble of a weight byte, of the high half that of
// its high nibble (int4 split-half packing: byte i of group j holds k = j g
// + i and j g + g/2 + i). Group j's g/2 bytes sit at [j span, j span + g/2)
// of a half, span >= g/2: zeros from there to (j + 1) span and past the
// last group.
__device__ __forceinline__ int planes_source(int e, int k, int g, int half, int span) {
  const int g2 = g / 2, hi = e >= half, c = e - hi * half;
  const int grp = c / span, off = c - grp * span;
  if (grp >= k / g || off >= g2) return -1;
  return grp * g + hi * g2 + off;
}

namespace {

constexpr int kPadThreads = 256;

// The pre-pass of the general routes that read rows of whole 16-byte spans
// (gemv.cu's for x, swiglu.cu's for x and both weights), one block a row:
// x [rows, k] copied to rows of ld elements (ld a multiple of 16 bytes, xp
// 16-byte aligned), zeros from k to ld. x may start at any element: a thread
// gathers 16 bytes of a row by element loads (a warp's loads cover 512
// contiguous bytes, read from L1 after the first) and writes them as one
// 16-byte store, so each thread keeps 16 bytes of loads in flight.
template <typename T>
__global__ void __launch_bounds__(kPadThreads)
pad_rows_kernel(const T* __restrict__ x, T* __restrict__ xp, int k, int ld) {
  constexpr int V = Vec16<T>::N;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * k;
  T* o = xp + static_cast<size_t>(blockIdx.x) * ld;
  for (int e = threadIdx.x * V; e < ld; e += kPadThreads * V) {
    Vec16<T> v;
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = e + j < k ? xr[e + j] : from_f32<T>(0.f);
    store16(o + e, v);
  }
}

constexpr int kPlanesThreads = 256;

// The quantized kernels' pre-pass (one block a row of x): x [rows, k] as P
// bf16 planes [P][rows][ld], fp32 x split into three (split_bf16x3), bf16 x
// copied into one, in the order the kernel reads them: natural (element e
// holds k = e, zeros from K to ld) or packed (planes_source, halves of ld / 2
// elements, groups `span` apart).
template <typename T, int P, bool kPacked>
__global__ void __launch_bounds__(kPlanesThreads)
split_rows_kernel(const T* __restrict__ x, uint16_t* __restrict__ planes, int rows, int k, int g,
                  int ld, int span) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * k;
  for (int e = threadIdx.x; e < ld; e += kPlanesThreads) {
    const int src = kPacked ? planes_source(e, k, g, ld / 2, span) : e < k ? e : -1;
    const float v = src >= 0 ? to_f32(xr[src]) : 0.f;
    uint16_t b[3];
    split_bf16x3(v, b);  // bf16 x: b[0] is x, b[1] = b[2] = 0
#pragma unroll
    for (int p = 0; p < P; ++p)
      planes[(static_cast<size_t>(p) * rows + blockIdx.x) * ld + e] = b[p];
  }
}

}  // namespace
