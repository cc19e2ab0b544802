// fp32 products on Hopper's tensor cores as three TF32 mma.sync products
// (3xTF32), shared by the fp32 flash kernels (flash_attention_tf32.cu) and
// the fp32 SwiGLU tile (swiglu.cu).
//
// One TF32 product (10 mantissa bits) would miss the fp32 contract by three
// orders of magnitude, so each operand is split, x = big + small with big =
// x rounded to TF32 and small = x - big (exact), and a b ~ a_s b_b + a_b b_s +
// a_b b_b (the small x small term is below fp32 rounding). bf16 and int8
// values are exact in TF32: their small part is 0 and its product is skipped.
// The mma reads the top 19 bits of a register, so big is rounded by integer
// add and mask, and small goes in as it is (truncated to TF32: 2^-21 of x).
//
// mma.sync m16n8k8 tf32 (A row-major 16x8, B col-major 8x8, fp32 C): a lane
// (gid = lane / 4, t = lane % 4) holds C at rows gid, gid + 8 and columns 2t,
// 2t + 1. Its k slots t and t + 4 may stand for any two k indices as long as
// A and B agree; product_p maps them to k 2t and 2t + 1 of its chunk, so
// product_rows' C registers are product_p's A fragment as they are (no
// shuffle through shared memory). Shared tiles are fp32 with rows of K + 4
// floats (Geom::LD): both products' loads are free of bank conflicts.
//
// The tensor cores round their fp32 accumulation toward zero, which over a
// chain of a few hundred adds drifts by about 1e-5 of the sum, the whole
// fp32 tolerance: a caller keeps each chain to a few dozen adds in fresh
// registers and adds the partial sums in fp32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Tile geometry for a product whose k extent (a head dim, or a k-stage) is HD.
template <int HD>
struct Geom {
  static constexpr int LD = HD + 4;  // floats a shared row
  static constexpr int VW = HD % 32 == 0 ? 4 : HD % 16 == 0 ? 2 : 1;
  static constexpr int NG = HD / (8 * VW);  // column groups of the second product
  static constexpr int KS = HD / 8;         // k8 steps over HD
};

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// x ~ big + small; unsplit (kSplit false) for values exact in TF32.
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  const uint32_t bits = __float_as_uint(x);
  if constexpr (kSplit) {
    big = (bits + 0x1000u) & 0xffffe000u;  // round to nearest on the 10-bit mantissa
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = bits;
    small = 0u;
  }
}

// A fragment in register order: (row gid, slot t), (gid + 8, t), (gid, t + 4),
// (gid + 8, t + 4).
template <bool kSplit>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32<kSplit>(a0, f.big[0], f.small[0]);
  split_tf32<kSplit>(a1, f.big[1], f.small[1]);
  split_tf32<kSplit>(a2, f.big[2], f.small[2]);
  split_tf32<kSplit>(a3, f.big[3], f.small[3]);
  return f;
}

// B fragment: (slot t, column gid), (slot t + 4, column gid).
template <bool kSplit>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32<kSplit>(b0, f.big[0], f.small[0]);
  split_tf32<kSplit>(b1, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C += A B at fp32 precision: the small products first, then big x big.
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (kSplitA) mma_tf32(c, a.small, b.big[0], b.big[1]);
  if constexpr (kSplitB) mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// VW adjacent floats of a shared row, one load.
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VW]) {
  if constexpr (VW == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
  } else if constexpr (VW == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    x[0] = r.x, x[1] = r.y;
  } else {
    x[0] = *p;
  }
}

// S (+)= A B^T over HD for one warp: A rows a_rows[gid], [gid + 8] (16 rows),
// B rows b_rows[8 nt + gid] (NT n8 tiles), both [.][LD] fp32 in shared
// memory; k slots t, t + 4 are columns 8 kk + t, 8 kk + t + 4.
template <int HD, int NT, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void product_rows(float (&s)[NT][4], const float* a_rows,
                                             const float* b_rows, int gid, int t4) {
  constexpr int LD = Geom<HD>::LD;
#pragma unroll 2
  for (int kk = 0; kk < Geom<HD>::KS; ++kk) {
    const float* ap = a_rows + gid * LD + 8 * kk + t4;
    const FragA a = frag_a<kSplitA>(ap[0], ap[8 * LD], ap[4], ap[8 * LD + 4]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* bp = b_rows + (8 * nt + gid) * LD + 8 * kk + t4;
      mma3<kSplitA, kSplitB>(s[nt], a, frag_b<kSplitB>(bp[0], bp[4]));
    }
  }
}

// acc += P B for one warp: P [16][8 NT] in the C registers of product_rows
// (k slots t, t + 4 = P's columns 2t, 2t + 1 of n8 tile nt), B rows
// b_rows[8 nt + 2t], [8 nt + 2t + 1] of [.][LD] fp32 in shared memory.
// acc[VW g + i] holds the output columns 8 VW g + VW c + i for C column c.
// Each 32 keys (kKC n8 tiles) go into fresh registers, added to acc in fp32.
constexpr int kKC = 4;

template <int HD, int NT, bool kSplitB>
__device__ __forceinline__ void product_p(float (&acc)[HD / 8][4], const float (&p)[NT][4],
                                          const float* b_rows, int gid, int t4) {
  using G = Geom<HD>;
  constexpr int LD = G::LD, VW = G::VW;
  static_assert(NT % kKC == 0, "P's columns go in chunks of kKC n8 tiles");
#pragma unroll
  for (int h = 0; h < NT / kKC; ++h) {
    FragA a[kKC];
#pragma unroll
    for (int j = 0; j < kKC; ++j) {
      const int nt = kKC * h + j;
      a[j] = frag_a<true>(p[nt][0], p[nt][2], p[nt][1], p[nt][3]);
    }
#pragma unroll
    for (int g = 0; g < G::NG; ++g) {
      float c[VW][4];
#pragma unroll
      for (int i = 0; i < VW; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        const float* bp = b_rows + (8 * (kKC * h + j) + 2 * t4) * LD + VW * gid + 8 * VW * g;
        float x0[VW], x1[VW];
        load_vec<VW>(bp, x0);
        load_vec<VW>(bp + LD, x1);
#pragma unroll
        for (int i = 0; i < VW; ++i)
          mma3<true, kSplitB>(c[i], a[j], frag_b<kSplitB>(x0[i], x1[i]));
      }
#pragma unroll
      for (int i = 0; i < VW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[VW * g + i][e] += c[i][e];
    }
  }
}
