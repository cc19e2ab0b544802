// The SwiGLU rows bodies: what one warp computes for a few rows of x (at most
// 8) against some intermediate columns of w_gate and w_up (both [I, H]), fp32
// sums in a k order fixed by H alone, so that a row's bits never depend on how
// many rows a call has. Shared by the rows kernels of csrc/swiglu.cu and the
// first phase of csrc/swiglu_down.cu.
//
// - gate_up_tc: bf16 on mma.sync m16n8k16 in the swap-AB form (16 columns of
//   gate and of up the M side of two products, the rows of x the N side), over
//   a range of H's 32-k spans.
// - gate_up_simt: T (fp32 or bf16) on the CUDA cores, kSimtCols columns of gate
//   and of up, all of H; each lane's slice of x is read once a span for all of
//   them. The lanes' partial sums are then reduce_scatter'ed.
#pragma once

#include <math.h>

#include "common.cuh"

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// One 32-k span of a swap-AB m16n8k16 product, A rows gid and gid + 8 (a0, a1)
// and B column gid (b) each as the 16 bytes at k 8t .. 8t + 7 that the lane
// loaded. The k slots of the fragments are a permutation of the span's k
// (words 0 and 1 of each 16 bytes feed the first product, 2 and 3 the second),
// the same on both sides, so the products are the span's.
__device__ __forceinline__ void mma_span(float (&acc)[4], uint4 a0, uint4 a1, uint4 b) {
  const uint32_t lo[4] = {a0.x, a1.x, a0.y, a1.y};  // k 8t .. 8t + 3
  const uint32_t hi[4] = {a0.z, a1.z, a0.w, a1.w};  // k 8t + 4 .. 8t + 7
  mma_16816(acc, lo, b.x, b.y);
  mma_16816(acc, hi, b.z, b.w);
}

// The 8 bf16 of a row at k .. k + 7, zeros at and past n (the row's length)
// and everywhere when !in. kVec (n % 8 == 0, a 16-byte-aligned row, k % 8 ==
// 0): one 16-byte load, a streaming one (weights read once) with kStream;
// else one element at a time.
template <bool kVec, bool kStream>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int k, int n, bool in) {
  if constexpr (kVec) {
    if (!in || k >= n) return make_uint4(0u, 0u, 0u, 0u);
    return kStream ? load_stream16(row + k) : *reinterpret_cast<const uint4*>(row + k);
  } else {
    auto bits = [&](int j) -> uint32_t {
      return in && k + j < n ? __bfloat16_as_ushort(row[k + j]) : 0u;
    };
    return make_uint4(bits(0) | bits(1) << 16, bits(2) | bits(3) << 16, bits(4) | bits(5) << 16,
                      bits(6) | bits(7) << 16);
  }
}

constexpr int kTcUnroll = 4;  // spans whose weight loads a lane keeps in flight

// gemv.cu's gemv_tc_kernel with two A streams. One m16 tile: the 16
// intermediate columns n0 .. n0 + 15 (rows of both weights; 0 at and past
// inter); one n8 tile: the rows of x (0 at and past rows). A span is 32 k:
// lane (gid, t) loads 16 bytes of gate rows gid and gid + 8, of up rows gid and
// gid + 8, and of x row gid at k 8t, and the lane's x fragment serves four
// products, two into the gate sums and two into the up sums. Sums the spans
// [ubeg, uend) in order into accg / accu: C element i of a lane is column
// gid + 8 (i / 2), x row 2t + i % 2. kVec: h % 8 == 0 and 16-byte-aligned x
// and weights (16-byte loads, the weights' with the L2::256B hint); else
// element loads, zeros past h.
template <bool kVec>
__device__ __forceinline__ void gate_up_tc(const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ wg,
                                           const __nv_bfloat16* __restrict__ wu, int rows, int h,
                                           int inter, int n0, int ubeg, int uend,
                                           float (&accg)[4], float (&accu)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
  // This lane's weight rows (row 0 stands in past I: never loaded) and x row.
  bool in[2];
  const __nv_bfloat16 *grow[2], *urow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = n0 + 8 * hh + gid;
    in[hh] = col < inter;
    const size_t o = static_cast<size_t>(in[hh] ? col : 0) * h;
    grow[hh] = wg + o;
    urow[hh] = wu + o;
  }
  const bool xin = gid < rows;
  const __nv_bfloat16* xrow = x + static_cast<size_t>(xin ? gid : 0) * h;

  for (int u0 = ubeg; u0 < uend; u0 += kTcUnroll) {
    uint4 gv[kTcUnroll][2], uv[kTcUnroll][2];
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool load = u0 + s < uend && in[hh];
        const int k = (u0 + s) * 32 + 8 * t;
        gv[s][hh] = load8<kVec, true>(grow[hh], k, h, load);
        uv[s][hh] = load8<kVec, true>(urow[hh], k, h, load);
      }
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      const uint4 xv = load8<kVec, false>(xrow, u * 32 + 8 * t, h, xin);
      mma_span(accg, gv[s][0], gv[s][1], xv);
      mma_span(accu, uv[s][0], uv[s][1], xv);
    }
  }
}

// reduce_scatter's steps at xor distances S, S / 2, .., 1: each lane keeps
// the S values whose index bit S matches its lane bit (moved to 0 .. S - 1)
// and adds its partner's. A template a step, so that every loop has a
// constant trip count and v stays in registers.
template <int S, int NV>
__device__ __forceinline__ void scatter_steps(float (&v)[NV], int lane) {
  if constexpr (S >= 1) {
    const bool upper = lane & S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float keep = upper ? v[i + S] : v[i];
      const float send = upper ? v[i] : v[i + S];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
    scatter_steps<S / 2>(v, lane);
  }
}

// Sum each of NV values (NV a power of two, at most 32) over the warp's lanes;
// lane l returns the sum of value l % NV. Values are exchanged with the xor
// partners 16, 8, .., 1: while the partner distance is at least NV every value
// is kept and added (a warp all-reduce), below it each lane keeps the half of
// its values whose index bit matches its lane bit and sends the other half.
// Every sum is thus the same xor tree over the 32 lanes as warp_sum's,
// whatever NV is (float addition commutes), in 31 exchanges for NV = 32.
template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV]) {
  static_assert(NV >= 1 && NV <= 32 && (NV & (NV - 1)) == 0, "NV: a power of two up to 32");
#pragma unroll
  for (int s = 16; s >= NV; s >>= 1)
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], s);
  scatter_steps<NV / 2>(v, threadIdx.x & 31);
  return v[0];
}

constexpr int kSimtCols = 4;  // columns of gate and of up a warp owns (gate_up_simt)

// The CUDA-core body for at most MAXR (<= 8) rows of x against the columns
// col0 .. col0 + kSimtCols - 1 of gate and of up (0 at and past inter): this
// lane's partial sums g[r * kSimtCols + c], u[...] over its k (lane V + 32 V j
// .. + V - 1 for 16-byte vectors of V elements, kVec; else lane + 32 j), in
// increasing k; reduce_scatter sums them over the warp. A span is 32 V k: the
// lane loads 16 bytes of each of the 2 kSimtCols weight rows (streaming, the
// next span's in flight during this one's products), then each row of x's 16
// bytes once for all of them, so x passes through L1 once per kSimtCols
// columns (the weights bypass L1). kVec: h a multiple of V and 16-byte-aligned
// x and weights; else element loads.
template <typename T, int MAXR, bool kVec>
__device__ __forceinline__ void gate_up_simt(const T* __restrict__ x, const T* __restrict__ wg,
                                             const T* __restrict__ wu, int rows, int h,
                                             int inter, int col0, float (&g)[kSimtCols * MAXR],
                                             float (&u)[kSimtCols * MAXR]) {
  constexpr int C = kSimtCols;
  const int lane = threadIdx.x & 31;
  bool in[C];
  const T *gr[C], *ur[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    in[c] = col0 + c < inter;
    const size_t o = static_cast<size_t>(in[c] ? col0 + c : 0) * h;
    gr[c] = wg + o;
    ur[c] = wu + o;
  }
#pragma unroll
  for (int i = 0; i < C * MAXR; ++i) g[i] = u[i] = 0.f;

  if constexpr (kVec) {
    constexpr int V = Vec16<T>::N, SPAN = 32 * V;
    // The next span's weights are loaded before this span's products, so a
    // warp keeps loads in flight while it multiplies.
    auto load = [&](Vec16<T> (&gv)[C], Vec16<T> (&uv)[C], int k) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool ld = in[c] && k < h;
        gv[c].raw = ld ? load_stream16(gr[c] + k) : make_uint4(0u, 0u, 0u, 0u);
        uv[c].raw = ld ? load_stream16(ur[c] + k) : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    Vec16<T> gv[C], uv[C];
    load(gv, uv, lane * V);
    for (int k = lane * V; k < h; k += SPAN) {
      Vec16<T> gn[C], un[C];
      load(gn, un, k + SPAN);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const Vec16<T> xv = load16(x + static_cast<size_t>(r) * h + k);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xf = to_f32(xv[e]);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              g[r * C + c] = fmaf(xf, to_f32(gv[c][e]), g[r * C + c]);
              u[r * C + c] = fmaf(xf, to_f32(uv[c][e]), u[r * C + c]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gv[c] = gn[c];
        uv[c] = un[c];
      }
    }
  } else {
    for (int k = lane; k < h; k += 32) {
      float gw[C], uw[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gw[c] = in[c] ? to_f32(gr[c][k]) : 0.f;
        uw[c] = in[c] ? to_f32(ur[c][k]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const float xf = to_f32(x[static_cast<size_t>(r) * h + k]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            g[r * C + c] = fmaf(xf, gw[c], g[r * C + c]);
            u[r * C + c] = fmaf(xf, uw[c], u[r * C + c]);
          }
        }
      }
    }
  }
}
