// Decode gemv: out[r, n] = sum_k x[r, k] * w[n, k] for a few rows r <= 32,
// with the weight stored [N, K] (nn.Linear's layout, and the [vocab, hidden]
// embedding read as the tied lm_head).
//
// Replaces three TPU kernels of llama32mm_tpu/ops/pallas/gemv.py:
// _kernel (gemv_pallas, w [K, N]), _stacked_kernel (gemv_stacked_pallas,
// w[layer] by scalar prefetch: here a pointer to one layer's weight) and
// _t_kernel (gemv_t_pallas, w_t [N, K], the orientation this kernel uses).
//
// Bound on the H100: device-memory bytes of the weight. Each weight element
// is used r times (r <= 32 FLOP pairs per 2 bytes), far below the ~295
// FLOPs per byte at which bf16 tensor cores become the limit. l32_gemv
// routes by shape (route()), never by failure:
//
// 1. The tensor-core kernel (gemv_tc_kernel) takes bf16 x with K a
//    multiple of 32 and 16-byte-aligned x and w: every decode linear of the
//    bf16 models, at every R from 1 to 32. mma.sync m16n8k16 in the swap-AB
//    form: 16 output columns (weight rows) are the M side and up to 8 rows
//    of x the N side of a product, one n8 tile for R <= 8, two for <= 16,
//    four for <= 32 (and two m16 tiles a warp above 16 rows, which halves
//    the x reads a weight byte costs). A span is 32 k: lane (gid, t) loads
//    16 bytes of weight rows gid and gid + 8 at k 8t and 16 bytes of x row
//    gid at the same k, and each pair of 32-bit words feeds one product as
//    loaded (A slots 2t, 2t + 8 and B slots 2t, 2t + 8 hold k 8t .. 8t + 3 of
//    both operands alike; a dot product is blind to which k sits in which
//    slot), so nothing is repacked. x is read once per 16 output columns
//    (the CUDA-core kernel read it once per column: at R = 8 eight times the
//    weight's bytes through L1/L2, and 64 FMAs per weight load, which made it
//    issue-bound). The block's warps split K at fixed span boundaries, their
//    fp32 totals are summed in shared memory in warp order, and each output
//    is rounded once to bf16 (Pallas: preferred_element_type=float32, then
//    astype). The number of warps depends on N and K only (tc_warps), the
//    n8/m16 tiling changes no output's arithmetic, and there are no atomics
//    and no split across blocks: a row's bits never depend on R or on the
//    other rows, so a server's row equals a solo engine's decode, and R = 1
//    runs this kernel too.
//    Measured (profile_qgemv.py --bf16, device time, NVIDIA H100 80GB HBM3
//    at 700 W): lm_head 0.343 / 0.351 / 0.364 / 0.390 ms at R = 1 / 8 / 16
//    / 32 (the CUDA-core kernel 0.330 / 0.565 / 1.381 / 4.681, F.linear
//    0.360-0.367, bound 0.314); w_down 0.042 / 0.044 at R = 1 / 8 (F.linear
//    0.045, bound 0.035).
// 2. fp32 x (fp32 weights: the tiny fp32 models) takes the same kernel on
//    mma.sync m16n8k8 TF32 with every product as three (3xTF32,
//    csrc/tf32.cuh): a = big + small for both operands, and a b ~ a_s b_b +
//    a_b b_s + a_b b_b. A span is 16 k: lane (gid, t) loads 16 bytes (k 4t ..
//    4t + 3) of weight rows gid and gid + 8 and of x row gid, and k 4t, 4t +
//    1 are the slots t, t + 4 of one k8 step, 4t + 2, 4t + 3 those of
//    another, in A and B alike, so nothing is repacked; each weight is split
//    in registers as loaded (an integer add and mask, one fp32 subtraction),
//    x likewise. The tensor cores round their fp32 accumulation toward zero,
//    so each span's six products go into fresh registers and are added to
//    the total in fp32. Warps from N and K, tiles and the reduction as in 1,
//    so a row's bits never depend on R.
// 3. bf16 x with K not a multiple of 32 or a pointer off 16-byte alignment
//    runs the kernel of 1 after a pre-pass (common.cuh::pad_rows_kernel) that copies x
//    to aligned rows of whole spans, zeros past K; fp32 x takes the same
//    pre-pass where K is not a multiple of 16 or x is misaligned. Weight rows
//    that are not 16-byte aligned, or end inside a span, are read 16 bytes
//    at a time by one load where those are aligned and inside the row, else
//    as aligned 4-byte words joined by a funnel shift, the bytes past the
//    row's end zeroed (load16_any): no word is read wholly past it.
#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- The tensor-core kernel: bf16, and fp32 as 3xTF32 ----

// W warps a block, each a fixed part of K's spans; MT m16 tiles (16 output
// columns each) and NT n8 tiles (8 rows of x each) a warp. C element i of a
// lane: output column 16 mt + gid + 8 (i / 2), x row 8 nt + 2t + i % 2. A
// span is 64 bytes of a row (32 bf16 k, 16 fp32 k), 16 a lane; x rows are
// ldx elements apart, whole spans (K, or the pre-pass's padding). A lane
// loads U spans at a time (U changes no arithmetic); kAny reads weight rows
// that are misaligned or end inside a span by words. bf16 sums every span
// in one chain, as the Pallas kernel's dot; fp32 (see the header) sums each
// span's six TF32 products in fresh registers, added to the total in fp32.
template <typename T, int W, int MT, int NT, int U, bool kAny>
__global__ void __launch_bounds__(W * 32)
gemv_tc_kernel(const T* __restrict__ x, int ldx, const T* __restrict__ w, T* __restrict__ out,
               int rows, int n, int k) {
  constexpr int BN = 16 * MT, RB = 8 * NT, V = 16 / sizeof(T), SPAN = 4 * V;
  __shared__ float red[W][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int spans = ldx / SPAN;
  const int ubeg = warp * spans / W, uend = (warp + 1) * spans / W;

  // This lane's weight rows (row 0 stands in past N: never loaded) and x rows.
  bool in[MT][2];
  const T* wrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      wrow[mt][h] = w + static_cast<size_t>(in[mt][h] ? col : 0) * k + V * t;
    }
  bool xin[NT];
  const T* xrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = 8 * nt + gid;
    xin[nt] = r < rows;
    xrow[nt] = x + static_cast<size_t>(xin[nt] ? r : 0) * ldx + V * t;
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
            wv[s][mt][h] = live ? load16_any(wrow[mt][h] + (u0 + s) * SPAN,
                                                wrow[mt][h] - V * t + k)
                                : make_uint4(0u, 0u, 0u, 0u);
          else
            wv[s][mt][h] = live ? load_stream16(wrow[mt][h] + (u0 + s) * SPAN)
                                : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      uint4 xv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        xv[nt] = xin[nt] ? *reinterpret_cast<const uint4*>(xrow[nt] + u * SPAN)
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 w0 = wv[s][mt][0], w1 = wv[s][mt][1];
        if constexpr (std::is_same_v<T, bf16>) {
          const uint32_t a_lo[4] = {w0.x, w1.x, w0.y, w1.y};  // k 8t .. 8t + 3
          const uint32_t a_hi[4] = {w0.z, w1.z, w0.w, w1.w};  // k 8t + 4 .. 8t + 7
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (8 * nt < rows) {
              mma_16816(acc[mt][nt], a_lo, xv[nt].x, xv[nt].y);
              mma_16816(acc[mt][nt], a_hi, xv[nt].z, xv[nt].w);
            }
          }
        } else {
          // k8 step 0: slots t, t + 4 = k 4t, 4t + 1; step 1: k 4t + 2, 4t + 3
          const FragA a0 = frag_a<true>(__uint_as_float(w0.x), __uint_as_float(w1.x),
                                        __uint_as_float(w0.y), __uint_as_float(w1.y));
          const FragA a1 = frag_a<true>(__uint_as_float(w0.z), __uint_as_float(w1.z),
                                        __uint_as_float(w0.w), __uint_as_float(w1.w));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (8 * nt < rows) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma3<true, true>(c, a0, frag_b<true>(__uint_as_float(xv[nt].x),
                                                   __uint_as_float(xv[nt].y)));
              mma3<true, true>(c, a1, frag_b<true>(__uint_as_float(xv[nt].z),
                                                   __uint_as_float(xv[nt].w)));
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][nt][i] += c[i];
            }
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
        red[warp][16 * mt + gid + 8 * (i >> 1)][8 * nt + 2 * t + (i & 1)] = acc[mt][nt][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BN * RB; idx += W * 32) {
    const int m = idx % BN, r = idx / BN;
    if (r < rows && n0 + m < n) {
      float sum = red[0][m][r];
#pragma unroll
      for (int v = 1; v < W; ++v) sum += red[v][m][r];
      out[static_cast<size_t>(r) * n + n0 + m] = from_f32<T>(sum);
    }
  }
}

// One launch a row bucket: one n8 tile for R <= 8, two for <= 16, four for
// <= 32 with two m16 tiles a warp (which halves the x reads of R = 32) where
// the reduction buffer of 32 columns fits (bf16: W <= 8; fp32: W = 8, its
// W = 4 grids running one m16 tile a warp faster). bf16 keeps 4 spans of
// loads in flight a lane; fp32 4 at R <= 2 and 2 above (fewer registers,
// more blocks an SM).
template <typename T, int W, bool kAny>
void launch_w(const T* x, int ldx, const T* w, T* out, int rows, int n, int k, cudaStream_t s) {
  auto go = [&](auto kernel, int bn) {
    kernel<<<(n + bn - 1) / bn, W * 32, 0, s>>>(x, ldx, w, out, rows, n, k);
  };
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int U = kF32 ? 2 : 4;
  if (kF32 && rows <= 2) go(gemv_tc_kernel<T, W, 1, 1, 4, kAny>, 16);
  else if (rows <= 8) go(gemv_tc_kernel<T, W, 1, 1, U, kAny>, 16);
  else if (rows <= 16) go(gemv_tc_kernel<T, W, 1, 2, U, kAny>, 16);
  else if constexpr (kF32 ? W == 8 : W <= 8) go(gemv_tc_kernel<T, W, 2, 4, U, kAny>, 32);
  else go(gemv_tc_kernel<T, W, 1, 4, U, kAny>, 16);
}

// Warps a block, from N and the bytes of a row alone (never from R):
// tc_warps counts spans of 32 bf16 k, 64 bytes, an fp32 span's too. fp32
// takes 4 where the grid of 16-column blocks fills one wave of 7 blocks an
// SM at least half way (N = 7393 .. 14784 on the H100's 132 SMs): at 8,
// fp32 w_gate (896 blocks, 2.3 waves at 3 blocks an SM) ran 11% slower at
// R=1 (PERF.md §6).
template <typename T, bool kAny>
void launch(const T* x, int ldx, const T* w, T* out, int rows, int n, int k, cudaStream_t s) {
  int warps = tc_warps(n, ldx * static_cast<int>(sizeof(T)) / 2);
  const int blocks = (n + 15) / 16;
  if (std::is_same_v<T, float> && blocks > 7 * 132 / 2 && blocks <= 7 * 132) warps = 4;
  if (warps == 4) launch_w<T, 4, kAny>(x, ldx, w, out, rows, n, k, s);
  else if (warps == 8) launch_w<T, 8, kAny>(x, ldx, w, out, rows, n, k, s);
  else launch_w<T, 16, kAny>(x, ldx, w, out, rows, n, k, s);
}

enum { kGeneral = 0, kTc = 1 };

// k of a span: 32 bf16 or 16 fp32 (64 bytes).
int span_k(int dtype) { return dtype == L32_F32 ? 16 : 32; }

// Rows of K elements at p are whole spans and 16-byte aligned: x is read
// as it is (else the pre-pass copies it to padded rows), weights by 16-byte
// loads (else by words).
bool rows_whole(const void* p, int k, int dtype) { return k % span_k(dtype) == 0 && aligned16(p); }

// The kernel a call takes: the tensor-core kernel for bf16 x read as it is
// against 16-byte-aligned weight rows of whole spans, else the general route
// (3xTF32 for fp32 x; bf16 x padded by the pre-pass, weights by words where
// their rows need it).
int route(const void* x, const void* w, int k, int dtype) {
  return dtype == L32_BF16 && rows_whole(x, k, dtype) && rows_whole(w, k, dtype) ? kTc : kGeneral;
}

template <typename T>
int launch_general(const void* x, const void* w, void* pad, void* out, int rows, int n, int k,
                   cudaStream_t s) {
  const int dtype = std::is_same_v<T, float> ? L32_F32 : L32_BF16, span = span_k(dtype);
  const T* xs = static_cast<const T*>(x);
  int ld = k;
  if (!rows_whole(x, k, dtype)) {
    if (pad == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ld = (k + span - 1) / span * span;
    pad_rows_kernel<T><<<rows, kPadThreads, 0, s>>>(xs, static_cast<T*>(pad), k, ld);
    xs = static_cast<const T*>(pad);
  }
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (rows_whole(w, k, dtype))
    launch<T, false>(xs, ld, wt, o, rows, n, k, s);
  else
    launch<T, true>(xs, ld, wt, o, rows, n, k, s);
  return 0;
}

}  // namespace

// pad: workspace the caller allocates unless x is read as it is (its rows
// whole spans, 32 k bf16 or 16 k fp32, and 16-byte aligned): rows * (K
// rounded up to a span) elements of x's type; NULL otherwise. kernel -1
// routes by shape (route above); 0 (the general route) or 1 (the tensor-core
// kernel on x as it is) asks for that one, and a kernel that does not take
// the call is an error. *launched is set to the kernel launched, or -1 where
// none was (no rows or no columns, or an error).
extern "C" int l32_gemv(const void* x, const void* w, void* pad, void* out, int rows, int n,
                        int k, int dtype, int kernel, int* launched, void* stream) {
  *launched = -1;
  if (rows == 0 || n == 0) return 0;
  if (rows > 32 || k <= 0 || (dtype != L32_BF16 && dtype != L32_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int routed = route(x, w, k, dtype);
  if (kernel == -1) kernel = routed;
  if (kernel != kGeneral && !(kernel == kTc && routed == kTc))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == L32_F32)
    err = launch_general<float>(x, w, pad, out, rows, n, k, s);
  else
    err = launch_general<bf16>(x, w, pad, out, rows, n, k, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}
