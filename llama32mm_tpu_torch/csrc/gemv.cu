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
// 1. The tensor-core kernel (gemv_bf16_tc_kernel) takes bf16 x with K a
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
// 2. The CUDA-core kernel (gemv_kernel) takes fp32 x (the tiny fp32 checks)
//    and bf16 x whose K or pointers the tensor-core kernel cannot take: one
//    warp per output column walks K with 16-byte loads (element loads for
//    ragged K), applies each weight vector to every row of x, keeps r fp32
//    accumulators a lane and reduces them with warp shuffles.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int MAXR, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
            int rows, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const T* wr = w + static_cast<size_t>(col) * k;
  constexpr int V = Vec16<T>::N;

  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  if (kVec) {
    for (int c = lane * V; c < k; c += 32 * V) {
      Vec16<T> wv = load16(wr + c);
      float wf[V];
#pragma unroll
      for (int j = 0; j < V; ++j) wf[j] = to_f32(wv[j]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          Vec16<T> xv = load16(x + static_cast<size_t>(r) * k + c);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r] = fmaf(to_f32(xv[j]), wf[j], acc[r]);
        }
      }
    }
  } else {
    for (int c = lane; c < k; c += 32) {
      const float wf = to_f32(wr[c]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rows) acc[r] = fmaf(to_f32(x[static_cast<size_t>(r) * k + c]), wf, acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) out[static_cast<size_t>(r) * n + col] = from_f32<T>(s);
    }
  }
}

template <typename T, int MAXR>
void launch_r(const void* x, const void* w, void* out, int rows, int n, int k,
              cudaStream_t stream) {
  const bool vec = k % Vec16<T>::N == 0 && aligned16(x) && aligned16(w);
  auto kernel = vec ? gemv_kernel<T, MAXR, true> : gemv_kernel<T, MAXR, false>;
  const int blocks = (n + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(static_cast<const T*>(x),
                                             static_cast<const T*>(w),
                                             static_cast<T*>(out), rows, n, k);
}

template <typename T>
int launch_simt(const void* x, const void* w, void* out, int rows, int n, int k,
                cudaStream_t stream) {
  if (rows <= 1) launch_r<T, 1>(x, w, out, rows, n, k, stream);
  else if (rows <= 2) launch_r<T, 2>(x, w, out, rows, n, k, stream);
  else if (rows <= 4) launch_r<T, 4>(x, w, out, rows, n, k, stream);
  else if (rows <= 8) launch_r<T, 8>(x, w, out, rows, n, k, stream);
  else if (rows <= 16) launch_r<T, 16>(x, w, out, rows, n, k, stream);
  else if (rows <= 32) launch_r<T, 32>(x, w, out, rows, n, k, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// ---- bf16 on the tensor cores (K a multiple of 32) ----

using bf16 = __nv_bfloat16;

constexpr int kTcUnroll = 4;  // spans whose weight loads a lane keeps in flight

// W warps a block, each a fixed part of K's spans; MT m16 tiles (16 output
// columns each) and NT n8 tiles (8 rows of x each) a warp. C element i of a
// lane: output column 16 mt + gid + 8 (i / 2), x row 8 nt + 2t + i % 2.
template <int W, int MT, int NT>
__global__ void __launch_bounds__(W * 32)
gemv_bf16_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ out, int rows, int n, int k) {
  constexpr int BN = 16 * MT, RB = 8 * NT;
  __shared__ float red[W][BN][RB + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int spans = k / 32;
  const int ubeg = warp * spans / W, uend = (warp + 1) * spans / W;

  // This lane's weight rows (row 0 stands in past N: never loaded) and x rows.
  bool in[MT][2];
  const bf16* wrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * mt + 8 * h + gid;
      in[mt][h] = col < n;
      wrow[mt][h] = w + static_cast<size_t>(in[mt][h] ? col : 0) * k + 8 * t;
    }
  bool xin[NT];
  const bf16* xrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = 8 * nt + gid;
    xin[nt] = r < rows;
    xrow[nt] = x + static_cast<size_t>(xin[nt] ? r : 0) * k + 8 * t;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int u0 = ubeg; u0 < uend; u0 += kTcUnroll) {
    uint4 wv[kTcUnroll][MT][2];
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wv[s][mt][h] = u0 + s < uend && in[mt][h] ? load_stream16(wrow[mt][h] + (u0 + s) * 32)
                                                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int s = 0; s < kTcUnroll; ++s) {
      const int u = u0 + s;
      if (u >= uend) break;
      uint4 xv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        xv[nt] = xin[nt] ? *reinterpret_cast<const uint4*>(xrow[nt] + u * 32)
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 w0 = wv[s][mt][0], w1 = wv[s][mt][1];
        const uint32_t a_lo[4] = {w0.x, w1.x, w0.y, w1.y};  // k 8t .. 8t + 3
        const uint32_t a_hi[4] = {w0.z, w1.z, w0.w, w1.w};  // k 8t + 4 .. 8t + 7
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (8 * nt < rows) {
            mma_16816(acc[mt][nt], a_lo, xv[nt].x, xv[nt].y);
            mma_16816(acc[mt][nt], a_hi, xv[nt].z, xv[nt].w);
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
      out[static_cast<size_t>(r) * n + n0 + m] = __float2bfloat16(sum);
    }
  }
}

template <int W>
void launch_tc_w(const bf16* x, const bf16* w, bf16* out, int rows, int n, int k,
                 cudaStream_t s) {
  if (rows <= 8) {
    gemv_bf16_tc_kernel<W, 1, 1><<<(n + 15) / 16, W * 32, 0, s>>>(x, w, out, rows, n, k);
  } else if (rows <= 16) {
    gemv_bf16_tc_kernel<W, 1, 2><<<(n + 15) / 16, W * 32, 0, s>>>(x, w, out, rows, n, k);
  } else if constexpr (W <= 8) {  // two m16 tiles a warp halve the x reads of R = 32
    gemv_bf16_tc_kernel<W, 2, 4><<<(n + 31) / 32, W * 32, 0, s>>>(x, w, out, rows, n, k);
  } else {  // (the reduction buffer of 32 columns would not fit)
    gemv_bf16_tc_kernel<W, 1, 4><<<(n + 15) / 16, W * 32, 0, s>>>(x, w, out, rows, n, k);
  }
}

int launch_tc(const void* x, const void* w, void* out, int rows, int n, int k, cudaStream_t s) {
  if (rows > 32) return static_cast<int>(cudaErrorInvalidValue);
  auto xb = static_cast<const bf16*>(x);
  auto wb = static_cast<const bf16*>(w);
  auto o = static_cast<bf16*>(out);
  const int warps = tc_warps(n, k);
  if (warps == 4) launch_tc_w<4>(xb, wb, o, rows, n, k, s);
  else if (warps == 8) launch_tc_w<8>(xb, wb, o, rows, n, k, s);
  else launch_tc_w<16>(xb, wb, o, rows, n, k, s);
  return 0;
}

enum { kSimt = 0, kTc = 1 };

// The kernel a call takes: the tensor-core kernel for bf16 x with K a
// multiple of 32 and 16-byte-aligned x and w, else the CUDA-core kernel.
int route(const void* x, const void* w, int k, int dtype) {
  if (dtype == L32_F32) return kSimt;
  if (dtype != L32_BF16) return -1;
  return k > 0 && k % 32 == 0 && aligned16(x) && aligned16(w) ? kTc : kSimt;
}

}  // namespace

// kernel -1 routes by shape (route above); 0 (CUDA cores) or 1 (tensor
// cores) asks for that kernel, and a kernel that does not take the call is
// an error. *launched is set to the kernel launched, or -1 where none was
// (no rows or no columns, or an error).
extern "C" int l32_gemv(const void* x, const void* w, void* out, int rows, int n, int k,
                        int dtype, int kernel, int* launched, void* stream) {
  *launched = -1;
  if (rows == 0 || n == 0) return 0;
  const int routed = route(x, w, k, dtype);
  if (kernel == -1) kernel = routed;
  if (routed < 0 || (kernel != routed && kernel != kSimt))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (kernel == kTc)
    err = launch_tc(x, w, out, rows, n, k, s);
  else if (dtype == L32_BF16)
    err = launch_simt<__nv_bfloat16>(x, w, out, rows, n, k, s);
  else
    err = launch_simt<float>(x, w, out, rows, n, k, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) *launched = kernel;
  return err;
}
