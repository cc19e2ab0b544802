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
// FLOPs per byte at which bf16 tensor cores become the limit. The design
// reads every weight byte exactly once: one warp per output row n walks K
// with coalesced 16-byte loads, applies each loaded weight vector to all r
// rows of x (x is small and stays in L1/L2), keeps r fp32 accumulators per
// lane, and reduces them with warp shuffles. Several warps per block keep
// enough loads in flight; an [N, K] layout makes each warp's reads one
// contiguous stream.
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
int launch(const void* x, const void* w, void* out, int rows, int n, int k,
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

}  // namespace

extern "C" int l32_gemv(const void* x, const void* w, void* out, int rows, int n,
                        int k, int dtype, void* stream) {
  if (rows == 0 || n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == L32_BF16)
    err = launch<__nv_bfloat16>(x, w, out, rows, n, k, s);
  else if (dtype == L32_F32)
    err = launch<float>(x, w, out, rows, n, k, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
