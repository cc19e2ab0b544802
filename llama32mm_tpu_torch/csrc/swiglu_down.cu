// SwiGLU + down projection for a few rows (decode):
//   out[r, h] = sum_i inter[r, i] * wd[h, i],
//   inter[r, i] = T(silu(sum_k x[r,k] wg[i,k]) * sum_k x[r,k] wu[i,k]),
// with x [R, H], w_gate and w_up [I, H] and w_down [H, I] (nn.Linear's
// layouts), fp32 accumulation, the intermediate rounded to x's type T before
// the down product, as the TPU kernel does.
//
// Replaces llama32mm_tpu/ops/pallas/swiglu.py::_down_kernel (via
// swiglu_down_pallas): the [R, I] intermediate never reaches device memory.
// The TPU kernel walks the I tiles in order and carries the [R, H] sum in a
// VMEM scratch across grid steps; blocks on the card run in no order, so each
// block here owns one tile of BI intermediate columns and writes its partial
// [R, H] product to an fp32 workspace [n_tiles, R, H], and a second kernel
// sums the tiles of each output in a fixed order (deterministic, no atomics;
// the RMSNorm weight gradient reduces the same way).
//
// Block (BI = 32 columns, 8 warps, up to kRows = 8 rows; more rows take more
// blocks along y): phase 1, one warp per column, reads wg[i, :] and wu[i, :]
// with 16-byte loads, applies them to the block's rows of x, reduces both
// fp32 sums with shuffles and leaves T(silu(g) * u) in shared memory (0 for
// the ragged tail i >= I); phase 2 reads the tile's BI columns of each wd
// row (a group of lanes per row, 16 bytes a lane, the tail read as 0: both
// sides of the ragged edge are zero, since 0 * NaN = NaN) and forms the
// partial products for all rows.
//
// Bound on the H100: the bytes of the three weights, 3 * H * I * 2 bytes in
// bf16 (352 MB at the 11B widths, about 105 us at 3.35 TB/s); every weight
// byte is read once whatever R is. The workspace adds 2 * n_tiles * R * H * 4
// bytes (7.3 MB at R = 1). No tensor cores: at R <= 8 each weight byte serves
// a few FMAs.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BI = 32;  // intermediate columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;  // rows of x per block

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

template <typename T, bool kVecH, bool kVecI>
__global__ void __launch_bounds__(kThreads)
swiglu_down_partial_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                           const T* __restrict__ wu, const T* __restrict__ wd,
                           float* __restrict__ part, int rows, int h, int inter) {
  __shared__ float inter_s[kRows][BI];
  constexpr int V = Vec16<T>::N;
  const int tile = blockIdx.x, i0 = tile * BI;
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xb = x + static_cast<size_t>(r0) * h;

  // Phase 1: the tile's intermediate columns, one warp per column.
  for (int j = warp; j < BI; j += kWarps) {
    const int i = i0 + j;
    float ag[kRows], au[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ag[r] = au[r] = 0.f;
    if (i < inter) {
      const T* gr = wg + static_cast<size_t>(i) * h;
      const T* ur = wu + static_cast<size_t>(i) * h;
      if (kVecH) {
        for (int c = lane * V; c < h; c += 32 * V) {
          const Vec16<T> gv = load16(gr + c), uv = load16(ur + c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
              const Vec16<T> xv = load16(xb + static_cast<size_t>(r) * h + c);
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float xf = to_f32(xv[e]);
                ag[r] = fmaf(xf, to_f32(gv[e]), ag[r]);
                au[r] = fmaf(xf, to_f32(uv[e]), au[r]);
              }
            }
          }
        }
      } else {
        for (int c = lane; c < h; c += 32) {
          const float g = to_f32(gr[c]), u = to_f32(ur[c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
              const float xf = to_f32(xb[static_cast<size_t>(r) * h + c]);
              ag[r] = fmaf(xf, g, ag[r]);
              au[r] = fmaf(xf, u, au[r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float g = warp_sum(ag[r]), u = warp_sum(au[r]);
      if (lane == 0)
        inter_s[r][j] = (i < inter && r < nr) ? to_f32(from_f32<T>(silu(g) * u)) : 0.f;
    }
  }
  __syncthreads();

  // Phase 2: part[tile, r0 + r, hh] = sum_j inter_s[r][j] * wd[hh, i0 + j]. A
  // group of LPH lanes reads one wd row's BI columns (V per lane); the loop
  // bound is warp-uniform so every lane takes part in the shuffles.
  constexpr int LPH = BI / V;
  constexpr int HPW = 32 / LPH;
  const int sub = lane % LPH, ic = sub * V;
  for (int base = warp * HPW; base < h; base += kWarps * HPW) {
    const int hh = base + lane / LPH;
    float wv[V];
    if (hh < h) {
      const T* wrow = wd + static_cast<size_t>(hh) * inter + i0 + ic;
      if (kVecI && i0 + ic < inter) {
        const Vec16<T> v = load16(wrow);
#pragma unroll
        for (int e = 0; e < V; ++e) wv[e] = to_f32(v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) wv[e] = i0 + ic + e < inter ? to_f32(wrow[e]) : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wv[e] = 0.f;
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) p[r] = fmaf(inter_s[r][ic + e], wv[e], p[r]);
#pragma unroll
      for (int o = LPH / 2; o > 0; o >>= 1) p[r] += __shfl_xor_sync(0xffffffffu, p[r], o);
    }
    if (sub == 0 && hh < h) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) part[(static_cast<size_t>(tile) * rows + r0 + r) * h + hh] = p[r];
    }
  }
}

// out[e] = sum over tiles of part[t, e], e = r * H + h, tiles in order.
template <typename T>
__global__ void swiglu_down_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                                          int n_tiles, int rh) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rh) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += part[static_cast<size_t>(t) * rh + e];
  out[e] = from_f32<T>(s);
}

template <typename T>
void launch(const void* x, const void* wg, const void* wu, const void* wd, float* part,
            void* out, int rows, int h, int inter, cudaStream_t s) {
  constexpr int V = Vec16<T>::N;
  const bool vec_h = h % V == 0 && aligned16(x) && aligned16(wg) && aligned16(wu);
  const bool vec_i = inter % V == 0 && aligned16(wd);
  const int n_tiles = (inter + BI - 1) / BI;
  const dim3 grid(n_tiles, (rows + kRows - 1) / kRows);
  auto kernel = vec_h ? (vec_i ? swiglu_down_partial_kernel<T, true, true>
                               : swiglu_down_partial_kernel<T, true, false>)
                      : (vec_i ? swiglu_down_partial_kernel<T, false, true>
                               : swiglu_down_partial_kernel<T, false, false>);
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(wg),
                                   static_cast<const T*>(wu), static_cast<const T*>(wd), part,
                                   rows, h, inter);
  const int rh = rows * h;
  swiglu_down_reduce_kernel<T><<<(rh + 255) / 256, 256, 0, s>>>(part, static_cast<T*>(out),
                                                                n_tiles, rh);
}

}  // namespace

// part: fp32 workspace of ceil(inter / 32) * rows * h floats (the wrapper's
// SWIGLU_DOWN_TILE is BI).
extern "C" int l32_swiglu_down(const void* x, const void* wg, const void* wu, const void* wd,
                               void* part, void* out, int rows, int h, int inter, int dtype,
                               void* stream) {
  if (rows == 0 || h == 0) return 0;
  if (inter <= 0 || rows > 65535 * kRows) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == L32_BF16)
    launch<__nv_bfloat16>(x, wg, wu, wd, p, out, rows, h, inter, s);
  else if (dtype == L32_F32)
    launch<float>(x, wg, wu, wd, p, out, rows, h, inter, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
