// Quantized decode gemvs for a few rows r <= 32, weights stored [N, K]
// (nn.Linear's orientation), fp32 accumulation, output in x's dtype.
//
// int8 (l32_gemv_int8): out[r, n] = (sum_k x[r, k] * q[n, k]) * scale[n],
// the per-channel scale applied once to the fp32 sum. Replaces two TPU
// kernels of llama32mm_tpu/ops/pallas/gemv.py: _qstacked_kernel
// (int8_gemv_stacked_pallas; a layer of the stack is a pointer here) and
// _qkernel (int8_gemv_pallas, the int8 head).
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
// as exact signed bytes, and __dp4a accumulates xq * (u - 8) in int32: the
// same integers as the TPU's algebra. One 16-byte chunk of a weight row lies
// inside one group (g/2 a multiple of 16), so its int32 dot is exact and
// takes one fp32 FMA with the group's scale; the row's ax multiplies the
// warp's sum once. The warp layout and row buckets are the W4A16 kernel's.
// Other group sizes (and misaligned rows) run a per-byte scalar loop with
// the same integer products.
//
// Bound on the H100: device-memory bytes of the weight, K bytes per output
// row in int8 (half of bf16) and K/2 in int4; each weight byte serves r <= 32
// rows, far below the ~295 FLOPs per byte where tensor cores would matter.
// Design (that of gemv.cu): one warp per output row n reads the row once with
// coalesced 16-byte loads (16 int8 weights, or 32 int4 weights) and applies
// each loaded vector to every row of x (x is small and stays in L1/L2), r
// fp32 accumulators per lane, warp-shuffle reduction. In int4 one 16-byte
// chunk lies inside one group (g/2 is a multiple of 16) and holds the low
// weights of 16 consecutive k and the high weights of the 16 k that follow
// g/2 later, so both x slices are contiguous; the chunk's fp32 partial is
// multiplied by its group scale once (legal: the scale is constant within
// a group). Other group sizes run a per-byte scalar loop. An int8 K that is
// not a multiple of 16 (or a misaligned row) runs a scalar head up to the
// row's 16-byte boundary, the vector body and a scalar tail. Bytes become
// floats by placing them in the mantissa of 2^23 (a byte permute and one
// fp32 subtraction), not by the int-to-float conversion, which issues at a
// quarter of the fp32 rate: with it the int8 head streamed 1630 GB/s, with
// the mantissa form 3054 GB/s (same call, NVIDIA H100 80GB HBM3, 700 W).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

// Four bytes of w as floats minus `bias`, without the quarter-rate
// integer-to-float conversion: byte b becomes the low mantissa bits of 2^23
// (bit pattern 0x4B0000bb = 2^23 + b), and one fp32 subtraction of
// 2^23 + offset leaves b - offset exactly.
__device__ __forceinline__ void bytes_to_f32(uint32_t w, float bias, float* f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + j)) - bias;
}

constexpr float kInt8Bias = 8388608.f + 128.f;  // signed byte, stored with its top bit flipped
constexpr float kInt4Bias = 8388608.f + 8.f;    // nibble u = q + 8

template <typename T, int MAXR>
__device__ __forceinline__ void store_rows(const float (&acc)[MAXR], float scale, T* out,
                                           int rows, int n, int col, int lane) {
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) out[static_cast<size_t>(r) * n + col] = from_f32<T>(s * scale);
    }
  }
}

// acc[r] += sum_j x[r, c + j] * w[j] over 16 consecutive k, x by 16-byte loads.
template <typename T, int MAXR>
__device__ __forceinline__ void dot16_vec(float (&acc)[MAXR], const T* x, int rows, int k, int c,
                                          const float (&w)[16]) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {
      const T* xr = x + static_cast<size_t>(r) * k + c;
#pragma unroll
      for (int h = 0; h < 16; h += V) {
        const Vec16<T> xv = load16(xr + h);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r] = fmaf(to_f32(xv[j]), w[h + j], acc[r]);
      }
    }
  }
}

template <typename T, int MAXR, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, T* __restrict__ out, int rows, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const int8_t* wr = q + static_cast<size_t>(col) * k;

  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  auto scalar = [&](int c) {
    const float wf = static_cast<float>(wr[c]);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows) acc[r] = fmaf(to_f32(x[static_cast<size_t>(r) * k + c]), wf, acc[r]);
  };
  auto unpack = [](const uint4& raw, float (&wf)[16]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) bytes_to_f32(w[i] ^ 0x80808080u, kInt8Bias, wf + 4 * i);
  };

  if (kVec) {  // k % 16 == 0, rows of q and x 16-byte aligned
    for (int c = lane * 16; c < k; c += 32 * 16) {
      float wf[16];
      unpack(*reinterpret_cast<const uint4*>(wr + c), wf);
      dot16_vec<T, MAXR>(acc, x, rows, k, c, wf);
    }
  } else {
    const int head = min(k, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(wr) & 15)) & 15));
    const int body_end = head + (k - head) / 16 * 16;
    for (int c = lane; c < head; c += 32) scalar(c);
    for (int c = head + lane * 16; c < body_end; c += 32 * 16) {
      float wf[16];
      unpack(*reinterpret_cast<const uint4*>(wr + c), wf);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const T* xr = x + static_cast<size_t>(r) * k + c;
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[r] = fmaf(to_f32(xr[j]), wf[j], acc[r]);
        }
      }
    }
    for (int c = body_end + lane; c < k; c += 32) scalar(c);
  }
  store_rows<T, MAXR>(acc, scale[col], out, rows, n, col, lane);
}

template <typename T, int MAXR, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_int4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q4,
                 const float* __restrict__ scale, T* __restrict__ out, int rows, int n, int k,
                 int g) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const int k2 = k / 2, g2 = g / 2, ng = k / g;
  const uint8_t* wr = q4 + static_cast<size_t>(col) * k2;
  const float* sr = scale + static_cast<size_t>(col) * ng;

  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  if (kVec) {  // g/2 % 16 == 0: a 16-byte chunk never straddles two groups
    for (int c = lane * 16; c < k2; c += 32 * 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wr + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float lo[16], hi[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bytes_to_f32(w[i] & 0x0F0F0F0Fu, kInt4Bias, lo + 4 * i);
        bytes_to_f32((w[i] >> 4) & 0x0F0F0F0Fu, kInt4Bias, hi + 4 * i);
      }
      const int grp = c / g2;
      const int xa = grp * g + (c - grp * g2);  // k of the low weights; high ones at xa + g/2
      float part[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) part[r] = 0.f;
      dot16_vec<T, MAXR>(part, x, rows, k, xa, lo);
      dot16_vec<T, MAXR>(part, x, rows, k, xa + g2, hi);
      const float s = sr[grp];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) acc[r] = fmaf(part[r], s, acc[r]);
    }
  } else {
    for (int c = lane; c < k2; c += 32) {
      const int bv = wr[c];
      const int grp = c / g2;
      const int xa = grp * g + (c - grp * g2);
      const float lo = static_cast<float>((bv & 0xF) - 8), hi = static_cast<float>((bv >> 4) - 8);
      const float s = sr[grp];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const T* xr = x + static_cast<size_t>(r) * k;
          acc[r] = fmaf(s, fmaf(to_f32(xr[xa]), lo, to_f32(xr[xa + g2]) * hi), acc[r]);
        }
      }
    }
  }
  store_rows<T, MAXR>(acc, 1.f, out, rows, n, col, lane);
}

constexpr int kQuantThreads = 256;

// One block per row of x: ax[r] and xq[r, :] (the W4A8 activations).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ ax,
                     int k) {
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
  int8_t* qr = xq + static_cast<size_t>(blockIdx.x) * k;
  for (int c = threadIdx.x; c < k; c += kQuantThreads)
    qr[c] = static_cast<int8_t>(fminf(fmaxf(rintf(to_f32(xr[c]) / a), -127.f), 127.f));
}

// u - 8 for the four low (or, shifted, high) nibbles of w, as signed bytes.
__device__ __forceinline__ int nibbles_s8(uint32_t w) {
  return static_cast<int>(__vsub4(w & 0x0F0F0F0Fu, 0x08080808u));
}

template <typename T, int MAXR, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gemv_w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ ax,
                 const uint8_t* __restrict__ q4, const float* __restrict__ scale,
                 T* __restrict__ out, int rows, int n, int k, int g) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const int k2 = k / 2, g2 = g / 2, ng = k / g;
  const uint8_t* wr = q4 + static_cast<size_t>(col) * k2;
  const float* sr = scale + static_cast<size_t>(col) * ng;

  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  if (kVec) {  // g/2 % 16 == 0 and 16-byte aligned rows: a chunk is in one group
    for (int c = lane * 16; c < k2; c += 32 * 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wr + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      int lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = nibbles_s8(w[i]);
        hi[i] = nibbles_s8(w[i] >> 4);
      }
      const int grp = c / g2;
      const int xa = grp * g + (c - grp * g2);  // k of the low weights; high ones at xa + g/2
      const float s = sr[grp];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const int8_t* xr = xq + static_cast<size_t>(r) * k;
          const uint4 xl = *reinterpret_cast<const uint4*>(xr + xa);
          const uint4 xh = *reinterpret_cast<const uint4*>(xr + xa + g2);
          int d = __dp4a(lo[0], static_cast<int>(xl.x), 0);
          d = __dp4a(lo[1], static_cast<int>(xl.y), d);
          d = __dp4a(lo[2], static_cast<int>(xl.z), d);
          d = __dp4a(lo[3], static_cast<int>(xl.w), d);
          d = __dp4a(hi[0], static_cast<int>(xh.x), d);
          d = __dp4a(hi[1], static_cast<int>(xh.y), d);
          d = __dp4a(hi[2], static_cast<int>(xh.z), d);
          d = __dp4a(hi[3], static_cast<int>(xh.w), d);
          acc[r] = fmaf(static_cast<float>(d), s, acc[r]);
        }
      }
    }
  } else {
    for (int c = lane; c < k2; c += 32) {
      const int bv = wr[c];
      const int grp = c / g2;
      const int xa = grp * g + (c - grp * g2);
      const int lo = (bv & 0xF) - 8, hi = (bv >> 4) - 8;
      const float s = sr[grp];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const int8_t* xr = xq + static_cast<size_t>(r) * k;
          acc[r] = fmaf(static_cast<float>(lo * xr[xa] + hi * xr[xa + g2]), s, acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {
      const float sum = warp_sum(acc[r]);
      if (lane == 0) out[static_cast<size_t>(r) * n + col] = from_f32<T>(sum * ax[r]);
    }
  }
}

template <typename T>
int launch_w4a8(const void* x, const void* q4, const float* scale, int8_t* xq, float* ax,
                void* out, int rows, int n, int k, int g, cudaStream_t s) {
  quantize_rows_kernel<T><<<rows, kQuantThreads, 0, s>>>(static_cast<const T*>(x), xq, ax, k);
  const bool vec = aligned16(q4) && aligned16(xq) && (g / 2) % 16 == 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  T* o = static_cast<T*>(out);
#define L32_ROWS(R)                                                                     \
  if (rows <= R) {                                                                      \
    auto kernel = vec ? gemv_w4a8_kernel<T, R, true> : gemv_w4a8_kernel<T, R, false>;   \
    kernel<<<blocks, kWarps * 32, 0, s>>>(xq, ax, w, scale, o, rows, n, k, g);          \
    return 0;                                                                           \
  }
  L32_ROWS(1)
  L32_ROWS(2)
  L32_ROWS(4)
  L32_ROWS(8)
  L32_ROWS(16)
  L32_ROWS(32)
#undef L32_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch per row bucket: the rows of x live in MAXR registers per lane.
template <typename T, int MAXR>
void launch_r(bool int4, bool vec, const void* x, const void* w, const float* scale, void* out,
              int rows, int n, int k, int g, cudaStream_t s) {
  const int blocks = (n + kWarps - 1) / kWarps;
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (int4) {
    auto kernel = vec ? gemv_int4_kernel<T, MAXR, true> : gemv_int4_kernel<T, MAXR, false>;
    kernel<<<blocks, kWarps * 32, 0, s>>>(xt, static_cast<const uint8_t*>(w), scale, o, rows, n,
                                          k, g);
  } else {
    auto kernel = vec ? gemv_int8_kernel<T, MAXR, true> : gemv_int8_kernel<T, MAXR, false>;
    kernel<<<blocks, kWarps * 32, 0, s>>>(xt, static_cast<const int8_t*>(w), scale, o, rows, n,
                                          k);
  }
}

template <typename T>
int launch(bool int4, const void* x, const void* w, const float* scale, void* out, int rows,
           int n, int k, int g, cudaStream_t s) {
  const bool aligned = aligned16(x) && aligned16(w);
  const bool vec = int4 ? aligned && (g / 2) % 16 == 0 : aligned && k % 16 == 0;
#define L32_ROWS(R)                                                   \
  if (rows <= R) {                                                    \
    launch_r<T, R>(int4, vec, x, w, scale, out, rows, n, k, g, s);    \
    return 0;                                                         \
  }
  L32_ROWS(1)
  L32_ROWS(2)
  L32_ROWS(4)
  L32_ROWS(8)
  L32_ROWS(16)
  L32_ROWS(32)
#undef L32_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(bool int4, const void* x, const void* w, const void* scale, void* out, int rows,
             int n, int k, int g, int dtype, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (int4 && (g <= 0 || g % 2 || k % g)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int err;
  if (dtype == L32_BF16)
    err = launch<__nv_bfloat16>(int4, x, w, sc, out, rows, n, k, g, s);
  else if (dtype == L32_F32)
    err = launch<float>(int4, x, w, sc, out, rows, n, k, g, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l32_gemv_int8(const void* x, const void* q, const void* scale, void* out,
                             int rows, int n, int k, int dtype, void* stream) {
  return dispatch(false, x, q, scale, out, rows, n, k, 0, dtype, stream);
}

extern "C" int l32_gemv_int4(const void* x, const void* q4, const void* scale, void* out,
                             int rows, int n, int k, int g, int dtype, void* stream) {
  return dispatch(true, x, q4, scale, out, rows, n, k, g, dtype, stream);
}

// xq [rows, k] int8 and ax [rows] fp32: workspace the caller allocates.
extern "C" int l32_gemv_int4_w4a8(const void* x, const void* q4, const void* scale, void* xq,
                                  void* ax, void* out, int rows, int n, int k, int g, int dtype,
                                  void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (g <= 0 || g % 2 || k % g) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int8_t* q = static_cast<int8_t*>(xq);
  float* a = static_cast<float*>(ax);
  int err;
  if (dtype == L32_BF16)
    err = launch_w4a8<__nv_bfloat16>(x, q4, sc, q, a, out, rows, n, k, g, s);
  else if (dtype == L32_F32)
    err = launch_w4a8<float>(x, q4, sc, q, a, out, rows, n, k, g, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
