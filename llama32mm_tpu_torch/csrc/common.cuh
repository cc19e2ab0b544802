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
