// Flash GQA attention forward on Hopper's tensor cores (wgmma), bf16.
//
// Replaces llama32mm_tpu/ops/pallas/attention.py::_flash_kernel for every
// bf16 call with more than a few query rows per kv head: the decoder's
// prefill, the ViT, the server's chunked admission, the int8-KV prefill and
// the training forward with its log-sum-exp. The function is
// flash_attention.cu's: q [B, nq, Tq, hd] bf16, k/v [B, nkv, Tk, hd], query
// head h reads kv head h / (nq / nkv); key `key` is allowed for query i of
// batch row b iff kv_valid[b, key] != 0 and, when causal,
// key <= q_offset + i (q_offset one int, or int32 [B] per row); allowed
// logits are s / sqrt(hd), blocked keys get probability exactly 0 and a row
// with no allowed key is 0. Optionally lse [B*nq, Tq] fp32, m + log(l) in
// logit space, or -0.7 * FLT_MAX for an empty row (the Pallas emit_lse).
// K/V are bf16, or int8 with fp32 per-position scales [B, nkv, Tk]: each
// int8 tile is converted to bf16 in shared memory (exact for |q| <= 127),
// k_scale[key] multiplies the fp32 scores after the product, v_scale[key]
// multiplies p before p is rounded for the PV product (blocked keys' p is
// already exactly 0), and the denominator sums p without v_scale.
//
// Bound on the H100: operations (the decoder prefill at Tq 1632, Tk 2048 is
// ~21.8 GFLOP per layer with the causal skip, 0.022 ms at 989 TFLOP/s). The
// design puts both products on the tensor cores:
//  - a block of two warpgroups owns 128 query rows of one (b, q head), 64 per
//    warpgroup, and both share each K/V tile; the grid runs the G query heads
//    of a kv head side by side (adjacent block indices) so their tiles come
//    from L2, and the causal prefill's longest rows first;
//  - K/V tiles of 64 keys go through a 3-stage shared-memory ring filled with
//    16-byte cp.async copies (validity and scales too), two tiles ahead of the
//    math; tiles wholly past the block's last causal limit are never loaded,
//    and a warpgroup skips tiles past its own rows' limit;
//  - S = Q K^T is wgmma m64n64k16 (hd / 16 steps), Q in registers (loaded
//    once with ldmatrix in the A fragment layout), K from shared memory,
//    K-major over hd, fp32 accumulators. S for tile t + 1 is issued before
//    the softmax of tile t, so the tensor cores work while the online
//    softmax runs in registers (exp2 of logits prescaled by
//    log2(e) / sqrt(hd)), each row spread over the 4 lanes of a quad;
//  - P is rounded to bf16 (as the Pallas kernel rounds p to the input type)
//    and fed straight from the accumulator registers as the A operand of
//    O += P V (wgmma m64n{hd}k16, 4 steps), V read from shared memory through
//    a transposed-B (MN-major) descriptor;
//  - the element mask is applied only to tiles that straddle a warpgroup's
//    first causal limit or hold a blocked key (a tile-level all-valid vote).
// Shared memory holds every tile in wgmma's no-swizzle canonical layout:
// 8x8 core matrices of 128 contiguous bytes (8 rows of 16 bytes), the core
// matrices of one 8-row group side by side, row groups hd_pad * 16 bytes
// apart. The same layout serves Q for ldmatrix, K as the K-major B operand
// of Q K^T (LBO 128, SBO hd_pad * 16) and V as the MN-major B operand of
// P V (LBO hd_pad * 16, SBO 128). hd is padded to a multiple of 16 with
// zeros (hd 8). An int8 tile is converted into one of two bf16 buffers.
#include <float.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarpgroups = 2;             // consumer warpgroups per block
constexpr int kBM = 64 * kWarpgroups;      // query rows per block, 64 per warpgroup
constexpr int kBN = 64;                    // keys per tile
constexpr int kStages = 3;                 // K/V ring depth (prefetch distance 2)
constexpr int kThreads = 128 * kWarpgroups;
constexpr float kNegBig = -0.7f * FLT_MAX;  // lse of a row with no allowed key
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// wgmma (sm_90a), A from registers and B from a shared-memory descriptor,
// K-major (kTransB 0) or MN-major (kTransB 1). scale_d 0 overwrites the
// accumulators, 1 adds to them.
// ---------------------------------------------------------------------------

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n80k16(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n96k16(float (&d)[48], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// O += P V for one k16 step: N = the padded head dim, V MN-major.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 16) wgmma_rs_m64n16k16<1>(d, a, desc_b, 1);
  else if constexpr (N == 32) wgmma_rs_m64n32k16<1>(d, a, desc_b, 1);
  else if constexpr (N == 64) wgmma_rs_m64n64k16<1>(d, a, desc_b, 1);
  else if constexpr (N == 80) wgmma_rs_m64n80k16<1>(d, a, desc_b, 1);
  else if constexpr (N == 96) wgmma_rs_m64n96k16<1>(d, a, desc_b, 1);
  else wgmma_rs_m64n128k16<1>(d, a, desc_b, 1);
}

// Four 8x8 bf16 matrices from shared memory (row addresses from lanes
// 8 i .. 8 i + 7 for matrix i), in the mma / wgmma A fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 2^x on the special-function unit; 0 for x = -inf.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous issue / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Generic-proxy shared-memory writes (cp.async, stores) made visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a no-swizzle canonical tile at p (byte strides lbo, sbo).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
struct TcGeom {
  static constexpr int kHdp = (HD + 15) / 16 * 16;  // head dim padded to the k16 step
  static constexpr int kGroup = kHdp * 16;           // bytes of one 8-row group
  static constexpr int kTile = kBN * kHdp * 2;       // one 64-row bf16 tile
  static constexpr int kRaw = kBN * HD;              // one 64-row int8 tile
  static constexpr int kRawChunk = HD % 16 == 0 ? 16 : 8;
  // Byte offset of (row, 8-column chunk) in a canonical tile.
  static __device__ __forceinline__ int at(int row, int chunk) {
    return (row >> 3) * kGroup + chunk * 128 + (row & 7) * 16;
  }
  // Shared memory: the block's Q rows; the ring of K and V tiles (bf16), or
  // two buffers of converted K and V tiles plus the ring of raw int8 tiles.
  static constexpr int kSmemBf16 = kWarpgroups * kTile + 2 * kStages * kTile;
  static constexpr int kSmemInt8 = kWarpgroups * kTile + 4 * kTile + 2 * kStages * kRaw;
};

template <typename KV, int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                const KV* __restrict__ v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ kv_valid,
                const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int nq, int nkv, int tq, int tk, int q_offset,
                int causal, int n_qtiles, float scale_log2) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  using G = TcGeom<HD>;
  constexpr int HDP = G::kHdp, NO = HDP / 2;  // output accumulators per thread
  constexpr int KS = HDP / 16;                // k16 steps over the head dim
  constexpr int kChunks = HD / 8;             // 16-byte bf16 chunks per row
  constexpr int kBuf = kInt8 ? 2 : kStages;   // bf16 K (and V) tiles in shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                          // kBM rows
  unsigned char* kst = qs + kWarpgroups * G::kTile;  // tile t in buffer t % kBuf
  unsigned char* vst = kst + kBuf * G::kTile;
  unsigned char* raw = vst + kBuf * G::kTile;        // int8: [kStages][K, V]
  __shared__ int valid_s[kStages][kBN];
  __shared__ float ksc[kStages][kBN], vsc[kStages][kBN];

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / 128, warp = (tid / 32) % 4;  // warpgroup, warp in it
  const int group = nq / nkv;
  int idx = blockIdx.x;  // (b, kv head, q tile from the last, q head in the group)
  const int g = idx % group;
  idx /= group;
  const int qt = n_qtiles - 1 - idx % n_qtiles;
  idx /= n_qtiles;
  const int kvh = idx % nkv, b = idx / nkv;
  const int q0 = qt * kBM, q_rows = min(kBM, tq - q0);
  if (q_offsets != nullptr) q_offset = q_offsets[b];
  int n_keys = tk;
  if (causal) n_keys = max(0, min(tk, q_offset + q0 + q_rows));  // the last row's limit + 1
  const int n_tiles = (n_keys + kBN - 1) / kBN;
  const size_t qrow0 = static_cast<size_t>(b * nq + kvh * group + g) * tq + q0;
  const size_t kvrow0 = static_cast<size_t>(b * nkv + kvh) * tk;
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;

  // This warpgroup's rows: wg_rows of them from block row 64 wg. It computes
  // tiles 0 .. wg_tiles - 1 (the causal limit only grows along its rows).
  const int wg_rows = max(0, min(64, q_rows - 64 * wg));
  const int first_limit = q_offset + q0 + 64 * wg;  // causal limit of its first row
  const int last_limit = first_limit + wg_rows - 1;
  const int wg_tiles = wg_rows == 0 ? 0 : causal ? min(n_tiles, last_limit / kBN + 1) : n_tiles;

  if constexpr (HD != HDP) {  // zero the head-dim padding of every bf16 tile once
    const int n = (kWarpgroups + 2 * kBuf) * G::kTile / 16;
    for (int i = tid; i < n; i += kThreads) reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }

  // Copy tile t (keys t*kBN ...) into ring stage t % kStages; keys past Tk
  // zero-filled and marked invalid.
  auto issue = [&](int t) {
    const int k0 = t * kBN, st = t % kStages;
    if constexpr (!kInt8) {
      for (int u = tid; u < kBN * kChunks; u += kThreads) {
        const int r = (u >> 3) / kChunks * 8 + (u & 7), c = (u >> 3) % kChunks;
        const bool in = k0 + r < tk;
        const size_t src = (kvrow0 + (in ? k0 + r : 0)) * HD + c * 8;
        const int dst = st * G::kTile + G::at(r, c);
        async_copy<16>(kst + dst, k + src, in);
        async_copy<16>(vst + dst, v + src, in);
      }
    } else {  // raw int8 rows are contiguous: copy the tile's bytes as they are
      const int valid_bytes = max(0, min(kBN, tk - k0)) * HD;
      const size_t base = (kvrow0 + k0) * HD;
      for (int u = tid; u < G::kRaw / G::kRawChunk; u += kThreads) {
        const int off = u * G::kRawChunk;
        const bool in = off < valid_bytes;
        unsigned char* dst = raw + st * 2 * G::kRaw + off;
        async_copy<G::kRawChunk>(dst, in ? k + base + off : k, in);
        async_copy<G::kRawChunk>(dst + G::kRaw, in ? v + base + off : v, in);
      }
    }
    if (tid < kBN) {  // the keys' validity (and scales), asynchronously too: 0 past Tk
      const int key = k0 + tid;
      const bool in = key < tk;
      const int at = in ? key : 0;
      async_copy<4>(&valid_s[st][tid], validb + at, in);
      if (kInt8) {
        async_copy<4>(&ksc[st][tid], k_scale + kvrow0 + at, in);
        async_copy<4>(&vsc[st][tid], v_scale + kvrow0 + at, in);
      }
    }
  };
  // int8: raw tile t -> bf16 (exact) in the canonical layout, buffer t % 2.
  auto convert = [&](int t) {
    const unsigned char* rk = raw + (t % kStages) * 2 * G::kRaw;
    for (int u = tid; u < kBN * kChunks; u += kThreads) {
      const int r = u / kChunks, c = u % kChunks;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const uint2 w = *reinterpret_cast<const uint2*>(rk + which * G::kRaw + r * HD + c * 8);
        const int8_t* e = reinterpret_cast<const int8_t*>(&w);
        uint4 packed;
        packed.x = pack_bf16(e[0], e[1]);
        packed.y = pack_bf16(e[2], e[3]);
        packed.z = pack_bf16(e[4], e[5]);
        packed.w = pack_bf16(e[6], e[7]);
        *reinterpret_cast<uint4*>((which ? vst : kst) + (t % 2) * G::kTile + G::at(r, c)) = packed;
      }
    }
  };

  // Prologue: Q and tiles 0 .. kStages - 2, one commit group per tile.
  if (n_tiles > 0) {
    for (int u = tid; u < kBM * kChunks; u += kThreads) {
      const int r = (u >> 3) / kChunks * 8 + (u & 7), c = (u >> 3) % kChunks;
      const bool in = r < q_rows;
      async_copy<16>(qs + G::at(r, c), q + (qrow0 + (in ? r : 0)) * HD + c * 8, in);
    }
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    async_commit();
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int r_lo = 16 * warp + (lane >> 2);  // this thread's rows in its warpgroup: r_lo, r_lo + 8
  const int cq = 2 * (lane & 3);             // its first column in each 8-column chunk
  uint32_t qa[KS][4];                        // its Q rows as wgmma A fragments
  // S[t] = Q K_t^T: 64 x 64 fp32, this thread's (row r_lo + 8 (i/2 % 2),
  // column 8 (i/4) + cq + i%2) in s[i]. Asynchronous: wgmma_wait_all() ends it.
  auto issue_s = [&](float (&s)[32], int t) {
    const unsigned char* kt = kst + (t % kBuf) * G::kTile;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_m64n64k16<0>(s, qa[kk], smem_desc(kt + kk * 256, 128, G::kGroup), kk > 0);
    wgmma_commit();
  };

  float s_cur[32], s_nxt[32];
  if (n_tiles > 0) {
    async_wait<kStages - 2>();  // Q and tile 0
    fence_proxy_async();
    __syncthreads();
    if constexpr (kInt8) {
      convert(0);
      fence_proxy_async();
      __syncthreads();
    }
    const unsigned char* qw = qs + wg * G::kTile;  // this warpgroup's 64 Q rows
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qa[kk], qw + G::at(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7),
                                     2 * kk + (lane >> 4)));
    if (wg_tiles > 0) {
      issue_s(s_cur, 0);
      wgmma_wait_all();
      fence_regs(s_cur);
    }
  }

  // Iteration t: S[t + 1] on the tensor cores while the softmax of S[t] runs,
  // then O += P[t] V_t.
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, k0 = t * kBN;
    async_wait<kStages - 3>();  // this thread's copies of tile t + 1 have landed
    fence_proxy_async();
    __syncthreads();  // ... everyone's; tile t - 1 is consumed, its stage free
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    async_commit();
    if constexpr (kInt8) {
      if (t + 1 < n_tiles) convert(t + 1);
      fence_proxy_async();
      __syncthreads();
    }
    // Warpgroup-uniform conditions: wgmma needs all 128 threads.
    if (t + 1 < wg_tiles) issue_s(s_nxt, t + 1);
    if (t < wg_tiles) {
      const bool all_valid =
          __all_sync(0xffffffffu, valid_s[st][lane] != 0 && valid_s[st][lane + 32] != 0);
      const bool masked = !all_valid || (causal && k0 + kBN - 1 > first_limit);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int limit = first_limit + r_lo + 8 * half;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e, col = 8 * j + cq + e;
            float x = (kInt8 ? s_cur[i] * ksc[st][col] : s_cur[i]) * scale_log2;
            if (masked && !(valid_s[st][col] != 0 && (!causal || k0 + col <= limit)))
              x = -INFINITY;
            s_cur[i] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[half], mx);
        // With nothing allowed yet, every weight stays 0 (and no -inf - -inf).
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = fast_exp2(m_r[half] - m_use);  // 0 when nothing was allowed before
        float rowsum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            s_cur[i] = fast_exp2(s_cur[i] - m_use);  // exactly 0 for a blocked key
            rowsum += s_cur[i];
          }
        }
        m_r[half] = m_new;
        l_r[half] = l_r[half] * alpha + rowsum;
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          o[4 * j + 2 * half] *= alpha;
          o[4 * j + 2 * half + 1] *= alpha;
        }
      }

      // P as the A operand of k-step kk (keys 16 kk ...): the accumulator
      // layout of S columns 16 kk .. 16 kk + 15 is the A fragment's.
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e, col = 8 * (i / 4) + cq + (i & 1);
          w[e] = kInt8 ? s_cur[i] * vsc[st][col] : s_cur[i];  // v_scale in the PV weight only
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(w[2 * r], w[2 * r + 1]);
      }
      const unsigned char* vt = vst + (t % kBuf) * G::kTile;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<HDP>(o, a[kk], smem_desc(vt + kk * 2 * G::kGroup, G::kGroup, 128));
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(s_nxt);
#pragma unroll
    for (int i = 0; i < 32; ++i) s_cur[i] = s_nxt[i];
  }
  async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_r[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_lo + 8 * half;
    if (r >= wg_rows) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row with no allowed key -> 0
    const size_t row = qrow0 + 64 * wg + r;
    __nv_bfloat16* orow = out + row * HD;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < HD)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
    if (kLse && (lane & 3) == 0) lse[row] = l > 0.f ? (m_r[half] + log2f(l)) * kLn2 : kNegBig;
  }
}

struct TcArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *kv_valid, *q_offsets;
  void* out;
  float* lse;
  int b, nq, nkv, tq, tk, q_offset, causal;
};

template <typename KV, int HD, bool kLse>
int launch(const TcArgs& a, cudaStream_t s) {
  using G = TcGeom<HD>;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int smem = kInt8 ? G::kSmemInt8 : G::kSmemBf16;
  const int align = kInt8 ? G::kRawChunk : 16;
  if ((reinterpret_cast<uintptr_t>(a.q) % 16) |
      ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) % align))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_qtiles = (a.tq + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(a.b) * a.nq * n_qtiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tc_kernel<KV, HD, kLse>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD)));
  kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scale, a.v_scale, a.kv_valid, a.q_offsets,
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.nq, a.nkv, a.tq, a.tk, a.q_offset, a.causal,
      n_qtiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, bool kLse>
int launch_hd(const TcArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<KV, 8, kLse>(a, s);
    case 16: return launch<KV, 16, kLse>(a, s);
    case 32: return launch<KV, 32, kLse>(a, s);
    case 64: return launch<KV, 64, kLse>(a, s);
    case 80: return launch<KV, 80, kLse>(a, s);
    case 96: return launch<KV, 96, kLse>(a, s);
    case 128: return launch<KV, 128, kLse>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 q [b, nq, tq, hd]; k_scale/v_scale null: bf16 K/V, else int8 K/V with
// [b, nkv, tk] fp32 scales; q_offsets null or int32 [b]; lse null or fp32
// [b * nq, tq] (bf16 K/V only).
extern "C" int l32_flash_attn_tc(const void* q, const void* k, const void* v, const void* k_scale,
                                 const void* v_scale, const void* kv_valid, const void* q_offsets,
                                 void* out, void* lse, int b, int nq, int nkv, int tq, int tk,
                                 int hd, int q_offset, int causal, void* stream) {
  if (b == 0 || tq == 0) return 0;
  const bool int8_kv = k_scale != nullptr;
  if (nkv <= 0 || nq % nkv != 0 || (int8_kv && lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                 static_cast<const int*>(kv_valid), static_cast<const int*>(q_offsets), out,
                 static_cast<float*>(lse), b, nq, nkv, tq, tk, q_offset, causal};
  auto s = static_cast<cudaStream_t>(stream);
  if (int8_kv) return launch_hd<int8_t, false>(a, hd, s);
  return lse != nullptr ? launch_hd<__nv_bfloat16, true>(a, hd, s)
                        : launch_hd<__nv_bfloat16, false>(a, hd, s);
}
