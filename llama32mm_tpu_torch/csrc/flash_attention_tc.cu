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
#include "wgmma.cuh"

namespace {

constexpr int kWarpgroups = 2;             // consumer warpgroups per block
constexpr int kBM = 64 * kWarpgroups;      // query rows per block, 64 per warpgroup
constexpr int kBN = 64;                    // keys per tile
constexpr int kStages = 3;                 // K/V ring depth (prefetch distance 2)
constexpr int kThreads = 128 * kWarpgroups;
constexpr float kNegBig = -0.7f * FLT_MAX;  // lse of a row with no allowed key
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct TcGeom {
  static constexpr int kHdp = (HD + 15) / 16 * 16;  // head dim padded to the k16 step
  static constexpr int kGroup = kHdp * 16;           // bytes of one 8-row group
  static constexpr int kTile = kBN * kHdp * 2;       // one 64-row bf16 tile
  static constexpr int kRaw = kBN * HD;              // one 64-row int8 tile
  static constexpr int kRawChunk = HD % 16 == 0 ? 16 : 8;
  // Byte offset of (row, 8-column chunk) in a canonical tile.
  static __device__ __forceinline__ int at(int row, int chunk) {
    return canonical_at(row, chunk, kGroup);
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

  // Zero the head-dim padding of every bf16 tile (Q, K, V) once. Only the
  // padding chunks, never the data chunks: the cp.async copies below fill
  // those without a barrier in between, and a late zero store would erase a
  // copied chunk. No copy or conversion ever writes a padding chunk (they
  // write chunks < kChunks), so the padding stays zero as the ring turns.
  if constexpr (HD != HDP) {
    constexpr int kPad = HDP / 8 - kChunks, kTiles = kWarpgroups + 2 * kBuf;
    for (int u = tid; u < kTiles * 64 * kPad; u += kThreads) {
      const int tile = u / (64 * kPad), r = u % 64, c = kChunks + u / 64 % kPad;
      *reinterpret_cast<uint4*>(smem + tile * G::kTile + G::at(r, c)) = make_uint4(0, 0, 0, 0);
    }
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
