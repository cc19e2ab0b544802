// Split-KV flash decode: the flash GQA forward for calls with few query rows
// per kv head (Tq * G <= kMaxRows, G = nq / nkv): decode steps, the
// continuous-batching server's decode, tiny prefills.
//
// Replaces, at those shapes, llama32mm_tpu/ops/pallas/attention.py::
// _flash_kernel. The function is flash_attention.cu's: q [B, nq, Tq, hd],
// k/v [B, nkv, Tk, hd], query head h reads kv head h / G; key `key` is allowed
// for query i of batch row b iff kv_valid[b, key] != 0 and, when causal,
// key <= q_offset + i, q_offset being one int or (q_offsets non-null) int32
// [B]; allowed logits are s / sqrt(hd), blocked keys get probability exactly
// 0 and a row with no allowed key is 0. K/V are in q's dtype (fp32 or bf16),
// or int8 with fp32 per-position scales: the logit is (q . k_q) * k_scale
// before the mask, the softmax denominator sums p without v_scale and the PV
// sum takes p * v_scale[key], re-masked. Inference only: no log-sum-exp.
//
// Bound on the H100: bytes. Each cached K/V byte meets G * Tq query rows (4 at
// 11B), far below the ~295 operations per byte at which even the tensor cores
// become the limit, so this kernel uses none and is built to read the cache
// once:
//  - grid (split, b * nkv): one block serves all G * Tq query rows of one kv
//    head, so each K/V byte is read once, not G times; the key axis is cut
//    into splits of kSplit keys at fixed absolute positions, so a single
//    sequence still fills the card (8 kv heads x 27 splits at 1701 keys);
//  - a split's two 32-key tiles, with their validity, scales and the block's
//    query rows, are all in flight at once in a 2-stage cp.async buffer of
//    16-byte copies; keys past the block's last causal limit are never
//    loaded, and a block whose split starts past it writes an empty partial
//    (m = -inf, l = 0, acc = 0) and returns;
//  - 8 warps: warps 0-3 take the first tile and warps 4-7 the second, so both
//    are computed at once (measured, the SIMT arithmetic per key and not the
//    bytes is what the card waits on: a copy of this kernel without it runs
//    faster, see PERF.md); each warp owns every fourth query row of its tile,
//    lane j key j of the tile (K rows padded by 16 bytes, so the 32 lanes
//    reading their own rows hit distinct banks); the fp32 softmax reduces
//    max and sum across the warp, and for the PV sum each lane owns up to 4
//    consecutive head-dim values, read with one vector load per key; the
//    second tile's (m, l, acc) merges into the first's through shared memory;
//  - the split's partial (m, l, acc[hd]) goes to an fp32 workspace the
//    wrapper allocates, and flash_decode_combine_kernel merges each row's
//    partials in split order, one thread per head-dim value:
//    M = max m_s, L = sum l_s e^(m_s - M), O = sum acc_s e^(m_s - M) / L,
//    0 where L = 0.
// The fixed split boundaries make a row's bits independent of the batch it
// is decoded in, of the cache length past its keys and of the SM count: a
// server slot decoded beside seven others matches a solo decode exactly.
#include <float.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSplit = 64;    // keys per split (KV_SPLIT in ops/cuda/flash_decode.py)
constexpr int kTile = 32;     // keys per tile: one per lane
constexpr int kTiles = kSplit / kTile;  // a split's tiles: both in flight at once
constexpr int kRowWarps = 4;  // warps per tile
constexpr int kThreads = kTiles * kRowWarps * 32;
constexpr int kMaxRows = 32;  // G * Tq rows per block (DECODE_MAX_ROWS)

// Shared-memory geometry of one K or V tile of kTile rows.
template <typename KV, int HD>
struct KvTile {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(KV));
  static constexpr int kChunk = kRowBytes % 16 == 0 ? 16 : 8;  // bytes per cp.async
  static constexpr int kChunks = kRowBytes / kChunk;
  static constexpr int kElems = kChunk / static_cast<int>(sizeof(KV));  // values per chunk
  static constexpr int kPitch = kRowBytes + 16;  // padded row: conflict-free row-per-lane reads
  static constexpr int kBytes = kTile * kPitch;
};

// One chunk of N bytes of KV values in shared memory, as fp32.
template <typename KV, int N>
__device__ __forceinline__ void chunk_f32(const unsigned char* p,
                                          float (&f)[N / sizeof(KV)]) {
  using Raw = typename std::conditional<N == 16, uint4, uint2>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(N / sizeof(KV)); ++i) f[i] = to_f32(e[i]);
}

// VEC consecutive fp32 values from KV values at p (aligned to VEC values).
template <typename KV, int VEC>
__device__ __forceinline__ void vec_f32(const KV* p, float (&f)[VEC]) {
  constexpr int N = VEC * static_cast<int>(sizeof(KV));
  using Raw = typename std::conditional<
      N == 16, uint4,
      typename std::conditional<
          N == 8, uint2,
          typename std::conditional<
              N == 4, uint32_t,
              typename std::conditional<N == 2, uint16_t, uint8_t>::type>::type>::type>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
}

// One block: the query rows of one (b, kv head) over one split. Warps
// 0-3 take the split's first 32-key tile, warps 4-7 its second; warp w owns
// rows w % 4, w % 4 + 4, ... of its tile. Each warp's softmax covers its
// own tile; the two halves merge in tile order at the end.
// RW: query rows per warp, 1 (rows <= kRowWarps) or kMaxRows / kRowWarps.
template <typename T, typename KV, int HD, int RW>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ kv_valid, const int* __restrict__ q_offsets,
                    float* __restrict__ ws, int nq, int nkv, int tq, int tk, int n_split,
                    int q_offset, int causal, float scale) {
  constexpr bool kScaled = std::is_same<KV, int8_t>::value;
  // The PV sum: lane j < HD / VEC owns head-dim values VEC j .. VEC j + VEC - 1.
  constexpr int VEC = HD >= 80 ? 4 : (HD == 64 ? 2 : 1);
  using L = KvTile<KV, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;                          // [kTiles][kBytes]
  unsigned char* vs = ks + kTiles * L::kBytes;       // [kTiles][kBytes]
  float* qs = reinterpret_cast<float*>(vs + kTiles * L::kBytes);  // [rows][HD] fp32
  __shared__ int valid_s[kTiles][kTile];
  __shared__ float ksc[kTiles][kTile], vsc[kTiles][kTile];

  const int bkv = blockIdx.y;
  const int b = bkv / nkv, kvh = bkv % nkv;
  const int group = nq / nkv, rows = group * tq;
  const int n_rows = gridDim.y * rows;  // B * nq * Tq
  T* q_raw = reinterpret_cast<T*>(qs + rows * HD);  // [rows][HD] as given
  if (q_offsets != nullptr) q_offset = q_offsets[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = warp / kRowWarps, row0 = warp % kRowWarps;
  // The split's keys: [key_lo, key_hi) in kTile-key tiles; keys past the
  // last row's causal limit are never needed.
  const int split = blockIdx.x, key_lo = split * kSplit;
  const int key_hi = min(key_lo + kSplit, causal ? min(tk, q_offset + tq) : tk);
  const int n_tiles = key_hi > key_lo ? (key_hi - key_lo + kTile - 1) / kTile : 0;

  float* ws_m = ws;
  float* ws_l = ws + static_cast<size_t>(n_rows) * n_split;
  float* ws_acc = ws + 2 * static_cast<size_t>(n_rows) * n_split;
  // Partial slot of block row r: global row (b*nq + h)*Tq + i, this split.
  auto slot = [&](int r) {
    const int h = kvh * group + r / tq;
    return (static_cast<size_t>(b * nq + h) * tq + r % tq) * n_split + split;
  };
  if (n_tiles == 0) {  // the split starts past every row's causal limit: an empty partial
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      ws_m[slot(r)] = -INFINITY;
      ws_l[slot(r)] = 0.f;
    }
    for (int e = threadIdx.x; e < rows * HD; e += kThreads) ws_acc[slot(e / HD) * HD + e % HD] = 0.f;
    return;
  }

  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + static_cast<size_t>(bkv) * tk * HD);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + static_cast<size_t>(bkv) * tk * HD);
  const int* validb = kv_valid + static_cast<size_t>(b) * tk;
  const size_t scale_row = static_cast<size_t>(bkv) * tk;

  // The split's tiles, their validity and scales and the block's query rows
  // (contiguous in q: rows r = g * Tq + i) all go in flight at once, as
  // 16-byte copies; keys past key_hi are zero-filled.
  for (int u = threadIdx.x; u < kTiles * kTile * L::kChunks; u += kThreads) {
    const int r = u / L::kChunks, c = u % L::kChunks;  // r: key of the split
    const bool in = key_lo + r < key_hi;
    const size_t off = static_cast<size_t>(in ? key_lo + r : 0) * L::kRowBytes + c * L::kChunk;
    const int dst = (r / kTile) * L::kBytes + (r % kTile) * L::kPitch + c * L::kChunk;
    async_copy<L::kChunk>(ks + dst, kb + off, in);
    async_copy<L::kChunk>(vs + dst, vb + off, in);
  }
  if (threadIdx.x < kSplit) {
    const int key = key_lo + threadIdx.x;
    const bool in = key < key_hi;
    const int at = in ? key : 0;
    async_copy<4>(&valid_s[0][0] + threadIdx.x, validb + at, in);
    if (kScaled) {
      async_copy<4>(&ksc[0][0] + threadIdx.x, k_scale + scale_row + at, in);
      async_copy<4>(&vsc[0][0] + threadIdx.x, v_scale + scale_row + at, in);
    }
  }
  const unsigned char* qb = reinterpret_cast<const unsigned char*>(
      q + static_cast<size_t>(b * nq + kvh * group) * tq * HD);
  for (int u = threadIdx.x; u < rows * HD * static_cast<int>(sizeof(T)) / 16; u += kThreads)
    async_copy<16>(reinterpret_cast<unsigned char*>(q_raw) + 16 * u, qb + 16 * u, true);
  async_commit();
  async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) qs[e] = to_f32(q_raw[e]);
  __syncthreads();

  float m[RW], l[RW], acc[RW][VEC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }
  const bool pv_lane = lane < HD / VEC;
  auto row_of = [&](int i) { return row0 + kRowWarps * i; };

  if (tile < n_tiles) {  // warp-uniform
    const int k0 = key_lo + tile * kTile;
    // Lane j: the logits of key k0 + j for this warp's rows, as two sums
    // (even and odd chunks) that halve the chain of dependent FMAs.
    float s2[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) s2[i][0] = s2[i][1] = 0.f;
    const unsigned char* krow = ks + tile * L::kBytes + lane * L::kPitch;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      float kf[L::kElems];
      chunk_f32<KV, L::kChunk>(krow + c * L::kChunk, kf);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (row_of(i) < rows) {
          const float4* qr = reinterpret_cast<const float4*>(qs + row_of(i) * HD + c * L::kElems);
          float& si = s2[i][c & 1];
#pragma unroll
          for (int e = 0; e < L::kElems / 4; ++e) {
            const float4 q4 = qr[e];
            si = fmaf(q4.x, kf[4 * e], si);
            si = fmaf(q4.y, kf[4 * e + 1], si);
            si = fmaf(q4.z, kf[4 * e + 2], si);
            si = fmaf(q4.w, kf[4 * e + 3], si);
          }
        }
      }
    }

    const int key = k0 + lane;
    const bool key_ok = key < key_hi && valid_s[tile][lane] != 0;
    float p[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      p[i] = 0.f;
      const int r = row_of(i);
      if (r >= rows) continue;  // warp-uniform
      const bool allowed = key_ok && (!causal || key <= q_offset + r % tq);
      const float si = s2[i][0] + s2[i][1];
      const float sk = kScaled ? si * ksc[tile][lane] : si;
      const float logit = allowed ? sk * scale : -INFINITY;
      m[i] = warp_max(logit);
      if (m[i] == -INFINITY) continue;  // nothing allowed in this tile's row (warp-uniform)
      p[i] = allowed ? __expf(logit - m[i]) : 0.f;
      l[i] = warp_sum(p[i]);
      if (kScaled) p[i] = allowed ? p[i] * vsc[tile][lane] : 0.f;  // PV weight, not in l
    }

    // acc[i][e] = sum_j p_j[i] * v[j][VEC lane + e].
    const unsigned char* vt = vs + tile * L::kBytes;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vd[VEC];
      if (pv_lane) {
        vec_f32<KV, VEC>(reinterpret_cast<const KV*>(vt + j * L::kPitch) + VEC * lane, vd);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vd[e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (row_of(i) >= rows) continue;
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(pj, vd[e], acc[i][e]);
      }
    }
  }

  // Merge the second tile's state into the first's, in tile order, through
  // the consumed tiles' shared memory: [kRowWarps][RW] m and l, then acc.
  static_assert(kTiles == 2, "two warp sets, one per tile");
  static_assert(kRowWarps * RW * (HD + 2) * 4 <= 2 * kTiles * L::kBytes, "merge area");
  float* mw = reinterpret_cast<float*>(ks);
  float* lw = mw + kRowWarps * RW;
  float* aw = lw + kRowWarps * RW;
  __syncthreads();
  if (tile == 1) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (row_of(i) >= rows) continue;
      if (lane == 0) {
        mw[row0 * RW + i] = m[i];
        lw[row0 * RW + i] = l[i];
      }
      if (pv_lane) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) aw[(row0 * RW + i) * HD + VEC * lane + e] = acc[i][e];
      }
    }
  }
  __syncthreads();
  if (tile == 1) return;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = row_of(i);
    if (r >= rows) continue;
    const float m1 = mw[row0 * RW + i], big_m = fmaxf(m[i], m1);
    // Each half's weight; 0 for a half with no allowed key (m = -inf).
    const float w0 = big_m == -INFINITY ? 0.f : __expf(m[i] - big_m);
    const float w1 = big_m == -INFINITY ? 0.f : __expf(m1 - big_m);
    const size_t at = slot(r);
    if (lane == 0) {
      ws_m[at] = big_m;
      ws_l[at] = l[i] * w0 + lw[row0 * RW + i] * w1;
    }
    if (pv_lane) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ws_acc[at * HD + VEC * lane + e] =
            acc[i][e] * w0 + aw[(row0 * RW + i) * HD + VEC * lane + e] * w1;
    }
  }
}

// Merge each query row's n_split partials in split order: one thread per
// head-dim element, kThreads / HD32 rows per block; loads in batches of
// kBatch splits, all in flight at once.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int n_rows,
                            int n_split) {
  constexpr int HD32 = (HD + 31) / 32 * 32, kBatch = 32;
  const int row = blockIdx.x * (kThreads / HD32) + threadIdx.x / HD32, d = threadIdx.x % HD32;
  if (row >= n_rows || d >= HD) return;
  const float* ms = ws + static_cast<size_t>(row) * n_split;
  const float* ls = ws + static_cast<size_t>(n_rows + row) * n_split;
  const float* as = ws + 2 * static_cast<size_t>(n_rows) * n_split +
                    static_cast<size_t>(row) * n_split * HD + d;
  float mv[kBatch], lv[kBatch], av[kBatch];
  auto load = [&](int s0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = s0 + j < n_split;
      mv[j] = in ? ms[s0 + j] : -INFINITY;
      lv[j] = in ? ls[s0 + j] : 0.f;
      av[j] = in ? as[static_cast<size_t>(s0 + j) * HD] : 0.f;
    }
  };
  load(0);  // the first batch's m, l and acc together: one round trip up to Tk 2048
  float big_m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) big_m = fmaxf(big_m, mv[j]);
  for (int s0 = kBatch; s0 < n_split; s0 += kBatch) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) big_m = fmaxf(big_m, s0 + j < n_split ? ms[s0 + j] : -INFINITY);
  }
  float big_l = 0.f, o = 0.f;
  if (big_m != -INFINITY) {
    for (int s0 = 0; s0 < n_split; s0 += kBatch) {
      if (s0 > 0) load(s0);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // in split order; an empty split adds exact zeros
        const float w = expf(mv[j] - big_m);
        big_l += lv[j] * w;
        o += av[j] * w;
      }
    }
  }
  // a row with no allowed key -> 0
  out[static_cast<size_t>(row) * HD + d] = from_f32<T>(big_l > 0.f ? o * (1.f / big_l) : 0.f);
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *kv_valid, *q_offsets;
  float* ws;
  void* out;
  int b, nq, nkv, tq, tk, q_offset, causal;
};

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, typename KV, int HD>
int launch(const DecodeArgs& a, cudaStream_t s) {
  using L = KvTile<KV, HD>;
  const int rows = a.nq / a.nkv * a.tq;
  const int n_rows = a.b * a.nq * a.tq;
  const int n_split = (a.tk + kSplit - 1) / kSplit;
  if ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) % L::kChunk != 0 ||
      reinterpret_cast<uintptr_t>(a.q) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_split > 0) {
    const int smem =
        2 * kTiles * L::kBytes + rows * HD * static_cast<int>(sizeof(float) + sizeof(T));
    auto kernel = rows <= kRowWarps ? flash_decode_kernel<T, KV, HD, 1>
                                    : flash_decode_kernel<T, KV, HD, kMaxRows / kRowWarps>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<dim3(n_split, a.b * a.nkv), kThreads, smem, s>>>(
        static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
        a.k_scale, a.v_scale, a.kv_valid, a.q_offsets, a.ws, a.nq, a.nkv, a.tq, a.tk, n_split,
        a.q_offset, a.causal, static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int kRowsPerBlock = kThreads / ((HD + 31) / 32 * 32);
  flash_decode_combine_kernel<T, HD>
      <<<(n_rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
          a.ws, static_cast<T*>(a.out), n_rows, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int launch_hd(const DecodeArgs& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, KV, 8>(a, s);
    case 16: return launch<T, KV, 16>(a, s);
    case 32: return launch<T, KV, 32>(a, s);
    case 64: return launch<T, KV, 64>(a, s);
    case 80: return launch<T, KV, 80>(a, s);
    case 96: return launch<T, KV, 96>(a, s);
    case 128: return launch<T, KV, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ws: fp32 workspace of b * nq * tq * ceil(tk / kSplit) * (hd + 2) floats.
// k_scale/v_scale null: K/V in q's dtype; else int8 K/V with [b, nkv, tk]
// fp32 scales. q_offsets: null (every row at q_offset) or int32 [b].
extern "C" int l32_flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* kv_valid, const void* q_offsets,
                                void* ws, void* out, int b, int nq, int nkv, int tq, int tk,
                                int hd, int q_offset, int causal, int dtype, void* stream) {
  if (b == 0 || tq == 0) return 0;
  if (nkv <= 0 || nq % nkv != 0 || nq / nkv * tq > kMaxRows || b * nkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k, v, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(kv_valid),
                     static_cast<const int*>(q_offsets), static_cast<float*>(ws), out, b, nq,
                     nkv, tq, tk, q_offset, causal};
  auto s = static_cast<cudaStream_t>(stream);
  const bool int8_kv = k_scale != nullptr;
  if (dtype == L32_BF16)
    return int8_kv ? launch_hd<__nv_bfloat16, int8_t>(a, hd, s)
                   : launch_hd<__nv_bfloat16, __nv_bfloat16>(a, hd, s);
  if (dtype == L32_F32)
    return int8_kv ? launch_hd<float, int8_t>(a, hd, s) : launch_hd<float, float>(a, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
