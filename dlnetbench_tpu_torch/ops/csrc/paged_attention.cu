// Paged-KV single-query decode attention for Hopper (sm_90a), split over
// the sequence (flash-decoding).
//
// Replaces two TPU kernels of the JAX package:
//   K1  jax.experimental.pallas.ops.tpu.paged_attention (called at
//       dlnetbench_tpu/serving/kv_cache.py:768) — bf16/f32 page pools;
//   K2  dlnetbench_tpu/ops/paged_attention_quant.py::_kernel (:48,
//       pallas_call :133) — int8 / e4m3 page pools with per-page,
//       per-head f32 scales.
// One templated kernel serves both (page element type + optional scale
// pointers; K1 is its unscaled mode); each has its own Python wrapper and
// launch counter (ops/paged_attention.py, ops/paged_attention_quant.py).
//
// What it computes (the TPU kernels' conventions): q [B, Hq, Dh] arrives
// PRE-SCALED by Dh^-0.5; pages are [Hkv, P, S, Dh]; q head h reads KV
// head h / (Hq/Hkv) (GQA, KV never broadcast); slot b attends its first
// lengths[b] cached tokens, located through block_tables[b, :]; softmax
// is accumulated in f32 with the finite mask kMaskValue; the output has
// q's dtype.  With scales, a page's scores are scaled by its K scale and
// its probabilities by its V scale — the same sums as dequantizing the
// page first.  A slot of length <= 0 gets zeros.
//
// Bound on this card: the kernel must read each valid token's K and V
// row once, so bytes = sum_b len_b * Hkv * Dh * 2 * elt, plus the
// scales (2 * 4 B per touched page and head), q and out; the work is
// 4 * Hq * Dh flops per token, far below the card's ~295 flop/byte
// ridge.  It is bound by device memory (3.35 TB/s on an H100 SXM), and
// at the served shapes (B = 8 slots of <= 512 tokens, ~4 MB of pages)
// by how many loads are in flight at once.
//
// The design:
//   * the grid is (Hkv, B, n_split).  Each slot's block-table row is cut
//     into splits of whole pages, at least kSplitTokens (64) tokens each
//     (split_pages: sized on the host from pmax and the page size, never
//     from lengths, which stay on the card: no host sync; a caller may
//     pass its own pages a split, the tuner's pages_per_compute_block,
//     as a runtime argument).  A block
//     whose split starts at or past its slot's length exits at once, so
//     the live blocks are sum_b ceil(len_b / split) * Hkv — at the
//     served shape 8 x 8 x 8 = 512 blocks, 240 of them live, where one
//     block per (KV head, slot) filled 64 of the 132 SMs and the longest
//     slot set the time;
//   * a block of 32 G threads serves the GQA group's G q heads of its KV
//     head, one warp a head: each K/V byte is fetched once for the G
//     heads.  Its split is walked in tiles of <= kTileTokens tokens,
//     fetched by 16-byte cp.async into two stages (the next tile's loads
//     in flight while this one is computed).  Past a stage's barrier a
//     warp's work is its own (no block barrier, no shared reduction):
//     at these sizes the time is a chain of latencies, not bytes;
//   * scores: a token a lane, every 16-byte chunk of its K row converted
//     once and dotted with the head's query held in shared memory
//     (broadcast reads).  K rows are stored swizzled (chunk c of row t
//     at (c + t) mod chunks) so a warp's 16-byte reads spread over the
//     banks;
//   * p . V: each lane owns one 16-byte chunk of V columns of a row, a
//     warp covers 32 / chunks rows a step; the row groups' sums meet by
//     shuffles at the end;
//   * 8-bit pages convert in packed form: e4m3 two values at a time
//     (cvt.rn.f16x2.e4m3x2), int8 four bytes a word by byte-permuting
//     each into the mantissa of 2^23 (0x4B00_0000) and subtracting
//     2^23 + 128 — exact, and no I2F per byte;
//   * the combine: each split leaves (m, l, acc[G][Dh]) in an f32
//     workspace; the LAST-ARRIVING block of the (slot, KV head) — a
//     counter per (slot, KV head), bumped after a threadfence — combines
//     every split's partial in split order 0, 1, ... (so the result does
//     not depend on which block came last: deterministic), a warp a
//     head, and resets the counter to zero, so no memset runs per call.
//     Chosen over a second combine kernel: one launch a call (the
//     serving engine calls this per layer per step, where a launch
//     costs as much as the kernel), and a slot with one live split
//     writes its output directly.  The counters are the caller's (the
//     wrapper keeps one zeroed buffer per device and stream); the
//     workspace too: the kernel allocates nothing.
// Tensor cores: the work is ~30 MFLOP a call at the served shape; it
// runs on the CUDA cores, in f32.
//
// Plain C interface (route (b) of the build: nvcc -> .so -> ctypes); the
// wrapper checks shapes, dtypes, contiguity and alignment before calling
// and sizes the workspace with the same split (ops/paged_attention.py,
// split_pages and workspace_floats).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

// finite mask, as in the JAX package (kv_cache.MASK_VALUE)
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kSplitTokens = 64;       // a split: whole pages, >= 64 tokens
constexpr int kMaxSplits = 65535;      // gridDim.z
constexpr int kTileTokens = 64;        // tokens a stage holds (rows <= 512 B)
constexpr int kWideTileTokens = 32;    // ... for rows of more than 512 B
constexpr size_t kMaxSmem = 227 * 1024;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// one 16-byte chunk of page elements -> f32 (N = 16 / sizeof(PT))
template <typename PT>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2k sits in the low half of word k (little endian)
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[N]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int N = 16;
  // byte b (signed) -> b + 128 by flipping its sign bit, moved into the
  // low mantissa byte of 2^23 (0x4B0000xx = 2^23 + b + 128): subtract
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[N]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) -
            8388736.f;
    }
  }
};

template <>
struct Chunk<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  // two e4m3 values per 16 bits, the first in the low byte
  static __device__ __forceinline__ float2 pair(unsigned short v) {
    return __half22float2(
        static_cast<__half2>(__nv_cvt_fp8x2_to_halfraw2(v, __NV_E4M3)));
  }
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[N]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = pair(static_cast<unsigned short>(w[i] & 0xffffu));
      const float2 b = pair(static_cast<unsigned short>(w[i] >> 16));
      f[4 * i] = a.x;
      f[4 * i + 1] = a.y;
      f[4 * i + 2] = b.x;
      f[4 * i + 3] = b.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------- sizing
//
// Host and device agree on these; ops/paged_attention.py mirrors
// split_pages and workspace_floats to size the workspace.

// pages a split takes: the fewest whole pages holding kSplitTokens
// tokens, more if the row would need over kMaxSplits splits
inline int split_pages(int page_size, int pmax) {
  int pps = (kSplitTokens + page_size - 1) / page_size;
  pps = std::max(pps, (pmax + kMaxSplits - 1) / kMaxSplits);
  return std::min(pps, pmax);
}

// tokens a stage holds: 64, or 32 for rows of more than 512 bytes
inline int tile_tokens(int head_dim, int elt) {
  return head_dim * elt <= 512 ? kTileTokens : kWideTileTokens;
}

// the shared memory of one block, in the kernel's order (every part a
// multiple of 16 bytes but the last)
struct Smem {
  size_t kv, pages, q, p, total;
  __host__ __device__ Smem(int group, int head_dim, int elt, int tile,
                           int pps) {
    kv = static_cast<size_t>(4) * tile * head_dim * elt;  // [2][K, V]
    // the split's pages and their K and V scales
    pages = (static_cast<size_t>(3) * pps * 4 + 15) / 16 * 16;
    q = static_cast<size_t>(group) * head_dim * 4;        // [G][Dh] f32
    p = static_cast<size_t>(group) * tile * 4;            // [G][tile]
    total = kv + pages + q + p + 16;                      // + the flag
  }
};

// ------------------------------------------------------------- kernel
//
// grid (Hkv, B, n_split), 32 * G threads: warp g serves q head h G + g.
// The block of (KV head h, slot b, split z) attends tokens [z pps S,
// min(len, (z + 1) pps S)); each stage's K/V rows are shared by the G
// warps, and past the stage's barrier a warp's work is its own: no
// block barrier but the stage's (and the combine's flag).
template <typename QT, typename PT, bool kScaled, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) paged_attention_kernel(
    const QT* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    const int* __restrict__ block_tables, QT* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int hq, int hkv,
    int num_pages, int page_size, int head_dim, int pmax, int pps,
    int tile) {
  using CK = Chunk<PT>;
  constexpr int NE = CK::N;                      // elements a chunk
  constexpr int kCpl = NE == 4 ? 2 : 1;          // chunks a lane in p . V
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int nt = blockDim.x;
  const int tid = threadIdx.x, g = tid >> 5, lane = tid & 31;
  const int group = hq / hkv;
  const int rc = head_dim / NE;                  // chunks a row
  const int bh = b * hkv + h;
  const size_t head_base = static_cast<size_t>(h) * num_pages;
  const Smem L(group, head_dim, static_cast<int>(sizeof(PT)), tile, pps);
  PT* kv_s = reinterpret_cast<PT*>(smem);
  int* pg_s = reinterpret_cast<int*>(smem + L.kv);       // [pps]
  float* ksc_s = reinterpret_cast<float*>(pg_s + pps);   // [pps]
  float* vsc_s = ksc_s + pps;                            // [pps]
  float* q_s = reinterpret_cast<float*>(smem + L.kv + L.pages);
  float* p_s = q_s + group * head_dim + g * tile;        // this warp's p
  int* flag = reinterpret_cast<int*>(q_s + group * head_dim + group * tile);

  // the split's block-table entries, read beside the slot's length
  for (int j = tid; j < pps; j += nt) {
    const int e = min(split * pps + j, pmax - 1);
    pg_s[j] = min(max(block_tables[static_cast<size_t>(b) * pmax + e], 0),
                  num_pages - 1);
  }
  const int len = min(lengths[b], pmax * page_size);
  const int split_tok = pps * page_size;
  const int t0 = split * split_tok;
  QT* orow = out + (static_cast<size_t>(b) * hq + h * group) * head_dim;
  if (len <= 0) {
    // a slot with no cached token gets zeros
    if (split == 0)
      for (int i = tid; i < group * head_dim; i += nt) store(0.f, orow + i);
    return;
  }
  if (t0 >= len) return;
  const int n_live = (len + split_tok - 1) / split_tok;
  const int t1 = min(len, t0 + split_tok);
  const int n_tiles = (t1 - t0 + tile - 1) / tile;
  __syncthreads();

  // queue tile `it`'s K/V rows into `stage`; K rows swizzled: chunk c of
  // row t at (c + t) mod rc, so lanes reading their own rows' chunk c
  // spread over the banks
  auto issue = [&](int it, int stage) {
    PT* ks = kv_s + static_cast<size_t>(stage) * 2 * tile * head_dim;
    PT* vs = ks + static_cast<size_t>(tile) * head_dim;
    const int tt0 = t0 + it * tile;
    const int n = min(tile, t1 - tt0);
    for (int c = tid; c < n * rc; c += nt) {
      const int t = c / rc, col = c - t * rc;
      const int tok = tt0 + t;
      const int pg = tok / page_size;
      const size_t src =
          ((head_base + pg_s[pg - split * pps]) * page_size +
           (tok - pg * page_size)) * static_cast<size_t>(head_dim) +
          static_cast<size_t>(col) * NE;
      int kcol = col + t % rc;
      if (kcol >= rc) kcol -= rc;
      cp_async16(ks + (t * rc + kcol) * NE, k_pages + src);
      cp_async16(vs + c * NE, v_pages + src);
    }
    cp_async_commit();
  };

  // the first tile's loads go out before the scales and queries are read
  issue(0, 0);
  if constexpr (kScaled) {
    for (int j = tid; j < pps; j += nt) {
      ksc_s[j] = k_scale[head_base + pg_s[j]];
      vsc_s[j] = v_scale[head_base + pg_s[j]];
    }
  }
  const QT* qrow = q + (static_cast<size_t>(b) * hq + h * group) * head_dim;
  for (int i = tid; i < group * head_dim; i += nt) q_s[i] = to_f32(qrow[i]);

  // p . V: lane (row group rr, chunk cb) of `rows` groups of lr lanes
  const int lr = min(32, rc), rows = 32 / lr;
  const int rr = lane / lr, cb = lane % lr;
  const float* qg = q_s + g * head_dim;
  float m = kMaskValue, l = 0.f;
  float acc[kCpl * NE] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      issue(it + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const PT* ks = kv_s + static_cast<size_t>(stage) * 2 * tile * head_dim;
    const uint4* vs = reinterpret_cast<const uint4*>(
        ks + static_cast<size_t>(tile) * head_dim);
    // token t of the tile lies in page (p0 + t) / page_size of the split
    const int p0 = it * tile + t0 - split * pps * page_size;
    const int ntok = min(tile, t1 - (t0 + it * tile));

    // scores: a token a lane (two for 64-token tiles), every chunk of
    // its K row converted once and dotted with the head's query
    float sc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = lane + 32 * u;
      sc[u] = kMaskValue;
      if (t < ntok) {
        const uint4* krow = reinterpret_cast<const uint4*>(ks) + t * rc;
        float s0 = 0.f, s1 = 0.f;
        int pc = t % rc;
        for (int c = 0; c < rc; ++c) {
          float f[NE];
          CK::unpack(krow[pc], f);
          const float4* q4 = reinterpret_cast<const float4*>(qg + c * NE);
#pragma unroll
          for (int e = 0; e < NE / 4; ++e) {
            const float4 a = q4[e];
            const float d = a.x * f[4 * e] + a.y * f[4 * e + 1] +
                            a.z * f[4 * e + 2] + a.w * f[4 * e + 3];
            if (e & 1) s1 += d; else s0 += d;
          }
          pc = pc + 1 == rc ? 0 : pc + 1;
        }
        sc[u] = s0 + s1;
        if constexpr (kScaled) sc[u] *= ksc_s[(p0 + t) / page_size];
      }
    }
    // online softmax over the tile, in the warp
    const float m_new = fmaxf(m, warp_max(fmaxf(sc[0], sc[1])));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = lane + 32 * u;
      if (t < ntok) {
        const float pu = expf(sc[u] - m_new);
        psum += pu;
        p_s[t] = kScaled ? pu * vsc_s[(p0 + t) / page_size] : pu;
      }
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();

    // o = o * alpha + p . V: 16-byte V chunks, `rows` tokens a step
#pragma unroll
    for (int i = 0; i < kCpl * NE; ++i) acc[i] *= alpha;
    if (rr < rows) {
      for (int t = rr; t < ntok; t += rows) {
        const float pt = p_s[t];
#pragma unroll
        for (int i = 0; i < kCpl; ++i) {
          const int c = cb + i * lr;
          if (c < rc) {
            float f[NE];
            CK::unpack(vs[t * rc + c], f);
#pragma unroll
            for (int e = 0; e < NE; ++e) acc[i * NE + e] += pt * f[e];
          }
        }
      }
    }
    // the stage is refilled next tile, and p_s rewritten
    __syncthreads();
  }
  // sum the row groups' parts into the lanes of row group 0
  for (int i = 0; i < kCpl * NE; ++i) {
    const float mine = acc[i];
    for (int r = 1; r < rows; ++r)
      acc[i] += __shfl_sync(0xffffffffu, mine, cb + r * lr);
  }

  // lane cb (< lr) of warp g holds chunks cb + i lr of head g
  if (n_live == 1) {
    if (rr == 0) {
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int c = cb + i * lr;
        if (c < rc)
#pragma unroll
          for (int e = 0; e < NE; ++e)
            store(acc[i * NE + e] / l, orow + g * head_dim + c * NE + e);
      }
    }
    return;
  }

  // leave this split's partial in the workspace: acc [B Hkv][n_split][G]
  // [Dh], then (m, l) [B Hkv][n_split][G][2]
  const size_t n_acc = static_cast<size_t>(gridDim.y) * hkv * n_split *
                       group * head_dim;
  float* ws_acc = ws + static_cast<size_t>(bh) * n_split * group * head_dim;
  float* ws_ml = ws + n_acc + static_cast<size_t>(bh) * n_split * group * 2;
  if (rr == 0) {
    float* dst = ws_acc + (static_cast<size_t>(split) * group + g) *
                              head_dim;
#pragma unroll
    for (int i = 0; i < kCpl; ++i) {
      const int c = cb + i * lr;
      if (c < rc)
#pragma unroll
        for (int e = 0; e < NE; ++e) dst[c * NE + e] = acc[i * NE + e];
    }
  }
  if (lane == 0) {
    ws_ml[(split * group + g) * 2] = m;
    ws_ml[(split * group + g) * 2 + 1] = l;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block to arrive combines splits 0 .. n_live - 1 in order,
  // warp g head g, 8 splits at a time: lane z < 8 holds split z's (m,
  // l) and weight, and every lane float4s lane and lane + 32 of each
  // split's Dh values, the 8 splits' loads in flight together
  const int f4n = head_dim / 4;                  // 8 .. 64
  float4 o[2] = {};
  float mx = kMaskValue, lsum = 0.f;
  for (int z0 = 0; z0 < n_live; z0 += 8) {
    const int nz = min(8, n_live - z0);
    float4 v[8][2];
#pragma unroll
    for (int z = 0; z < 8; ++z)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (z < nz && lane + 32 * u < f4n)
          v[z][u] = __ldcg(reinterpret_cast<const float4*>(
                               ws_acc + (static_cast<size_t>(z0 + z) *
                                             group + g) * head_dim) +
                           lane + 32 * u);
    float mz = kMaskValue, lz = 0.f;
    if (lane < nz) {
      mz = __ldcg(ws_ml + ((z0 + lane) * group + g) * 2);
      lz = __ldcg(ws_ml + ((z0 + lane) * group + g) * 2 + 1);
    }
    const float m_new = fmaxf(mx, warp_max(mz));
    const float a = expf(mx - m_new);
    const float w = lane < nz ? expf(mz - m_new) : 0.f;
    lsum = lsum * a + warp_sum(lz * w);
    mx = m_new;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      o[u].x *= a;
      o[u].y *= a;
      o[u].z *= a;
      o[u].w *= a;
    }
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      const float wz = __shfl_sync(0xffffffffu, w, z);
      if (z < nz)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          o[u].x += wz * v[z][u].x;
          o[u].y += wz * v[z][u].y;
          o[u].z += wz * v[z][u].z;
          o[u].w += wz * v[z][u].w;
        }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (lane + 32 * u < f4n) {
      QT* dst = orow + g * head_dim + 4 * (lane + 32 * u);
      store(o[u].x / lsum, dst);
      store(o[u].y / lsum, dst + 1);
      store(o[u].z / lsum, dst + 2);
      store(o[u].w / lsum, dst + 3);
    }
  if (tid == 0) counters[bh] = 0;
}

template <typename QT, typename PT, bool kScaled>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* lengths,
           const void* block_tables, void* out, void* workspace,
           void* counters, int batch, int hq, int hkv, int num_pages,
           int page_size, int head_dim, int pmax, int split,
           cudaStream_t stream) {
  constexpr int elt = static_cast<int>(sizeof(PT));
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > 32 ||
      head_dim % 32 != 0 || head_dim > 256 || page_size < 1 || pmax < 1 ||
      num_pages < 1 || batch > 65535 || workspace == nullptr ||
      counters == nullptr || split < 0 || split > pmax)
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  const int pps = split > 0 ? split : split_pages(page_size, pmax);
  const int n_split = (pmax + pps - 1) / pps;
  if (n_split > kMaxSplits) return cudaErrorInvalidValue;
  const int tile = tile_tokens(head_dim, elt);
  const Smem L(group, head_dim, elt, tile, pps);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  // groups of up to 8 heads take the 256-thread instance, whose threads
  // may hold up to 255 registers (a 1024-thread bound caps them at 64)
  auto kern = group <= 8 ? paged_attention_kernel<QT, PT, kScaled, 256>
                         : paged_attention_kernel<QT, PT, kScaled, 1024>;
  // raise the dynamic shared memory cap once per instantiation
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(paged_attention_kernel<QT, PT, kScaled, 256>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem)),
      cudaFuncSetAttribute(paged_attention_kernel<QT, PT, kScaled, 1024>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem))};
  if (attr[0] != cudaSuccess) return attr[0];
  if (attr[1] != cudaSuccess) return attr[1];
  kern<<<dim3(hkv, batch, n_split), dim3(32 * group), L.total, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<const int*>(block_tables), static_cast<QT*>(out),
      static_cast<float*>(workspace), static_cast<int*>(counters), hq, hkv,
      num_pages, page_size, head_dim, pmax, pps, tile);
  return cudaGetLastError();
}

}  // namespace

// workspace: f32, workspace_floats(batch, hq, hkv, head_dim, page_size,
// pmax, split) of ops/paged_attention.py; counters: int32 [batch * hkv],
// zero on entry and left zero (the combining block resets its own).
// split: the pages a split takes (1..pmax; the tuner's
// pages_per_compute_block), or 0 for split_pages(page_size, pmax)
extern "C" int dlnb_paged_attention(
    int q_dtype, int page_dtype, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* lengths, const void* block_tables, void* out,
    void* workspace, void* counters, int batch, int hq, int hkv,
    int num_pages, int page_size, int head_dim, int pmax, void* stream,
    int split) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLNB_LAUNCH(QT, PT, SCALED)                                        \
  return launch<QT, PT, SCALED>(q, k_pages, v_pages, k_scale, v_scale,     \
                                lengths, block_tables, out, workspace,     \
                                counters, batch, hq, hkv, num_pages,       \
                                page_size, head_dim, pmax, split, s)
  const bool scaled = k_scale != nullptr && v_scale != nullptr;
  if (q_dtype == kF32 && page_dtype == kF32 && !scaled)
    DLNB_LAUNCH(float, float, false);
  if (q_dtype == kBF16 && page_dtype == kBF16 && !scaled)
    DLNB_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
  if (q_dtype == kF32 && page_dtype == kI8 && scaled)
    DLNB_LAUNCH(float, int8_t, true);
  if (q_dtype == kBF16 && page_dtype == kI8 && scaled)
    DLNB_LAUNCH(__nv_bfloat16, int8_t, true);
  if (q_dtype == kF32 && page_dtype == kE4M3 && scaled)
    DLNB_LAUNCH(float, __nv_fp8_e4m3, true);
  if (q_dtype == kBF16 && page_dtype == kE4M3 && scaled)
    DLNB_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3, true);
#undef DLNB_LAUNCH
  return cudaErrorInvalidValue;
}
