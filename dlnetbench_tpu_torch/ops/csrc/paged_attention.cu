// Paged-KV single-query decode attention for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   K1  jax.experimental.pallas.ops.tpu.paged_attention (called at
//       dlnetbench_tpu/serving/kv_cache.py:768) — bf16/f32 page pools;
//   K2  dlnetbench_tpu/ops/paged_attention_quant.py::_kernel (:48,
//       pallas_call :133) — int8 / e4m3 page pools with per-page,
//       per-head f32 scales.
// One templated kernel serves both (page element type + optional scale
// pointers); each has its own Python wrapper and launch counter
// (ops/paged_attention.py, ops/paged_attention_quant.py).
//
// What it computes (the TPU kernels' conventions): q [B, Hq, Dh] arrives
// PRE-SCALED by Dh^-0.5; pages are [Hkv, P, S, Dh]; q head h reads KV
// head h / (Hq/Hkv) (GQA, KV never broadcast); slot b attends its first
// lengths[b] cached tokens, located through block_tables[b, :]; softmax
// is accumulated in f32 (online, over tiles of pages); the output has
// q's dtype.  With scales, a page's scores are scaled by its K scale and
// its probabilities by its V scale — the same sums as dequantizing the
// page first.
//
// Bound on this card: the kernel must read each valid token's K and V
// row once, so bytes = sum_b len_b * Hkv * Dh * 2 * elt, plus the
// scales (2 * 4 B per touched page and head), q and out; the work is
// 4 * Hq * Dh flops per token, far below the card's ~295 flop/byte
// ridge.  It is bound by device memory (3.35 TB/s on an H100 SXM).
//
// What the design does about that bound:
//   * reads pages straight through the block table (no contiguous copy
//     of the sequence, which the JAX quant wrapper makes first), and
//     only the pages below ceil(len / S): the bytes read are the bytes
//     the bound counts;
//   * one block per (KV head, slot), one warp per query head of the
//     GQA group: the group's G queries share each K/V tile staged in
//     shared memory, so each byte is fetched once for G heads;
//   * tiles of whole pages (up to 128 tokens, 64 KiB of K+V over two
//     stages) are fetched with 16-byte cp.async, so the next tile's
//     loads are in flight while this tile is computed;
//   * scores put one token on each lane (a full Dh-long dot product
//     against the query held in shared memory), over a K tile stored
//     swizzled so the 32 lanes' row reads do not collide in a bank:
//     no warp reduction per token.  The weighted sum of V puts the
//     head dimension across the lanes;
//   * int8/e4m3 pages travel as 1 byte per element and are converted in
//     registers; nothing is widened in device memory.
// What it does not do yet: split a long sequence across blocks (a
// batch of 8 slots x 8 KV heads fills 64 of the 132 SMs), or use
// wgmma/TMA.  Those are later work; the times stand in PERF.md.
//
// Plain C interface (route (b) of the build: nvcc -> .so -> ctypes); the
// wrapper checks shapes, dtypes, contiguity and alignment before calling.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

// finite mask, as in the JAX package (kv_cache.MASK_VALUE)
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr int kMaxDimsPerLane = 8;          // head_dim <= 256
constexpr size_t kStageBudget = 64 * 1024;  // bytes of K+V over both stages
constexpr int kMaxTileTokens = 128;
constexpr size_t kMaxSmem = 227 * 1024;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// dot product of one 16-byte chunk of page elements with the matching
// f32 query values (q4 points at 16 / sizeof(PT) floats)
template <typename PT>
struct Chunk;

template <>
struct Chunk<float> {
  static __device__ __forceinline__ float dot(uint4 r, const float4* q4) {
    const float4 a = q4[0];
    return a.x * __uint_as_float(r.x) + a.y * __uint_as_float(r.y) +
           a.z * __uint_as_float(r.z) + a.w * __uint_as_float(r.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  // element 2k sits in the low half of word k (little endian)
  static __device__ __forceinline__ float lo(unsigned w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float hi(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ float dot(uint4 r, const float4* q4) {
    const float4 a = q4[0];
    const float4 b = q4[1];
    return a.x * lo(r.x) + a.y * hi(r.x) + a.z * lo(r.y) + a.w * hi(r.y) +
           b.x * lo(r.z) + b.y * hi(r.z) + b.z * lo(r.w) + b.w * hi(r.w);
  }
};

template <>
struct Chunk<int8_t> {
  static __device__ __forceinline__ float word(unsigned w, float4 a) {
    return a.x * static_cast<float>(static_cast<int8_t>(w & 0xffu)) +
           a.y * static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)) +
           a.z * static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)) +
           a.w * static_cast<float>(static_cast<int8_t>(w >> 24));
  }
  static __device__ __forceinline__ float dot(uint4 r, const float4* q4) {
    return word(r.x, q4[0]) + word(r.y, q4[1]) + word(r.z, q4[2]) +
           word(r.w, q4[3]);
  }
};

template <>
struct Chunk<__nv_fp8_e4m3> {
  // two e4m3 values per 16 bits, the first in the low byte
  static __device__ __forceinline__ float2 pair(unsigned short v) {
    return __half22float2(
        static_cast<__half2>(__nv_cvt_fp8x2_to_halfraw2(v, __NV_E4M3)));
  }
  static __device__ __forceinline__ float word(unsigned w, float4 a) {
    const float2 p = pair(static_cast<unsigned short>(w & 0xffffu));
    const float2 q = pair(static_cast<unsigned short>(w >> 16));
    return a.x * p.x + a.y * p.y + a.z * q.x + a.w * q.y;
  }
  static __device__ __forceinline__ float dot(uint4 r, const float4* q4) {
    return word(r.x, q4[0]) + word(r.y, q4[1]) + word(r.z, q4[2]) +
           word(r.w, q4[3]);
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

// grid (Hkv, B); block 32 * G threads, warp w = query head h*G + w.
// Shared memory: [2 stages][K tile, V tile] page elements, then
// [2 stages][K, V][ppt] page scales, [G][Dh] f32 queries and
// [G][tile tokens] f32 scores.  The K tile is stored SWIZZLED: 16-byte
// chunk c of tile row t sits at chunk (c + t) mod (chunks per row), so
// that lane t reading its own row's chunk c hits a different bank group
// than its neighbours while every lane reads the same query chunk.
template <typename QT, typename PT, bool kScaled>
__global__ void __launch_bounds__(1024) paged_attention_kernel(
    const QT* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    const int* __restrict__ block_tables, QT* __restrict__ out, int hq,
    int hkv, int num_pages, int page_size, int head_dim, int pmax,
    int ppt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qh = h * group + warp;
  const int dpl = head_dim >> 5;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(PT));
  const int row_chunks = head_dim / kChunk;
  const int page_elems = page_size * head_dim;
  const int tile_elems = ppt * page_elems;
  const int tile_tokens = ppt * page_size;

  PT* kv_s = reinterpret_cast<PT*>(smem);
  float* sc_s = reinterpret_cast<float*>(
      smem + 4 * static_cast<size_t>(tile_elems) * sizeof(PT));
  float* q_s = sc_s + 4 * ppt + warp * head_dim;
  float* p_s = sc_s + 4 * ppt + group * head_dim + warp * tile_tokens;

  // never read past the block table's row, nor a page past the length
  const int len = min(lengths[b], pmax * page_size);
  const int n_pages = len > 0 ? (len + page_size - 1) / page_size : 0;
  const int n_tiles = (n_pages + ppt - 1) / ppt;
  const int* bt = block_tables + static_cast<size_t>(b) * pmax;
  const size_t head_base = static_cast<size_t>(h) * num_pages;

  const QT* qrow = q + (static_cast<size_t>(b) * hq + qh) * head_dim;
  for (int d = lane; d < head_dim; d += 32) q_s[d] = to_f32(qrow[d]);
  float acc[kMaxDimsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) acc[i] = 0.f;
  float m = kMaskValue;
  float l = 0.f;

  // queue tile `tile`'s pages (and scales) into `stage`
  auto issue = [&](int tile, int stage) {
    PT* ks = kv_s + static_cast<size_t>(stage) * 2 * tile_elems;
    PT* vs = ks + tile_elems;
    const int first = tile * ppt;
    const int npg = min(ppt, n_pages - first);
    const int chunks = npg * page_size * row_chunks;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int t = c / row_chunks;              // tile row (token)
      const int col = c - t * row_chunks;
      const int j = t / page_size;               // page within the tile
      const int page = min(max(bt[first + j], 0), num_pages - 1);
      const size_t src = (head_base + page) * page_elems +
                         static_cast<size_t>(t - j * page_size) * head_dim +
                         static_cast<size_t>(col) * kChunk;
      int kcol = col + t % row_chunks;
      if (kcol >= row_chunks) kcol -= row_chunks;
      cp_async16(ks + (t * row_chunks + kcol) * kChunk, k_pages + src);
      cp_async16(vs + c * kChunk, v_pages + src);
    }
    if constexpr (kScaled) {
      for (int j = threadIdx.x; j < npg; j += blockDim.x) {
        const int page = min(max(bt[first + j], 0), num_pages - 1);
        sc_s[(2 * stage) * ppt + j] = k_scale[head_base + page];
        sc_s[(2 * stage + 1) * ppt + j] = v_scale[head_base + page];
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      issue(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const PT* ks = kv_s + static_cast<size_t>(stage) * 2 * tile_elems;
    const PT* vs = ks + tile_elems;
    const int ntok = min(tile_tokens, len - t * tile_tokens);

    // scores: lane j of this warp dots token j's K row with the query
    for (int base = 0; base < ntok; base += 32) {
      const int j = base + lane;
      if (j < ntok) {
        const uint4* krow =
            reinterpret_cast<const uint4*>(ks + j * head_dim);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        int pc = j % row_chunks;
        float s0 = 0.f, s1 = 0.f;
        int c = 0;
        for (; c + 1 < row_chunks; c += 2) {
          s0 += Chunk<PT>::dot(krow[pc], q4 + c * (kChunk / 4));
          pc = pc + 1 == row_chunks ? 0 : pc + 1;
          s1 += Chunk<PT>::dot(krow[pc], q4 + (c + 1) * (kChunk / 4));
          pc = pc + 1 == row_chunks ? 0 : pc + 1;
        }
        if (c < row_chunks)
          s0 += Chunk<PT>::dot(krow[pc], q4 + c * (kChunk / 4));
        float s = s0 + s1;
        if constexpr (kScaled) s *= sc_s[(2 * stage) * ppt + j / page_size];
        p_s[j] = s;
      }
    }
    __syncwarp();

    // online softmax: rescale the running sums to the new maximum
    float mt = kMaskValue;
    for (int j = lane; j < ntok; j += 32) mt = fmaxf(mt, p_s[j]);
    const float m_new = fmaxf(m, warp_max(mt));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int j = lane; j < ntok; j += 32) {
      const float p = expf(p_s[j] - m_new);
      psum += p;
      if constexpr (kScaled)
        p_s[j] = p * sc_s[(2 * stage + 1) * ppt + j / page_size];
      else
        p_s[j] = p;
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();

    // weighted sum of V rows: lane owns dims lane + 32 i
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < ntok; ++j) {
      const float p = p_s[j];
      const PT* vr = vs + j * head_dim;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i)
        if (i < dpl) acc[i] += p * to_f32(vr[lane + 32 * i]);
    }
    // every warp is done with this stage before it is refilled
    __syncthreads();
  }

  // a slot with no cached token (length <= 0) gets zeros
  QT* orow = out + (static_cast<size_t>(b) * hq + qh) * head_dim;
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i)
    if (i < dpl) store(l > 0.f ? acc[i] / l : 0.f, &orow[lane + 32 * i]);
}

template <typename QT, typename PT, bool kScaled>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* lengths,
           const void* block_tables, void* out, int batch, int hq, int hkv,
           int num_pages, int page_size, int head_dim, int pmax,
           cudaStream_t stream) {
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > 32 ||
      head_dim % 32 != 0 || head_dim > 32 * kMaxDimsPerLane ||
      page_size < 1 || pmax < 1 || num_pages < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  const size_t page_bytes =
      static_cast<size_t>(page_size) * head_dim * sizeof(PT);
  const int group = hq / hkv;
  int ppt = static_cast<int>(
      std::max<size_t>(1, kStageBudget / (4 * page_bytes)));
  ppt = std::min(ppt, std::max(1, kMaxTileTokens / page_size));
  ppt = std::min(ppt, pmax);
  const size_t smem = 4 * ppt * page_bytes + 4 * ppt * sizeof(float) +
                      static_cast<size_t>(group) * head_dim * sizeof(float) +
                      static_cast<size_t>(group) * ppt * page_size *
                          sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<QT, PT, kScaled>;
  // raise the dynamic shared memory cap once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(hkv, batch), dim3(32 * group), smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<const int*>(block_tables), static_cast<QT*>(out), hq, hkv,
      num_pages, page_size, head_dim, pmax, ppt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dlnb_paged_attention(
    int q_dtype, int page_dtype, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* lengths, const void* block_tables, void* out, int batch,
    int hq, int hkv, int num_pages, int page_size, int head_dim, int pmax,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLNB_LAUNCH(QT, PT, SCALED)                                       \
  return launch<QT, PT, SCALED>(q, k_pages, v_pages, k_scale, v_scale,    \
                                lengths, block_tables, out, batch, hq,    \
                                hkv, num_pages, page_size, head_dim, pmax, \
                                s)
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
