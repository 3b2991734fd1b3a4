// Flash and splash attention (forward, dq, dk/dv) for Hopper (sm_90a).
//
// Replaces six TPU kernels of the JAX package
// (dlnetbench_tpu/ops/flash_attention.py):
//   K3  _fwd_kernel (:126, pallas_call :207) — causal/full attention
//       forward, base-2 online softmax, f32 accumulator; emits O and the
//       natural-log logsumexp;
//   K4  _dq_kernel (:242, pallas_call :468) — dq from p = exp(s - lse)
//       recomputed and D = rowsum(dO * O);
//   K5  _dkv_kernel (:279, pallas_call :500) — dk, dv;
//   K6  _splash_fwd_kernel (:648, pallas_call :746), K7
//       _splash_dq_kernel (:761, :904), K8 _splash_dkv_kernel (:802,
//       :955) — the same three under a BlockMask (ops/attention_mask.py):
//       the loops of K3/K4/K5 (one template each, mode kSplash) driven
//       by the mask's visit ranges.
//
// Layout (the JAX package's public one, no transpose): q [B, S, Hq, Dh],
// k/v [B, S, Hkv, Dh], row stride H * Dh elements; lse and D are plain
// [B, Hq, S] f32 (the TPU's 128-lane head padding and 8-sublane row
// replication are TPU layout and are gone).  q head h reads KV head
// h / (Hq / Hkv): GQA by index, KV never broadcast.  Dh is 64 or 128,
// S a multiple of 128.
//
// Numerics (the TPU kernels' rounding points): the forward rounds
// q * scale * log2(e) to the input type and runs the online softmax in
// base 2 with f32 m / l / accumulator and the finite -1e30 mask, then
// converts lse back to natural log; the backward rounds q * scale to the
// input type for s, p = exp(s - lse), ds = p * (dp - D) * scale, and
// rounds p and ds to the input type before their products.  D is
// computed by the dq kernel (rowsum of dO * O in f32, written to the D
// buffer that the dk/dv kernel then reads).
//
// Bound on this card: at the training shape (B=2, S=6144, Hq=32, Hkv=8,
// Dh=128, causal) each kernel does 0.6e12-1.2e12 tensor-core FLOP on
// ~0.3 GB of operands: it is bound by operations (989 TFLOP/s bf16), not
// by bytes.  What the design does about that:
//   * every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate), operands fed by ldmatrix from shared memory rows
//     padded by 16 bytes so the 8 row addresses of an 8x8 matrix fall in
//     distinct banks;
//   * tiles wholly above the causal diagonal are neither loaded nor
//     computed; the forward and dq grids launch the longest (last) q
//     tiles first, and dk/dv the longest (first) KV tiles first;
//   * the streamed operand (K/V for forward and dq; Q, dO, lse, D for
//     dk/dv) is double-buffered with 16-byte cp.async, so the next tile
//     is in flight while this one is computed;
//   * the dk/dv kernel runs one block per (batch, KV head, 128-key tile)
//     and loops over the GQA group's q heads itself, accumulating dk/dv
//     in f32 registers and writing [B, S, Hkv, Dh] once: the TPU path's
//     per-q-head dk/dv and the wrapper's group sum (:517-518) are gone,
//     with no atomics (the result is deterministic).
// Not yet: wgmma, TMA, warp specialisation, a persistent grid.  The
// times stand in PERF.md.
//
// Splash (mode kSplash).  The wrapper hands each kernel the BlockMask
// built at THAT kernel's tiles (forward and dq: 64 q rows x 64 keys;
// dk/dv: 64 q rows x 128 keys), packed as one int32 array on the card
// (MaskView below).  Per q tile (K6, K7) or per 128-key tile (K8) the
// kernel walks only the tiles of its visit range [first, last]: a
// skipped tile is neither loaded by cp.async nor multiplied, so the work
// is what the mask leaves (a window of W keys costs ~W/S of the dense
// grid).  A tile is FULL when blk_lo_max[i] <= j*bk and blk_hi_min[i] >=
// (j+1)*bk - 1 and then skips the mask; a PARTIAL tile masks each
// element against its row's [lo[q], hi[q]] (forward and dq: the lane's
// two row bounds read once per q tile into registers; dk/dv: the q
// tile's bounds staged in shared memory beside lse and D).  Numerics are
// K3-K5's (same rounding points, the finite -1e30 mask; a row whose
// first visited tile holds none of its keys gets p = 1 there and the
// next tile's alpha = 0 wipes it), so under the plain-causal mask K6/K7/
// K8 visit, mask and add exactly what K3/K4/K5 do: bitwise equal.  No
// causality is assumed: a non-causal segment mask has hi[q] > q.
//
// float32 operands take simple CUDA-core kernels (one thread per query
// or key row, same formulas): that path serves the small f32 reference
// models that hold the card against the CPU, not the bf16 training path.
//
// Plain C interface (nvcc -> .so -> ctypes): the wrapper
// (ops/flash_attention.py) checks device, dtype, shapes, contiguity and
// alignment before calling; each entry returns the cudaError_t of its
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // finite mask: no NaN from -inf - -inf
constexpr float kLog2e = 1.4426950408889634f;

enum Dtype { kF32 = 0, kBF16 = 1 };

// which keys a query sees: all, the causal triangle, or a BlockMask
enum Mode { kDense = 0, kCausal = 1, kSplash = 2 };

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------ tile primitives
//
// A warp owns 16 rows of an M x N product.  Its accumulator is N/8 m16n8
// tiles; in tile t, element e of lane L sits at row L/4 + 8*(e/2) and
// column 8t + 2*(L%4) + e%2.  Shared tiles are row-major with a pitch of
// DH + 8 elements.

template <int DH>
struct Tile {
  static constexpr int P = DH + 8;   // padded pitch (elements)
};

// R x DH tile, global row stride ld (elements) -> shared, 16 B per copy
template <int R, int DH, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int ld, int tid) {
  constexpr int kChunks = DH / 8;
  constexpr int P = Tile<DH>::P;
#pragma unroll 4
  for (int c = tid; c < R * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    cp_async16(dst + r * P + col, src + static_cast<size_t>(r) * ld + col);
  }
}

// n 4-byte values (a multiple of 4) -> shared
template <int N, int NT, typename T>
__device__ __forceinline__ void load_row(T* dst, const T* src, int tid) {
  static_assert(sizeof(T) == 4, "4-byte rows");
  for (int c = tid; c < N / 4; c += NT) cp_async16(dst + 4 * c, src + 4 * c);
}

// in place: x = round(x * mul) over an R x DH shared tile
template <int R, int DH, int NT>
__device__ __forceinline__ void scale_tile(bf16* dst, const bf16* src,
                                           float mul, int tid) {
  constexpr int P = Tile<DH>::P;
  for (int c = tid; c < R * DH / 2; c += NT) {
    const int r = c / (DH / 2), col = (c % (DH / 2)) * 2;
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + r * P + col));
    *reinterpret_cast<__nv_bfloat162*>(dst + r * P + col) =
        __floats2bfloat162_rn(x.x * mul, x.y * mul);
  }
}

// acc[N/8] (16 x N) += A (16 rows of a, at row0, K = DH) * B^T where B is
// N rows of b (row-major [N][DH]); a and b in shared memory
template <int N, int DH>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const bf16* a, const bf16* b,
                                        int lane) {
  constexpr int P = Tile<DH>::P;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t af[4];
    ldsm4(af, a + (lane % 16) * P + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t bfr[4];
      ldsm4(bfr, b + (nb * 16 + (lane / 16) * 8 + lane % 8) * P + ks * 16 +
                     ((lane / 8) & 1) * 8);
      mma(acc[2 * nb], af, bfr[0], bfr[1]);
      mma(acc[2 * nb + 1], af, bfr[2], bfr[3]);
    }
  }
}

// out[DH/8] (16 x DH) += X (16 x K, in registers as an accumulator of
// K/8 tiles, rounded to bf16 here) * B where B is K rows of b
// (row-major [K][DH] in shared memory)
template <int K, int DH>
__device__ __forceinline__ void mma_xb(float (&out)[DH / 8][4],
                                       const float (&x)[K / 8][4],
                                       const bf16* b, int lane) {
  constexpr int P = Tile<DH>::P;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    af[0] = pack(x[2 * kk][0], x[2 * kk][1]);
    af[1] = pack(x[2 * kk][2], x[2 * kk][3]);
    af[2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    af[3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t bfr[4];
      ldsm4_t(bfr, b + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * P +
                       dp * 16 + (lane / 16) * 8);
      mma(out[2 * dp], af, bfr[0], bfr[1]);
      mma(out[2 * dp + 1], af, bfr[2], bfr[3]);
    }
  }
}

// mask s[row][col] = -1e30 where col > row (global positions of the
// warp's first row and of column 0)
template <int N>
__device__ __forceinline__ void causal_mask(float (&s)[N / 8][4], int row0,
                                            int col0, int lane) {
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + lane / 4 + 8 * (e / 2);
      const int col = col0 + 8 * t + 2 * (lane % 4) + (e % 2);
      if (col > row) s[t][e] = kNegInf;
    }
}

// mask s[row][col] = -1e30 where col lies outside the lane's row
// interval [lo[r], hi[r]] (r: the row half; col0 the global position of
// column 0)
template <int N>
__device__ __forceinline__ void interval_mask(float (&s)[N / 8][4],
                                              const int (&lo)[2],
                                              const int (&hi)[2], int col0,
                                              int lane) {
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + 8 * t + 2 * (lane % 4) + (e % 2);
      if (col < lo[e / 2] || col > hi[e / 2]) s[t][e] = kNegInf;
    }
}

// write a warp's 16 x DH accumulator, times mul[row half], as bf16 rows
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, int ld,
                                           const float (&acc)[DH / 8][4],
                                           const float (&mul)[2], int lane) {
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lane / 4 + 8 * r, col = 8 * t + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(
          dst + static_cast<size_t>(row) * ld + col) =
          __floats2bfloat162_rn(acc[t][2 * r] * mul[r],
                                acc[t][2 * r + 1] * mul[r]);
    }
}

// ------------------------------------------------------------ K3 forward

constexpr int kFwdWarps = 4, kBQ = 64, kBK = 64;
constexpr int kDkvWarps = 8, kBKd = kDkvWarps * 16;   // 128 keys a block

// A BlockMask's int32 arrays as the wrapper packs them (ops/
// flash_attention.py, SplashArrays): [first n | last n | blk_lo_max nq |
// blk_hi_min nq | lo S | hi S], with nq = S / kBQ q tiles and n the
// visit-range count (nq for the forward and dq, S / kBKd for dk/dv);
// each of the four short arrays padded to a multiple of 4 entries, so
// lo and hi (read by 16-byte cp.async in dk/dv) start 16-byte aligned
struct MaskView {
  const int* first;
  const int* last;
  const int* lo_max;
  const int* hi_min;
  const int* lo;
  const int* hi;
};

__device__ __forceinline__ MaskView mask_view(const int* m, int n, int S) {
  const int n4 = (n + 3) & ~3, nq4 = (S / kBQ + 3) & ~3;
  return {m, m + n4, m + 2 * n4, m + 2 * n4 + nq4, m + 2 * n4 + 2 * nq4,
          m + 2 * n4 + 2 * nq4 + S};
}

// is kv tile [c0, c0 + width) FULL for q tile qt (no element masked)?
__device__ __forceinline__ bool full_tile(const MaskView& mv, int qt,
                                          int c0, int width) {
  return mv.lo_max[qt] <= c0 && mv.hi_min[qt] >= c0 + width - 1;
}

template <int DH>
__host__ __device__ constexpr size_t fwd_smem() {
  return static_cast<size_t>(kBQ + 4 * kBK) * Tile<DH>::P * sizeof(bf16);
}

template <int DH, int MODE>
__global__ void __launch_bounds__(kFwdWarps * 32)
    fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, const int* __restrict__ mask, int S,
             int Hq, int Hkv, float q_mul) {
  constexpr int NT = kFwdWarps * 32, P = Tile<DH>::P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * P;          // 2 stages
  bf16* sV = sK + 2 * kBK * P;      // 2 stages
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = S / kBQ;
  const int qt = nq - 1 - blockIdx.y;            // longest rows first
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int ldq = Hq * DH, ldk = Hkv * DH;
  const int q0 = qt * kBQ;
  const bf16* qg = q + (static_cast<size_t>(b) * S + q0) * ldq + h * DH;
  const bf16* kg = k + static_cast<size_t>(b) * S * ldk + hk * DH;
  const bf16* vg = v + static_cast<size_t>(b) * S * ldk + hk * DH;
  // visit range [j0, j1) of kv tiles; splash: the lane's row bounds
  int j0 = 0, j1 = MODE == kCausal ? (q0 + kBQ - 1) / kBK + 1 : S / kBK;
  MaskView mv{};
  int rlo[2] = {0, 0}, rhi[2] = {0, 0};
  if (MODE == kSplash) {
    mv = mask_view(mask, S / kBQ, S);
    j0 = mv.first[qt];
    j1 = mv.last[qt] + 1;
    const int r = q0 + warp * 16 + lane / 4;
    rlo[0] = mv.lo[r], rhi[0] = mv.hi[r];
    rlo[1] = mv.lo[r + 8], rhi[1] = mv.hi[r + 8];
  }

  load_tile<kBQ, DH, NT>(sQ, qg, ldq, tid);
  load_tile<kBK, DH, NT>(sK, kg + static_cast<size_t>(j0) * kBK * ldk, ldk,
                         tid);
  load_tile<kBK, DH, NT>(sV, vg + static_cast<size_t>(j0) * kBK * ldk, ldk,
                         tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  scale_tile<kBQ, DH, NT>(sQ, sQ, q_mul, tid);   // q * scale * log2(e)
  __syncthreads();

  float acc[DH / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bf16* sQw = sQ + warp * 16 * P;
  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < j1) {
      const size_t off = static_cast<size_t>(j + 1) * kBK * ldk;
      load_tile<kBK, DH, NT>(sK + (st ^ 1) * kBK * P, kg + off, ldk, tid);
      load_tile<kBK, DH, NT>(sV + (st ^ 1) * kBK * P, vg + off, ldk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kBK / 8][4] = {};
    mma_abt<kBK, DH>(s, sQw, sK + st * kBK * P, lane);
    if (MODE == kCausal && j * kBK + kBK - 1 > q0)
      causal_mask<kBK>(s, q0 + warp * 16, j * kBK, lane);
    if (MODE == kSplash && !full_tile(mv, qt, j * kBK, kBK))
      interval_mask<kBK>(s, rlo, rhi, j * kBK, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kBK / 8; ++t)
        mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kBK / 8; ++t) {
        s[t][2 * r] = exp2f(s[t][2 * r] - m_new);
        s[t][2 * r + 1] = exp2f(s[t][2 * r + 1] - m_new);
        sum += s[t][2 * r] + s[t][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;     // this lane's columns; summed below
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DH / 8; ++t) {
        acc[t][2 * r] *= alpha;
        acc[t][2 * r + 1] *= alpha;
      }
    }
    mma_xb<kBK, DH>(acc, s, sV + st * kBK * P, lane);   // += p (bf16) V
    __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + warp * 16;
  store_rows<DH>(o + (static_cast<size_t>(b) * S + row0) * ldq + h * DH,
                 ldq, acc, inv, lane);
  if (lane % 4 == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * S + row0;
    lrow[lane / 4] = (m[0] + log2f(l[0])) / kLog2e;
    lrow[lane / 4 + 8] = (m[1] + log2f(l[1])) / kLog2e;
  }
}

// ----------------------------------------------------------------- K4 dq

constexpr int kDqWarps = 4;

template <int DH>
__host__ __device__ constexpr size_t dq_smem() {
  return static_cast<size_t>(2 * kBQ + 4 * kBK) * Tile<DH>::P *
             sizeof(bf16) +
         2 * kBQ * sizeof(float);
}

template <int DH, int MODE>
__global__ void __launch_bounds__(kDqWarps * 32)
    dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            float* __restrict__ dcap, bf16* __restrict__ dq,
            const int* __restrict__ mask, int S, int Hq, int Hkv,
            float scale) {
  constexpr int NT = kDqWarps * 32, P = Tile<DH>::P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBQ * P;          // dO
  bf16* sK = sO + kBQ * P;          // 2 stages
  bf16* sV = sK + 2 * kBK * P;      // 2 stages
  float* sL = reinterpret_cast<float*>(sV + 2 * kBK * P);
  float* sD = sL + kBQ;
  static_assert(2 * kBQ == NT, "D takes two threads per row");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = S / kBQ;
  const int qt = nq - 1 - blockIdx.y;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int ldq = Hq * DH, ldk = Hkv * DH;
  const int q0 = qt * kBQ;
  const size_t qoff = (static_cast<size_t>(b) * S + q0) * ldq + h * DH;
  const size_t roff = (static_cast<size_t>(b) * Hq + h) * S + q0;
  const bf16* kg = k + static_cast<size_t>(b) * S * ldk + hk * DH;
  const bf16* vg = v + static_cast<size_t>(b) * S * ldk + hk * DH;
  // visit range [j0, j1) of kv tiles; splash: the lane's row bounds
  int j0 = 0, j1 = MODE == kCausal ? (q0 + kBQ - 1) / kBK + 1 : S / kBK;
  MaskView mv{};
  int rlo[2] = {0, 0}, rhi[2] = {0, 0};
  if (MODE == kSplash) {
    mv = mask_view(mask, S / kBQ, S);
    j0 = mv.first[qt];
    j1 = mv.last[qt] + 1;
    const int r = q0 + warp * 16 + lane / 4;
    rlo[0] = mv.lo[r], rhi[0] = mv.hi[r];
    rlo[1] = mv.lo[r + 8], rhi[1] = mv.hi[r + 8];
  }

  load_tile<kBQ, DH, NT>(sQ, q + qoff, ldq, tid);
  load_tile<kBQ, DH, NT>(sO, dout + qoff, ldq, tid);
  load_row<kBQ, NT>(sL, lse + roff, tid);
  load_tile<kBK, DH, NT>(sK, kg + static_cast<size_t>(j0) * kBK * ldk, ldk,
                         tid);
  load_tile<kBK, DH, NT>(sV, vg + static_cast<size_t>(j0) * kBK * ldk, ldk,
                         tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // D = rowsum(dO * O) in f32: two threads per row
  {
    const int r = tid / 2, half = tid % 2;
    const bf16* orow = o + qoff + static_cast<size_t>(r) * ldq +
                       half * (DH / 2);
    const bf16* drow = sO + r * P + half * (DH / 2);
    float d = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH / 2; c += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + c));
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(drow + c));
      d += a.x * g.x + a.y * g.y;
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sD[r] = d;
      dcap[roff + r] = d;
    }
  }
  scale_tile<kBQ, DH, NT>(sQ, sQ, scale, tid);   // q * scale, rounded
  __syncthreads();

  // this lane's two rows: lse and D
  const int rl = warp * 16 + lane / 4;
  const float lrow[2] = {sL[rl], sL[rl + 8]};
  const float drow[2] = {sD[rl], sD[rl + 8]};
  float acc[DH / 8][4] = {};
  const bf16* sQw = sQ + warp * 16 * P;
  const bf16* sOw = sO + warp * 16 * P;
  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < j1) {
      const size_t off = static_cast<size_t>(j + 1) * kBK * ldk;
      load_tile<kBK, DH, NT>(sK + (st ^ 1) * kBK * P, kg + off, ldk, tid);
      load_tile<kBK, DH, NT>(sV + (st ^ 1) * kBK * P, vg + off, ldk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sK + st * kBK * P;
    float s[kBK / 8][4] = {};
    mma_abt<kBK, DH>(s, sQw, kt, lane);
    if (MODE == kCausal && j * kBK + kBK - 1 > q0)
      causal_mask<kBK>(s, q0 + warp * 16, j * kBK, lane);
    if (MODE == kSplash && !full_tile(mv, qt, j * kBK, kBK))
      interval_mask<kBK>(s, rlo, rhi, j * kBK, lane);
    float dp[kBK / 8][4] = {};
    mma_abt<kBK, DH>(dp, sOw, sV + st * kBK * P, lane);   // dO V^T
#pragma unroll
    for (int t = 0; t < kBK / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[t][e] - lrow[e / 2]);
        s[t][e] = p * (dp[t][e] - drow[e / 2]) * scale;    // ds
      }
    mma_xb<kBK, DH>(acc, s, kt, lane);                     // += ds K
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<DH>(dq + qoff + static_cast<size_t>(warp) * 16 * ldq, ldq, acc,
                 one, lane);
}

// ------------------------------------------------------------- K5 dk/dv

// a stage: q and dO tiles, lse and D rows, and (splash) the q tile's
// row bounds lo and hi
template <int DH, int MODE>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return static_cast<size_t>(2 * kBQ) * Tile<DH>::P * sizeof(bf16) +
         (MODE == kSplash ? 4 : 2) * kBQ * sizeof(float);
}

template <int DH, int MODE>
__host__ __device__ constexpr size_t dkv_smem() {
  return static_cast<size_t>(2 * kBKd + kBQ) * Tile<DH>::P * sizeof(bf16) +
         2 * dkv_stage_bytes<DH, MODE>();
}

template <int DH, int MODE>
__global__ void __launch_bounds__(kDkvWarps * 32, 1)
    dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dcap,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             const int* __restrict__ mask, int S, int Hq, int Hkv,
             float scale) {
  constexpr int NT = kDkvWarps * 32, P = Tile<DH>::P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBKd * P;
  bf16* sQs = sV + kBKd * P;                          // q * scale
  unsigned char* stages = reinterpret_cast<unsigned char*>(sQs + kBQ * P);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.y * kBKd;                   // longest first
  const int ldq = Hq * DH, ldk = Hkv * DH;
  const size_t koff = (static_cast<size_t>(b) * S + k0) * ldk + hk * DH;
  const int nq = S / kBQ;
  // visit range [first, last] of q tiles
  int first = MODE == kCausal ? k0 / kBQ : 0, last = nq - 1;
  MaskView mv{};
  if (MODE == kSplash) {
    mv = mask_view(mask, S / kBKd, S);
    first = mv.first[blockIdx.y];
    last = mv.last[blockIdx.y];
  }
  const int per_head = last + 1 - first;
  const int iters = G * per_head;

  auto stage_q = [&](int st) {
    return reinterpret_cast<bf16*>(stages +
                                   st * dkv_stage_bytes<DH, MODE>());
  };
  auto issue = [&](int it, int st) {
    const int h = hk * G + it / per_head, q0 = (first + it % per_head) * kBQ;
    const size_t qoff = (static_cast<size_t>(b) * S + q0) * ldq + h * DH;
    const size_t roff = (static_cast<size_t>(b) * Hq + h) * S + q0;
    bf16* sq = stage_q(st);
    bf16* so = sq + kBQ * P;
    float* sl = reinterpret_cast<float*>(so + kBQ * P);
    load_tile<kBQ, DH, NT>(sq, q + qoff, ldq, tid);
    load_tile<kBQ, DH, NT>(so, dout + qoff, ldq, tid);
    load_row<kBQ, NT>(sl, lse + roff, tid);
    load_row<kBQ, NT>(sl + kBQ, dcap + roff, tid);
    if (MODE == kSplash) {
      int* sb = reinterpret_cast<int*>(sl + 2 * kBQ);
      load_row<kBQ, NT>(sb, mv.lo + q0, tid);
      load_row<kBQ, NT>(sb + kBQ, mv.hi + q0, tid);
    }
    cp_async_commit();
  };

  load_tile<kBKd, DH, NT>(sK, k + koff, ldk, tid);
  load_tile<kBKd, DH, NT>(sV, v + koff, ldk, tid);
  cp_async_commit();
  issue(0, 0);

  float dka[DH / 8][4] = {}, dva[DH / 8][4] = {};
  const bf16* sKw = sK + warp * 16 * P;
  const bf16* sVw = sV + warp * 16 * P;
  const int key0 = k0 + warp * 16;
  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    if (it + 1 < iters) {
      issue(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sq = stage_q(st);
    const bf16* so = sq + kBQ * P;
    const float* sl = reinterpret_cast<const float*>(so + kBQ * P);
    const float* sd = sl + kBQ;
    scale_tile<kBQ, DH, NT>(sQs, sq, scale, tid);
    __syncthreads();
    const int qt = first + it % per_head, q0 = qt * kBQ;

    float s[kBQ / 8][4] = {};                // s^T: keys x queries
    mma_abt<kBQ, DH>(s, sKw, sQs, lane);
    if (MODE == kCausal && q0 < key0 + 15)
#pragma unroll
      for (int t = 0; t < kBQ / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + lane / 4 + 8 * (e / 2);
          const int qry = q0 + 8 * t + 2 * (lane % 4) + (e % 2);
          if (key > qry) s[t][e] = kNegInf;
        }
    if (MODE == kSplash && !full_tile(mv, qt, k0, kBKd)) {
      // the q tile's row bounds, staged with it
      const int* sb = reinterpret_cast<const int*>(sd + kBQ);
#pragma unroll
      for (int t = 0; t < kBQ / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + lane / 4 + 8 * (e / 2);
          const int c = 8 * t + 2 * (lane % 4) + (e % 2);
          if (key < sb[c] || key > sb[kBQ + c]) s[t][e] = kNegInf;
        }
    }
#pragma unroll
    for (int t = 0; t < kBQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[t][e] = expf(s[t][e] - sl[8 * t + 2 * (lane % 4) + (e % 2)]);
    mma_xb<kBQ, DH>(dva, s, so, lane);       // dv += p^T dO
    float dp[kBQ / 8][4] = {};
    mma_abt<kBQ, DH>(dp, sVw, so, lane);     // dp^T = V dO^T
#pragma unroll
    for (int t = 0; t < kBQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[t][e] = s[t][e] *
                  (dp[t][e] - sd[8 * t + 2 * (lane % 4) + (e % 2)]) * scale;
    mma_xb<kBQ, DH>(dka, s, sq, lane);       // dk += ds^T q
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  const size_t woff = koff + static_cast<size_t>(warp) * 16 * ldk;
  store_rows<DH>(dk + woff, ldk, dka, one, lane);
  store_rows<DH>(dv + woff, ldk, dva, one, lane);
}

// -------------------------------------------- float32 (CUDA-core) kernels
//
// One thread per query (forward, dq) or key (dk/dv) row.  Each walks the
// keys (queries) its row can see: all, the causal triangle, or under a
// BlockMask the row's interval clipped to its tile's visit range.

constexpr int kRowThreads = 128;

// the keys [jb, je) query `row` visits
__device__ __forceinline__ void key_range(int row, int S, int mode,
                                          const int* mask, int& jb,
                                          int& je) {
  jb = 0;
  je = mode == kCausal ? row + 1 : S;
  if (mode == kSplash) {
    const MaskView mv = mask_view(mask, S / kBQ, S);
    const int qt = row / kBQ;
    jb = max(mv.lo[row], mv.first[qt] * kBK);
    je = min(mv.hi[row], mv.last[qt] * kBK + kBK - 1) + 1;
  }
}

template <int DH>
__global__ void __launch_bounds__(kRowThreads)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, const int* __restrict__ mask, int S,
            int Hq, int Hkv, float q_mul, int mode) {
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= S) return;
  const int h = blockIdx.y % Hq, b = blockIdx.y / Hq;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (static_cast<size_t>(b) * S + row) * Hq * DH + h * DH;
  const float* kb = k + static_cast<size_t>(b) * S * Hkv * DH + hk * DH;
  const float* vb = v + static_cast<size_t>(b) * S * Hkv * DH + hk * DH;
  float qv[DH], acc[DH];
  for (int d = 0; d < DH; ++d) {
    qv[d] = q[qoff + d] * q_mul;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  int jb, je;
  key_range(row, S, mode, mask, jb, je);
  for (int j = jb; j < je; ++j) {
    const float* kr = kb + static_cast<size_t>(j) * Hkv * DH;
    const float* vr = vb + static_cast<size_t>(j) * Hkv * DH;
    float s = 0.f;
    for (int d = 0; d < DH; ++d) s += qv[d] * kr[d];
    const float m_new = fmaxf(m, s);
    const float alpha = exp2f(m - m_new), p = exp2f(s - m_new);
    l = l * alpha + p;
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] * alpha + p * vr[d];
    m = m_new;
  }
  for (int d = 0; d < DH; ++d) o[qoff + d] = acc[d] / l;
  lse[(static_cast<size_t>(b) * Hq + h) * S + row] = (m + log2f(l)) / kLog2e;
}

template <int DH>
__global__ void __launch_bounds__(kRowThreads)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ dcap, float* __restrict__ dq,
           const int* __restrict__ mask, int S, int Hq, int Hkv,
           float scale, int mode) {
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= S) return;
  const int h = blockIdx.y % Hq, b = blockIdx.y / Hq;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (static_cast<size_t>(b) * S + row) * Hq * DH + h * DH;
  const size_t roff = (static_cast<size_t>(b) * Hq + h) * S + row;
  const float* kb = k + static_cast<size_t>(b) * S * Hkv * DH + hk * DH;
  const float* vb = v + static_cast<size_t>(b) * S * Hkv * DH + hk * DH;
  float qs[DH], g[DH], acc[DH];
  float dsum = 0.f;
  for (int d = 0; d < DH; ++d) {
    qs[d] = q[qoff + d] * scale;
    g[d] = dout[qoff + d];
    dsum += g[d] * o[qoff + d];
    acc[d] = 0.f;
  }
  dcap[roff] = dsum;
  const float l = lse[roff];
  int jb, je;
  key_range(row, S, mode, mask, jb, je);
  for (int j = jb; j < je; ++j) {
    const float* kr = kb + static_cast<size_t>(j) * Hkv * DH;
    const float* vr = vb + static_cast<size_t>(j) * Hkv * DH;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < DH; ++d) {
      s += qs[d] * kr[d];
      dp += g[d] * vr[d];
    }
    const float ds = expf(s - l) * (dp - dsum) * scale;
    for (int d = 0; d < DH; ++d) acc[d] += ds * kr[d];
  }
  for (int d = 0; d < DH; ++d) dq[qoff + d] = acc[d];
}

template <int DH>
__global__ void __launch_bounds__(kRowThreads)
    dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dcap,
            float* __restrict__ dk, float* __restrict__ dv,
            const int* __restrict__ mask, int S, int Hq, int Hkv,
            float scale, int mode) {
  const int key = blockIdx.x * kRowThreads + threadIdx.x;
  if (key >= S) return;
  const int hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv;
  const int G = Hq / Hkv;
  const size_t koff = (static_cast<size_t>(b) * S + key) * Hkv * DH + hk * DH;
  // the queries [ib, ie) that may see this key; splash: the key tile's
  // visit range, each query then held to its own interval
  int ib = mode == kCausal ? key : 0, ie = S;
  MaskView mv{};
  if (mode == kSplash) {
    mv = mask_view(mask, S / kBKd, S);
    ib = mv.first[key / kBKd] * kBQ;
    ie = (mv.last[key / kBKd] + 1) * kBQ;
  }
  float kv[DH], vv[DH], dka[DH], dva[DH];
  for (int d = 0; d < DH; ++d) {
    kv[d] = k[koff + d];
    vv[d] = v[koff + d];
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * S;
    const float* drow = dcap + (static_cast<size_t>(b) * Hq + h) * S;
    for (int i = ib; i < ie; ++i) {
      if (mode == kSplash && (key < mv.lo[i] || key > mv.hi[i])) continue;
      const size_t qoff = (static_cast<size_t>(b) * S + i) * Hq * DH + h * DH;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < DH; ++d) {
        s += (q[qoff + d] * scale) * kv[d];
        dp += dout[qoff + d] * vv[d];
      }
      const float p = expf(s - lrow[i]);
      const float ds = p * (dp - drow[i]) * scale;
      for (int d = 0; d < DH; ++d) {
        dva[d] += p * dout[qoff + d];
        dka[d] += ds * q[qoff + d];
      }
    }
  }
  for (int d = 0; d < DH; ++d) {
    dk[koff + d] = dka[d];
    dv[koff + d] = dva[d];
  }
}

// --------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t with_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH, int MODE>
cudaError_t fwd_bf16_launch(const void* q, const void* k, const void* v,
                            void* o, float* lse, const int* mask, int B,
                            int S, int Hq, int Hkv, float q_mul,
                            cudaStream_t stream) {
  auto kernel = fwd_bf16<DH, MODE>;
  const size_t smem = fwd_smem<DH>();
  cudaError_t err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * Hq, S / kBQ), kFwdWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, mask, S, Hq,
      Hkv, q_mul);
  return cudaGetLastError();
}

template <int DH, int MODE>
cudaError_t dq_bf16_launch(const void* q, const void* k, const void* v,
                           const void* o, const void* dout,
                           const float* lse, float* dcap, void* dq,
                           const int* mask, int B, int S, int Hq, int Hkv,
                           float scale, cudaStream_t stream) {
  auto kernel = dq_bf16<DH, MODE>;
  const size_t smem = dq_smem<DH>();
  cudaError_t err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * Hq, S / kBQ), kDqWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, dcap, static_cast<bf16*>(dq),
      mask, S, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <int DH, int MODE>
cudaError_t dkv_bf16_launch(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* dcap, void* dk, void* dv,
                            const int* mask, int B, int S, int Hq, int Hkv,
                            float scale, cudaStream_t stream) {
  auto kernel = dkv_bf16<DH, MODE>;
  const size_t smem = dkv_smem<DH, MODE>();
  cudaError_t err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * Hkv, S / kBKd), kDkvWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      dcap, static_cast<bf16*>(dk), static_cast<bf16*>(dv), mask, S, Hq,
      Hkv, scale);
  return cudaGetLastError();
}

dim3 row_grid(int S, int BH) {
  return dim3((S + kRowThreads - 1) / kRowThreads, BH);
}

// Dh is a template parameter; this picks the instance
#define DLNB_DISPATCH_DH(DH_VAL, CALL)                                  \
  do {                                                                  \
    if ((DH_VAL) == 64) { constexpr int DH = 64; return CALL; }         \
    if ((DH_VAL) == 128) { constexpr int DH = 128; return CALL; }       \
    return cudaErrorInvalidValue;                                       \
  } while (0)

// the mode as a template parameter: dense, causal or splash
#define DLNB_DISPATCH(DH_VAL, MODE_VAL, CALL)                           \
  do {                                                                  \
    if ((MODE_VAL) == kSplash) {                                        \
      constexpr int M = kSplash; DLNB_DISPATCH_DH(DH_VAL, CALL);        \
    }                                                                   \
    if ((MODE_VAL) == kCausal) {                                        \
      constexpr int M = kCausal; DLNB_DISPATCH_DH(DH_VAL, CALL);        \
    }                                                                   \
    constexpr int M = kDense; DLNB_DISPATCH_DH(DH_VAL, CALL);           \
  } while (0)

cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* o, float* lse, const int* mask, int mode, int B,
                int S, int Hq, int Hkv, int Dh, float scale,
                cudaStream_t st) {
  if (S % kBKd || Hq % Hkv) return cudaErrorInvalidValue;
  const float q_mul = scale * kLog2e;
  if (dtype == kBF16) {
    DLNB_DISPATCH(Dh, mode,
                  (fwd_bf16_launch<DH, M>(q, k, v, o, lse, mask, B, S, Hq,
                                          Hkv, q_mul, st)));
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (Dh == 64)
    fwd_f32<64><<<row_grid(S, B * Hq), kRowThreads, 0, st>>>(
        qf, kf, vf, of, lse, mask, S, Hq, Hkv, q_mul, mode);
  else if (Dh == 128)
    fwd_f32<128><<<row_grid(S, B * Hq), kRowThreads, 0, st>>>(
        qf, kf, vf, of, lse, mask, S, Hq, Hkv, q_mul, mode);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

cudaError_t dq(int dtype, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               float* dcap, void* dq, const int* mask, int mode, int B,
               int S, int Hq, int Hkv, int Dh, float scale,
               cudaStream_t st) {
  if (S % kBKd || Hq % Hkv) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    DLNB_DISPATCH(Dh, mode,
                  (dq_bf16_launch<DH, M>(q, k, v, o, dout, lse, dcap, dq,
                                         mask, B, S, Hq, Hkv, scale, st)));
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* gf = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  if (Dh == 64)
    dq_f32<64><<<row_grid(S, B * Hq), kRowThreads, 0, st>>>(
        qf, kf, vf, of, gf, lse, dcap, dqf, mask, S, Hq, Hkv, scale, mode);
  else if (Dh == 128)
    dq_f32<128><<<row_grid(S, B * Hq), kRowThreads, 0, st>>>(
        qf, kf, vf, of, gf, lse, dcap, dqf, mask, S, Hq, Hkv, scale, mode);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

cudaError_t dkv(int dtype, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dcap,
                void* dk, void* dv, const int* mask, int mode, int B,
                int S, int Hq, int Hkv, int Dh, float scale,
                cudaStream_t st) {
  if (S % kBKd || Hq % Hkv) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    DLNB_DISPATCH(Dh, mode,
                  (dkv_bf16_launch<DH, M>(q, k, v, dout, lse, dcap, dk, dv,
                                          mask, B, S, Hq, Hkv, scale, st)));
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(dout);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  if (Dh == 64)
    dkv_f32<64><<<row_grid(S, B * Hkv), kRowThreads, 0, st>>>(
        qf, kf, vf, gf, lse, dcap, dkf, dvf, mask, S, Hq, Hkv, scale, mode);
  else if (Dh == 128)
    dkv_f32<128><<<row_grid(S, B * Hkv), kRowThreads, 0, st>>>(
        qf, kf, vf, gf, lse, dcap, dkf, dvf, mask, S, Hq, Hkv, scale, mode);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: O [B,S,Hq,Dh] and lse [B,Hq,S] f32 of causal or full attention
int dlnb_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int S, int Hq, int Hkv,
                   int Dh, int causal, float scale, void* stream) {
  return fwd(dtype, q, k, v, o, lse, nullptr, causal ? kCausal : kDense, B,
             S, Hq, Hkv, Dh, scale, static_cast<cudaStream_t>(stream));
}

// K4: dq [B,S,Hq,Dh]; also writes D = rowsum(dO * O) into dcap [B,Hq,S]
int dlnb_flash_dq(int dtype, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* dcap, void* dq_out, int B, int S, int Hq, int Hkv,
                  int Dh, int causal, float scale, void* stream) {
  return dq(dtype, q, k, v, o, dout, lse, dcap, dq_out, nullptr,
            causal ? kCausal : kDense, B, S, Hq, Hkv, Dh, scale,
            static_cast<cudaStream_t>(stream));
}

// K5: dk, dv [B,S,Hkv,Dh], summed over each KV head's q-head group;
// reads the D that dlnb_flash_dq wrote
int dlnb_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dcap,
                   void* dk, void* dv, int B, int S, int Hq, int Hkv,
                   int Dh, int causal, float scale, void* stream) {
  return dkv(dtype, q, k, v, dout, lse, dcap, dk, dv, nullptr,
             causal ? kCausal : kDense, B, S, Hq, Hkv, Dh, scale,
             static_cast<cudaStream_t>(stream));
}

// K6: the forward under a BlockMask at 64 x 64 tiles (mask: MaskView's
// packing with n = S / 64)
int dlnb_splash_fwd(int dtype, const void* q, const void* k, const void* v,
                    void* o, float* lse, const int* mask, int B, int S,
                    int Hq, int Hkv, int Dh, float scale, void* stream) {
  return fwd(dtype, q, k, v, o, lse, mask, kSplash, B, S, Hq, Hkv, Dh,
             scale, static_cast<cudaStream_t>(stream));
}

// K7: dq and D under a BlockMask at 64 x 64 tiles
int dlnb_splash_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* dcap, void* dq_out, const int* mask, int B, int S,
                   int Hq, int Hkv, int Dh, float scale, void* stream) {
  return dq(dtype, q, k, v, o, dout, lse, dcap, dq_out, mask, kSplash, B,
            S, Hq, Hkv, Dh, scale, static_cast<cudaStream_t>(stream));
}

// K8: dk, dv under a BlockMask at 64-row x 128-key tiles (n = S / 128)
int dlnb_splash_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dcap,
                    void* dk, void* dv, const int* mask, int B, int S,
                    int Hq, int Hkv, int Dh, float scale, void* stream) {
  return dkv(dtype, q, k, v, dout, lse, dcap, dk, dv, mask, kSplash, B, S,
             Hq, Hkv, Dh, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
