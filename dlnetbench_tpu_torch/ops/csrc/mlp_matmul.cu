// The MLP GEMMs of the quantized and fused-backward SwiGLU recipes, for
// Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package:
//   K11 ops/quantized_matmul.py::_fused_matmul_kernel (:112, pallas_call
//       :230) — x [T, K] (bf16 or f32 master) @ pre-quantized w [K, N]
//       (int8 or e4m3) -> [T, N] in x's dtype: x quantized in the
//       prologue against a provided scale, int32 (int8) or f32 (e4m3)
//       accumulation, the sx * sw epilogue in registers, and optionally
//       max |x| over the whole tensor (the delayed-scaling state);
//   K9  ops/mlp_backward.py::_dgdu_kernel (:50, pallas_call :73) — dg, du
//       [T, F] bf16 from dh = dy [T, D] . Wd [F, D]^T kept in f32
//       registers and the saved g, u: dg = dh * u * silu'(g),
//       du = dh * silu(g);
//   K10 ops/mlp_backward.py::_dwd_kernel (:103, pallas_call :131) — dWd
//       [F, D] f32 = h^T . dy over T, h = bf16(silu(g) * u) recomputed per
//       tile in the prologue;
//   K12 ops/grouped_matmul.py::_grouped_kernel (:82, pallas_call :206) — the
//       MoE expert FFN's grouped product, x [E, C, K] . w [E, K, N] -> [E, C,
//       N] per expert, every row at or past the expert's count counts[e]
//       zero and never read; bf16 on the tensor cores (gmm_bf16_kernel), f32
//       on the CUDA cores (gmm_f32_kernel, any shape), and int8 / e4m3 as
//       K11's kernel launched over the experts (a per-expert scale sx[e] in
//       the prologue, sx[e] * sw[e] in the epilogue, the weight K-major per
//       expert).
//
// One GEMM skeleton serves all four: a 128 x 256 output tile per block of
// 8 warps (2 along M x 4 along N, 64 x 64 each; one block per SM), the
// block's tile chosen by a grouped raster (8 row tiles share each column
// sweep, so a wave of blocks reuses its operand panels from L2), operands
// staged through a ring of shared-memory stages filled by 16-byte
// cp.async, fragments read with ldmatrix (rows padded by 16 bytes: the 8
// row addresses of one 8x8 matrix fall in distinct banks) and multiplied
// with mma.sync on the tensor cores.  Each kernel adds its own prologue
// (what is computed from a stage before the products: K11's quantized A
// tile, K10's recomputed h tile) and epilogue.  A prologue writes one of
// two buffers: each iteration issues the products of stage k and then
// computes the prologue of stage k + 1, so the prologue's ALU work runs
// while the tensor cores drain, one barrier an iteration.
//
// Why 128 x 256: K11 quantizes every x tile once per column tile and K10
// recomputes every h tile once per column tile, so the prologue's work per
// product falls with the tile's width.  The first design (128 x 128, the
// prologue between two barriers) spent most of its time there: K11 read
// 0.08 of its bound and K10 0.12 (PERF.md).
//
// Layouts.  K11 reads the weight K-major, w_t [N, K] (one transposed copy
// of the quantized weight, made by the wrapper, once per quantization):
// an 8-bit mma B fragment wants K contiguous and ldmatrix.trans moves
// 16-bit elements only.  K9's operands are both D-contiguous (row.col as
// they lie).  K10's are both T-major, so its fragments come through
// ldmatrix.trans (bf16).
//
// Numerics (the TPU kernels' rounding points):
//   K11: x / sx rounded as IEEE division rounds it (never x * (1 / sx),
//        see div_rn); int8 rounds half to even, then clips to +-127; e4m3
//        clips to +-448, then converts with round-to-nearest-even (the
//        satfinite conversion is that clip); the epilogue is float(acc) *
//        (sx * sw), one f32 product of the two scales, then the cast.
//        int32 accumulation is exact, so the int8 result is bit-for-bit
//        the plain product's; amax is a max, order-free, published with
//        atomicMax on the f32 bits (non-negative floats order as their bit
//        patterns) into a zeroed scalar, so it is deterministic.
//   K9:  silu(g) = g * sig, silu'(g) = sig + silu * (1 - sig), sig =
//        1 / (1 + exp(-g)) in f32 (the JAX _silu_parts); dg = (dh * u) *
//        silu'(g) and du = dh * silu(g), rounded to bf16.
//   K10: h = bf16(silu(g) * u), products in f32; its sigmoid takes exp
//        and the reciprocal from the approximate units (a few ulp each),
//        which can move an element of h across a bf16 rounding boundary;
//        the bar on dWd (1e-3 of each row's max-abs) stays well above the
//        effect (PERF.md has the measured error).
// This file is compiled without --use_fast_math: the exact int8 bar relies
// on correctly rounded division and on __float2int_rn / __int2float_rn.
//
// Bound on this card at the train shape (T = 12288, D = 4096, F = 14336):
// each kernel does 2 * T * D * F = 1.443e12 operations.  K11 on ~0.5 GB of
// operands at 1979 T/s int8/e4m3: 0.729 ms, bound by operations.  K9 on
// 1.63 GB and K10 on 1.04 GB at 989 TFLOP/s bf16: 1.459 ms each, bound by
// operations.  What the design does about it: every product on the tensor
// cores, 32 mma.sync per 8 ldmatrix.x4 in a warp (four m16 tiles share each
// B fragment, eight n8 tiles each A fragment), the next stages' loads in
// flight while a stage is computed, the prologue overlapped with the
// products, and nothing quantized or recomputed (x_q, dh, h) ever written
// to device memory.  Not yet: wgmma, TMA, warp specialisation, a
// persistent grid; the times stand in PERF.md.
//
// K12 (see Grouped launches below) at the MoE bench shape (E = 8 experts of
// C = 1280 slots, D = 4096, F = 7168): 2 * E * C * D * F = 6.01e11
// operations a product, 0.608 ms at the bf16 peak (0.70 GB moved, 0.21 ms),
// 0.304 ms at the int8/e4m3 peak; bound by operations.  Rows past a count
// cost no operations and no reads: a row tile wholly past it writes zeros
// and returns, a partly live tile zero-fills its dead rows instead of
// loading them.
//
// Plain C interface (nvcc -> .so -> ctypes): the wrappers
// (ops/quantized_matmul.py, ops/mlp_backward.py, ops/grouped_matmul.py)
// check device, dtype,
// shapes, contiguity and alignment before calling; each entry returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

enum Dtype { kF32 = 0, kBF16 = 1 };
enum Fmt { kInt8 = 0, kE4M3 = 1 };

constexpr int kThreads = 256;          // 8 warps: 2 (M) x 4 (N)
constexpr int kBM = 128, kBN = 256;    // block tile
constexpr int kWM = 64, kWN = 64;      // warp tile: 4 m16 x 8 n8
constexpr int kGroupM = 8;             // raster group (row tiles)

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// the same, copying src_bytes (16 or 0) and zero-filling the rest
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices (or 8 x 16-byte rows of 8-bit values); lanes
// 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x32, row) * b (32x8, col); int8 in, exact int32 accumulate
__device__ __forceinline__ void mma_q(int (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x32, row) * b (32x8, col); e4m3 in, f32 accumulate
__device__ __forceinline__ void mma_q(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------- shared skeleton

// block -> (row tile, column tile): kGroupM row tiles sweep the columns
// together, so the blocks resident at one time share a few operand panels
__device__ __forceinline__ void tile_of(int bid, int mt, int nt, int& tm,
                                        int& tn) {
  const int per_group = kGroupM * nt;
  const int first = (bid / per_group) * kGroupM;
  const int rows = min(mt - first, kGroupM);
  const int in = bid % per_group;
  tm = first + in % rows;
  tn = in / rows;
}

// R rows x BYTES bytes from global (row stride ld_bytes) -> shared (row
// pitch p_bytes), 16 bytes per cp.async
template <int R, int BYTES>
__device__ __forceinline__ void load_rows(void* dst, int p_bytes,
                                          const void* src, size_t ld_bytes,
                                          int tid) {
  constexpr int kChunks = BYTES / 16;
  auto* d = static_cast<unsigned char*>(dst);
  const auto* s = static_cast<const unsigned char*>(src);
#pragma unroll
  for (int c = tid; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 16;
    cp_async16(d + r * p_bytes + col, s + r * ld_bytes + col);
  }
}

// load_rows for a tile whose rows at or past `valid` are dead (past an
// expert's count, or past the buffer's end): they are zero-filled and never
// read; row 0 is always live when the tile is loaded
template <int R, int BYTES>
__device__ __forceinline__ void load_rows_live(void* dst, int p_bytes,
                                               const void* src,
                                               size_t ld_bytes, int tid,
                                               int valid) {
  constexpr int kChunks = BYTES / 16;
  auto* d = static_cast<unsigned char*>(dst);
  const auto* s = static_cast<const unsigned char*>(src);
#pragma unroll
  for (int c = tid; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 16;
    const bool live = r < valid;
    cp_async16_zfill(d + r * p_bytes + col, s + (live ? r : 0) * ld_bytes + col,
                     live ? 16 : 0);
  }
}

// Grouped launches (K12; K11 is the one-expert case): blockIdx.z is the
// expert, whose operands sit `stride` elements after the previous
// expert's; counts[e] (nullptr: every row) bounds its live rows.  A row
// tile at or past the live rows writes zeros and returns; a live tile
// zero-fills its dead rows (load_rows_live) and writes them as zeros.
struct Group {
  const int* counts;
  size_t x_stride, w_stride, y_stride;
};

__device__ __forceinline__ int live_rows(const int* counts, int e, int M) {
  return counts ? min(max(counts[e], 0), M) : M;
}

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// zeros over rows [tm * kBM, min(tm * kBM + kBM, M)) of a kBN-column tile
template <typename T>
__device__ __forceinline__ void zero_tile(T* y, int M, int N, int tm, int tn,
                                          int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int rows = min(kBM, M - tm * kBM);
  for (int c = tid; c < rows * (kBN / kVec); c += kThreads) {
    const int r = c / (kBN / kVec), col = (c % (kBN / kVec)) * kVec;
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(tm * kBM + r) * N +
                              tn * kBN + col) = make_uint4(0, 0, 0, 0);
  }
}

// The warp's 64 x 64 accumulator (acc[m16 tile][n8 tile][4]): in a tile,
// element e of lane L sits at row L/4 + 8*(e/2), column 2*(L%4) + e%2.
template <typename Acc>
struct WarpAcc {
  Acc v[kWM / 16][kWN / 8][4];
};

// acc += A (the warp's 64 rows of a row-major [kBM][K] tile) * B^T (the
// warp's 32 rows of a row-major [kBN][K] tile); 16-bit elements, KS
// contraction steps of 16; pitches in elements
template <int KS>
__device__ __forceinline__ void mma_rows_bf16(WarpAcc<float>& acc,
                                              const bf16* a, int pa,
                                              const bf16* b, int pb,
                                              int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[kWM / 16][4];
#pragma unroll
    for (int mt = 0; mt < kWM / 16; ++mt)
      ldsm4(af[mt], a + (mt * 16 + lane % 16) * pa + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nb = 0; nb < kWN / 16; ++nb) {
      uint32_t bfr[4];
      ldsm4(bfr, b + (nb * 16 + (lane / 16) * 8 + lane % 8) * pb + ks * 16 +
                     ((lane / 8) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < kWM / 16; ++mt) {
        mma_bf16(acc.v[mt][2 * nb], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc.v[mt][2 * nb + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// the same with 8-bit elements (int8 or e4m3), KS steps of 32; pitches in
// bytes
template <int KS, typename Acc>
__device__ __forceinline__ void mma_rows_q(WarpAcc<Acc>& acc,
                                           const uint8_t* a, int pa,
                                           const uint8_t* b, int pb,
                                           int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[kWM / 16][4];
#pragma unroll
    for (int mt = 0; mt < kWM / 16; ++mt)
      ldsm4(af[mt],
            a + (mt * 16 + lane % 16) * pa + ks * 32 + (lane / 16) * 16);
#pragma unroll
    for (int nb = 0; nb < kWN / 16; ++nb) {
      uint32_t bfr[4];
      ldsm4(bfr, b + (nb * 16 + (lane / 16) * 8 + lane % 8) * pb + ks * 32 +
                     ((lane / 8) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < kWM / 16; ++mt) {
        mma_q(acc.v[mt][2 * nb], af[mt], bfr[0], bfr[1]);
        mma_q(acc.v[mt][2 * nb + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// acc += A * B with A stored K-major ([K][kBM] rows, the warp's 64 columns
// at a) and B stored K-major ([K][kBN] rows, the warp's 32 columns at b),
// both fed through ldmatrix.trans; bf16, KS steps of 16; pitches in
// elements
template <int KS>
__device__ __forceinline__ void mma_cols_bf16(WarpAcc<float>& acc,
                                              const bf16* a, int pa,
                                              const bf16* b, int pb,
                                              int lane) {
  const int j = lane / 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[kWM / 16][4];
#pragma unroll
    for (int mt = 0; mt < kWM / 16; ++mt)
      ldsm4_t(af[mt], a + (ks * 16 + (j >> 1) * 8 + lane % 8) * pa +
                          mt * 16 + (j & 1) * 8);
#pragma unroll
    for (int nb = 0; nb < kWN / 16; ++nb) {
      uint32_t bfr[4];
      ldsm4_t(bfr, b + (ks * 16 + (j & 1) * 8 + lane % 8) * pb + nb * 16 +
                       (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < kWM / 16; ++mt) {
        mma_bf16(acc.v[mt][2 * nb], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc.v[mt][2 * nb + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// acc += A * B with A row-major (the warp's 64 rows of a [kBM][K] tile, as
// mma_rows_bf16) and B stored K-major ([K][kBN] rows, the warp's 64 columns
// at b, through ldmatrix.trans as mma_cols_bf16); bf16, KS steps of 16
template <int KS>
__device__ __forceinline__ void mma_rk_bf16(WarpAcc<float>& acc,
                                            const bf16* a, int pa,
                                            const bf16* b, int pb, int lane) {
  const int j = lane / 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[kWM / 16][4];
#pragma unroll
    for (int mt = 0; mt < kWM / 16; ++mt)
      ldsm4(af[mt], a + (mt * 16 + lane % 16) * pa + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nb = 0; nb < kWN / 16; ++nb) {
      uint32_t bfr[4];
      ldsm4_t(bfr, b + (ks * 16 + (j & 1) * 8 + lane % 8) * pb + nb * 16 +
                       (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < kWM / 16; ++mt) {
        mma_bf16(acc.v[mt][2 * nb], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc.v[mt][2 * nb + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// eight consecutive values from shared memory, as f32
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

// K10's sigmoid: exp from ex2.approx and the reciprocal from rcp.approx
// (see Numerics); h is recomputed once per column tile, and the correctly
// rounded forms took most of the kernel's time
__device__ __forceinline__ float sigmoid_fast(float g) {
  return __fdividef(1.f, 1.f + __expf(-g));
}

// -------------------------------------------- K11 fused quantized matmul

constexpr int kQK = 64;                // contraction per stage (elements)
constexpr int kQP = kQK + 16;          // 8-bit tile pitch (bytes)

template <typename TX>
__host__ __device__ constexpr int q_stages() {   // the f32 ring fits 3
  return sizeof(TX) == 2 ? 4 : 3;
}

template <typename TX>
__host__ __device__ constexpr int x_pitch() {   // elements; +16 bytes
  return kQK + 16 / static_cast<int>(sizeof(TX));
}

template <typename TX>
__host__ __device__ constexpr size_t qmm_smem() {
  return q_stages<TX>() *
             (static_cast<size_t>(kBM) * x_pitch<TX>() * sizeof(TX) +
              static_cast<size_t>(kBN) * kQP) +
         2 * static_cast<size_t>(kBM) * kQP + kThreads / 32 * sizeof(float);
}

// x / sx rounded to nearest even, equal to IEEE division: r = RN(1 / sx)
// (__frcp_rn), q0 = x * r is within 1.5 ulp of the quotient, the first
// correction (its remainder x - q0 * sx exact in an fma) brings it within
// one ulp, and by Markstein's theorem the second returns RN(x / sx).  The
// remainders are exact unless the quotient is below ~2^-100 (a zero code
// either way); from |q0| >= 1024 on, where the corrections could meet an
// overflow, every value saturates the same, so q0 stands.
__device__ __forceinline__ float div_rn(float v, float sx, float r) {
  const float q0 = v * r;
  const float q1 = fmaf(fmaf(-q0, sx, v), r, q0);
  const float q2 = fmaf(fmaf(-q1, sx, v), r, q1);
  return fabsf(q0) < 1024.f ? q2 : q0;
}

// four values of x -> four codes of the JAX _cast_q of x / sx, packed
// (the first in the low byte): int8 rounds half to even then clips (both
// bounds are integers, so clipping first gives the same code); e4m3 clips
// then converts with round-to-nearest-even (satfinite is the clip)
template <int FMT>
__device__ __forceinline__ uint32_t quant4(const float* v, float sx,
                                           float r) {
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = div_rn(v[i], sx, r);
  if (FMT == kInt8) {
    int c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = __float2int_rn(fminf(fmaxf(q[i], -127.f), 127.f));
    return __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                       __byte_perm(c[2], c[3], 0x0040), 0x5410);
  }
  const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(q[0], q[1]),
                                               __NV_SATFINITE, __NV_E4M3);
  const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(q[2], q[3]),
                                               __NV_SATFINITE, __NV_E4M3);
  return lo | (hi << 16);
}

// prologue: a kBM x kQK master-dtype tile of x -> the 8-bit A tile, eight
// values a thread per pass; |x| folded into amax
template <typename TX, int FMT, bool AMAX>
__device__ __forceinline__ void quantize_tile(uint8_t* dst, const TX* src,
                                              float sx, float r,
                                              float& amax, int tid) {
  constexpr int XP = x_pitch<TX>();
#pragma unroll
  for (int c = tid; c < kBM * kQK / 8; c += kThreads) {
    const int row = c / (kQK / 8), col = (c % (kQK / 8)) * 8;
    float v[8];
    load8(v, src + row * XP + col);
    if (AMAX) {
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
    *reinterpret_cast<uint2*>(dst + row * kQP + col) =
        make_uint2(quant4<FMT>(v, sx, r), quant4<FMT>(v + 4, sx, r));
  }
}

template <typename TX, int FMT, bool AMAX>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w_t,
               const float* __restrict__ sx_p, const float* __restrict__ sw_p,
               TX* __restrict__ y, float* __restrict__ amax_out, int M, int N,
               int K, Group grp) {
  using Acc = typename std::conditional<FMT == kInt8, int, float>::type;
  constexpr int S = q_stages<TX>();
  constexpr int XP = x_pitch<TX>();
  constexpr size_t XS = static_cast<size_t>(kBM) * XP;   // elements
  constexpr int WS = kBN * kQP, AS = kBM * kQP;          // bytes
  extern __shared__ __align__(16) unsigned char smem[];
  TX* sX = reinterpret_cast<TX*>(smem);                  // [S] x tiles
  uint8_t* sW = reinterpret_cast<uint8_t*>(sX + S * XS); // [S] w tiles
  uint8_t* sA = sW + S * WS;                             // [2] quantized x
  float* sRed = reinterpret_cast<float*>(sA + 2 * AS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int e = blockIdx.z;
  x += e * grp.x_stride;
  w_t += e * grp.w_stride;
  y += e * grp.y_stride;
  const int live = live_rows(grp.counts, e, M);
  int tm, tn;
  tile_of(blockIdx.x, ceil_div(M, kBM), N / kBN, tm, tn);
  if (tm * kBM >= live) {
    zero_tile(y, M, N, tm, tn, tid);
    return;
  }
  const int valid = min(kBM, live - tm * kBM);
  const TX* xg = x + static_cast<size_t>(tm) * kBM * K;
  const uint8_t* wg = w_t + static_cast<size_t>(tn) * kBN * K;
  // the scales are read on the card: the caller never waits for them
  const float sx = sx_p[e];
  const float r = __frcp_rn(sx);
  const float s_out = sx * sw_p[e];
  const int nk = K / kQK;

  auto issue = [&](int kt) {
    const int st = kt % S;
    load_rows_live<kBM, static_cast<int>(kQK * sizeof(TX))>(
        sX + st * XS, static_cast<int>(XP * sizeof(TX)),
        xg + static_cast<size_t>(kt) * kQK,
        static_cast<size_t>(K) * sizeof(TX), tid, valid);
    load_rows<kBN, kQK>(sW + st * WS, kQP,
                        wg + static_cast<size_t>(kt) * kQK,
                        static_cast<size_t>(K), tid);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  WarpAcc<Acc> acc = {};
  float amax = 0.f;
  cp_async_wait<S - 2>();               // stage 0 has landed
  __syncthreads();
  quantize_tile<TX, FMT, AMAX>(sA, sX, sx, r, amax, tid);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 3>();             // stage kt + 1 has landed
    // A tile kt is written, stage kt + 1 is visible to every thread, and
    // every warp is done with the A buffer and the stage written below
    __syncthreads();
    if (kt + S - 1 < nk) issue(kt + S - 1);
    cp_async_commit();
    mma_rows_q<kQK / 32>(acc, sA + (kt & 1) * AS + wm * kWM * kQP, kQP,
                         sW + (kt % S) * WS + wn * kWN * kQP, kQP, lane);
    if (kt + 1 < nk)
      quantize_tile<TX, FMT, AMAX>(sA + ((kt + 1) & 1) * AS,
                                   sX + ((kt + 1) % S) * XS, sx, r, amax,
                                   tid);
  }

  if (AMAX && tn == 0) {   // the first column of tiles covers x once
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) sRed[warp] = amax;
    __syncthreads();
    if (tid == 0) {
      float m = sRed[0];
#pragma unroll
      for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, sRed[i]);
      atomicMax(reinterpret_cast<int*>(amax_out), __float_as_int(m));
    }
  }

  // epilogue: float(acc) * (sx * sw), one write in x's dtype; dead rows
  // are zeros, rows past the buffer are not written
  const int row0 = tm * kBM + wm * kWM, col0 = tn * kBN + wn * kWN;
#pragma unroll
  for (int mt = 0; mt < kWM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWN / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + lane / 4 + 8 * h;
        const int col = col0 + nt * 8 + 2 * (lane % 4);
        if (row >= M) continue;
        const bool on = row < live;
        store2(y + static_cast<size_t>(row) * N + col,
               on ? to_f32(acc.v[mt][nt][2 * h]) * s_out : 0.f,
               on ? to_f32(acc.v[mt][nt][2 * h + 1]) * s_out : 0.f);
      }
}

// ------------------------------------------------------------- K9 dg/du

constexpr int kBK = 64;                // contraction per stage (elements)
constexpr int kP = kBK + 8;            // bf16 tile pitch (elements)
constexpr int kStages = 3;

__host__ __device__ constexpr size_t dgdu_smem() {
  return static_cast<size_t>(kStages) * (kBM + kBN) * kP * sizeof(bf16);
}

__global__ void __launch_bounds__(kThreads, 1)
    dgdu_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ wd,
                const bf16* __restrict__ g, const bf16* __restrict__ u,
                bf16* __restrict__ dg, bf16* __restrict__ du, int T, int F,
                int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);             // dy rows
  bf16* sB = sA + kStages * kBM * kP;                   // Wd rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  int tm, tn;
  tile_of(blockIdx.x, T / kBM, F / kBN, tm, tn);
  const bf16* ag = dy + static_cast<size_t>(tm) * kBM * D;
  const bf16* bg = wd + static_cast<size_t>(tn) * kBN * D;
  const int nk = D / kBK;

  auto issue = [&](int kt) {
    const int st = kt % kStages;
    load_rows<kBM, kBK * 2>(sA + st * kBM * kP, kP * 2, ag + kt * kBK,
                            static_cast<size_t>(D) * 2, tid);
    load_rows<kBN, kBK * 2>(sB + st * kBN * kP, kP * 2, bg + kt * kBK,
                            static_cast<size_t>(D) * 2, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  WarpAcc<float> acc = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    cp_async_commit();
    const int st = kt % kStages;
    mma_rows_bf16<kBK / 16>(acc, sA + st * kBM * kP + wm * kWM * kP, kP,
                            sB + st * kBN * kP + wn * kWN * kP, kP, lane);
  }

  // epilogue: dh stays in registers; read g, u, write dg, du
  const int row0 = tm * kBM + wm * kWM, col0 = tn * kBN + wn * kWN;
#pragma unroll
  for (int mt = 0; mt < kWM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWN / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + mt * 16 + lane / 4 + 8 * r;
        const int col = col0 + nt * 8 + 2 * (lane % 4);
        const size_t off = static_cast<size_t>(row) * F + col;
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(g + off));
        const float2 uv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(u + off));
        float dgv[2], duv[2];
        const float gs[2] = {gv.x, gv.y}, us[2] = {uv.x, uv.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dh = acc.v[mt][nt][2 * r + e];
          const float sig = sigmoid(gs[e]);
          const float silu = gs[e] * sig;
          const float dsilu = sig + silu * (1.f - sig);
          dgv[e] = dh * us[e] * dsilu;
          duv[e] = dh * silu;
        }
        store2(dg + off, dgv[0], dgv[1]);
        store2(du + off, duv[0], duv[1]);
      }
}

// --------------------------------------------------------------- K10 dWd

constexpr int kTK = 32;                // tokens (contraction) per stage
constexpr int kFP = kBM + 8;           // g, u, h tile pitch (elements)
constexpr int kDP = kBN + 8;           // dy tile pitch (elements)
constexpr int kWStages = 4;
constexpr int kGS = kTK * kFP, kDS = kTK * kDP;   // elements a tile

__host__ __device__ constexpr size_t dwd_smem() {
  return (static_cast<size_t>(kWStages) * (2 * kGS + kDS) + 2 * kGS) *
         sizeof(bf16);
}

// prologue: h = bf16(silu(g) * u) for a kTK x kBM tile
__device__ __forceinline__ void silu_tile(bf16* sh, const bf16* sg,
                                          const bf16* su, int tid) {
#pragma unroll
  for (int c = tid; c < kTK * kBM / 8; c += kThreads) {
    const int row = c / (kBM / 8), col = (c % (kBM / 8)) * 8;
    float gv[8], uv[8];
    load8(gv, sg + row * kFP + col);
    load8(uv, su + row * kFP + col);
    uint4 out;
    auto* h2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = gv[2 * i] * sigmoid_fast(gv[2 * i]) * uv[2 * i];
      const float b =
          gv[2 * i + 1] * sigmoid_fast(gv[2 * i + 1]) * uv[2 * i + 1];
      h2[i] = __floats2bfloat162_rn(a, b);
    }
    *reinterpret_cast<uint4*>(sh + row * kFP + col) = out;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    dwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
               const bf16* __restrict__ dy, float* __restrict__ dwd, int T,
               int F, int D) {
  constexpr int S = kWStages;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sG = reinterpret_cast<bf16*>(smem);             // [S][kTK][kFP]
  bf16* sU = sG + S * kGS;
  bf16* sD = sU + S * kGS;                              // [S][kTK][kDP] dy
  bf16* sH = sD + S * kDS;                              // [2] h, recomputed
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  int tm, tn;
  tile_of(blockIdx.x, F / kBM, D / kBN, tm, tn);
  const int f0 = tm * kBM, d0 = tn * kBN;
  const int nk = T / kTK;

  auto issue = [&](int kt) {
    const int st = kt % S;
    const size_t t0 = static_cast<size_t>(kt) * kTK;
    load_rows<kTK, kBM * 2>(sG + st * kGS, kFP * 2, g + t0 * F + f0,
                            static_cast<size_t>(F) * 2, tid);
    load_rows<kTK, kBM * 2>(sU + st * kGS, kFP * 2, u + t0 * F + f0,
                            static_cast<size_t>(F) * 2, tid);
    load_rows<kTK, kBN * 2>(sD + st * kDS, kDP * 2, dy + t0 * D + d0,
                            static_cast<size_t>(D) * 2, tid);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  WarpAcc<float> acc = {};
  cp_async_wait<S - 2>();               // stage 0 has landed
  __syncthreads();
  silu_tile(sH, sG, sU, tid);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 3>();             // stage kt + 1 has landed
    // h tile kt is written, stage kt + 1 is visible to every thread, and
    // every warp is done with the h buffer and the stage written below
    __syncthreads();
    if (kt + S - 1 < nk) issue(kt + S - 1);
    cp_async_commit();
    mma_cols_bf16<kTK / 16>(acc, sH + (kt & 1) * kGS + wm * kWM, kFP,
                            sD + (kt % S) * kDS + wn * kWN, kDP, lane);
    if (kt + 1 < nk) {
      const int st = (kt + 1) % S;
      silu_tile(sH + ((kt + 1) & 1) * kGS, sG + st * kGS, sU + st * kGS,
                tid);
    }
  }

  const int row0 = f0 + wm * kWM, col0 = d0 + wn * kWN;
#pragma unroll
  for (int mt = 0; mt < kWM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWN / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + lane / 4 + 8 * h;
        const int col = col0 + nt * 8 + 2 * (lane % 4);
        store2(dwd + static_cast<size_t>(row) * D + col,
               acc.v[mt][nt][2 * h], acc.v[mt][nt][2 * h + 1]);
      }
}


// ------------------------------------------------------ K12 grouped bf16

constexpr int kGP = kBN + 8;           // K-major weight tile pitch (elements)

__host__ __device__ constexpr size_t gmm_smem() {
  return static_cast<size_t>(kStages) * (kBM * kP + kBK * kGP) * sizeof(bf16);
}

// y[e] (bf16) = x[e] [M, K] . w[e] [K, N] (both as they lie: x rows
// K-contiguous, w rows N-contiguous), f32 sums on the tensor cores; dead
// rows (Group) are zeros
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int M, int N, int K, Group grp) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);             // x rows
  bf16* sB = sA + kStages * kBM * kP;                   // w rows (K-major)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int e = blockIdx.z;
  x += e * grp.x_stride;
  w += e * grp.w_stride;
  y += e * grp.y_stride;
  const int live = live_rows(grp.counts, e, M);
  int tm, tn;
  tile_of(blockIdx.x, ceil_div(M, kBM), N / kBN, tm, tn);
  if (tm * kBM >= live) {
    zero_tile(y, M, N, tm, tn, tid);
    return;
  }
  const int valid = min(kBM, live - tm * kBM);
  const bf16* ag = x + static_cast<size_t>(tm) * kBM * K;
  const bf16* bg = w + static_cast<size_t>(tn) * kBN;
  const int nk = K / kBK;

  auto issue = [&](int kt) {
    const int st = kt % kStages;
    load_rows_live<kBM, kBK * 2>(sA + st * kBM * kP, kP * 2, ag + kt * kBK,
                                 static_cast<size_t>(K) * 2, tid, valid);
    load_rows<kBK, kBN * 2>(sB + st * kBK * kGP, kGP * 2,
                            bg + static_cast<size_t>(kt) * kBK * N,
                            static_cast<size_t>(N) * 2, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  WarpAcc<float> acc = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    cp_async_commit();
    const int st = kt % kStages;
    mma_rk_bf16<kBK / 16>(acc, sA + st * kBM * kP + wm * kWM * kP, kP,
                          sB + st * kBK * kGP + wn * kWN, kGP, lane);
  }

  const int row0 = tm * kBM + wm * kWM, col0 = tn * kBN + wn * kWN;
#pragma unroll
  for (int mt = 0; mt < kWM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWN / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + lane / 4 + 8 * h;
        const int col = col0 + nt * 8 + 2 * (lane % 4);
        if (row >= M) continue;
        const bool on = row < live;
        store2(y + static_cast<size_t>(row) * N + col,
               on ? acc.v[mt][nt][2 * h] : 0.f,
               on ? acc.v[mt][nt][2 * h + 1] : 0.f);
      }
}

// ------------------------------------------------------- K12 grouped f32

// CUDA cores, any shape: a 64 x 64 tile per block, 4 x 4 outputs a thread
// (rows ty + 16 i, columns tx + 16 j), contraction staged 16 at a time;
// each output is one sequential fmaf chain over K
constexpr int kFT = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int M, int N, int K, Group grp) {
  __shared__ float sA[kFK][kFT + 4];
  __shared__ float sB[kFK][kFT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int e = blockIdx.z;
  x += e * grp.x_stride;
  w += e * grp.w_stride;
  y += e * grp.y_stride;
  const int live = live_rows(grp.counts, e, M);
  const int row0 = blockIdx.y * kFT, col0 = blockIdx.x * kFT;
  float acc[4][4] = {};
  if (row0 < live) {
    for (int k0 = 0; k0 < K; k0 += kFK) {
      for (int i = tid; i < kFT * kFK; i += kThreads) {
        const int r = i / kFK, kk = i % kFK;
        const int gr = row0 + r, gk = k0 + kk;
        sA[kk][r] = (gr < live && gk < K)
                        ? x[static_cast<size_t>(gr) * K + gk] : 0.f;
      }
      for (int i = tid; i < kFK * kFT; i += kThreads) {
        const int kk = i / kFT, c = i % kFT;
        const int gk = k0 + kk, gc = col0 + c;
        sB[kk][c] = (gk < K && gc < N)
                        ? w[static_cast<size_t>(gk) * N + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty + 16 * i, col = col0 + tx + 16 * j;
      if (row < M && col < N)
        y[static_cast<size_t>(row) * N + col] = row < live ? acc[i][j] : 0.f;
    }
}

// --------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t with_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// E experts of M rows each (K11: E = 1 with an empty Group)
template <typename TX, int FMT, bool AMAX>
cudaError_t qmm_launch(const void* x, const void* w_t, const float* sx,
                       const float* sw, void* y, float* amax, int M, int N,
                       int K, int E, Group grp, cudaStream_t stream) {
  auto kernel = qmm_kernel<TX, FMT, AMAX>;
  const size_t smem = qmm_smem<TX>();
  cudaError_t err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(ceil_div(M, kBM) * (N / kBN), 1, E), kThreads, smem,
           stream>>>(static_cast<const TX*>(x),
                     static_cast<const uint8_t*>(w_t), sx, sw,
                     static_cast<TX*>(y), amax, M, N, K, grp);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t qmm_dispatch(int fmt, int amax, const void* x, const void* w_t,
                         const float* sx, const float* sw, void* y,
                         float* amax_out, int M, int N, int K, int E,
                         Group grp, cudaStream_t st) {
  if (fmt == kInt8)
    return amax ? qmm_launch<TX, kInt8, true>(x, w_t, sx, sw, y, amax_out, M,
                                              N, K, E, grp, st)
                : qmm_launch<TX, kInt8, false>(x, w_t, sx, sw, y, amax_out,
                                               M, N, K, E, grp, st);
  if (fmt == kE4M3)
    return amax ? qmm_launch<TX, kE4M3, true>(x, w_t, sx, sw, y, amax_out, M,
                                              N, K, E, grp, st)
                : qmm_launch<TX, kE4M3, false>(x, w_t, sx, sw, y, amax_out,
                                               M, N, K, E, grp, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K11: y [M, N] (x's dtype) = quant(x [M, K] / sx) . w_t [N, K]^T, times
// sx * sw; with amax != 0, also max |x| into amax_out (a zeroed f32
// scalar).  sx and sw are f32 scalars on the card.
int dlnb_qmm(int dtype, int fmt, int amax, const void* x, const void* w_t,
             const float* sx, const float* sw, void* y, float* amax_out,
             int M, int N, int K, void* stream) {
  if (M % kBM || N % kBN || K % kQK || (amax && amax_out == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const Group one = {nullptr, 0, 0, 0};
  if (dtype == kBF16)
    return qmm_dispatch<bf16>(fmt, amax, x, w_t, sx, sw, y, amax_out, M, N,
                              K, 1, one, st);
  if (dtype == kF32)
    return qmm_dispatch<float>(fmt, amax, x, w_t, sx, sw, y, amax_out, M, N,
                               K, 1, one, st);
  return cudaErrorInvalidValue;
}

// K9: dg, du [T, F] bf16 from dy [T, D], Wd [F, D], g, u [T, F] (bf16)
int dlnb_dgdu(const void* dy, const void* wd, const void* g, const void* u,
              void* dg, void* du, int T, int F, int D, void* stream) {
  if (T % kBM || F % kBN || D % kBK) return cudaErrorInvalidValue;
  const size_t smem = dgdu_smem();
  cudaError_t err = with_smem(dgdu_kernel, smem);
  if (err != cudaSuccess) return err;
  dgdu_kernel<<<(T / kBM) * (F / kBN), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<bf16*>(dg), static_cast<bf16*>(du), T, F, D);
  return cudaGetLastError();
}

// K10: dWd [F, D] f32 = (bf16(silu(g) * u))^T . dy over T; g, u [T, F],
// dy [T, D] bf16
int dlnb_dwd(const void* g, const void* u, const void* dy, float* dwd,
             int T, int F, int D, void* stream) {
  if (T % kTK || F % kBM || D % kBN) return cudaErrorInvalidValue;
  const size_t smem = dwd_smem();
  cudaError_t err = with_smem(dwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dwd_kernel<<<(F / kBM) * (D / kBN), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<const bf16*>(dy), dwd, T, F, D);
  return cudaGetLastError();
}

// K12: y [E, M, N] (x's dtype) = x [E, M, K] . w per expert, every row at
// or past counts[e] (int32 [E] on the card; null: none) zero.  fmt < 0: w
// [E, K, N] in x's dtype (bf16: N % 256 == 0, K % 64 == 0; f32: any shape).
// fmt int8 / e4m3: w_t [E, N, K] quantized (K-major), sx and sw f32 [E] on
// the card, N % 256 == 0, K % 64 == 0.  M is free: rows past it are never
// read.
int dlnb_gmm(int dtype, int fmt, const void* x, const void* w,
             const int* counts, const float* sx, const float* sw, void* y,
             int E, int M, int N, int K, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || E > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const size_t mk = static_cast<size_t>(M) * K,
               kn = static_cast<size_t>(K) * N,
               mn = static_cast<size_t>(M) * N;
  const Group grp = {counts, mk, kn, mn};
  if (fmt >= 0) {
    if (N % kBN || K % kQK || sx == nullptr || sw == nullptr)
      return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return qmm_dispatch<bf16>(fmt, 0, x, w, sx, sw, y, nullptr, M, N, K, E,
                                grp, st);
    if (dtype == kF32)
      return qmm_dispatch<float>(fmt, 0, x, w, sx, sw, y, nullptr, M, N, K,
                                 E, grp, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == kBF16) {
    if (N % kBN || K % kBK) return cudaErrorInvalidValue;
    const size_t smem = gmm_smem();
    cudaError_t err = with_smem(gmm_bf16_kernel, smem);
    if (err != cudaSuccess) return err;
    gmm_bf16_kernel<<<dim3(ceil_div(M, kBM) * (N / kBN), 1, E), kThreads,
                      smem, st>>>(static_cast<const bf16*>(x),
                                  static_cast<const bf16*>(w),
                                  static_cast<bf16*>(y), M, N, K, grp);
    return cudaGetLastError();
  }
  if (dtype == kF32) {
    if (ceil_div(M, kFT) > 65535) return cudaErrorInvalidValue;
    gmm_f32_kernel<<<dim3(ceil_div(N, kFT), ceil_div(M, kFT), E), kThreads, 0,
                     st>>>(static_cast<const float*>(x),
                           static_cast<const float*>(w),
                           static_cast<float*>(y), M, N, K, grp);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
