// The MLP GEMMs of the quantized and fused-backward SwiGLU recipes and of
// the MoE expert FFN, for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package:
//   K11 ops/quantized_matmul.py::_fused_matmul_kernel (:112, pallas_call
//       :230) — x [T, K] (bf16 or f32 master) @ pre-quantized w [K, N]
//       (int8 or e4m3) -> [T, N] in x's dtype: x quantized in the
//       kernel against a provided scale, int32 (int8) or f32 (e4m3)
//       accumulation, the sx * sw epilogue in registers, and optionally
//       max |x| over the whole tensor (the delayed-scaling state);
//   K12 ops/grouped_matmul.py::_grouped_kernel (:82, pallas_call :206) — the
//       MoE expert FFN's grouped product, x [E, C, K] . w [E, K, N] -> [E, C,
//       N] per expert, every row at or past the expert's count counts[e]
//       zero; bf16, and int8 / e4m3 as K11 over the experts (a per-expert
//       scale sx[e] for the quantization, sx[e] * sw[e] in the epilogue,
//       the weight K-major per expert); f32 on the CUDA cores
//       (gmm_f32_kernel, any shape, the f32 reference phases only);
//   K9  ops/mlp_backward.py::_dgdu_kernel (:50, pallas_call :73) — dg, du
//       [T, F] bf16 from dh = dy [T, D] . Wd [F, D]^T kept in f32
//       registers and the saved g, u: dg = dh * u * silu'(g),
//       du = dh * silu(g);
//   K10 ops/mlp_backward.py::_dwd_kernel (:103, pallas_call :131) — dWd
//       [F, D] f32 = h^T . dy over T, h = bf16(silu(g) * u) recomputed per
//       tile in the prologue.
//
// K11 and K12 (bf16, int8, e4m3) are one warp-specialised template,
// wg_gemm_kernel (K11 is K12 with one expert and every row live): TMA
// loads into rings of mbarrier-guarded stages, wgmma.mma_async in two
// consumer warpgroups, a producer warp, and for the 8-bit formats a
// quantizer warpgroup whose work a thread-block cluster shares along N;
// persistent over the live tiles.  Its own comment below has the design.
//
// K9 and K10 keep the first skeleton: a 128 x 256 output tile per block
// of 8 warps (2 along M x 4 along N, 64 x 64 each; one block per SM),
// the block's tile chosen by a grouped raster (8 row tiles share each
// column sweep), operands staged through a ring of shared-memory stages
// filled by 16-byte cp.async, fragments read with ldmatrix (rows padded
// by 16 bytes) and multiplied with mma.sync.  Each adds its own
// prologue (K10's recomputed h tile, written to one of two buffers while
// the tensor cores drain the other) and epilogue.  K9's operands are
// both D-contiguous (row.col as they lie); K10's are both T-major, so
// its fragments come through ldmatrix.trans.
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
//   K12: as K11 per expert; bf16 sums in f32, one rounding to bf16; dead
//        rows are zeros.  e4m3 sums (K11, K12) are promoted to f32
//        registers every 128 products (see the skeleton's comment).
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
// operands at 1979 T/s int8/e4m3: 0.729 ms, bound by operations; its
// quantization (x / sx, clip, convert, pack: ~13 f32 instructions an
// element) is ALU work on top, which the cluster divides by its size.
// K9 on 1.63 GB and K10 on 1.04 GB at 989 TFLOP/s bf16: 1.459 ms each,
// bound by operations.
//
// K12 at the MoE bench shape (E = 8 experts of C = 1280 slots, D = 4096,
// F = 7168): 2 * E * C * D * F = 6.01e11 operations a product, 0.608 ms at
// the bf16 peak (0.70 GB moved, 0.21 ms), 0.304 ms at the int8/e4m3 peak;
// bound by operations.  Rows past a count cost no operations and no
// reads: a row tile wholly past it is only written (zeros).
//
// Plain C interface (nvcc -> .so -> ctypes): the wrappers
// (ops/quantized_matmul.py, ops/mlp_backward.py, ops/grouped_matmul.py)
// check device, dtype, shapes, contiguity and alignment before calling;
// each entry returns the cudaError_t of its launch.

#include <cuda.h>            // CUtensorMap (types only: no -lcuda)
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

constexpr int kThreads = 256;          // K9/K10: 8 warps, 2 (M) x 4 (N)
constexpr int kBM = 128, kBN = 256;    // block tile (every kernel but f32)
constexpr int kWM = 64, kWN = 64;      // K9/K10 warp tile: 4 m16 x 8 n8
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

// K12's f32 launch: blockIdx.z is the expert, whose operands sit
// `stride` elements after the previous expert's; counts[e] (nullptr:
// every row) bounds its live rows (live_rows, shared with the wgmma
// kernel's schedule).
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

// --------------------------------------------------- K11 quantization

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
    // adding 1.5 * 2^23 rounds a value of [-127, 127] to an integer, half
    // to even (the sum's ulp is 1), and leaves it, two's complement, in
    // the low byte: the code of __float2int_rn at the cost of one add
    uint32_t c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = __float_as_uint(
          __fadd_rn(fminf(fmaxf(q[i], -127.f), 127.f), 12582912.f));
    return __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                       __byte_perm(c[2], c[3], 0x0040), 0x5410);
  }
  const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(q[0], q[1]),
                                               __NV_SATFINITE, __NV_E4M3);
  const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(q[2], q[3]),
                                               __NV_SATFINITE, __NV_E4M3);
  return lo | (hi << 16);
}

// ------------------------------------------ K11 / K12: the wgmma skeleton
//
// One output tile is 128 x 256.  A block is three warpgroups (384
// threads: a 64 x 256 f32 accumulator is 128 registers a thread, more
// than the 128 a thread of a 512-thread block may hold), whose roles
// never share a barrier with __syncthreads:
//   WG 0, warp 0  producer: one thread issues the TMA loads of each
//         stage (the x tile and the weight tile) into rings of
//         shared-memory stages, each with a full / empty mbarrier pair;
//   WG 0, warps 1-3  quantizer (8-bit formats only): turns each landed
//         x stage (bf16 or f32 master) into the 8-bit A stage, written
//         in the same 128-byte swizzled K-major layout that wgmma reads,
//         and folds |x| into amax;
//   WG 1, WG 2  consumers: rows 0-63 and 64-127 of the tile, 64 x 256
//         each, four wgmma.mma_async a stage from the A and W stages in
//         shared memory (128-byte swizzled, as TMA writes them), one
//         group in flight while the previous stage is released; then
//         the epilogue from registers.
// setmaxnreg moves registers from WG 0 to the consumers.  The bf16
// grouped product (K12 bf16) has no quantizer: the producer loads A (x)
// with TMA beside W.
//
// A stage is 128 bytes of contraction a row: 64 bf16 or 128 8-bit
// values.  The 8-bit contract is K % 64 == 0, so the last stage may be
// half full: TMA fills a box's columns past K with zeros (both x and
// w), which quantize to zero codes and add nothing.
//
// Clusters: kPairM (2) rows of CL (1, 2 or 4) blocks.  A cluster takes
// a pair of row tiles and CL neighbouring column tiles.
// - The blocks of a column share each W stage: each loads its half with
//   a TMA multicast into both blocks' stage, so the weight crosses from
//   L2 once per pair of row tiles (at CL = 4 the W tiles' L2-to-SM
//   traffic bounded the kernel).  A W stage is free again when the
//   consumers of both blocks have released it.
// - The blocks of a row share the quantization (8-bit formats): each
//   loads 128 / CL rows of the x stage, quantizes them into its own A
//   stage and sends them to its row peers' with one bulk copy each
//   (distributed shared memory, completing as transaction bytes on the
//   peer's mbarrier); an A stage is full when its own rows are written
//   and the peers' bytes have landed, and free again when all 2 * CL
//   consumer warpgroups of the row have released it.  So each x element
//   is quantized once per CL column tiles, not once per column tile.
//
// e4m3 sums: the fp8 tensor-core path keeps fewer than 32 bits of the
// running sum (DeepSeek-V3's report, arXiv 2412.19437, 3.3.2), which at
// K = 14336 broke the 2^-6 row bar on an H100.  So each 128-deep stage
// is summed on the tensor cores from zero, in two 64 x 128 halves, and
// added into the f32 accumulator in registers (that report's interval).
//
// Persistent schedule: the grid is as many clusters as fit on the card;
// cluster c takes units c, c + G, c + 2G, ... of the live units in
// order, a unit being (expert, pair of row tiles, CL column tiles).  An
// expert's live pairs are ceil(min(count, M) / 256); its units are
// ordered by tile_of (groups of 8 pairs sweep the columns).  The counts
// are read on the card; the host never waits for them.  Row tiles past
// an expert's last pair never reach a role: the consumers write their
// zeros after their last unit, dead tile d by block d mod grid.  A
// computed tile's rows past the count are loaded (they lie inside the
// buffer; past it TMA reads zeros) but the epilogue writes zeros there,
// and a row of a product depends on that row of A alone.  The rings carry on from one unit to the next, so
// the producer and quantizer run ahead into the next unit's stages
// while the consumers write the epilogue.  ops/grouped_matmul.py's
// tile_schedule is this schedule in plain Python (tested).
//
// amax (K11's collect_amax): each quantizer folds |x| only in units of
// column tile 0 (tu == 0); with its slice of rows, that covers every x
// element exactly once.  One atomicMax on the f32 bits a warp at the
// end.

constexpr int kRowBytes = 128;        // contraction bytes a stage row
constexpr int kQ8K = 128;             // 8-bit contraction a stage
constexpr int kBf16K = 64;            // bf16 contraction a stage
constexpr int kStageA = 16384;        // A stage: kBM rows x kRowBytes
constexpr int kStageW = 32768;        // W stage: kBN x kRowBytes (8-bit),
                                      // kBf16K x kBN x 2 (bf16)
constexpr int kMaxWStages = 6;
constexpr int kSmemBudget = 230400;   // the rings' share of 232448 bytes
constexpr int kSmemExtra = 2048;      // barriers and 1024-byte alignment
constexpr int kWgThreads = 384;       // producer + quantizer, 2 consumers
constexpr int kQuantWarps = 3;        // warps 1-3 of WG 0
// setmaxnreg, registers a thread: what WG 0 gives back, the consumers
// take, out of the block's pool at launch (384 x 168 = 64512; an inc
// past it waits for ever)
constexpr int kRegLoader = 120;       // WG 0, int8 (with the quantizer)
constexpr int kRegConsumer = 192;     //   and the consumers
constexpr int kRegLoaderE4M3 = 88;    // WG 0, e4m3, and the consumers, who
constexpr int kRegConsumerE4M3 = 208; //   also hold the promotion's sums
constexpr int kRegProducer = 40;      // WG 0, bf16 (no quantizer)
constexpr int kRegConsumerBf16 = 232; //   and the consumers
constexpr int kNoQuant = 2;           // FMT of the bf16 grouped product
constexpr int kPairM = 2;             // row tiles a cluster pairs: they
                                      // share each W stage (multicast)

// 8-bit: the depths of the x and A rings.  A cluster adds a bulk copy
// and the peers' releases to each A stage's round trip, so its rings
// are deeper (and its x stages smaller)
template <int CL>
__host__ __device__ constexpr int x_stages() {
  return CL == 1 ? 2 : CL == 2 ? 3 : 4;
}

template <int CL>
__host__ __device__ constexpr int a_stages() {
  return CL == 1 ? 2 : 4;
}

template <typename TX, int CL>
__host__ __device__ constexpr int x_stage_bytes() {
  return kBM / CL * kQ8K * static_cast<int>(sizeof(TX));
}

template <typename TX, int FMT, int CL>
__host__ __device__ constexpr int w_stages() {
  return FMT == kNoQuant
             ? kSmemBudget / (kStageA + kStageW)
             : (kSmemBudget - x_stages<CL>() * x_stage_bytes<TX, CL>() -
                a_stages<CL>() * kStageA) / kStageW < kMaxWStages
                   ? (kSmemBudget - x_stages<CL>() * x_stage_bytes<TX, CL>() -
                      a_stages<CL>() * kStageA) / kStageW
                   : kMaxWStages;
}

template <typename TX, int FMT, int CL>
__host__ __device__ constexpr size_t wg_smem() {
  return kSmemExtra + static_cast<size_t>(w_stages<TX, FMT, CL>()) *
                          (kStageW + (FMT == kNoQuant ? kStageA : 0)) +
         (FMT == kNoQuant ? 0
                          : static_cast<size_t>(a_stages<CL>()) * kStageA +
                                x_stages<CL>() * x_stage_bytes<TX, CL>());
}

// ------------------------------------------------ mbarrier, TMA, cluster

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive on the barrier at bar's offset in block `rank` of the cluster.
// Only consumers use it, to free an A stage once their wgmma reads of
// it have retired (wgmma.wait_group): nothing written needs publishing,
// so the default (cta-scope) semantics do, as in CUTLASS's pipelines;
// the A rows themselves reach a peer as bulk-copy transaction bytes
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar,
                                                 uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a 3-D box of a tensor map -> shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// tma_load into the same offset of every block of the cluster in
// `mask` (bit r: block r), each completing on its own barrier at bar's
// offset
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// `bytes` of this block's shared memory at `src` -> the same offset in
// block `rank` of the cluster, completing (transaction bytes) on the
// barrier at bar's offset there
__device__ __forceinline__ void bulk_to_peer(const void* src, int bytes,
                                             uint64_t* bar,
                                             uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 rd, rb;\nmapa.shared::cluster.u32 rd, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [rd], [%0], %3, [rb];\n}\n" ::"r"(smem_addr(src)),
      "r"(smem_addr(bar)), "r"(rank), "r"(bytes)
      : "memory");
}

// the quantizer warps' own barrier (0 is __syncthreads')
__device__ __forceinline__ void quantizer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kQuantWarps * 32) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma and the
// bulk copies (the async proxy) once the barrier that follows is passed
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void reg_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------- wgmma

// shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).  K-major tiles (A,
// and the 8-bit W): rows of 128 bytes, 8-row core groups 1024 bytes
// apart (the leading offset unused).  The N-major bf16 W: each 8 x 64
// core is 8 K rows of 128 bytes; 64-column panels lie 8192 bytes apart
// (leading), 8-row K groups 1024 (stride).  A K step within the swizzle
// row moves the start address (32 bytes: 16 bf16 or 32 8-bit values);
// every stage is 1024-byte aligned, so the swizzle phase is the row's.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, int lead,
                                               int stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma that is in flight
__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 128 accumulator registers of one thread, as asm operands
#define WG_ACC_F(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
  "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
  "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
  "+f"(d[126]), "+f"(d[127])

#define WG_ACC_R(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
  "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
  "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), \
  "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
  "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), \
  "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
  "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
  "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
  "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), \
  "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), \
  "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), \
  "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
  "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), \
  "+r"(d[126]), "+r"(d[127])

// d (64 x 256, f32) += A (64 x 16 bf16, K-major) * B (16 x 256 bf16,
// N-major: the transpose bit of B set); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC_F(d)
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 256, s32, exact) += A (64 x 32 int8) * B (32 x 256 int8), both
// K-major
__device__ __forceinline__ void wgmma_q8(int (&d)[128], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : WG_ACC_R(d)
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

#define WG_ACC64_F(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 32 e4m3) * B (32 x 128
// e4m3), both K-major: K11/K12 e4m3's partial sums, promoted into the
// f32 accumulator once a stage
__device__ __forceinline__ void wgmma_e4m3_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : WG_ACC64_F(d)
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// A cluster is kPairM rows of CL blocks: block rank = my * CL + nx takes
// row tile tm + my and column tile tu * CL + nx of a unit.  The blocks of
// a row share the quantized A stage, those of a column the W stage.

// a consumer warp is done with an A stage: tell every quantizer of its
// row (each sends its rows into this block's copy), ranks row0 ..
template <int CL>
__device__ __forceinline__ void release_a(uint64_t* bar, uint32_t row0) {
  if constexpr (CL == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (int p = 0; p < CL; ++p) mbar_arrive_peer(bar, row0 + p);
  }
}

// ... and with a W stage: tell the producer of every block of its column
// (each multicasts its part of W into this block's copy)
template <int CL>
__device__ __forceinline__ void release_w(uint64_t* bar, uint32_t nx) {
#pragma unroll
  for (int m = 0; m < kPairM; ++m) mbar_arrive_peer(bar, nx + m * CL);
}

// ------------------------------------------------- persistent schedule

// the live units (expert, pair of row tiles, CL column tiles) and the
// dead tiles (row tiles no unit covers: wholly past a count, and past
// the pair that holds the last live row tile) of one launch, read alike
// by every role; ops/grouped_matmul.py's tile_schedule models it
struct Sched {
  const int* counts;
  int E, M, NT, CL;

  __device__ __forceinline__ int live_pairs(int e) const {
    return ceil_div(live_rows(counts, e, M), kPairM * kBM);
  }
  __device__ __forceinline__ int units() const {
    int u = 0;
    for (int e = 0; e < E; ++e) u += live_pairs(e);
    return u * (NT / CL);
  }
  // unit u -> expert, first row tile of its pair, column unit
  __device__ __forceinline__ void unit(int u, int& e, int& tm,
                                       int& tu) const {
    const int nu = NT / CL;
    for (e = 0; e < E - 1; ++e) {
      const int n = live_pairs(e) * nu;
      if (u < n) break;
      u -= n;
    }
    tile_of(u, live_pairs(e), nu, tm, tu);
    tm *= kPairM;
  }
  __device__ __forceinline__ int dead_rows(int e) const {  // row tiles
    return max(ceil_div(M, kBM) - kPairM * live_pairs(e), 0);
  }
  __device__ __forceinline__ int dead() const {
    int d = 0;
    for (int e = 0; e < E; ++e) d += dead_rows(e) * NT;
    return d;
  }
  __device__ __forceinline__ void dead_tile(int d, int& e, int& tm,
                                            int& tn) const {
    for (e = 0; e < E - 1; ++e) {
      const int n = dead_rows(e) * NT;
      if (d < n) break;
      d -= n;
    }
    tm = kPairM * live_pairs(e) + d / NT;
    tn = d % NT;
  }
};

// a ring's slot and the parity of its current round
struct Ring {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// the quantizer warps (thread qt of kQuantWarps * 32): each landed x
// stage -> this block's 128 / CL rows of the 8-bit A stage, in every
// block of its cluster row; |x| folded into amax in units of column
// tile 0
template <typename TX, int FMT, int CL>
__device__ __forceinline__ void quantize(
    const Sched& sc, int first, int step, int nk, unsigned char* sX,
    unsigned char* sA, uint64_t* full_x, uint64_t* empty_x,
    uint64_t* full_a, uint64_t* empty_a, const float* __restrict__ sx_p,
    float* __restrict__ amax_out, uint32_t nx, uint32_t row0, int qt) {
  constexpr int XB = x_stage_bytes<TX, CL>();
  constexpr int R = kBM / CL;
  constexpr int kQT = kQuantWarps * 32;
  const int lane = qt % 32;
  const int units = sc.units();
  Ring x, a;
  float amax = 0.f;
  for (int u = first; u < units; u += step) {
    int e, tm, tu;
    sc.unit(u, e, tm, tu);
    const float sx = sx_p[e];
    const float r = __frcp_rn(sx);
    const bool fold = amax_out != nullptr && tu == 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full_x[x.slot], x.phase);
      mbar_wait(&empty_a[a.slot], a.phase ^ 1);
      const TX* src = reinterpret_cast<const TX*>(sX + x.slot * XB);
      unsigned char* dst = sA + a.slot * kStageA;
      // eight values a thread a pass: row f / 16, 16-byte chunk
      // (f % 16) / 2 of the 8-bit row, its half f % 2
#pragma unroll 2
      for (int f = qt; f < R * 16; f += kQT) {
        const int row = f >> 4, g = f & 15;
        float v[8];
        load8(v, src + row * kQ8K + g * 8);
        if (fold) {
#pragma unroll
          for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
        }
        const uint32_t lo = quant4<FMT>(v, sx, r);
        const uint32_t hi = quant4<FMT>(v + 4, sx, r);
        const int arow = static_cast<int>(nx) * R + row;
        const int off = arow * kRowBytes +
                        ((((g >> 1) ^ arow) & 7) << 4) + (g & 1) * 8;
        *reinterpret_cast<uint2*>(dst + off) = make_uint2(lo, hi);
      }
      fence_to_async();
      quantizer_sync();
      if (qt == 0) {
        mbar_arrive(&empty_x[x.slot]);
        if constexpr (CL == 1) {
          mbar_arrive(&full_a[a.slot]);
        } else {
          // this block's rows to every peer of its row, one bulk copy
          // each; the peers' rows arrive here the same way
          const unsigned char* mine = dst + nx * R * kRowBytes;
#pragma unroll
          for (int p = 1; p < CL; ++p)
            bulk_to_peer(mine, R * kRowBytes, &full_a[a.slot],
                         row0 + (nx + p) % CL);
          mbar_expect_tx(&full_a[a.slot], (CL - 1) * R * kRowBytes);
        }
      }
      x.next(x_stages<CL>());
      a.next(a_stages<CL>());
    }
  }
  if (amax_out != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(amax_out), __float_as_int(amax));
  }
}

// K11 (E = 1, counts null) and K12: y [E, M, N] (TX) = x [E, M, K] . w
// per expert.  FMT int8 / e4m3: x is quantized against sx[e], w_t [E, N,
// K] 8-bit, the epilogue multiplies by sx[e] * sw[e].  FMT kNoQuant: x
// and w [E, K, N] bf16.  map_x and map_w are the TMA maps of x and w
// (3-D, the expert outermost).
template <typename TX, int FMT, int CL>
__global__ void __launch_bounds__(kWgThreads, 1)
    wg_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ sx_p,
                   const float* __restrict__ sw_p, TX* __restrict__ y,
                   float* __restrict__ amax_out,
                   const int* __restrict__ counts, int E, int M, int N,
                   int K) {
  constexpr bool kQuant = FMT != kNoQuant;
  constexpr int SW = w_stages<TX, FMT, CL>();
  constexpr int SA = kQuant ? a_stages<CL>() : SW;
  constexpr int SX = x_stages<CL>();
  constexpr int XB = x_stage_bytes<TX, CL>();
  constexpr int R = kBM / CL;             // x rows this block quantizes
  using Acc = typename std::conditional<FMT == kInt8, int, float>::type;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_w = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty_w = full_w + SW;
  uint64_t* full_a = empty_w + SW;        // 8-bit only
  uint64_t* empty_a = full_a + SA;
  uint64_t* full_x = empty_a + SA;
  uint64_t* empty_x = full_x + SX;
  unsigned char* sW = base + 1024;
  unsigned char* sA = sW + SW * kStageW;
  unsigned char* sX = sA + SA * kStageA;  // 8-bit only

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const uint32_t nx = rank % CL, my = rank / CL, row0 = my * CL;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SW; ++s) {
      mbar_init(&full_w[s], 1);          // + the column's W parts, bytes
      mbar_init(&empty_w[s], 8 * kPairM);  // the column's consumer warps
    }
    if constexpr (kQuant) {
      for (int s = 0; s < SA; ++s) {
        mbar_init(&full_a[s], 1);        // + the peers' rows, as bytes
        mbar_init(&empty_a[s], 8 * CL);  // each consumer warp
      }
      for (int s = 0; s < SX; ++s) {
        mbar_init(&full_x[s], 1);
        mbar_init(&empty_x[s], 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                         // peers' barriers exist

  const Sched sc = {counts, E, M, N / kBN, CL};
  const int units = sc.units();
  constexpr int kCluster = CL * kPairM;
  const int first = blockIdx.x / kCluster, step = gridDim.x / kCluster;
  // this block's column in the cluster's column tiles, and the blocks
  // of its column (who share each W stage)
  const uint16_t column = static_cast<uint16_t>((1u << nx) |
                                                (1u << (nx + CL)));
  const int nk = kQuant ? ceil_div(K, kQ8K) : K / kBf16K;

  if (wg == 0) {
    reg_release<FMT == kInt8   ? kRegLoader
                : FMT == kE4M3 ? kRegLoaderE4M3
                               : kRegProducer>();
    if (tid == 0) {
      // --------------------------------------------------- producer
      Ring w, x;
      for (int u = first; u < units; u += step) {
        int e, tm, tu;
        sc.unit(u, e, tm, tu);
        const int tn = tu * CL + static_cast<int>(nx);
        const int row = (tm + static_cast<int>(my)) * kBM;
        for (int kt = 0; kt < nk; ++kt) {
          if constexpr (kQuant) {            // x first: the quantizer
            mbar_wait(&empty_x[x.slot], x.phase ^ 1);  // runs ahead
            mbar_expect_tx(&full_x[x.slot], XB);
            tma_load(sX + x.slot * XB, &map_x, &full_x[x.slot], kt * kQ8K,
                     row + static_cast<int>(nx) * R, e);
            x.next(SX);
          }
          // W: this block loads its 1 / kPairM of the stage (rows of the
          // 8-bit w_t, 64-column panels of the bf16 w) into every block
          // of its column, once their consumers are all done with it
          mbar_wait(&empty_w[w.slot], w.phase ^ 1);
          unsigned char* ws = sW + w.slot * kStageW;
          if constexpr (kQuant) {
            mbar_expect_tx(&full_w[w.slot], kStageW);
            tma_load_multicast(ws + my * (kStageW / kPairM), &map_w,
                               &full_w[w.slot], kt * kQ8K,
                               tn * kBN + my * (kBN / kPairM), e, column);
          } else {
            mbar_expect_tx(&full_w[w.slot], kStageA + kStageW);
            tma_load(sA + w.slot * kStageA, &map_x, &full_w[w.slot],
                     kt * kBf16K, row, e);
#pragma unroll
            for (int j = 0; j < kBN / 64 / kPairM; ++j) {  // its panels
              const int panel = my * (kBN / 64 / kPairM) + j;
              tma_load_multicast(ws + panel * (kStageW / 4), &map_w,
                                 &full_w[w.slot], tn * kBN + panel * 64,
                                 kt * kBf16K, e, column);
            }
          }
          w.next(SW);
        }
      }
    }
    if constexpr (kQuant) {
      if (tid >= 32)
        quantize<TX, FMT, CL>(sc, first, step, nk, sX, sA, full_x, empty_x,
                              full_a, empty_a, sx_p, amax_out, nx, row0,
                              tid - 32);
    }
    cluster_sync();
  } else {
    // ---------------------------------------------------- consumers
    reg_claim<FMT == kInt8   ? kRegConsumer
              : FMT == kE4M3 ? kRegConsumerE4M3
                             : kRegConsumerBf16>();
    const int ci = wg - 1, warp = tid / 32, lane = tid % 32;
    Acc d[128];
    Ring w, a;
    for (int u = first; u < units; u += step) {
      int e, tm, tu;
      sc.unit(u, e, tm, tu);
      tm += static_cast<int>(my);
      const int tn = tu * CL + static_cast<int>(nx);
      int w_prev = 0, a_prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full_w[w.slot], w.phase);
        const int as = kQuant ? a.slot : w.slot;
        if constexpr (kQuant) mbar_wait(&full_a[a.slot], a.phase);
        const uint32_t a0 =
            smem_addr(sA + as * kStageA + ci * 64 * kRowBytes);
        const uint32_t b0 = smem_addr(sW + w.slot * kStageW);
        if constexpr (FMT == kE4M3) {
          // e4m3: the tensor cores keep fewer than 32 bits of the sum;
          // each stage's products (128 deep) are summed there from zero
          // and promoted into d in f32, one 128-column half at a time
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float part[64];
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_e4m3_n128(part, sw128_desc(a0 + ks * 32, 16, 1024),
                              sw128_desc(b0 + h * 128 * kRowBytes + ks * 32,
                                         16, 1024),
                              ks > 0);
            wgmma_commit();
            acc_fence(part);
            wgmma_wait<0>();
            acc_fence(part);
#pragma unroll
            for (int i = 0; i < 64; ++i)
              d[64 * h + i] = kt > 0 ? d[64 * h + i] + part[i] : part[i];
          }
        } else {
          wgmma_fence();
          acc_fence(d);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t da = sw128_desc(a0 + ks * 32, 16, 1024);
            if constexpr (kQuant) {
              wgmma_q8(d, da, sw128_desc(b0 + ks * 32, 16, 1024),
                       kt > 0 || ks > 0);
            } else {
              wgmma_bf16(d, da,
                         sw128_desc(b0 + ks * 16 * kRowBytes, kStageW / 4,
                                    1024),
                         kt > 0 || ks > 0);
            }
          }
          wgmma_commit();
          acc_fence(d);
          wgmma_wait<1>();               // stage kt - 1 has retired
        }
        if (kt > 0 && lane == 0) {
          release_w<CL>(empty_w + w_prev, nx);
          if constexpr (kQuant) release_a<CL>(empty_a + a_prev, row0);
        }
        w_prev = w.slot;
        a_prev = a.slot;
        w.next(SW);
        if constexpr (kQuant) a.next(SA);
      }
      wgmma_wait<0>();
      acc_fence(d);
      if (lane == 0) {
        release_w<CL>(empty_w + w_prev, nx);
        if constexpr (kQuant) release_a<CL>(empty_a + a_prev, row0);
      }

      // epilogue: float(acc) * (sx * sw) in x's dtype; rows at or past
      // the live count are zeros, rows past the buffer are not written.
      // d[4j + 2h + i] is row lane/4 + 8h, column 8j + 2(lane%4) + i of
      // the warp's 16 x 256 slice
      const float s_out = kQuant ? sx_p[e] * sw_p[e] : 1.f;
      const int live = live_rows(counts, e, M);
      TX* ye = y + static_cast<size_t>(e) * M * N;
      const int row0 = tm * kBM + ci * 64 + warp * 16 + lane / 4;
      const int col0 = tn * kBN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          const bool on = row < live;
          const float v0 = to_f32(d[4 * j + 2 * h]) * s_out;
          const float v1 = to_f32(d[4 * j + 2 * h + 1]) * s_out;
          store2(ye + static_cast<size_t>(row) * N + col0 + 8 * j,
                 on ? v0 : 0.f, on ? v1 : 0.f);
        }
    }
    // the dead row tiles' zeros, dead tile t by block t mod grid
    const int dead = sc.dead();
    for (int t = blockIdx.x; t < dead; t += gridDim.x) {
      int e, tm, tn;
      sc.dead_tile(t, e, tm, tn);
      zero_tile(y + static_cast<size_t>(e) * M * N, M, N, tm, tn,
                threadIdx.x - 128);
    }
    cluster_sync();
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

// ---------------------------------------------------- TMA maps, launch

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the map of a [d2][d1][d0] tensor (d0 contiguous) read in boxes of b0 x
// b1 x 1; out-of-bounds elements read as zeros
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType dt,
                     const void* ptr, size_t elt, uint64_t d0, uint64_t d1,
                     uint64_t d2, uint32_t b0, uint32_t b1,
                     CUtensorMapSwizzle sw) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elt, d0 * d1 * elt};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = enc(map, dt, 3, const_cast<void*>(ptr), dims, strides,
                         box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// the cluster size the 8-bit launches prefer (dlnb_qmm_set_cluster); a
// launch takes the largest of it, half of it, ... that divides N / 256
int g_cluster = 4;

// E experts of M rows; counts null: every row live
template <typename TX, int FMT, int CL>
cudaError_t wg_launch(const void* x, const void* w, const float* sx,
                      const float* sw, void* y, float* amax,
                      const int* counts, int E, int M, int N, int K,
                      cudaStream_t stream) {
  auto kernel = wg_gemm_kernel<TX, FMT, CL>;
  constexpr size_t smem = wg_smem<TX, FMT, CL>();
  constexpr bool kQuant = FMT != kNoQuant;
  static_assert(smem <= 232448, "shared memory");
  CUtensorMap mx, mw;
  cudaError_t err;
  if constexpr (kQuant) {
    err = make_map(&mx, sizeof(TX) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   x, sizeof(TX), K, M, E, kQ8K, kBM / CL,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 1, K, N, E,
                     kQ8K, kBN / kPairM, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    err = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, K, M, E,
                   kBf16K, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, N, K, E,
                     64, kBf16K, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = with_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = CL * kPairM;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(sm_count() / (CL * kPairM) * (CL * kPairM));
  // persistent: as many clusters as fit at once, or as there are units
  static const int fit = [&] {
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess &&
                   n > 0
               ? n
               : sm_count() / (CL * kPairM);
  }();
  int clusters = fit;
  if (counts == nullptr)
    clusters = min(clusters,
                   E * ceil_div(M, kPairM * kBM) * (N / kBN / CL));
  cfg.gridDim = dim3(clusters * CL * kPairM);
  err = cudaLaunchKernelEx(&cfg, kernel, mx, mw, sx, sw,
                           static_cast<TX*>(y), amax, counts, E, M, N, K);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX, int FMT>
cudaError_t q8_cluster(const void* x, const void* w, const float* sx,
                       const float* sw, void* y, float* amax,
                       const int* counts, int E, int M, int N, int K,
                       cudaStream_t st) {
  int cl = g_cluster;
  while (cl > 1 && (N / kBN) % cl) cl /= 2;
  if (cl == 4)
    return wg_launch<TX, FMT, 4>(x, w, sx, sw, y, amax, counts, E, M, N, K,
                                 st);
  if (cl == 2)
    return wg_launch<TX, FMT, 2>(x, w, sx, sw, y, amax, counts, E, M, N, K,
                                 st);
  return wg_launch<TX, FMT, 1>(x, w, sx, sw, y, amax, counts, E, M, N, K,
                               st);
}

template <typename TX>
cudaError_t q8_dispatch(int fmt, const void* x, const void* w,
                        const float* sx, const float* sw, void* y,
                        float* amax, const int* counts, int E, int M, int N,
                        int K, cudaStream_t st) {
  if (fmt == kInt8)
    return q8_cluster<TX, kInt8>(x, w, sx, sw, y, amax, counts, E, M, N, K,
                                 st);
  if (fmt == kE4M3)
    return q8_cluster<TX, kE4M3>(x, w, sx, sw, y, amax, counts, E, M, N, K,
                                 st);
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
  if (M % kBM || N % kBN || K % 64 || (amax && amax_out == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* am = amax ? amax_out : nullptr;
  if (dtype == kBF16)
    return q8_dispatch<bf16>(fmt, x, w_t, sx, sw, y, am, nullptr, 1, M, N,
                             K, st);
  if (dtype == kF32)
    return q8_dispatch<float>(fmt, x, w_t, sx, sw, y, am, nullptr, 1, M, N,
                              K, st);
  return cudaErrorInvalidValue;
}

// The cluster size (1, 2 or 4) K11's and K12's 8-bit launches prefer;
// returns the previous one, or -1 for another value (nothing changes).
int dlnb_qmm_set_cluster(int cl) {
  if (cl != 1 && cl != 2 && cl != 4) return -1;
  const int prev = g_cluster;
  g_cluster = cl;
  return prev;
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
  if (fmt >= 0) {
    if (N % kBN || K % 64 || sx == nullptr || sw == nullptr)
      return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return q8_dispatch<bf16>(fmt, x, w, sx, sw, y, nullptr, counts, E, M,
                               N, K, st);
    if (dtype == kF32)
      return q8_dispatch<float>(fmt, x, w, sx, sw, y, nullptr, counts, E, M,
                                N, K, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == kBF16) {
    if (N % kBN || K % kBf16K) return cudaErrorInvalidValue;
    return wg_launch<bf16, kNoQuant, 1>(x, w, nullptr, nullptr, y, nullptr,
                                        counts, E, M, N, K, st);
  }
  if (dtype == kF32) {
    if (ceil_div(M, kFT) > 65535) return cudaErrorInvalidValue;
    const Group grp = {counts, static_cast<size_t>(M) * K,
                       static_cast<size_t>(K) * N,
                       static_cast<size_t>(M) * N};
    gmm_f32_kernel<<<dim3(ceil_div(N, kFT), ceil_div(M, kFT), E), kThreads, 0,
                     st>>>(static_cast<const float*>(x),
                           static_cast<const float*>(w),
                           static_cast<float*>(y), M, N, K, grp);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
