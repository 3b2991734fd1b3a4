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
//       [F, D] f32 = h^T . dy over T, h = bf16(silu(g) * u) recomputed
//       from g and u in shared memory (h never reaches device memory).
//
// K9, K10, K11 and K12 (bf16, int8, e4m3) are one warp-specialised
// template, wg_gemm_kernel (K11 is K12 with one expert and every row
// live): TMA loads into rings of mbarrier-guarded stages,
// wgmma.mma_async in two consumer warpgroups, a producer warp, and for
// the 8-bit formats a quantizer warpgroup (for K10 a silu warpgroup in
// its seat) whose work a thread-block cluster shares along N; persistent
// over the live tiles.  K9 is K12 bf16 with a K-major weight and an
// epilogue that reads g and u.  Its own comment below has the design.
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
// bound by operations.  K10's silu pass (a sigmoid, four products and a
// rounding an element) is ALU work on top, divided by the cluster size
// as K11's quantization is; K9's epilogue moves 1.41 GB of g, u, dg and
// du (0.42 ms at the memory rate) between mainloops.
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

#include "hopper.cuh"        // mbarrier, TMA, wgmma, tensor maps

namespace {

using bf16 = __nv_bfloat16;

enum Dtype { kF32 = 0, kBF16 = 1 };
enum Fmt { kInt8 = 0, kE4M3 = 1 };

constexpr int kThreads = 256;          // the f32 kernel's block; the two
                                       // consumer warpgroups' zero fill
constexpr int kBM = 128, kBN = 256;    // block tile (every kernel but f32)
constexpr int kGroupM = 8;             // raster group (row tiles)

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

// K9's sigmoid (the JAX _silu_parts): the precise expf, then 1 / x
// rounded to nearest, which __frcp_rn(x) is (IEEE division's result
// without its slow-path test)
__device__ __forceinline__ float sigmoid(float g) {
  return __frcp_rn(1.f + expf(-g));
}

// K10's sigmoid: exp from ex2.approx and the reciprocal from rcp.approx
// (see Numerics); h is recomputed once per cluster of column tiles, by
// three warps beside the tensor cores, and the precise forms would set
// their pace
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

// ----------------------------------------- K9 - K12: the wgmma skeleton
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
// K10 (FMT kSilu; dWd [F, D] = h^T . dy, so M = F, N = D, contraction
// T) is K11 with a silu pass in the quantizer's seat:
// - the x ring holds this block's slice of g and of u (64 T rows of the
//   row tile's 128 F columns each, as two 64-column panels in TMA's
//   128-byte swizzle: x_stage_bytes<bf16, CL>() = 2 * kStageA / CL);
// - warps 1-3 write h = bf16(silu(g) * u) into the A stage at the very
//   byte offsets where g and u landed: g, u and h are all F-contiguous
//   and the swizzle moves whole 16-byte pieces of a row, so the pass is
//   elementwise over 16-byte vectors with no layout change;
// - the consumers read h M-major (F contiguous, the transpose bit of A
//   set), panel ci for consumer ci, a K step of 16 T rows 2048 bytes on;
//   dy [T, D] is B, N-major as K12 bf16's W, multicast to the pair;
// - the cluster shares h along D as K11 shares its quantization: each
//   block makes 1 / CL of the h stage (slice nx: CL = 1 both panels, 2
//   panel nx, 4 half a panel) and bulk-copies it to its row peers, so h
//   is recomputed once per CL column tiles (D / 256 / CL times in all).
// K9 (FMT kDgdu; dg, du [T, F] from dh = dy [T, D] . Wd [F, D]^T, so
// M = T, N = F, contraction D) is K12 bf16 with one expert and the
// weight K-major (Wd as it lies: rows of 64 D values, 128 bytes, the
// 8-bit W's layout and descriptor, the transpose bit of B clear).  Its
// epilogue reads g and u and writes dg and du (64 KB each a tile, bf16)
// through shared memory, a 64-column chunk at a time: a loader thread
// (WG 0, warp 1) brings the chunk's g and u by TMA into an epilogue ring
// of kEpiSlots slots while the mainloop runs; each consumer reads its
// rows with ldmatrix in the accumulator's fragment layout, writes dg and
// du over them with stmatrix, and stores them with TMA.  The ring's
// room costs the mainloop its fourth stage.  Measured on an H100 against
// the first design, which read g and u from global memory in the
// fragment layout (4-byte pieces, eight 16-byte rows a warp access):
// 2.28 against 2.65 ms at the train shape (PERF.md).
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
constexpr int kSilu = 3;              // FMT of K10: A = h, made in WG 0
constexpr int kDgdu = 4;              // FMT of K9: bf16, the B K-major
constexpr int kPairM = 2;             // row tiles a cluster pairs: they
                                      // share each W stage (multicast)

// K9's epilogue ring: slots of one 64-column chunk of the tile's g and
// u (kBM rows x 128 bytes each), dg and du written over them in place
constexpr int kEpiSlots = 2;
constexpr int kEpiSlot = 32768;      // 2 x kBM x kRowBytes
// K10: TMA boxes of g (and of u) a block loads a stage, and their T rows
template <int CL>
__host__ __device__ constexpr int silu_boxes() {
  return CL == 1 ? 2 : 1;
}

template <int CL>
__host__ __device__ constexpr int silu_rows() {
  return CL == 4 ? 32 : 64;
}

// 8-bit and K10: the depths of the x and A rings.  A cluster adds a
// bulk copy and the peers' releases to each A stage's round trip, so
// its rings are deeper (and its x stages smaller)
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

// the bf16 products whose A the producer loads (K12 bf16, K9) beside
// their weight; the 8-bit formats and K10 make A in WG 0 from an x ring
__host__ __device__ constexpr bool a_by_tma(int fmt) {
  return fmt == kNoQuant || fmt == kDgdu;
}

template <typename TX, int FMT, int CL>
__host__ __device__ constexpr int w_stages() {
  return FMT == kDgdu
             ? (kSmemBudget - kEpiSlots * kEpiSlot) / (kStageA + kStageW)
         : a_by_tma(FMT)
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
                          (kStageW + (a_by_tma(FMT) ? kStageA : 0)) +
         (FMT == kDgdu ? static_cast<size_t>(kEpiSlots) * kEpiSlot : 0) +
         (a_by_tma(FMT) ? 0
                          : static_cast<size_t>(a_stages<CL>()) * kStageA +
                                x_stages<CL>() * x_stage_bytes<TX, CL>());
}

// ---------------------------------- ldmatrix, stmatrix, cluster copies

// four 8 x 8 b16 matrices between shared memory and the mma fragment
// layout (lane L: row L / 4, elements 2 (L % 4) and 2 (L % 4) + 1 of
// each); lanes 8i .. 8i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void stsm4(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
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

// K10's silu warps (thread qt of kQuantWarps * 32): each landed g, u
// slice -> this block's slice of the h stage, h = bf16(silu(g) * u) at
// the same byte offsets (see the skeleton's K10 notes), in every block of
// its cluster row
template <int CL>
__device__ __forceinline__ void silu_h(
    int units, int first, int step, int nk, unsigned char* sX,
    unsigned char* sA, uint64_t* full_x, uint64_t* empty_x,
    uint64_t* full_a, uint64_t* empty_a, uint32_t nx, uint32_t row0,
    int qt) {
  constexpr int XB = x_stage_bytes<bf16, CL>();   // g's slice, then u's
  constexpr int HB = kStageA / CL;                 // the h slice
  static_assert(2 * HB == XB, "the x stage is one slice of g and of u");
  Ring x, a;
  for (int u = first; u < units; u += step) {
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full_x[x.slot], x.phase);
      mbar_wait(&empty_a[a.slot], a.phase ^ 1);
      const unsigned char* gs = sX + x.slot * XB;
      unsigned char* hs = sA + a.slot * kStageA + nx * HB;
#pragma unroll 2
      for (int i = qt * 16; i < HB; i += kQuantWarps * 32 * 16) {
        float gv[8], uv[8];
        load8(gv, reinterpret_cast<const bf16*>(gs + i));
        load8(uv, reinterpret_cast<const bf16*>(gs + HB + i));
        uint4 out;
        auto* h2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h2[j] = __floats2bfloat162_rn(
              gv[2 * j] * sigmoid_fast(gv[2 * j]) * uv[2 * j],
              gv[2 * j + 1] * sigmoid_fast(gv[2 * j + 1]) * uv[2 * j + 1]);
        *reinterpret_cast<uint4*>(hs + i) = out;
      }
      fence_to_async();
      quantizer_sync();
      if (qt == 0) {
        mbar_arrive(&empty_x[x.slot]);
        if constexpr (CL == 1) {
          mbar_arrive(&full_a[a.slot]);
        } else {
#pragma unroll
          for (int p = 1; p < CL; ++p)
            bulk_to_peer(hs, HB, &full_a[a.slot], row0 + (nx + p) % CL);
          mbar_expect_tx(&full_a[a.slot], (CL - 1) * HB);
        }
      }
      x.next(x_stages<CL>());
      a.next(a_stages<CL>());
    }
  }
}

// K9's and K10's extra operands, for their TMA maps: g, u [T, F] and
// K9's du (its dg is y; K10's g is x)
struct Swiglu {
  const bf16* g;
  const bf16* u;
  bf16* du;
};

// the output type: K10 writes f32 dWd from bf16 operands
template <typename TX, int FMT>
using OutT = typename std::conditional<FMT == kSilu, float, TX>::type;

// K11 (E = 1, counts null) and K12: y [E, M, N] (TX) = x [E, M, K] . w
// per expert.  FMT int8 / e4m3: x is quantized against sx[e], w_t [E, N,
// K] 8-bit, the epilogue multiplies by sx[e] * sw[e].  FMT kNoQuant: x
// and w [E, K, N] bf16.  map_x and map_w are the TMA maps of x and w
// (3-D, the expert outermost).
// K10 (kSilu, TX bf16, E = 1): map_g, map_u the maps of g, u [K = T, M =
// F], map_w of dy [T, N = D]; y f32.  K9 (kDgdu, TX bf16, E = 1): map_x
// of dy [M = T, K = D], map_w of Wd [N = F, K = D], map_g, map_u of g, u
// [M = T, N = F] in 128-row chunks, map_dg, map_du of dg (y) and du in a
// consumer's 64 rows.
template <typename TX, int FMT, int CL>
__global__ void __launch_bounds__(kWgThreads, 1)
    wg_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_u,
                   const __grid_constant__ CUtensorMap map_dg,
                   const __grid_constant__ CUtensorMap map_du,
                   const float* __restrict__ sx_p,
                   const float* __restrict__ sw_p,
                   OutT<TX, FMT>* __restrict__ y,
                   float* __restrict__ amax_out,
                   const int* __restrict__ counts, int E, int M, int N,
                   int K) {
  constexpr bool kQuant = FMT == kInt8 || FMT == kE4M3;
  constexpr bool kSiluA = FMT == kSilu;       // A made by the silu warps
  constexpr bool kHelper = kQuant || kSiluA;  // WG 0's warps 1-3 work
  constexpr bool kKMajorW = FMT != kNoQuant && FMT != kSilu;
  constexpr int SW = w_stages<TX, FMT, CL>();
  constexpr int SA = kHelper ? a_stages<CL>() : SW;
  constexpr int SX = x_stages<CL>();
  constexpr int XB = x_stage_bytes<TX, CL>();
  constexpr int R = kBM / CL;             // x rows this block quantizes
  using Acc = typename std::conditional<FMT == kInt8, int, float>::type;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_w = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty_w = full_w + SW;
  uint64_t* full_a = empty_w + SW;        // 8-bit and K10 only
  uint64_t* empty_a = full_a + SA;
  uint64_t* full_x = empty_a + SA;
  uint64_t* empty_x = full_x + SX;
  unsigned char* sW = base + 1024;
  unsigned char* sA = sW + SW * kStageW;
  unsigned char* sX = sA + SA * kStageA;  // 8-bit and K10 only
  unsigned char* sE = sX;                 // K9's epilogue ring
  static_assert(FMT != kDgdu || kEpiSlots <= SX, "K9 epilogue barriers");

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const uint32_t nx = rank % CL, my = rank / CL, row0 = my * CL;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SW; ++s) {
      mbar_init(&full_w[s], 1);          // + the column's W parts, bytes
      mbar_init(&empty_w[s], 8 * kPairM);  // the column's consumer warps
    }
    if constexpr (FMT == kDgdu) {
      for (int s = 0; s < kEpiSlots; ++s) {
        mbar_init(&full_x[s], 1);        // + the chunk's bytes
        mbar_init(&empty_x[s], 2);       // each consumer warpgroup
      }
    }
    if constexpr (kHelper) {
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
  const int nk = kQuant   ? ceil_div(K, kQ8K)
                 : kSiluA ? ceil_div(K, kBf16K)
                          : K / kBf16K;

  if (wg == 0) {
    reg_release<FMT == kE4M3              ? kRegLoaderE4M3
                : FMT == kInt8 || kSiluA ? kRegLoader
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
          } else if constexpr (kSiluA) {
            // this block's slice of g and of u: box c = nx * NB + i of
            // the stage is silu_rows T rows of one 64-column panel
            constexpr int HR = silu_rows<CL>(), NB = silu_boxes<CL>();
            mbar_wait(&empty_x[x.slot], x.phase ^ 1);
            mbar_expect_tx(&full_x[x.slot], XB);
            unsigned char* xs = sX + x.slot * XB;
#pragma unroll
            for (int i = 0; i < NB; ++i) {
              const int c = static_cast<int>(nx) * NB + i;
              const int panel = c / (64 / HR), r0 = c % (64 / HR) * HR;
              tma_load(xs + i * HR * kRowBytes, &map_g, &full_x[x.slot],
                       row + panel * 64, kt * kBf16K + r0, 0);
              tma_load(xs + XB / 2 + i * HR * kRowBytes, &map_u,
                       &full_x[x.slot], row + panel * 64, kt * kBf16K + r0,
                       0);
            }
            x.next(SX);
          }
          // W: this block loads its 1 / kPairM of the stage (rows of a
          // K-major w, 64-column panels of an N-major one) into every
          // block of its column, once their consumers are all done with it
          mbar_wait(&empty_w[w.slot], w.phase ^ 1);
          unsigned char* ws = sW + w.slot * kStageW;
          if constexpr (!a_by_tma(FMT)) {
            mbar_expect_tx(&full_w[w.slot], kStageW);
          } else {
            mbar_expect_tx(&full_w[w.slot], kStageA + kStageW);
            tma_load(sA + w.slot * kStageA, &map_x, &full_w[w.slot],
                     kt * kBf16K, row, e);
          }
          if constexpr (kKMajorW) {
            tma_load_multicast(ws + my * (kStageW / kPairM), &map_w,
                               &full_w[w.slot],
                               kt * (kQuant ? kQ8K : kBf16K),
                               tn * kBN + my * (kBN / kPairM), e, column);
          } else {
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
    } else if constexpr (FMT == kDgdu) {
      if (tid == 32) {
        // K9's epilogue loader: the unit's g and u, a 64-column chunk of
        // the pair's tile at a time, into the epilogue ring (slots reach
        // the next unit's chunks while its mainloop runs)
        Ring ep;
        for (int u = first; u < units; u += step) {
          int e, tm, tu;
          sc.unit(u, e, tm, tu);
          const int row = (tm + static_cast<int>(my)) * kBM;
          const int col = (tu * CL + static_cast<int>(nx)) * kBN;
          for (int c = 0; c < kBN / 64; ++c) {
            mbar_wait(&empty_x[ep.slot], ep.phase ^ 1);
            mbar_expect_tx(&full_x[ep.slot], kEpiSlot);
            unsigned char* es = sE + ep.slot * kEpiSlot;
            tma_load(es, &map_g, &full_x[ep.slot], col + c * 64, row, 0);
            tma_load(es + kEpiSlot / 2, &map_u, &full_x[ep.slot],
                     col + c * 64, row, 0);
            ep.next(kEpiSlots);
          }
        }
      }
    } else if constexpr (kSiluA) {
      if (tid >= 32)
        silu_h<CL>(units, first, step, nk, sX, sA, full_x, empty_x, full_a,
                   empty_a, nx, row0, tid - 32);
    }
    cluster_sync();
  } else {
    // ---------------------------------------------------- consumers
    reg_claim<FMT == kE4M3              ? kRegConsumerE4M3
              : FMT == kInt8 || kSiluA ? kRegConsumer
                                        : kRegConsumerBf16>();
    const int ci = wg - 1, warp = tid / 32, lane = tid % 32;
    Acc d[128];
    Ring w, a, ep;
    for (int u = first; u < units; u += step) {
      int e, tm, tu;
      sc.unit(u, e, tm, tu);
      tm += static_cast<int>(my);
      const int tn = tu * CL + static_cast<int>(nx);
      int w_prev = 0, a_prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full_w[w.slot], w.phase);
        const int as = kHelper ? a.slot : w.slot;
        if constexpr (kHelper) mbar_wait(&full_a[a.slot], a.phase);
        // consumer ci's 64 rows: 64 K-major rows of 128 bytes, or (K10)
        // the 64-column panel ci of the M-major h stage
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
            const int acc = kt > 0 || ks > 0;
            if constexpr (kQuant) {
              wgmma_q8(d, sw128_desc(a0 + ks * 32, 16, 1024),
                       sw128_desc(b0 + ks * 32, 16, 1024), acc);
            } else if constexpr (kSiluA) {
              wgmma_bf16<1, 1>(
                  d, sw128_desc(a0 + ks * 16 * kRowBytes, kStageA / 2, 1024),
                  sw128_desc(b0 + ks * 16 * kRowBytes, kStageW / 4, 1024),
                  acc);
            } else if constexpr (FMT == kDgdu) {
              wgmma_bf16<0, 0>(d, sw128_desc(a0 + ks * 32, 16, 1024),
                               sw128_desc(b0 + ks * 32, 16, 1024), acc);
            } else {
              wgmma_bf16<0, 1>(
                  d, sw128_desc(a0 + ks * 32, 16, 1024),
                  sw128_desc(b0 + ks * 16 * kRowBytes, kStageW / 4, 1024),
                  acc);
            }
          }
          wgmma_commit();
          acc_fence(d);
          wgmma_wait<1>();               // stage kt - 1 has retired
        }
        if (kt > 0 && lane == 0) {
          release_w<CL>(empty_w + w_prev, nx);
          if constexpr (kHelper) release_a<CL>(empty_a + a_prev, row0);
        }
        w_prev = w.slot;
        a_prev = a.slot;
        w.next(SW);
        if constexpr (kHelper) a.next(SA);
      }
      wgmma_wait<0>();
      acc_fence(d);
      if (lane == 0) {
        release_w<CL>(empty_w + w_prev, nx);
        if constexpr (kHelper) release_a<CL>(empty_a + a_prev, row0);
      }

      // epilogue.  d[4j + 2h + i] is row lane/4 + 8h, column 8j +
      // 2(lane%4) + i of the warp's 16 x 256 slice; rows past the buffer
      // are not written
      const int r0 = tm * kBM + ci * 64 + warp * 16 + lane / 4;
      const int c0 = tn * kBN + 2 * (lane % 4);
      if constexpr (FMT == kDgdu) {
        // K9: dh is d; dg = (dh * u) * silu'(g), du = dh * silu(g).  Per
        // 64-column chunk: g and u from the epilogue ring by ldmatrix in
        // the accumulator's fragment layout (matrices (j, h): rows 8h ..
        // 8h + 7 of the warp's 16, columns 8j .. 8j + 7), dg and du back
        // over them by stmatrix, then one TMA store each of this
        // warpgroup's 64 rows (rows past M are not written)
        const int lrow = warp * 16 + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c) {
          mbar_wait(&full_x[ep.slot], ep.phase);
          unsigned char* gsl = sE + ep.slot * kEpiSlot + ci * 64 * kRowBytes;
          unsigned char* usl = gsl + kEpiSlot / 2;
#pragma unroll
          for (int jj = 0; jj < 8; jj += 2) {
            const int off = lrow * kRowBytes +
                            (((jj + (lane >> 4)) ^ (lrow & 7)) << 4);
            uint32_t gr[4], ur[4], dgr[4], dur[4];
            ldsm4(gr, gsl + off);
            ldsm4(ur, usl + off);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int j = 8 * c + jj + (m >> 1), h = m & 1;
              const float2 gv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&gr[m]));
              const float2 uv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&ur[m]));
              const float gs[2] = {gv.x, gv.y}, us[2] = {uv.x, uv.y};
              float dgv[2], duv[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float dh = d[4 * j + 2 * h + i];
                const float sig = sigmoid(gs[i]);
                const float silu = gs[i] * sig;
                const float dsilu = sig + silu * (1.f - sig);
                dgv[i] = dh * us[i] * dsilu;
                duv[i] = dh * silu;
              }
              const __nv_bfloat162 dg2 = __floats2bfloat162_rn(dgv[0], dgv[1]);
              const __nv_bfloat162 du2 = __floats2bfloat162_rn(duv[0], duv[1]);
              dgr[m] = *reinterpret_cast<const uint32_t*>(&dg2);
              dur[m] = *reinterpret_cast<const uint32_t*>(&du2);
            }
            stsm4(gsl + off, dgr);
            stsm4(usl + off, dur);
          }
          fence_to_async();
          consumer_sync(ci);
          if (tid == 0) {
            const int col = tn * kBN + c * 64, row = tm * kBM + ci * 64;
            tma_store(&map_dg, gsl, col, row, 0);
            tma_store(&map_du, usl, col, row, 0);
            bulk_commit();
            bulk_wait_read<0>();         // the slot may be loaded again
            mbar_arrive(&empty_x[ep.slot]);
          }
          ep.next(kEpiSlots);
        }
      } else {
        // float(acc) * (sx * sw) in y's dtype; rows at or past the live
        // count are zeros
        const float s_out = kQuant ? sx_p[e] * sw_p[e] : 1.f;
        const int live = live_rows(counts, e, M);
        OutT<TX, FMT>* ye = y + static_cast<size_t>(e) * M * N;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            if (row >= M) continue;
            const bool on = row < live;
            const float v0 = to_f32(d[4 * j + 2 * h]) * s_out;
            const float v1 = to_f32(d[4 * j + 2 * h + 1]) * s_out;
            store2(ye + static_cast<size_t>(row) * N + c0 + 8 * j,
                   on ? v0 : 0.f, on ? v1 : 0.f);
          }
      }
    }
    if constexpr (FMT == kDgdu) {
      if (tid == 0) bulk_wait_all();     // dg, du written before exit
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

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// the cluster sizes the 8-bit launches (dlnb_qmm_set_cluster) and K10
// (dlnb_dwd_set_cluster) prefer; a launch takes the largest of it, half
// of it, ... that divides N / 256
int g_cluster = 4;
int g_cluster_dwd = 4;

// E experts of M rows; counts null: every row live.  K10: x is g, sg.u
// u; K9: sg holds g, u and du
template <typename TX, int FMT, int CL>
cudaError_t wg_launch(const void* x, const void* w, const float* sx,
                      const float* sw, void* y, float* amax,
                      const int* counts, Swiglu sg, int E, int M, int N,
                      int K, cudaStream_t stream) {
  auto kernel = wg_gemm_kernel<TX, FMT, CL>;
  constexpr size_t smem = wg_smem<TX, FMT, CL>();
  constexpr bool kQuant = FMT == kInt8 || FMT == kE4M3;
  static_assert(smem <= 232448, "shared memory");
  CUtensorMap mx = {}, mw = {}, mg = {}, mu = {}, mdg = {}, mdu = {};
  cudaError_t err;
  if constexpr (FMT == kSilu) {
    // g, u [K = T][M = F] in silu_rows x 64 boxes; dy [T][N = D] as K12
    // bf16's w
    err = make_map(&mg, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, M, K, 1, 64,
                   silu_rows<CL>(), CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = make_map(&mu, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sg.u, 2, M, K, 1,
                     64, silu_rows<CL>(), CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, N, K, 1,
                     64, kBf16K, CU_TENSOR_MAP_SWIZZLE_128B);
  } else if constexpr (FMT == kDgdu) {
    // dy [T][D] as K12 bf16's x; Wd [F][D] K-major as the 8-bit w_t; g,
    // u [T][F] in chunks of 64 columns x kBM rows, dg, du of 64 x 64
    err = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, K, M, 1,
                   kBf16K, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, K, N, 1,
                     kBf16K, kBN / kPairM, CU_TENSOR_MAP_SWIZZLE_128B);
    const void* gu[2] = {sg.g, sg.u};
    const void* out[2] = {y, sg.du};
    CUtensorMap* in_maps[2] = {&mg, &mu};
    CUtensorMap* out_maps[2] = {&mdg, &mdu};
    for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
      err = make_map(in_maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, gu[i], 2,
                     N, M, 1, 64, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
      if (err == cudaSuccess)
        err = make_map(out_maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out[i],
                       2, N, M, 1, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    }
  } else if constexpr (kQuant) {
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
  err = cudaLaunchKernelEx(&cfg, kernel, mx, mw, mg, mu, mdg, mdu, sx, sw,
                           static_cast<OutT<TX, FMT>*>(y), amax, counts, E,
                           M, N, K);
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
    return wg_launch<TX, FMT, 4>(x, w, sx, sw, y, amax, counts, {}, E, M,
                                 N, K,
                                 st);
  if (cl == 2)
    return wg_launch<TX, FMT, 2>(x, w, sx, sw, y, amax, counts, {}, E, M,
                                 N, K,
                                 st);
  return wg_launch<TX, FMT, 1>(x, w, sx, sw, y, amax, counts, {}, E, M, N,
                               K,
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
  if (T <= 0 || F <= 0 || D <= 0 || T % kBM || F % kBN || D % kBf16K)
    return cudaErrorInvalidValue;
  const Swiglu sg = {static_cast<const bf16*>(g),
                     static_cast<const bf16*>(u), static_cast<bf16*>(du)};
  return wg_launch<bf16, kDgdu, 1>(dy, wd, nullptr, nullptr, dg, nullptr,
                                   nullptr, sg, 1, T, F, D,
                                   static_cast<cudaStream_t>(stream));
}

// K10: dWd [F, D] f32 = (bf16(silu(g) * u))^T . dy over T; g, u [T, F],
// dy [T, D] bf16
int dlnb_dwd(const void* g, const void* u, const void* dy, float* dwd,
             int T, int F, int D, void* stream) {
  if (T <= 0 || F <= 0 || D <= 0 || T % 32 || F % kBM || D % kBN)
    return cudaErrorInvalidValue;
  const Swiglu sg = {nullptr, static_cast<const bf16*>(u), nullptr};
  auto st = static_cast<cudaStream_t>(stream);
  int cl = g_cluster_dwd;
  while (cl > 1 && (D / kBN) % cl) cl /= 2;
  if (cl == 4)
    return wg_launch<bf16, kSilu, 4>(g, dy, nullptr, nullptr, dwd, nullptr,
                                     nullptr, sg, 1, F, D, T, st);
  if (cl == 2)
    return wg_launch<bf16, kSilu, 2>(g, dy, nullptr, nullptr, dwd, nullptr,
                                     nullptr, sg, 1, F, D, T, st);
  return wg_launch<bf16, kSilu, 1>(g, dy, nullptr, nullptr, dwd, nullptr,
                                   nullptr, sg, 1, F, D, T, st);
}

// The cluster size (1, 2 or 4) K10's launches prefer; returns the
// previous one, or -1 for another value (nothing changes).
int dlnb_dwd_set_cluster(int cl) {
  if (cl != 1 && cl != 2 && cl != 4) return -1;
  const int prev = g_cluster_dwd;
  g_cluster_dwd = cl;
  return prev;
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
                                        counts, {}, E, M, N, K, st);
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
