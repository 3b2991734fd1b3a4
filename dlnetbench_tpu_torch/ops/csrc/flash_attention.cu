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
// rounds p and ds to the input type before their products; dk uses the
// unscaled q.  D is computed by the dq kernel (rowsum of dO * O in f32,
// written to the D buffer that the dk/dv kernel then reads).  The bf16
// backward takes exp(s - lse) as exp2(s * log2(e) - lse * log2(e)) (f32,
// a few ulp from expf, far under the bf16 rounding of p and ds that
// follows; the precise expf's longer sequence showed in K4's and K5's
// times on an H100).
//
// Bound on this card: at the training shape (B=2, S=6144, Hq=32, Hkv=8,
// Dh=128, causal) each kernel does 0.6e12-1.2e12 tensor-core FLOP on
// ~0.3 GB of operands: it is bound by operations (989 TFLOP/s bf16), not
// by bytes.  What the design does about that:
//   * all three (and K6 / K7 / K8, their splash mode) are
//     warp-specialised wgmma / TMA kernels on the helpers of hopper.cuh
//     (their comment below has the design): a producer warp keeps TMA
//     loads in flight through mbarrier rings, two consumer warpgroups
//     issue m64nN wgmma products with f32 accumulators in registers, and
//     p and ds go back in as register A operands, never through shared
//     memory.  Their first form (mma.sync m16n8k16 from ldmatrix, 16
//     rows a warp, 16-byte cp.async behind a block barrier a stage, one
//     q head a block) was bound by shared-memory traffic and barriers:
//     each B fragment fed one m16 tile, and the GQA group's q heads each
//     fetched every K/V tile.  A wgmma reads each B tile once for 64
//     rows, and a K3 / K4 block's two q heads share each K/V stage;
//   * tiles wholly outside the causal triangle or the mask are neither
//     loaded nor computed; the forward and dq grids launch the longest
//     (last) q tiles first, and dk/dv the longest (first) KV tiles first;
//   * the dk/dv kernel runs one block per (batch, KV head, 128-key tile)
//     and loops over the GQA group's q heads itself, accumulating dk/dv
//     in f32 registers and writing [B, S, Hkv, Dh] once: the TPU path's
//     per-q-head dk/dv and the wrapper's group sum (:517-518) are gone,
//     with no atomics (the result is deterministic).
// Not yet: a persistent grid for K4 / K5 (K3 has one).  The times stand
// in PERF.md.
//
// Splash (mode kSplash).  The wrapper hands each kernel the BlockMask
// built at THAT kernel's tiles (forward and dq: 64 q rows x 64 keys;
// dk/dv: 64 q rows x 128 keys), packed as one int32 array on the card
// (MaskView below).  Per q tile (K6, K7) or per 128-key tile (K8) the
// kernel walks only the tiles of its visit range [first, last]: a
// skipped tile is neither loaded nor multiplied, so the work is what the
// mask leaves (a window of W keys costs ~W/S of the dense grid).  A tile
// is FULL when blk_lo_max[i] <= j*bk and blk_hi_min[i] >= (j+1)*bk - 1
// and then skips the mask; a PARTIAL tile masks each element against its
// row's [lo[q], hi[q]] (forward and dq: the thread's two row bounds read
// once per q tile into registers; dk/dv: the q tile's bounds staged in
// shared memory beside lse and D by a bulk copy).  Numerics are K3-K5's
// (same rounding points, the finite -1e30 mask; a row whose first
// visited tile holds none of its keys gets p = 1 there and the next
// tile's alpha = 0 wipes it), so under the plain-causal mask K6/K7/K8
// visit, mask and add exactly what K3/K4/K5 do: bitwise equal.  No
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

#include <cuda.h>            // CUtensorMap (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"        // mbarrier, TMA, wgmma, tensor maps

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // finite mask: no NaN from -inf - -inf
constexpr float kLog2e = 1.4426950408889634f;

enum Dtype { kF32 = 0, kBF16 = 1 };

// which keys a query sees: all, the causal triangle, or a BlockMask
enum Mode { kDense = 0, kCausal = 1, kSplash = 2 };

// --------------------------------------------------- tiles and masks

constexpr int kBQ = 64, kBK = 64;     // q rows x keys of K4
constexpr int kBKf = 128;             // keys of a K3 stage
constexpr int kConsumers = 2, kBKd = kConsumers * 64;   // K5: 128 keys

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

// ---------------------- K3 forward, K4 dq, K5 dk/dv: wgmma and TMA
//
// All three are one block of three warpgroups (kWsThreads):
//   WG 0, warp 0  producer: one thread issues every TMA load into rings
//         of mbarrier-guarded stages (K3, K4: K/V tiles; K5: the q tiles
//         of the group's q heads, one after another, with their lse and
//         D rows and, in splash mode, their lo / hi rows by 1-D bulk
//         copies on the same barrier);
//   WG 0, warps 1-3  (K5 only) write bf16(q * scale) of each landed q
//         tile into the stage's third tile, at the same byte offsets;
//   WG 1, WG 2  consumers: 64 rows of the block's work each, f32
//         accumulators in registers, wgmma.mma_async for every product.
// setmaxnreg moves registers from WG 0 to the consumers.
//
// A 64-row tile of Dh columns lies in shared memory as TMA's 128-byte
// swizzle writes it: Dh / 64 panels of 64 rows x 128 bytes (a row
// tile of 128 keys: panels of 128 rows), every panel 1024-byte aligned.
// One tile is read two ways: K-major (rows of 64 contraction values per
// panel, 8-row groups 1024 bytes apart; a K step of 16 moves the start
// 32 bytes, and to the next panel every 4 steps) when Dh is the
// contraction, and N-major (Dh is N: panels `panel` bytes apart as the
// leading offset, 8-row K groups 1024 apart; a K step of 16 rows moves
// the start 2048 bytes) when the tile's rows are the contraction.
//
// K3 (per consumer: 64 q rows of one q head; 128-key K and V stages):
//   the work is K4's (q head, q tile) item pairs (below), taken by one
//   persistent block an SM, longest pairs first; each pair's q tiles are
//   loaded once by TMA into one of two q slots (the next pair's loads
//   run while this one finishes) and rounded in place to bf16(q * scale
//   * log2 e), the forward's rounding point.  S = Q K^T (m64n128k16, both
//   operands K-major in shared memory: at 64 keys the S product read
//   its 4 KB a k-step from shared memory at the SM's full rate), then in
//   registers the causal or interval mask and the base-2 online softmax
//   (ex2.approx.ftz) with f32 m, l and O in the accumulator's layout; p
//   is rounded to bf16 and packed as the register A fragment, and O +=
//   p V (m64nDHk16, V read N-major).  Stage j's S is issued before stage
//   j - 1's p V, so the softmax of stage j runs while p V of j - 1 is on
//   the tensor cores (FA3's intra-warpgroup overlap); O is rescaled once
//   p V of j - 1 retires.  K and V have rings of their own: K j is freed
//   as soon as its S retires, V j after its p V, and the producer loads
//   K j before V j - 1.  On an H100 at the train shape, a third stage
//   gained 17 % while K and V shared one ring (split, two K stages are
//   as fast as three for K3 and 4 % faster for K6), persistence 7 %,
//   ex2.approx.ftz for exp2f 4 %; lost: consumers taking turns on named
//   barriers (FA3's ping-pong, 7-11 %), rescaling O between S's and p
//   V's issue (1 %), a quarter of the exps by a polynomial on the FMA
//   pipe (4 %: the SFU is not what bounds the softmax), skipping the
//   rescale where no row's max moved (1 %).  The epilogue writes O / l
//   as bf16 and lse = (m + log2 l) ln 2 as f32 [B, Hq, S].
// K4 (per consumer: 64 q rows of one q head; a 64-key K/V stage):
//   S = (q * scale) K^T and dP = dO V^T (m64n64k16, both operands in
//   shared memory, K-major), then in registers p = exp(S - lse) and
//   dS = p (dP - D) scale, rounded to bf16 and packed into the register
//   A fragment (pack_a), then dQ += dS K (m64nDHk16, A from registers,
//   B the same K stage read N-major).  A block takes two (q head, q tile)
//   items of one KV head, items 2p and 2p + 1 of the KV head's G x nq in
//   (q tile, q head) order: with G even the two q heads of one q tile
//   (one visit range), with G = 1 two neighbouring q tiles.  The K/V ring
//   runs over the union of the two visit ranges; a consumer waits on and
//   releases a stage outside its own range without computing it.  S and
//   dP are two commit groups, so exp runs while dP is on the tensor
//   cores; a stage's dQ product stays in flight while the next stage's S
//   and dP are issued, and the stage is released when it retires (its
//   dS registers are held live until then).  Both gained on an H100 at
//   the train shape; in K5 the same splits lost time (its dK and dV
//   accumulators leave fewer registers), so K5 issues its four products
//   in two groups and waits on each.
// K5 (per consumer: 64 keys of the block's 128; one q tile a stage):
//   S^T = K (q * scale)^T and dP^T = V dO^T (K-major, in shared memory),
//   p^T = exp(S^T - lse), dS^T = p^T (dP^T - D) scale, both rounded to
//   bf16 and packed as register A fragments, then dV += p^T dO and dK +=
//   dS^T q (B the dO and q tiles of the stage read N-major; dk uses the
//   unscaled q).  dK and dV sum over the group's q heads in registers
//   (64 + 64 accumulator registers a thread at Dh = 128) and are written
//   once: no atomics, deterministic.

constexpr int kWsThreads = 384;       // WG 0 + two consumer warpgroups
constexpr int kHelperWarps = 3;       // K5: WG 0's warps 1-3
constexpr int kFwdKStages = 2;        // K3's K ring (128-key tiles)
constexpr int kFwdVStages = 2;        // ... its V ring
constexpr int kFwdQSlots = 2;         // ... its q tiles, double-buffered
constexpr int kDqStages = 3;          // K4's K/V ring
constexpr int kDkvStages = 3;         // K5's q-tile ring
constexpr int kWsExtra = 2048;        // 1024-byte alignment, barriers and
                                      // K4's D rows
constexpr int kRowsBytes = 1024;      // K5 stage: lse, D, lo, hi (64 each)
constexpr int kPanel = 8192;          // 64 rows x 128 bytes
// setmaxnreg, registers a thread: WG 0 gives back, the consumers take,
// within the block's pool at launch (384 x 168 = 64512; an inc past it
// waits for ever)
constexpr int kRegProducer = 40;
constexpr int kRegConsumer = 232;

// bytes of a 64-row tile of DH bf16 columns
template <int DH>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * DH * 2;
}

// two slots of the two items' q tiles, the K and V rings of 128-key
// tiles
template <int DH>
__host__ __device__ constexpr size_t fwd_smem() {
  return kWsExtra +
         static_cast<size_t>(2 * kFwdQSlots +
                             2 * (kFwdKStages + kFwdVStages)) *
             tile_bytes<DH>();
}

template <int DH>
__host__ __device__ constexpr size_t dq_smem() {
  return kWsExtra + static_cast<size_t>(4 + 2 * kDqStages) *
                         tile_bytes<DH>();
}

// a stage: the q tile, the dO tile, the q * scale tile, the rows
template <int DH>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 3 * tile_bytes<DH>() + kRowsBytes;
}

template <int DH>
__host__ __device__ constexpr size_t dkv_smem() {
  return kWsExtra + 4 * static_cast<size_t>(tile_bytes<DH>()) +
         static_cast<size_t>(kDkvStages) * dkv_stage_bytes<DH>();
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// K step ks (16 of the Dh contraction) of a tile read K-major; `panel`:
// the bytes between its 64-column panels (64 or 128 rows x 128)
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int ks,
                                           int panel) {
  return sw128_desc(addr + (ks / 4) * panel + (ks % 4) * 32, 16, 1024);
}

// K step kk (16 of the tile's rows) of a tile read N-major; `panel`:
// the bytes between its 64-column panels (64 or 128 rows x 128)
__device__ __forceinline__ uint64_t nmajor(uint32_t addr, int kk,
                                           int panel = kPanel) {
  return sw128_desc(addr + kk * 16 * 128, panel, 1024);
}

// the WG 0 helpers' own barrier (0 is __syncthreads')
__device__ __forceinline__ void helper_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kHelperWarps * 32) : "memory");
}

// x = round(x * mul) over n bytes of bf16 (16 per step, from thread t of
// nt), src -> dst; the swizzle moves whole 16-byte pieces, so the pass
// is elementwise in any of the tiles' layouts
__device__ __forceinline__ void scale_bytes(unsigned char* dst,
                                            const unsigned char* src, int n,
                                            float mul, int t, int nt) {
  for (int i = t * 16; i < n; i += nt * 16) {
    uint4 v = *reinterpret_cast<const uint4*>(src + i);
    auto* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    *reinterpret_cast<uint4*>(dst + i) = v;
  }
}

// An m64nN accumulator (N = 2 * NR / ... ; NR registers a thread):
// element e of thread (warp w, lane L) is row 16w + L/4 + 8((e % 4) / 2),
// column 8(e / 4) + 2(L % 4) + e % 2.
__device__ __forceinline__ int acc_row(int e, int lane) {
  return lane / 4 + 8 * ((e % 4) / 2);
}
__device__ __forceinline__ int acc_col(int e, int lane) {
  return 8 * (e / 4) + 2 * (lane % 4) + e % 2;
}

// the two (q head, q tile) items of block (KV head hk, pair index y) in
// K3 and K4: items 2p and 2p + 1 of the KV head's G x nq in (q tile, q
// head) order, the longest pair first; each with its visit range [j0,
// j1) of kv tiles, and the union [J0, J1) the K/V ring runs over
struct Items {
  int qt[2], hq[2], j0[2], j1[2], J0, J1;
};

template <int MODE, int BK>
__device__ __forceinline__ Items pair_items(const MaskView& mv, int hk,
                                            int G, int nq, int y) {
  Items it;
  const int pair = G * nq / 2 - 1 - y;     // longest first
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = 2 * pair + c;
    it.qt[c] = i / G;
    it.hq[c] = hk * G + i % G;
    it.j0[c] = 0;
    it.j1[c] = MODE == kCausal ? (it.qt[c] * kBQ + kBQ - 1) / BK + 1
                               : nq * kBQ / BK;
    if (MODE == kSplash) {
      it.j0[c] = mv.first[it.qt[c]];
      it.j1[c] = mv.last[it.qt[c]] + 1;
    }
  }
  it.J0 = min(it.j0[0], it.j0[1]);
  it.J1 = max(it.j1[0], it.j1[1]);
  return it;
}

// write a consumer's 64 x DH accumulator as bf16 rows (its warp's 16
// rows start at dst)
template <int DH>
__device__ __forceinline__ void store_acc(bf16* dst, int ld,
                                          const float (&d)[DH / 2],
                                          int lane) {
#pragma unroll
  for (int e = 0; e < DH / 2; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(
        dst + static_cast<size_t>(acc_row(e, lane)) * ld +
        acc_col(e, lane)) = __floats2bfloat162_rn(d[e], d[e + 1]);
}

// the same, each row half times mul[half] (O / l)
template <int DH>
__device__ __forceinline__ void store_acc(bf16* dst, int ld,
                                          const float (&d)[DH / 2],
                                          const float (&mul)[2], int lane) {
#pragma unroll
  for (int e = 0; e < DH / 2; e += 2) {
    const float f = mul[(e % 4) / 2];
    *reinterpret_cast<__nv_bfloat162*>(
        dst + static_cast<size_t>(acc_row(e, lane)) * ld +
        acc_col(e, lane)) = __floats2bfloat162_rn(d[e] * f, d[e + 1] * f);
  }
}

// 2^x on the SFU: one ex2.approx.ftz (exp2f adds a range fix-up for
// results under 2^-126, far below the bf16 rounding of p that follows)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O += p V over the 128-key V tile at va (p: its 8 K steps as register
// A); one commit group
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2],
                                         uint32_t (&a)[kBKf / 16][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < kBKf / 16; ++kk)
    wgmma_rs<DH>(acc, a[kk], nmajor(va, kk, 2 * kPanel), 1);
  wgmma_commit();
  acc_fence(acc);
}

// ... issued and waited for: then its V stage (`empty`) is freed
template <int DH>
__device__ __forceinline__ void retire_pv(float (&acc)[DH / 2],
                                          uint32_t (&a)[kBKf / 16][4],
                                          uint32_t va, uint64_t* empty,
                                          int lane) {
  wgmma_fence();
  issue_pv<DH>(acc, a, va);
  wgmma_wait<0>();
  acc_fence(acc);
  frag_fence(a);
  if (lane == 0) mbar_arrive(empty);
}

// K3 (K6 in splash mode), persistent: block k takes units k, k + grid,
// ... of the B Hkv x G nq / 2 (pair, KV head) units, longest pairs
// first, and its producer loads the next unit's q tiles and K/V stages
// while the consumers finish this one.  map_q: [B S, Hq, Dh] in boxes of
// 64 columns x 1 head x 64 rows; map_k, map_v: [B S, Hkv, Dh], boxes of
// kBKf rows
template <int DH, int MODE>
__global__ void __launch_bounds__(kWsThreads, 1)
    fwd_bf16(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             bf16* __restrict__ o, float* __restrict__ lse,
             const int* __restrict__ mask, int S, int Hq, int Hkv,
             float q_mul, int units) {
  constexpr int TB = tile_bytes<DH>();
  constexpr int KT = 2 * TB;            // a 128-key tile
  constexpr int KP = 2 * kPanel;        // ... its 64-column panels
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty_q = full_q + kFwdQSlots;
  uint64_t* full_k = empty_q + kFwdQSlots;   // the K ring
  uint64_t* empty_k = full_k + kFwdKStages;
  uint64_t* full_v = empty_k + kFwdKStages;  // the V ring
  uint64_t* empty_v = full_v + kFwdVStages;
  unsigned char* sQ = base + 1024;      // [slot][item] q, rounded in place
  unsigned char* sK = sQ + kFwdQSlots * 2 * TB;
  unsigned char* sV = sK + kFwdKStages * KT;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int G = Hq / Hkv, nq = S / kBQ;
  const int nbh = units / (G * nq / 2);      // B Hkv
  MaskView mv{};
  if (MODE == kSplash) mv = mask_view(mask, nq, S);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdQSlots; ++s) {
      mbar_init(&full_q[s], 1);
      mbar_init(&empty_q[s], 4 * kConsumers);    // each consumer warp
    }
    for (int s = 0; s < kFwdKStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], 4 * kConsumers);
    }
    for (int s = 0; s < kFwdVStages; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_release<kRegProducer>();
    if (tid == 0) {
      Ring rq, rk, rv;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int hk = u % nbh % Hkv, b = u % nbh / Hkv;
        const Items it = pair_items<MODE, kBKf>(mv, hk, G, nq, u / nbh);
        mbar_wait(&empty_q[rq.slot], rq.phase ^ 1);
        mbar_expect_tx(&full_q[rq.slot], 2 * TB);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int p = 0; p < DH / 64; ++p)
            tma_load(sQ + (rq.slot * 2 + c) * TB + p * kPanel, &map_q,
                     &full_q[rq.slot], p * 64, it.hq[c],
                     b * S + it.qt[c] * kBQ);
        rq.next(kFwdQSlots);
        // K j, then V j - 1: V is used a stage after its K (p V runs
        // behind the next stage's S), and each ring waits only on its own
        for (int j = it.J0; j <= it.J1; ++j) {
          if (j < it.J1) {
            mbar_wait(&empty_k[rk.slot], rk.phase ^ 1);
            mbar_expect_tx(&full_k[rk.slot], KT);
#pragma unroll
            for (int p = 0; p < DH / 64; ++p)
              tma_load(sK + rk.slot * KT + p * KP, &map_k, &full_k[rk.slot],
                       p * 64, hk, b * S + j * kBKf);
            rk.next(kFwdKStages);
          }
          if (j > it.J0) {
            mbar_wait(&empty_v[rv.slot], rv.phase ^ 1);
            mbar_expect_tx(&full_v[rv.slot], KT);
#pragma unroll
            for (int p = 0; p < DH / 64; ++p)
              tma_load(sV + rv.slot * KT + p * KP, &map_v, &full_v[rv.slot],
                       p * 64, hk, b * S + (j - 1) * kBKf);
            rv.next(kFwdVStages);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  reg_claim<kRegConsumer>();
  const int ci = wg - 1, warp = tid / 32, lane = tid % 32;
  // the rings' positions run on from unit to unit, as the producer's
  Ring rq, rk, rv;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int hk = u % nbh % Hkv, b = u % nbh / Hkv;
    const Items it = pair_items<MODE, kBKf>(mv, hk, G, nq, u / nbh);
    const int q0 = ci ? it.qt[1] * kBQ : it.qt[0] * kBQ;
    const int h = ci ? it.hq[1] : it.hq[0];
    const int j0 = ci ? it.j0[1] : it.j0[0], j1 = ci ? it.j1[1] : it.j1[0];
    const int r0 = q0 + warp * 16;      // the warp's first row
    unsigned char* sq = sQ + (rq.slot * 2 + ci) * TB;
    mbar_wait(&full_q[rq.slot], rq.phase);
    scale_bytes(sq, sq, TB, q_mul, tid, 128);
    fence_to_async();
    consumer_sync(ci);

    // splash: this thread's two rows' key intervals
    int rlo[2] = {0, 0}, rhi[2] = {0, 0};
    if (MODE == kSplash) {
      rlo[0] = mv.lo[r0 + lane / 4], rhi[0] = mv.hi[r0 + lane / 4];
      rlo[1] = mv.lo[r0 + lane / 4 + 8], rhi[1] = mv.hi[r0 + lane / 4 + 8];
    }
    const uint32_t qa = smem_addr(sq);
    float acc[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) acc[e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // the pending stage (p packed as register A, p V not yet retired):
    // its V in slot pr of the V ring, at parity pp
    uint32_t a[kBKf / 16][4] = {};
    int pr = -1, pp = 0;
    for (int j = it.J0; j < it.J1; ++j) {
      mbar_wait(&full_k[rk.slot], rk.phase);
      if (j >= j0 && j < j1) {
        const uint32_t ka = smem_addr(sK + rk.slot * KT);
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
          wgmma_ss_n128(s, kmajor(qa, ks, kPanel), kmajor(ka, ks, KP),
                        ks > 0);
        wgmma_commit();
        acc_fence(s);
        if (pr >= 0) {
          // the pending stage's p V runs behind this stage's S and on
          // through its softmax
          mbar_wait(&full_v[pr], pp);
          issue_pv<DH>(acc, a, smem_addr(sV + pr * KT));
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        acc_fence(s);
        if (lane == 0) mbar_arrive(&empty_k[rk.slot]);   // S has read K
        const int c0 = j * kBKf;
        if (MODE == kCausal && c0 + kBKf - 1 > q0) {
#pragma unroll
          for (int e = 0; e < 64; ++e)
            if (c0 + acc_col(e, lane) > r0 + acc_row(e, lane))
              s[e] = kNegInf;
        }
        if (MODE == kSplash && !full_tile(mv, ci ? it.qt[1] : it.qt[0], c0,
                                          kBKf)) {
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            const int col = c0 + acc_col(e, lane), hh = (e % 4) / 2;
            if (col < rlo[hh] || col > rhi[hh]) s[e] = kNegInf;
          }
        }
        // base-2 online softmax, a row half at a time (columns 8t + ...)
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = kNegInf;
#pragma unroll
          for (int t = 0; t < 16; ++t)
            mx = fmaxf(mx, fmaxf(s[4 * t + 2 * hh], s[4 * t + 2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[hh], mx);
          alpha[hh] = ex2(m[hh] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            s[4 * t + 2 * hh] = ex2(s[4 * t + 2 * hh] - m_new);
            s[4 * t + 2 * hh + 1] = ex2(s[4 * t + 2 * hh + 1] - m_new);
            sum += s[4 * t + 2 * hh] + s[4 * t + 2 * hh + 1];
          }
          l[hh] = l[hh] * alpha[hh] + sum;   // this lane's columns
          m[hh] = m_new;
        }
        if (pr >= 0) {
          wgmma_wait<0>();
          acc_fence(acc);
          frag_fence(a);
          if (lane == 0) mbar_arrive(&empty_v[pr]);
        }
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) acc[e] *= alpha[(e % 4) / 2];
#pragma unroll
        for (int kk = 0; kk < kBKf / 16; ++kk) pack_a(a[kk], s, kk);
        pr = rv.slot;
        pp = rv.phase;
      } else {
        // outside this item's range: retire and free the pending stage
        // first, so that a run of skipped stages never leaves the
        // producer waiting on it; then this stage's K and V
        if (pr >= 0) {
          mbar_wait(&full_v[pr], pp);
          retire_pv<DH>(acc, a, smem_addr(sV + pr * KT), &empty_v[pr],
                        lane);
          pr = -1;
        }
        mbar_wait(&full_v[rv.slot], rv.phase);
        if (lane == 0) {
          mbar_arrive(&empty_k[rk.slot]);
          mbar_arrive(&empty_v[rv.slot]);
        }
      }
      rk.next(kFwdKStages);
      rv.next(kFwdVStages);
    }
    if (pr >= 0) {
      mbar_wait(&full_v[pr], pp);
      retire_pv<DH>(acc, a, smem_addr(sV + pr * KT), &empty_v[pr], lane);
    }
    // every S of this unit has retired: its q slot is free
    if (lane == 0) mbar_arrive(&empty_q[rq.slot]);
    rq.next(kFwdQSlots);

    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      inv[hh] = 1.f / l[hh];
    }
    const int ldq = Hq * DH;
    store_acc<DH>(o + (static_cast<size_t>(b) * S + r0) * ldq + h * DH,
                  ldq, acc, inv, lane);
    if (lane % 4 == 0) {
      float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * S + r0;
      lrow[lane / 4] = (m[0] + log2f(l[0])) / kLog2e;
      lrow[lane / 4 + 8] = (m[1] + log2f(l[1])) / kLog2e;
    }
  }
}

// K4 (K7 in splash mode).  map_q, map_do: [B S, Hq, Dh] in boxes of 64
// columns x 1 head x 64 rows; map_k, map_v: [B S, Hkv, Dh], the same box
template <int DH, int MODE>
__global__ void __launch_bounds__(kWsThreads, 1)
    dq_bf16(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_do,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ dcap,
            bf16* __restrict__ dq, const int* __restrict__ mask, int S,
            int Hq, int Hkv, float scale) {
  constexpr int TB = tile_bytes<DH>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kDqStages;
  float* sD = reinterpret_cast<float*>(base + 512);     // [2][64]
  unsigned char* sQ = base + 1024;      // the two items' q, then q * scale
  unsigned char* sO = sQ + 2 * TB;      // their dO
  unsigned char* sK = sO + 2 * TB;      // the K/V ring
  unsigned char* sV = sK + kDqStages * TB;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int G = Hq / Hkv, nq = S / kBQ;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  MaskView mv{};
  if (MODE == kSplash) mv = mask_view(mask, nq, S);
  const Items it = pair_items<MODE, kBK>(mv, hk, G, nq, blockIdx.y);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);    // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_release<kRegProducer>();
    if (tid == 0) {
      mbar_expect_tx(full_q, 4 * TB);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int p = 0; p < DH / 64; ++p) {
          const int row = b * S + it.qt[c] * kBQ;
          tma_load(sQ + c * TB + p * kPanel, &map_q, full_q, p * 64,
                   it.hq[c], row);
          tma_load(sO + c * TB + p * kPanel, &map_do, full_q, p * 64,
                   it.hq[c], row);
        }
      Ring r;
      for (int j = it.J0; j < it.J1; ++j) {
        mbar_wait(&empty[r.slot], r.phase ^ 1);
        mbar_expect_tx(&full[r.slot], 2 * TB);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p) {
          tma_load(sK + r.slot * TB + p * kPanel, &map_k, &full[r.slot],
                   p * 64, hk, b * S + j * kBK);
          tma_load(sV + r.slot * TB + p * kPanel, &map_v, &full[r.slot],
                   p * 64, hk, b * S + j * kBK);
        }
        r.next(kDqStages);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  reg_claim<kRegConsumer>();
  const int ci = wg - 1, warp = tid / 32, lane = tid % 32;
  const int q0 = it.qt[ci] * kBQ, h = it.hq[ci];
  const int ldq = Hq * DH;
  const size_t qoff = (static_cast<size_t>(b) * S + q0) * ldq + h * DH;
  const size_t roff = (static_cast<size_t>(b) * Hq + h) * S + q0;
  {
    // D = rowsum(dO * O) in f32: two threads per row
    const int r = tid / 2, half = tid % 2;
    const size_t off = qoff + static_cast<size_t>(r) * ldq + half * (DH / 2);
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 2; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c);
      const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]);
        const float2 g = __bfloat1622float2(g2[i]);
        d += a.x * g.x + a.y * g.y;
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sD[ci * 64 + r] = d;
      dcap[roff + r] = d;
    }
  }
  mbar_wait(full_q, 0);
  scale_bytes(sQ + ci * TB, sQ + ci * TB, TB, scale, tid, 128);
  fence_to_async();
  consumer_sync(ci);

  // this thread's two rows: lse, D and (splash) their key intervals
  const int rl = warp * 16 + lane / 4;
  // lse * log2(e): p = exp2(s log2(e) - lse log2(e)) (see Numerics)
  const float lrow[2] = {lse[roff + rl] * kLog2e,
                         lse[roff + rl + 8] * kLog2e};
  const float drow[2] = {sD[ci * 64 + rl], sD[ci * 64 + rl + 8]};
  int rlo[2] = {0, 0}, rhi[2] = {0, 0};
  if (MODE == kSplash) {
    rlo[0] = mv.lo[q0 + rl], rhi[0] = mv.hi[q0 + rl];
    rlo[1] = mv.lo[q0 + rl + 8], rhi[1] = mv.hi[q0 + rl + 8];
  }
  const uint32_t qa = smem_addr(sQ + ci * TB), oa = smem_addr(sO + ci * TB);
  float acc[DH / 2];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) acc[e] = 0.f;
  Ring r;
  uint32_t a[4][4] = {};
  int held = -1;             // the slot whose dQ product is in flight
  for (int j = it.J0; j < it.J1; ++j) {
    mbar_wait(&full[r.slot], r.phase);
    if (j >= it.j0[ci] && j < it.j1[ci]) {
      const uint32_t ka = smem_addr(sK + r.slot * TB);
      const uint32_t va = smem_addr(sV + r.slot * TB);
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_ss_n64(s, kmajor(qa, ks, kPanel), kmajor(ka, ks, kPanel),
                     ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_ss_n64(dp, kmajor(oa, ks, kPanel), kmajor(va, ks, kPanel),
                     ks > 0);
      wgmma_commit();
      acc_fence(s);
      acc_fence(dp);
      wgmma_wait<1>();
      acc_fence(s);
      frag_fence(a);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      const int c0 = j * kBK;
      if (MODE == kCausal && c0 + kBK - 1 > q0) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (c0 + acc_col(e, lane) > q0 + warp * 16 + acc_row(e, lane))
            s[e] = kNegInf;
      }
      if (MODE == kSplash && !full_tile(mv, it.qt[ci], c0, kBK)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = c0 + acc_col(e, lane), hh = (e % 4) / 2;
          if (col < rlo[hh] || col > rhi[hh]) s[e] = kNegInf;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = exp2f(fmaf(s[e], kLog2e, -lrow[(e % 4) / 2]));
      wgmma_wait<0>();
      acc_fence(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e % 4) / 2;
        s[e] = s[e] * (dp[e] - drow[hh]) * scale;              // ds
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(a[kk], s, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DH>(acc, a[kk], nmajor(ka, kk), 1);      // += ds K
      wgmma_commit();
      acc_fence(acc);
      held = r.slot;
    } else {
      // outside this item's range: free the held stage first, so that
      // a run of skipped stages never leaves the producer waiting on it
      if (held >= 0) {
        wgmma_wait<0>();
        acc_fence(acc);
        frag_fence(a);
        if (lane == 0) mbar_arrive(&empty[held]);
        held = -1;
      }
      if (lane == 0) mbar_arrive(&empty[r.slot]);
    }
    r.next(kDqStages);
  }
  wgmma_wait<0>();
  acc_fence(acc);
  frag_fence(a);
  if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
  store_acc<DH>(dq + qoff + static_cast<size_t>(warp) * 16 * ldq, ldq, acc,
                lane);
}

// K5 (K8 in splash mode).  map_q, map_do: as K4's; map_k, map_v: [B S,
// Hkv, Dh] in boxes of 64 columns x 1 head x kBKd rows
template <int DH, int MODE>
__global__ void __launch_bounds__(kWsThreads, 1)
    dkv_bf16(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_do,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const float* __restrict__ lse, const float* __restrict__ dcap,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             const int* __restrict__ mask, int S, int Hq, int Hkv,
             float scale) {
  constexpr int TB = tile_bytes<DH>();
  constexpr int SB = dkv_stage_bytes<DH>();
  constexpr int KP = 2 * kPanel;        // a 128-key tile's panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(base);
  uint64_t* full = full_kv + 1;         // q, dO and rows landed
  uint64_t* ready = full + kDkvStages;  // q * scale written
  uint64_t* empty = ready + kDkvStages;
  unsigned char* sK = base + 1024;      // 128 keys: DH / 64 panels of KP
  unsigned char* sV = sK + 2 * TB;
  unsigned char* stages = sV + 2 * TB;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int G = Hq / Hkv, nq = S / kBQ;
  const int k0 = blockIdx.y * kBKd;                   // longest first
  // visit range [first, last] of q tiles
  int first = MODE == kCausal ? k0 / kBQ : 0, last = nq - 1;
  MaskView mv{};
  if (MODE == kSplash) {
    mv = mask_view(mask, S / kBKd, S);
    first = mv.first[blockIdx.y];
    last = mv.last[blockIdx.y];
  }
  const int per_head = last + 1 - first;
  const int iters = per_head > 0 ? G * per_head : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    reg_release<kRegProducer>();
    if (tid == 0) {
      mbar_expect_tx(full_kv, 4 * TB);
#pragma unroll
      for (int p = 0; p < DH / 64; ++p) {
        tma_load(sK + p * KP, &map_k, full_kv, p * 64, hk, b * S + k0);
        tma_load(sV + p * KP, &map_v, full_kv, p * 64, hk, b * S + k0);
      }
      Ring r;
      for (int it = 0; it < iters; ++it) {
        const int h = hk * G + it / per_head;
        const int q0 = (first + it % per_head) * kBQ;
        const size_t roff = (static_cast<size_t>(b) * Hq + h) * S + q0;
        unsigned char* st = stages + r.slot * SB;
        mbar_wait(&empty[r.slot], r.phase ^ 1);
        mbar_expect_tx(&full[r.slot],
                       2 * TB + (MODE == kSplash ? 4 : 2) * kBQ * 4);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p) {
          tma_load(st + p * kPanel, &map_q, &full[r.slot], p * 64, h,
                   b * S + q0);
          tma_load(st + TB + p * kPanel, &map_do, &full[r.slot], p * 64, h,
                   b * S + q0);
        }
        float* rows = reinterpret_cast<float*>(st + 3 * TB);
        bulk_load(rows, lse + roff, kBQ * 4, &full[r.slot]);
        bulk_load(rows + kBQ, dcap + roff, kBQ * 4, &full[r.slot]);
        if (MODE == kSplash) {
          bulk_load(rows + 2 * kBQ, mv.lo + q0, kBQ * 4, &full[r.slot]);
          bulk_load(rows + 3 * kBQ, mv.hi + q0, kBQ * 4, &full[r.slot]);
        }
        r.next(kDkvStages);
      }
    } else if (tid >= 32) {
      // bf16(q * scale) beside each landed q tile
      Ring r;
      for (int it = 0; it < iters; ++it) {
        unsigned char* st = stages + r.slot * SB;
        mbar_wait(&full[r.slot], r.phase);
        scale_bytes(st + 2 * TB, st, TB, scale, tid - 32,
                    kHelperWarps * 32);
        fence_to_async();
        helper_sync();
        if (tid == 32) mbar_arrive(&ready[r.slot]);
        r.next(kDkvStages);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  reg_claim<kRegConsumer>();
  const int ci = wg - 1, warp = tid / 32, lane = tid % 32;
  const int key0 = k0 + ci * 64 + warp * 16;      // the warp's first key
  const uint32_t ka = smem_addr(sK) + ci * kPanel;
  const uint32_t va = smem_addr(sV) + ci * kPanel;
  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) dka[e] = dva[e] = 0.f;
  mbar_wait(full_kv, 0);
  Ring r;
  for (int it = 0; it < iters; ++it) {
    const int qt = first + it % per_head, q0 = qt * kBQ;
    unsigned char* st = stages + r.slot * SB;
    const uint32_t sqa = smem_addr(st), soa = sqa + TB, ssa = sqa + 2 * TB;
    const float* sl = reinterpret_cast<const float*>(st + 3 * TB);
    const float* sd = sl + kBQ;
    mbar_wait(&full[r.slot], r.phase);
    mbar_wait(&ready[r.slot], r.phase);
    float s[32], dp[32];                 // s^T, dp^T: keys x queries
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss_n64(s, kmajor(ka, ks, KP), kmajor(ssa, ks, kPanel), ks > 0);
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_ss_n64(dp, kmajor(va, ks, KP), kmajor(soa, ks, kPanel), ks > 0);
    wgmma_commit();
    acc_fence(s);
    acc_fence(dp);
    wgmma_wait<0>();
    acc_fence(s);
    acc_fence(dp);
    if (MODE == kCausal && q0 < key0 + 15) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (key0 + acc_row(e, lane) > q0 + acc_col(e, lane)) s[e] = kNegInf;
    }
    if (MODE == kSplash && !full_tile(mv, qt, k0, kBKd)) {
      // the q tile's row bounds, staged with it
      const int* sb = reinterpret_cast<const int*>(sl + 2 * kBQ);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = key0 + acc_row(e, lane), c = acc_col(e, lane);
        if (key < sb[c] || key > sb[kBQ + c]) s[e] = kNegInf;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = acc_col(e, lane);
      const float p = exp2f(fmaf(s[e], kLog2e, -sl[c] * kLog2e));
      s[e] = p;
      dp[e] = p * (dp[e] - sd[c]) * scale;            // ds^T
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DH>(dva, pa[kk], nmajor(soa, kk), 1);   // dv += p^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DH>(dka, da[kk], nmajor(sqa, kk), 1);   // dk += ds^T q
    wgmma_commit();
    acc_fence(dva);
    acc_fence(dka);
    wgmma_wait<0>();
    acc_fence(dva);
    acc_fence(dka);
    frag_fence(pa);
    frag_fence(da);
    if (lane == 0) mbar_arrive(&empty[r.slot]);
    r.next(kDkvStages);
  }
  const int ldk = Hkv * DH;
  const size_t woff = (static_cast<size_t>(b) * S + key0) * ldk + hk * DH;
  store_acc<DH>(dk + woff, ldk, dka, lane);
  store_acc<DH>(dv + woff, ldk, dva, lane);
}

// -------------------------------------------- float32 (CUDA-core) kernels
//
// One thread per query (forward, dq) or key (dk/dv) row.  Each walks the
// keys (queries) its row can see: all, the causal triangle, or under a
// BlockMask the row's interval clipped to its tile's visit range.

constexpr int kRowThreads = 128;

// the keys [jb, je) query `row` visits; bk: the key tiles of the
// BlockMask's visit ranges (the forward's kBKf, dq's kBK)
__device__ __forceinline__ void key_range(int row, int S, int mode,
                                          const int* mask, int bk, int& jb,
                                          int& je) {
  jb = 0;
  je = mode == kCausal ? row + 1 : S;
  if (mode == kSplash) {
    const MaskView mv = mask_view(mask, S / kBQ, S);
    const int qt = row / kBQ;
    jb = max(mv.lo[row], mv.first[qt] * bk);
    je = min(mv.hi[row], mv.last[qt] * bk + bk - 1) + 1;
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
  key_range(row, S, mode, mask, kBKf, jb, je);
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
  key_range(row, S, mode, mask, kBK, jb, je);
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

// a [B S, H, Dh] bf16 tensor's TMA map: boxes of 64 columns (128 bytes,
// the swizzle's span) x 1 head x `rows` rows
cudaError_t head_map(CUtensorMap* map, const void* p, int BS, int H, int DH,
                     int rows) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, DH, H, BS,
                  64, 1, CU_TENSOR_MAP_SWIZZLE_128B, rows);
}

template <int DH, int MODE>
cudaError_t fwd_bf16_launch(const void* q, const void* k, const void* v,
                            void* o, float* lse, const int* mask, int B,
                            int S, int Hq, int Hkv, float q_mul,
                            cudaStream_t stream) {
  static_assert(fwd_smem<DH>() <= 232448, "shared memory");
  CUtensorMap mq = {}, mk = {}, mv = {};
  cudaError_t err = head_map(&mq, q, B * S, Hq, DH, kBQ);
  if (err == cudaSuccess) err = head_map(&mk, k, B * S, Hkv, DH, kBKf);
  if (err == cudaSuccess) err = head_map(&mv, v, B * S, Hkv, DH, kBKf);
  if (err != cudaSuccess) return err;
  auto kernel = fwd_bf16<DH, MODE>;
  const size_t smem = fwd_smem<DH>();
  err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // units: a pair of (q head, q tile) items of one KV head, as K4's
  // blocks; one persistent block an SM
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int units = B * Hkv * (Hq / Hkv * (S / kBQ) / 2);
  kernel<<<units < sms ? units : sms, kWsThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, mask, S, Hq, Hkv, q_mul,
      units);
  return cudaGetLastError();
}

template <int DH, int MODE>
cudaError_t dq_bf16_launch(const void* q, const void* k, const void* v,
                           const void* o, const void* dout,
                           const float* lse, float* dcap, void* dq,
                           const int* mask, int B, int S, int Hq, int Hkv,
                           float scale, cudaStream_t stream) {
  static_assert(dq_smem<DH>() <= 232448, "shared memory");
  CUtensorMap mq = {}, mdo = {}, mk = {}, mv = {};
  cudaError_t err = head_map(&mq, q, B * S, Hq, DH, kBQ);
  if (err == cudaSuccess) err = head_map(&mdo, dout, B * S, Hq, DH, kBQ);
  if (err == cudaSuccess) err = head_map(&mk, k, B * S, Hkv, DH, kBK);
  if (err == cudaSuccess) err = head_map(&mv, v, B * S, Hkv, DH, kBK);
  if (err != cudaSuccess) return err;
  auto kernel = dq_bf16<DH, MODE>;
  const size_t smem = dq_smem<DH>();
  err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // one block a pair of (q head, q tile) items of one KV head
  kernel<<<dim3(B * Hkv, Hq / Hkv * (S / kBQ) / 2), kWsThreads, smem,
           stream>>>(mq, mdo, mk, mv, static_cast<const bf16*>(o),
                     static_cast<const bf16*>(dout), lse, dcap,
                     static_cast<bf16*>(dq), mask, S, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <int DH, int MODE>
cudaError_t dkv_bf16_launch(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* dcap, void* dk, void* dv,
                            const int* mask, int B, int S, int Hq, int Hkv,
                            float scale, cudaStream_t stream) {
  static_assert(dkv_smem<DH>() <= 232448, "shared memory");
  CUtensorMap mq = {}, mdo = {}, mk = {}, mv = {};
  cudaError_t err = head_map(&mq, q, B * S, Hq, DH, kBQ);
  if (err == cudaSuccess) err = head_map(&mdo, dout, B * S, Hq, DH, kBQ);
  if (err == cudaSuccess) err = head_map(&mk, k, B * S, Hkv, DH, kBKd);
  if (err == cudaSuccess) err = head_map(&mv, v, B * S, Hkv, DH, kBKd);
  if (err != cudaSuccess) return err;
  auto kernel = dkv_bf16<DH, MODE>;
  const size_t smem = dkv_smem<DH>();
  err = with_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * Hkv, S / kBKd), kWsThreads, smem, stream>>>(
      mq, mdo, mk, mv, lse, dcap, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), mask, S, Hq, Hkv, scale);
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

// K6: the forward under a BlockMask at 64 x 128 tiles (mask: MaskView's
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
