// The native tier's device burn: a strictly sequential chain
//
//     state <- tanh(state @ state / n)      n = 256
//
// written by hand for Hopper (sm_90a), the counterpart of the JAX
// package's StableHLO burn module (native/include/dlnb/stablehlo_gen.hpp)
// and of the port's torch chain (proxies/burn.py), with their rounding:
// the product summed in f32 (bf16 x bf16 products are exact in f32),
// scaled, passed through tanh in f32 and rounded to the bf16 state.
//
// Bound: an iteration is 2 x 256^3 = 33.5 Mflop on 128 KiB of state, so
// the whole card would take 0.034 us; one SM's share of the tensor
// cores needs 4.5 us.  The chain is sequential, so the work of one
// iteration is spread over the SMs of one thread-block cluster, and the
// state moves between them through distributed shared memory (DSMEM):
//
//   * Grid: one cluster of kCluster = 8 CTAs (the portable size), CTA
//     (mi, nj) = cluster rank 4 mi + nj owns the 128 x 64 output tile
//     at rows 128 mi, columns 64 nj.  Eight, not sixteen: the smallest
//     cluster whose double-buffered inputs fit in shared memory, and the
//     fewer SMs of one GPC it needs free at once, the sooner it starts
//     beside NCCL's kernels.
//   * Inputs of a tile: the state's row slab mi as A (128 x 256, K-major,
//     four 16 KiB k-blocks) and its column slab nj as B (256 x 64,
//     MN-major), 96 KiB; two such buffers, the current and the next.
//     Every operand row is 128 bytes with its 16-byte chunks XOR-swizzled
//     by row % 8 on a 1024-byte-aligned base: the 128-byte swizzle that
//     wgmma's descriptors read, for A (K-major) and B (MN-major) alike.
//   * Product: two warpgroups, each wgmma m64n64k16 (bf16 in, f32
//     accumulate in registers) over 64 rows of the tile, 16 k-steps.
//   * Exchange: a tile in that layout is one contiguous 16 KiB block in
//     both of the buffers it feeds: k-block nj of A for the CTAs of row
//     group mi, rows 128 mi of B for those of column group nj.  The
//     epilogue (scale, tanh, bf16) writes it into the CTA's own next A
//     and B; every thread then stores its share of it, 16 bytes a
//     st.async, into the next buffer of the four peers (three of the row
//     group, one of the column group), each store completing its bytes
//     on the peer's mbarrier for that buffer.  A CTA then waits on that
//     one mbarrier.  (One thread's cp.async.bulk of each 16 KiB tile
//     took 0.6 us more an iteration.  On an H100 the 64 KiB an SM
//     receives take about 2 us, some 30 GB/s, against 1.4 us for the
//     product: the exchange, not the product, is most of an iteration.)
//   * Why one wait an iteration is enough: the CTAs a CTA sends to are
//     exactly those it receives from.  So no peer can start iteration
//     t + 1, and overwrite buffer t % 2, before every reader of that
//     buffer has sent its own iteration-t tile, which it does after its
//     last read of that buffer.
//   * The stop decision is taken by cluster rank 0 alone (a CTA that
//     stopped by itself would leave its peers waiting for its tile).  It
//     goes to every other CTA as a 4-byte st.async on the same mbarrier,
//     and every other CTA sends rank 0 a 4-byte acknowledgement with its
//     tiles.  Rank 0 is no peer of the three CTAs outside its row and
//     column groups, so without the acknowledgement it could run two
//     iterations ahead of them and land a flag on a barrier phase they
//     have not finished; with it, rank 0 starts iteration t + 1 only
//     after all seven have sent their iteration-t tiles, as above.
//   * The state is loaded from global memory at the start of a launch,
//     each CTA its own slabs, and each CTA stores its tile at the end.
//   A launch that is refused (the cluster does not fit, the cap cannot
//   be raised) fails the burn with its CUDA error: there is no other
//   kernel to fall back on.
//
// A requested time rarely is a whole number of iterations, and a launch
// has a fixed cost (the state's load and store, the next launch) that
// grows on a card the host left idle.  So a burn is the chain, which
// starts no iteration with less than `lead_ns` of the time asked left
// (the host passes two iterations and the launch's fixed cost: the
// iteration, and one of slack for a card slower than its calibration),
// and then a spin on %globaltimer until the time asked has passed since
// the burn's first kernel began.  The spin runs at the end of the
// chain's last launch (flag kFinish), not in a kernel of its own: after
// a short chain on a card the host left idle, a second launch could
// begin tens of microseconds after the chain's end, and the burn overran
// the time asked.  A burn shorter than the lead is finish_kernel's spin
// alone.  Both book on a
// per-rank clock (BurnClock), once a burn: the burns' device span and
// the iterations run, which the records report beside the time
// requested.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 256;
constexpr int kTileM = 128, kTileN = 64;  // a CTA's output tile
constexpr int kGridM = kN / kTileM, kGridN = kN / kTileN;  // 2 x 4
constexpr int kCluster = kGridM * kGridN;
constexpr int kThreads = 256;  // two warpgroups of 64 tile rows
constexpr int kChunk = 1024;   // iterations a launch at most
constexpr int kRow = 128;      // bytes an operand row: 64 bf16
constexpr int kTile = kTileM * kRow;          // 16 KiB
constexpr int kA = kGridN * kTile;            // row slab: 4 k-blocks
constexpr int kBuf = kA + kGridM * kTile;     // + column slab: 96 KiB
constexpr int kSmem = 2 * kBuf + 1024;        // + the 1024-byte alignment
constexpr uint32_t kPeerBytes = (kGridN - 1 + kGridM - 1) * kTile;
// dlnb_burn_launch's flags
constexpr int kStamp = 1;   // this launch begins the burn: stamp the clock
constexpr int kFinish = 2;  // this launch ends it: spin to the budget, book

struct BurnClock {
  unsigned long long t0;      // the running burn's first kernel began
  unsigned long long spent;   // ns of device time, every burn so far
  unsigned long long iters;   // iterations of the chain, every burn so far
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// byte offset of element (row, col) in a swizzled region of 128-byte rows
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * kRow + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address of the same shared byte in cluster CTA `rank`
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
      :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// 16 bytes to a peer's shared memory, counted on its mbarrier `bar`
// (both cluster addresses)
__device__ __forceinline__ void vec_to_peer(uint32_t dst, uint4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// a 4-byte word to a peer, counted on its mbarrier
__device__ __forceinline__ void word_to_peer(uint32_t dst, uint32_t v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
      "[%0], %1, [%2];"
      :: "r"(dst), "r"(v), "r"(bar) : "memory");
}

// the generic proxy's shared-memory accesses, ordered with wgmma's (the
// async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart (the stride byte offset); the leading byte offset is not
// read for these layouts (a K-major k-step stays inside a 128-byte row,
// an MN-major tile is one 64-element atom wide)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A[64 x 16] @ B[16 x 64]; A K-major, B MN-major (transposed)
__device__ __forceinline__ void wgmma_64x64(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack(float x, float y, float scale) {
  __nv_bfloat162 v = __floats2bfloat162_rn(tanhf(x * scale), tanhf(y * scale));
  return *reinterpret_cast<uint32_t*>(&v);
}

// `iters` iterations, or with a `clock` fewer: none starts with less
// than `lead_ns` of `budget_ns` left since the clock's t0 (stamped here
// when `mode` has kStamp); with kFinish, then a spin until `budget_ns`
// have passed since t0, booked on the clock.  One cluster of kCluster
// CTAs (header comment).
__global__ void __launch_bounds__(kThreads, 1)
    burn_kernel(__nv_bfloat16* g, int iters, BurnClock* clock, int mode,
                long long budget_ns, long long lead_ns) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];  // a buffer's peer bytes
  __shared__ uint32_t flags[2];  // rank 0's stop decision, by buffer
  __shared__ uint32_t acks;      // rank 0: the others' acknowledgements
  __shared__ uint32_t stop0;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int mi = rank / kGridN, nj = rank % kGridN;
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t flag0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(flags));
  const uint32_t ack =
      static_cast<uint32_t>(__cvta_generic_to_shared(&acks));
  unsigned long long t0 = 0;
  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (rank == 0 && clock) {
      t0 = now_ns();
      if (mode & kStamp) clock->t0 = t0;
      else t0 = clock->t0;
    }
  }
  // rank 0's thread 0 only
  auto late = [&] {
    return clock != nullptr &&
           static_cast<long long>(now_ns() - t0) + lead_ns > budget_ns;
  };
  // this CTA's slabs into buffer 0: A's row r, column c at k-block c / 64
  const uint4* gin = reinterpret_cast<const uint4*>(g);
  for (int q = tid; q < kTileM * kN / 8; q += kThreads) {
    const int r = q / (kN / 8), c = (q % (kN / 8)) * 8;
    *reinterpret_cast<uint4*>(smem + (c / kTileN) * kTile +
                              swz(r, c % kTileN)) =
        gin[((kTileM * mi + r) * kN + c) / 8];
  }
  for (int q = tid; q < kN * kTileN / 8; q += kThreads) {
    const int k = q / (kTileN / 8), c = (q % (kTileN / 8)) * 8;
    *reinterpret_cast<uint4*>(smem + kA + swz(k, c)) =
        gin[(k * kN + kTileN * nj + c) / 8];
  }
  fence_async_smem();
  cluster_sync();  // every CTA has started and its barriers are set
  if (rank == 0 && tid == 0) {
    const uint32_t s = late();
    for (uint32_t p = 0; p < kCluster; ++p)
      asm volatile("st.shared::cluster.u32 [%0], %1;"
                   :: "r"(peer(static_cast<uint32_t>(
                                   __cvta_generic_to_shared(&stop0)), p)),
                      "r"(s) : "memory");
  }
  cluster_sync();
  bool stop = stop0 != 0;

  const int wg = tid / 128, w4 = (tid / 32) % 4, lane = tid % 32;
  const int row0 = 64 * wg + 16 * w4 + lane / 4;  // the tile's, and +8
  const float scale = 1.0f / kN;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  int it = 0;
  for (; it < iters && !stop; ++it) {
    const uint32_t cur = base + (it & 1) * kBuf;
    const uint32_t nxt = base + ((it + 1) & 1) * kBuf;
    unsigned char* nxt_p = smem + ((it + 1) & 1) * kBuf;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < kN / 16; ++s)
      wgmma_64x64(acc,
                  desc(cur + (s / 4) * kTile + wg * 64 * kRow + (s % 4) * 32),
                  desc(cur + kA + s * 16 * kRow), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    // the tile into this CTA's own next A (k-block nj) and B (rows 128 mi)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      const uint32_t lo = pack(acc[4 * i], acc[4 * i + 1], scale);
      const uint32_t hi = pack(acc[4 * i + 2], acc[4 * i + 3], scale);
      unsigned char* a = nxt_p + nj * kTile;
      unsigned char* b = nxt_p + kA + mi * kTile;
      *reinterpret_cast<uint32_t*>(a + swz(row0, col)) = lo;
      *reinterpret_cast<uint32_t*>(a + swz(row0 + 8, col)) = hi;
      *reinterpret_cast<uint32_t*>(b + swz(row0, col)) = lo;
      *reinterpret_cast<uint32_t*>(b + swz(row0 + 8, col)) = hi;
    }
    fence_async_smem();
    __syncthreads();
    if (it + 1 == iters) continue;  // the last: nobody reads this tile
    const uint32_t bar = bar0 + 8 * ((it + 1) & 1);
    const uint32_t flag = flag0 + 4 * ((it + 1) & 1);
    // the tile, 16 bytes a store from every thread, into the next A of
    // the row group's peers and the next B of the column group's
    for (int q = tid; q < kTile / 16; q += kThreads) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(nxt_p + nj * kTile + 16 * q);
      for (int n = 0; n < kGridN; ++n)
        if (n != nj) {
          const uint32_t p = mi * kGridN + n;
          vec_to_peer(peer(nxt + nj * kTile + 16 * q, p), v, peer(bar, p));
        }
      for (int m = 0; m < kGridM; ++m)
        if (m != mi) {
          const uint32_t p = m * kGridN + nj;
          vec_to_peer(peer(nxt + kA + mi * kTile + 16 * q, p), v,
                      peer(bar, p));
        }
    }
    if (tid == 0) {
      if (rank == 0) {
        const uint32_t s = late();
        flags[(it + 1) & 1] = s;
        for (uint32_t p = 1; p < kCluster; ++p)
          word_to_peer(peer(flag, p), s, peer(bar, p));
        bar_expect(bar, kPeerBytes + 4 * (kCluster - 1));
      } else {
        word_to_peer(peer(ack, 0), 1, peer(bar, 0));
        bar_expect(bar, kPeerBytes + 4);
      }
    }
    bar_wait(bar, (it >> 1) & 1);
    fence_async_smem();  // the peers' stores, seen by the next wgmma
    stop = flags[(it + 1) & 1] != 0;
  }
  // this CTA's tile, from the buffer the last iteration wrote
  const unsigned char* fin = smem + (it & 1) * kBuf + nj * kTile;
  uint4* gout = reinterpret_cast<uint4*>(g);
  for (int q = tid; q < kTileM * kTileN / 8; q += kThreads) {
    const int r = q / (kTileN / 8), c = (q % (kTileN / 8)) * 8;
    gout[((kTileM * mi + r) * kN + kTileN * nj + c) / 8] =
        *reinterpret_cast<const uint4*>(fin + swz(r, c));
  }
  if (clock && rank == 0 && tid == 0) {
    clock->iters += it;
    if (mode & kFinish) {
      unsigned long long t = now_ns();
      while (static_cast<long long>(t - t0) < budget_ns) t = now_ns();
      clock->spent += t - t0;
    }
  }
  cluster_sync();  // no CTA exits while its stores into a peer may fly
}

// The end of a burn: spin until `ns` have passed since the burn's first
// kernel began (this one, when `stamp`), then book the span.
__global__ void finish_kernel(BurnClock* clock, long long ns, int stamp) {
  unsigned long long t = now_ns();
  if (stamp) clock->t0 = t;
  const unsigned long long t0 = clock->t0;
  while (static_cast<long long>(t - t0) < ns) t = now_ns();
  clock->spent += t - t0;
}

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// A seeded state in (-0.5, 0.5), like the torch burn's make_state range.
__global__ void init_kernel(__nv_bfloat16* g, unsigned long long seed) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kN * kN) return;
  unsigned long long r = splitmix64(seed * 0x100000001b3ULL + i);
  float u = static_cast<float>(r >> 40) / static_cast<float>(1ULL << 24);
  g[i] = __float2bfloat16_rn((2.0f * u - 1.0f) * 0.5f);
}

__global__ void spin_kernel(long long ns) {
  const unsigned long long t0 = now_ns();
  while (static_cast<long long>(now_ns() - t0) < ns) {
  }
}

// The smallest step of %globaltimer seen over `samples` changes.
__global__ void tick_kernel(unsigned long long* out, int samples) {
  unsigned long long prev = now_ns(), least = ~0ULL;
  for (int n = 0; n < samples;) {
    unsigned long long t = now_ns();
    if (t != prev) {
      if (t - prev < least) least = t - prev;
      prev = t;
      ++n;
    }
  }
  *out = least;
}

// A block that holds its SM for `ns` (its dynamic shared memory keeps a
// second block, and a burn CTA, off it): the earliest start and the
// count of blocks started, for the start-delay probe.
__global__ void hold_kernel(long long ns, unsigned long long* first,
                            unsigned int* started) {
  if (threadIdx.x != 0) return;
  const unsigned long long t0 = now_ns();
  atomicMin(first, t0);
  atomicAdd(started, 1u);
  while (static_cast<long long>(now_ns() - t0) < ns) {
  }
}

// Waits until `want` holder blocks have started, or `timeout_ns` passed;
// stamps its end at `done`.
__global__ void wait_count_kernel(const unsigned int* started,
                                  unsigned int want, long long timeout_ns,
                                  unsigned long long* done) {
  const unsigned long long t0 = now_ns();
  unsigned long long t = t0;
  while (*reinterpret_cast<const volatile unsigned int*>(started) < want &&
         static_cast<long long>(t - t0) < timeout_ns)
    t = now_ns();
  *done = now_ns();
}

// cudaFuncSetAttribute applies to the current device: raise the kernel's
// shared-memory cap once a device.
bool ensure_smem() {
  static int done[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return false;
  if (!__atomic_load_n(&done[dev], __ATOMIC_ACQUIRE)) {
    if (cudaFuncSetAttribute(burn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess)
      return false;
    __atomic_store_n(&done[dev], 1, __ATOMIC_RELEASE);
  }
  return true;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int dlnb_burn_chunk() { return kChunk; }
extern "C" int dlnb_burn_clock_bytes() { return sizeof(BurnClock); }

extern "C" int dlnb_burn_init(void* state, unsigned long long seed,
                              void* stream) {
  init_kernel<<<kN * kN / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(state), seed);
  return static_cast<int>(cudaGetLastError());
}

// The chain's shape on the current card: CTAs a cluster, shared memory a
// CTA, and how many such clusters the card could hold at once.
extern "C" int dlnb_burn_shape(int* cluster, int* smem, int* max_clusters) {
  *cluster = kCluster;
  *smem = kSmem;
  if (!ensure_smem()) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(max_clusters, burn_kernel, &cfg));
}

// Queue `iters` (1..kChunk) iterations of the chain on `stream`.  With a
// non-null `clock` none starts with less than `lead_ns` of `budget_ns`
// left since the burn's start (this launch's, with flag kStamp = 1), and
// with kFinish = 2 the launch ends the burn: it spins until `budget_ns`
// have passed since that start and books the span.
extern "C" int dlnb_burn_launch(void* state, long long iters, void* clock,
                                int flags, long long budget_ns,
                                long long lead_ns, void* stream) {
  if (iters <= 0) return 0;
  if (iters > kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (!ensure_smem()) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(&attr, static_cast<cudaStream_t>(stream));
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, burn_kernel, static_cast<__nv_bfloat16*>(state),
      static_cast<int>(iters), static_cast<BurnClock*>(clock), flags,
      budget_ns, lead_ns);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dlnb_burn_finish(void* clock, long long ns, int stamp,
                                void* stream) {
  finish_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<BurnClock*>(clock), ns, stamp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dlnb_spin_launch(long long ns, void* stream) {
  spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ns);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dlnb_timer_tick(void* out, int samples, void* stream) {
  tick_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out), samples);
  return static_cast<int>(cudaGetLastError());
}

// `blocks` holder blocks of `smem` bytes each for `ns` on `stream`
// (`first` set to ~0 and `started` to 0 beforehand).
extern "C" int dlnb_hold_launch(int blocks, int smem, long long ns,
                                void* first, void* started, void* stream) {
  if (cudaFuncSetAttribute(hold_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  hold_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      ns, static_cast<unsigned long long*>(first),
      static_cast<unsigned int*>(started));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dlnb_wait_count(void* started, int want, long long timeout_ns,
                               void* done, void* stream) {
  wait_count_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(started),
      static_cast<unsigned int>(want), timeout_ns,
      static_cast<unsigned long long*>(done));
  return static_cast<int>(cudaGetLastError());
}
