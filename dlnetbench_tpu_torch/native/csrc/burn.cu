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
// Design: one block of 512 threads (16 warps) keeps the whole 256 x 256
// bf16 state in shared memory (128 KiB) and loops a chunk of iterations,
// so a burn of any length is a handful of launches and no host work an
// iteration.  The product runs on the tensor cores: mma.sync m16n8k16
// (bf16 in, f32 accumulate), the operands read with ldmatrix (A as
// stored, B transposed), the rows' 16-byte chunks XOR-swizzled by row % 8
// so neither ldmatrix nor the output's stores meet a bank conflict.  Each
// pass covers 128 output rows, a warp a 32 x 64 tile of it; the new state
// may only replace the old once every thread has read it, so the first
// pass's half waits in a 64 KiB shared buffer and the second pass's in
// registers.  One SM does the work: the burn is a calibrated time, not a
// throughput, and it leaves the other SMs to the collectives it overlaps.
//
// A requested time rarely is a whole number of iterations, and a launch
// has a fixed cost (the state's load and store, the next launch) that
// grows on a card the host left idle.  So a burn is the chain, which
// starts no iteration with less than `lead_ns` of the time asked left
// (the host passes two iterations and the launch's fixed cost: the
// iteration, and one of slack for a card slower than its calibration),
// and then finish_kernel, which spins on %globaltimer until the time
// asked has passed since the burn's first kernel began.  Both book on a
// per-rank clock (BurnClock): the burns' device span and the iterations
// run, which the records report beside the time requested.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 256;
constexpr int kThreads = 512;
constexpr int kChunk = 1024;  // iterations a launch at most
constexpr int kRow = kN * 2;  // bytes a row
constexpr int kSmem = kN * kRow + (kN / 2) * kRow;  // state + half the next

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

// byte offset of (row, 16-byte chunk) in a swizzled 512-byte-row buffer
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kRow + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float x, float y, float scale) {
  __nv_bfloat162 v = __floats2bfloat162_rn(tanhf(x * scale), tanhf(y * scale));
  return *reinterpret_cast<uint32_t*>(&v);
}

// `iters` iterations, or with a `clock` fewer: none starts with less
// than `lead_ns` of `budget_ns` left since the clock's t0 (stamped here
// when `stamp`).
__global__ void __launch_bounds__(kThreads, 1)
    burn_kernel(__nv_bfloat16* g, int iters, BurnClock* clock, int stamp,
                long long budget_ns, long long lead_ns) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int stop;
  unsigned char* half = smem + kN * kRow;
  const int tid = threadIdx.x;
  unsigned long long t0 = 0;
  if (clock && tid == 0) {
    t0 = now_ns();
    if (stamp) clock->t0 = t0;
    else t0 = clock->t0;
  }
  // thread 0 only; the others read `stop` after a barrier
  auto late = [&] {
    return clock != nullptr &&
           static_cast<long long>(now_ns() - t0) + lead_ns > budget_ns;
  };
  const uint4* gin = reinterpret_cast<const uint4*>(g);
  for (int q = tid; q < kN * kN / 8; q += kThreads)
    *reinterpret_cast<uint4*>(smem + swz(q / 32, q % 32)) = gin[q];
  if (tid == 0) stop = late();
  __syncthreads();
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, c0 = (warp % 4) * 64;
  const float scale = 1.0f / kN;
  int it = 0;
  for (; it < iters && !stop; ++it) {
    uint32_t keep[2][8][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int r0 = pass * (kN / 2) + wm * 32;
      float acc[2][8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
#pragma unroll 4
      for (int k0 = 0; k0 < kN; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(s_base + swz(r0 + 16 * mi + (lane & 15),
                               k0 / 8 + lane / 16),
                  a[mi]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t b[4];
          ldsm_x4_t(s_base + swz(k0 + (lane & 15),
                                 (c0 + 16 * nj) / 8 + lane / 16),
                    b);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma(acc[mi][2 * nj], a[mi], b[0], b[1]);
            mma(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const uint32_t lo = pack(acc[mi][ni][0], acc[mi][ni][1], scale);
          const uint32_t hi = pack(acc[mi][ni][2], acc[mi][ni][3], scale);
          if (pass == 0) {
            const int row = wm * 32 + 16 * mi + g8;  // the half's own row
            const int col = c0 + 8 * ni + 2 * t4;
            *reinterpret_cast<uint32_t*>(half + swz(row, col / 8) +
                                         (col % 8) * 2) = lo;
            *reinterpret_cast<uint32_t*>(half + swz(row + 8, col / 8) +
                                         (col % 8) * 2) = hi;
          } else {
            keep[mi][ni][0] = lo;
            keep[mi][ni][1] = hi;
          }
        }
    }
    __syncthreads();  // every thread has read the old state
    for (int q = tid; q < (kN / 2) * kRow / 16; q += kThreads)
      reinterpret_cast<uint4*>(smem)[q] = reinterpret_cast<const uint4*>(half)[q];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int row = kN / 2 + wm * 32 + 16 * mi + g8;
        const int col = c0 + 8 * ni + 2 * t4;
        *reinterpret_cast<uint32_t*>(smem + swz(row, col / 8) +
                                     (col % 8) * 2) = keep[mi][ni][0];
        *reinterpret_cast<uint32_t*>(smem + swz(row + 8, col / 8) +
                                     (col % 8) * 2) = keep[mi][ni][1];
      }
    if (tid == 0) stop = late();
    __syncthreads();
  }
  if (clock && tid == 0) clock->iters += it;
  uint4* gout = reinterpret_cast<uint4*>(g);
  for (int q = tid; q < kN * kN / 8; q += kThreads)
    gout[q] = *reinterpret_cast<const uint4*>(smem + swz(q / 32, q % 32));
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

}  // namespace

extern "C" int dlnb_burn_chunk() { return kChunk; }
extern "C" int dlnb_burn_clock_bytes() { return sizeof(BurnClock); }

extern "C" int dlnb_burn_init(void* state, unsigned long long seed,
                              void* stream) {
  init_kernel<<<kN * kN / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(state), seed);
  return static_cast<int>(cudaGetLastError());
}

// Queue `iters` (1..kChunk) iterations of the chain on `stream`.  With a
// non-null `clock` none starts with less than `lead_ns` of `budget_ns`
// left since the burn's start (this launch's, when `stamp`).
extern "C" int dlnb_burn_launch(void* state, long long iters, void* clock,
                                int stamp, long long budget_ns,
                                long long lead_ns, void* stream) {
  if (iters <= 0) return 0;
  if (iters > kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (!ensure_smem()) return static_cast<int>(cudaErrorInvalidConfiguration);
  burn_kernel<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(state), static_cast<int>(iters),
      static_cast<BurnClock*>(clock), stamp, budget_ns, lead_ns);
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
