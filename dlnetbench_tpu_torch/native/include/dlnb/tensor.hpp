// Memory & dtype layer: DType, element conversion, RAII Tensor.
//
// Counterpart of the reference's compile-time `_FLOAT` selection
// (reference cpp/data_types.hpp:36-79) and `Tensor<T, Device>` RAII buffer
// (reference cpp/proxy_classes.hpp:349-444).  Differences by design:
//   * dtype is a RUNTIME value, not a build config — one binary serves
//     bfloat16 / float8 / float32, erasing the reference quirk where GPU
//     builds silently used 4-byte floats while telling NCCL bf16
//     (SURVEY.md §7.4).
//   * buffers are 64-byte aligned host memory, zero-initialized like the
//     reference's calloc path; the nccl fabric gives each one a device
//     twin at first use (nccl_fabric.hpp), found through the registry
//     below.  A buffer of kMapBytes or more is its own anonymous mapping,
//     zero from the kernel and never touched here: the proxies' multi-GB
//     gradient buffers then cost no page faults on the host, where only
//     their device twins are used.  The registry knows whether the host
//     wrote a Tensor through set or fill, so an unwritten one's twin is
//     zeroed on the card instead of copied.
#pragma once

#include <sys/mman.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <new>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace dlnb {

enum class DType { F32, BF16, F8E4M3 };

inline std::size_t dtype_bytes(DType d) {
  switch (d) {
    case DType::F32: return 4;
    case DType::BF16: return 2;
    case DType::F8E4M3: return 1;
  }
  return 4;
}

inline const char* dtype_name(DType d) {
  switch (d) {
    case DType::F32: return "float32";
    case DType::BF16: return "bfloat16";
    case DType::F8E4M3: return "float8";
  }
  return "?";
}

inline DType dtype_from_name(const std::string& s) {
  if (s == "bfloat16" || s == "bf16") return DType::BF16;
  if (s == "float8" || s == "fp8" || s == "f8e4m3") return DType::F8E4M3;
  if (s == "float32" || s == "f32" || s == "float") return DType::F32;
  throw std::invalid_argument("unknown dtype '" + s + "'");
}

// ---- element conversion (for real reduction math on narrow types) ------
inline float bf16_to_f32(std::uint16_t v) {
  std::uint32_t bits = static_cast<std::uint32_t>(v) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline std::uint16_t f32_to_bf16(float f) {
  std::uint32_t bits;
  std::memcpy(&bits, &f, 4);
  if (f != f)  // NaN: canonical quiet bf16 NaN, else rounding can make Inf
    return static_cast<std::uint16_t>((bits >> 16) | 0x0040);
  // round-to-nearest-even, the convention of JAX and torch
  std::uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<std::uint16_t>((bits + rounding) >> 16);
}

inline float f8e4m3_to_f32(std::uint8_t v) {
  int sign = (v >> 7) & 1;
  int exp = (v >> 3) & 0xF;
  int man = v & 0x7;
  float mag;
  if (exp == 0) {
    mag = man / 8.0f / 64.0f;  // subnormal: man/2^3 * 2^-6
  } else if (exp == 0xF && man == 0x7) {
    mag = __builtin_nanf("");  // e4m3fn: only 0xff/0x7f is NaN
  } else {
    mag = (1.0f + man / 8.0f) * std::exp2f(static_cast<float>(exp - 7));
  }
  return sign ? -mag : mag;
}

inline std::uint8_t f32_to_f8e4m3(float f) {
  if (f != f) return 0x7F;
  std::uint8_t sign = f < 0 ? 0x80 : 0;
  float mag = f < 0 ? -f : f;
  if (mag == 0) return sign;
  // clamp to e4m3fn max (448)
  if (mag >= 448.0f) return sign | 0x7E;
  int exp;
  float frac = std::frexp(mag, &exp);  // mag = frac * 2^exp, frac in [0.5,1)
  int e = exp - 1 + 7;                 // biased exponent for 1.m form
  if (e <= 0) {
    // subnormal: value = man/8 * 2^-6
    int man = static_cast<int>(mag * 8.0f * 64.0f + 0.5f);
    if (man > 7) man = 7;
    return sign | static_cast<std::uint8_t>(man);
  }
  int man = static_cast<int>((frac * 2.0f - 1.0f) * 8.0f + 0.5f);
  if (man == 8) {
    man = 0;
    ++e;
    if (e > 0xF) return sign | 0x7E;
  }
  return sign | static_cast<std::uint8_t>(e << 3) |
         static_cast<std::uint8_t>(man);
}

inline float load_element(const void* buf, std::size_t i, DType d) {
  switch (d) {
    case DType::F32: return static_cast<const float*>(buf)[i];
    case DType::BF16:
      return bf16_to_f32(static_cast<const std::uint16_t*>(buf)[i]);
    case DType::F8E4M3:
      return f8e4m3_to_f32(static_cast<const std::uint8_t*>(buf)[i]);
  }
  return 0;
}

inline void store_element(void* buf, std::size_t i, DType d, float v) {
  switch (d) {
    case DType::F32: static_cast<float*>(buf)[i] = v; break;
    case DType::BF16:
      static_cast<std::uint16_t*>(buf)[i] = f32_to_bf16(v);
      break;
    case DType::F8E4M3:
      static_cast<std::uint8_t*>(buf)[i] = f32_to_f8e4m3(v);
      break;
  }
}

// ---- allocation registry ----------------------------------------------
// Every live Tensor's extent, its allocating thread and a process-unique
// id.  A device fabric (nccl_fabric.hpp) maps a host pointer a proxy
// hands it — often an offset into a bucket — to the whole Tensor, so it
// can give that Tensor one device twin; the id keeps a twin from being
// reused by a later Tensor at the same address.
namespace registry {

struct Alloc {
  std::uintptr_t base = 0;
  std::size_t bytes = 0;
  std::uint64_t id = 0;
  std::thread::id owner;
  const std::atomic<bool>* written = nullptr;  // the Tensor's flag
};

struct State {
  std::mutex m;
  std::map<std::uintptr_t, Alloc> live;
  std::uint64_t next_id = 0;
};

inline State& state() {
  static State s;
  return s;
}

inline void add(const void* p, std::size_t bytes,
                const std::atomic<bool>* written) {
  auto& s = state();
  std::lock_guard<std::mutex> lk(s.m);
  auto b = reinterpret_cast<std::uintptr_t>(p);
  s.live[b] =
      Alloc{b, bytes, ++s.next_id, std::this_thread::get_id(), written};
}

inline void remove(const void* p) {
  auto& s = state();
  std::lock_guard<std::mutex> lk(s.m);
  s.live.erase(reinterpret_cast<std::uintptr_t>(p));
}

// The live allocation holding [p, p + bytes), if any.
inline bool find(const void* p, std::size_t bytes, Alloc& out) {
  auto& s = state();
  std::lock_guard<std::mutex> lk(s.m);
  auto a = reinterpret_cast<std::uintptr_t>(p);
  auto it = s.live.upper_bound(a);
  if (it == s.live.begin()) return false;
  --it;
  if (a + bytes > it->second.base + it->second.bytes) return false;
  out = it->second;
  return true;
}

// Every live allocation the calling thread made.
inline std::vector<Alloc> owned_by_caller() {
  auto& s = state();
  std::lock_guard<std::mutex> lk(s.m);
  std::vector<Alloc> out;
  auto me = std::this_thread::get_id();
  for (const auto& [b, a] : s.live)
    if (a.owner == me) out.push_back(a);
  return out;
}

}  // namespace registry

// ---- Tensor -------------------------------------------------------------
// RAII zero-initialized buffer (reference Tensor<T,Device>,
// proxy_classes.hpp:381-444).  Host-side; 64-byte aligned for vectorized
// reduction loops.
class Tensor {
 public:
  static constexpr std::size_t kMapBytes = 16u << 20;

  Tensor() = default;
  Tensor(std::int64_t count, DType dtype) : count_(count), dtype_(dtype) {
    if (count < 0) throw std::invalid_argument("negative tensor size");
    bytes_ = static_cast<std::size_t>(count) * dtype_bytes(dtype);
    if (bytes_ > 0) {
      if (bytes_ >= kMapBytes) {
        void* p = ::mmap(nullptr, bytes_, PROT_READ | PROT_WRITE,
                         MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
        if (p == MAP_FAILED) throw std::bad_alloc();
        data_ = p;
        mapped_ = true;
      } else {
        data_ = std::aligned_alloc(64, (bytes_ + 63) / 64 * 64);
        if (!data_) throw std::bad_alloc();
        std::memset(data_, 0, bytes_);
      }
      written_ = std::make_unique<std::atomic<bool>>(false);
      registry::add(data_, bytes_, written_.get());
    }
  }
  Tensor(Tensor&& o) noexcept { swap(o); }
  Tensor& operator=(Tensor&& o) noexcept {
    if (this != &o) {
      release();
      swap(o);
    }
    return *this;
  }
  Tensor(const Tensor&) = delete;
  Tensor& operator=(const Tensor&) = delete;
  ~Tensor() { release(); }

  void* data() { return data_; }
  const void* data() const { return data_; }
  std::int64_t count() const { return count_; }
  std::size_t bytes() const { return bytes_; }
  DType dtype() const { return dtype_; }

  float get(std::size_t i) const { return load_element(data_, i, dtype_); }
  void set(std::size_t i, float v) {
    mark_written();
    store_element(data_, i, dtype_, v);
  }
  void fill(float v) {
    mark_written();
    for (std::int64_t i = 0; i < count_; ++i)
      store_element(data_, static_cast<std::size_t>(i), dtype_, v);
  }
 private:
  // A device twin made later copies the contents instead of zeroing.
  void mark_written() {
    if (written_) written_->store(true, std::memory_order_relaxed);
  }

  void release() {
    if (data_) registry::remove(data_);
    if (mapped_)
      ::munmap(data_, bytes_);
    else
      std::free(data_);
    data_ = nullptr;
    mapped_ = false;
    written_.reset();
    count_ = 0;
    bytes_ = 0;
  }
  void swap(Tensor& o) {
    std::swap(data_, o.data_);
    std::swap(mapped_, o.mapped_);
    std::swap(written_, o.written_);
    std::swap(count_, o.count_);
    std::swap(bytes_, o.bytes_);
    std::swap(dtype_, o.dtype_);
  }

  void* data_ = nullptr;
  bool mapped_ = false;
  std::unique_ptr<std::atomic<bool>> written_;
  std::int64_t count_ = 0;
  std::size_t bytes_ = 0;
  DType dtype_ = DType::F32;
};

}  // namespace dlnb
