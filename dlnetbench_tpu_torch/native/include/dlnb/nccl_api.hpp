// The NCCL and CUDA-runtime entry points the nccl fabric uses, behind two
// tables with two implementations each.
//
// nccl::Api holds the NCCL calls (unique id, init, split, destroy, group
// start/end, all-reduce, all-gather, reduce-scatter, send, recv, count,
// user rank, version, error string):
//   * real — dlopen("libnccl.so.2") (or $DLNB_NCCL_LIB), the library
//     torch's CUDA wheel installs, through this file's own declarations
//     of NCCL's C ABI, so a build needs no NCCL header.  The JAX package
//     dlopens its PJRT plugin the same way.
//   * host — a test double in portable C++: rank threads of one process,
//     host memory, a rendezvous per communicator.  Reached only through
//     an explicit `--nccl_impl host`; its records say so.
//
// nccl::Device holds the runtime calls around them (card count and name,
// memory, copies, streams, the burn kernel of csrc/burn.cu):
//   * CudaDevice — the CUDA runtime; compiled only with DLNB_HAVE_CUDA.
//   * HostDevice — host memory, and a stream is an ordered worker thread
//     (shm::SlotWorker), so the host double's operations run
//     asynchronously on their "stream" exactly as NCCL's run on a card's.
#pragma once

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

#include "dlnb/shm_backend.hpp"  // SlotWorker
#include "dlnb/tensor.hpp"

#ifdef DLNB_HAVE_CUDA
#include <cuda_runtime.h>
// csrc/burn.cu's C entry points (the burn kernel, a burn's finishing
// spin and clock, a device spin, the device timer's tick)
extern "C" {
int dlnb_burn_init(void* state, unsigned long long seed, void* stream);
int dlnb_burn_launch(void* state, long long iters, void* clock, int stamp,
                     long long budget_ns, long long lead_ns, void* stream);
int dlnb_burn_finish(void* clock, long long ns, int stamp, void* stream);
int dlnb_spin_launch(long long ns, void* stream);
int dlnb_timer_tick(void* out, int samples, void* stream);
int dlnb_burn_chunk();
int dlnb_burn_clock_bytes();
}
#endif

namespace dlnb {
namespace nccl {

// ---- NCCL's C ABI (nccl.h), the parts used here ------------------------
struct CommOpaque;
using Comm = CommOpaque*;  // ncclComm_t
struct UniqueId {
  char internal[128];
};
using Stream = void*;  // cudaStream_t
constexpr int kSuccess = 0;
constexpr int kSum = 0;  // ncclSum
// ncclDataType_t
constexpr int kFloat32 = 7;
constexpr int kBfloat16 = 9;
constexpr int kFloat8e4m3 = 10;

inline int dtype_code(DType d) {
  switch (d) {
    case DType::F32: return kFloat32;
    case DType::BF16: return kBfloat16;
    case DType::F8E4M3: return kFloat8e4m3;
  }
  return kFloat32;
}

struct Api {
  std::string impl;     // "real" | "host"
  std::string library;  // the dlopened file, or "host"
  int (*GetVersion)(int*) = nullptr;
  int (*GetUniqueId)(UniqueId*) = nullptr;
  int (*CommInitRank)(Comm*, int, UniqueId, int) = nullptr;
  int (*CommSplit)(Comm, int, int, Comm*, void*) = nullptr;
  int (*CommDestroy)(Comm) = nullptr;
  int (*CommCount)(Comm, int*) = nullptr;
  int (*CommUserRank)(Comm, int*) = nullptr;
  int (*GroupStart)() = nullptr;
  int (*GroupEnd)() = nullptr;
  int (*AllReduce)(const void*, void*, std::size_t, int, int, Comm,
                   Stream) = nullptr;
  int (*AllGather)(const void*, void*, std::size_t, int, Comm,
                   Stream) = nullptr;
  int (*ReduceScatter)(const void*, void*, std::size_t, int, int, Comm,
                       Stream) = nullptr;
  int (*Send)(const void*, std::size_t, int, int, Comm, Stream) = nullptr;
  int (*Recv)(void*, std::size_t, int, int, Comm, Stream) = nullptr;
  const char* (*GetErrorString)(int) = nullptr;

  void check(int rc, const char* what) const {
    if (rc != kSuccess)
      throw std::runtime_error(std::string("nccl: ") + what + " failed: " +
                               (GetErrorString ? GetErrorString(rc) : "?") +
                               " (" + std::to_string(rc) + ")");
  }
  // "2.28.9" from the version code (X*10000 + Y*100 + Z since 2.9)
  std::string version_string() const {
    int v = 0;
    check(GetVersion(&v), "ncclGetVersion");
    if (impl == "host") return "host";
    int major = v / 10000, minor = (v % 10000) / 100, patch = v % 100;
    return std::to_string(major) + "." + std::to_string(minor) + "." +
           std::to_string(patch);
  }
};

// ---- real: dlopen --------------------------------------------------------
inline std::string default_library() {
  if (const char* e = std::getenv("DLNB_NCCL_LIB"); e && *e) return e;
  return "libnccl.so.2";
}

inline Api load_real(const std::string& path = default_library()) {
  void* h = ::dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!h) {
    const char* err = ::dlerror();
    throw std::runtime_error(
        "--backend nccl: cannot load the NCCL library '" + path + "' (" +
        (err ? err : "dlopen failed") +
        "); set DLNB_NCCL_LIB to torch's libnccl.so.2");
  }
  Api a;
  a.impl = "real";
  auto sym = [&](const char* name) {
    void* p = ::dlsym(h, name);
    if (!p)
      throw std::runtime_error(std::string("--backend nccl: '") + path +
                               "' has no symbol " + name);
    return p;
  };
#define DLNB_NCCL_SYM(field, name) \
  a.field = reinterpret_cast<decltype(a.field)>(sym(name))
  DLNB_NCCL_SYM(GetVersion, "ncclGetVersion");
  DLNB_NCCL_SYM(GetUniqueId, "ncclGetUniqueId");
  DLNB_NCCL_SYM(CommInitRank, "ncclCommInitRank");
  DLNB_NCCL_SYM(CommSplit, "ncclCommSplit");
  DLNB_NCCL_SYM(CommDestroy, "ncclCommDestroy");
  DLNB_NCCL_SYM(CommCount, "ncclCommCount");
  DLNB_NCCL_SYM(CommUserRank, "ncclCommUserRank");
  DLNB_NCCL_SYM(GroupStart, "ncclGroupStart");
  DLNB_NCCL_SYM(GroupEnd, "ncclGroupEnd");
  DLNB_NCCL_SYM(AllReduce, "ncclAllReduce");
  DLNB_NCCL_SYM(AllGather, "ncclAllGather");
  DLNB_NCCL_SYM(ReduceScatter, "ncclReduceScatter");
  DLNB_NCCL_SYM(Send, "ncclSend");
  DLNB_NCCL_SYM(Recv, "ncclRecv");
  DLNB_NCCL_SYM(GetErrorString, "ncclGetErrorString");
#undef DLNB_NCCL_SYM
  Dl_info info;
  a.library = path;
  if (::dladdr(reinterpret_cast<void*>(a.GetVersion), &info) &&
      info.dli_fname)
    a.library = info.dli_fname;
  return a;
}

// ---- host double ---------------------------------------------------------
namespace host {

// A stream of the host double: one ordered worker thread.
struct HostStream {
  shm::SlotWorker worker;
};

enum class Op { AllReduce, AllGather, ReduceScatter };

// The ranks of one communicator.
struct Clique {
  explicit Clique(int n) : n(n) {}
  const int n;
  std::mutex m;
  std::condition_variable cv;
  bool aborted = false;

  struct Round {
    int arrived = 0, computed = 0, departed = 0;
    Op op = Op::AllReduce;
    std::size_t count = 0;
    int dtype = 0;
    bool mismatch = false;
    std::vector<const void*> src;
  };
  std::map<std::uint64_t, Round> rounds;
  // p2p: (from, to) -> message sequence -> payload; sends are buffered
  // and match receives in issue order, as NCCL's do
  std::map<std::pair<int, int>, std::map<std::uint64_t, std::vector<char>>>
      msgs;
  struct SplitRound {
    int arrived = 0, departed = 0;
    std::vector<int> color, key;
    std::map<int, std::shared_ptr<Clique>> children;
  };
  std::map<std::uint64_t, SplitRound> splits;

  void wait(std::unique_lock<std::mutex>& lk,
            const std::function<bool()>& ready) {
    cv.wait(lk, [&] { return aborted || ready(); });
    if (aborted)
      throw std::runtime_error(
          "host nccl: a rank of this communicator died");
  }
  void abort() {
    std::lock_guard<std::mutex> lk(m);
    aborted = true;
    cv.notify_all();
  }
};

struct CommState {
  std::shared_ptr<Clique> clique;
  int rank = 0;
  std::uint64_t seq = 0;        // collectives issued
  std::uint64_t split_seq = 0;  // splits made
  std::map<std::pair<int, int>, std::uint64_t> p2p_seq;
};

struct Registry {
  std::mutex m;
  std::map<std::string, std::weak_ptr<Clique>> by_id;
  std::vector<std::weak_ptr<Clique>> all;
  std::atomic<std::uint64_t> ids{0};
};
inline Registry& registry() {
  static Registry r;
  return r;
}

inline void abort_all() {
  std::vector<std::shared_ptr<Clique>> live;
  {
    auto& r = registry();
    std::lock_guard<std::mutex> lk(r.m);
    for (auto& w : r.all)
      if (auto c = w.lock()) live.push_back(c);
  }
  for (auto& c : live) c->abort();
}

inline std::shared_ptr<Clique> make_clique(int n) {
  auto c = std::make_shared<Clique>(n);
  auto& r = registry();
  std::lock_guard<std::mutex> lk(r.m);
  r.all.push_back(c);
  return c;
}

// ncclGroupStart/End: p2p calls inside a group are held, then issued
// sends first, so a group's exchanges never wait on each other.
struct Pending {
  HostStream* stream;
  std::function<void()> fn;
  bool send;
};
inline int& group_depth() {
  thread_local int d = 0;
  return d;
}
inline std::vector<Pending>& pending() {
  thread_local std::vector<Pending> p;
  return p;
}
inline void issue(Stream s, std::function<void()> fn, bool send) {
  auto* hs = static_cast<HostStream*>(s);
  if (group_depth() > 0)
    pending().push_back({hs, std::move(fn), send});
  else
    hs->worker.enqueue(std::move(fn));
}

inline CommState* st(Comm c) { return reinterpret_cast<CommState*>(c); }

inline int GetVersion(int* v) {
  *v = 0;
  return kSuccess;
}
inline int GetUniqueId(UniqueId* id) {
  std::memset(id->internal, 0, sizeof id->internal);
  std::string s = "dlnb-host-nccl:" + std::to_string(::getpid()) + ":" +
                  std::to_string(registry().ids.fetch_add(1)) + ":" +
                  std::to_string(std::chrono::steady_clock::now()
                                     .time_since_epoch()
                                     .count());
  std::memcpy(id->internal, s.data(),
              std::min(s.size(), sizeof id->internal - 1));
  return kSuccess;
}
inline int CommInitRank(Comm* out, int n, UniqueId id, int rank) {
  std::string key(id.internal, sizeof id.internal);
  std::shared_ptr<Clique> c;
  {
    auto& r = registry();
    std::lock_guard<std::mutex> lk(r.m);
    c = r.by_id[key].lock();
    if (!c) {
      c = std::make_shared<Clique>(n);
      r.by_id[key] = c;
      r.all.push_back(c);
    }
  }
  if (c->n != n || rank < 0 || rank >= n) return 4;  // ncclInvalidArgument
  auto* s = new CommState;
  s->clique = c;
  s->rank = rank;
  *out = reinterpret_cast<Comm>(s);
  return kSuccess;
}
inline int CommDestroy(Comm c) {
  delete st(c);
  return kSuccess;
}
inline int CommCount(Comm c, int* n) {
  *n = st(c)->clique->n;
  return kSuccess;
}
inline int CommUserRank(Comm c, int* r) {
  *r = st(c)->rank;
  return kSuccess;
}
// Blocking and collective over the parent, like ncclCommSplit: members
// of each color ordered by (key, parent rank).
inline int CommSplit(Comm parent, int color, int key, Comm* out, void*) {
  CommState* p = st(parent);
  auto& c = *p->clique;
  std::uint64_t seq = p->split_seq++;
  std::shared_ptr<Clique> child;
  int child_rank = 0;
  {
    std::unique_lock<std::mutex> lk(c.m);
    auto& r = c.splits[seq];
    if (r.color.empty()) {
      r.color.assign(c.n, 0);
      r.key.assign(c.n, 0);
    }
    r.color[p->rank] = color;
    r.key[p->rank] = key;
    if (++r.arrived == c.n) {
      std::map<int, std::vector<std::pair<int, int>>> by;
      for (int i = 0; i < c.n; ++i)
        if (r.color[i] >= 0) by[r.color[i]].push_back({r.key[i], i});
      for (auto& [col, members] : by)
        r.children[col] = make_clique(static_cast<int>(members.size()));
      c.cv.notify_all();
    }
    c.wait(lk, [&] { return r.arrived == c.n; });
    if (color >= 0) {
      std::vector<std::pair<int, int>> members;
      for (int i = 0; i < c.n; ++i)
        if (r.color[i] == color) members.push_back({r.key[i], i});
      std::sort(members.begin(), members.end());
      for (std::size_t i = 0; i < members.size(); ++i)
        if (members[i].second == p->rank) child_rank = static_cast<int>(i);
      child = r.children.at(color);
    }
    if (++r.departed == c.n) c.splits.erase(seq);
  }
  if (!child) {
    *out = nullptr;
    return kSuccess;
  }
  auto* s = new CommState;
  s->clique = child;
  s->rank = child_rank;
  *out = reinterpret_cast<Comm>(s);
  return kSuccess;
}
inline int GroupStart() {
  ++group_depth();
  return kSuccess;
}
inline int GroupEnd() {
  if (group_depth() <= 0) return 5;  // ncclInvalidUsage
  if (--group_depth() > 0) return kSuccess;
  auto ops = std::move(pending());
  pending().clear();
  for (auto& o : ops)
    if (o.send) o.stream->worker.enqueue(std::move(o.fn));
  for (auto& o : ops)
    if (!o.send) o.stream->worker.enqueue(std::move(o.fn));
  return kSuccess;
}

inline DType dtype_of(int code) {
  switch (code) {
    case kBfloat16: return DType::BF16;
    case kFloat8e4m3: return DType::F8E4M3;
    default: return DType::F32;
  }
}

// One collective round: every rank publishes its input, computes its own
// output into a scratch (sums in float in rank order, the shm fabric's
// arithmetic), and writes it only once every rank has read the inputs.
inline void collective(std::shared_ptr<Clique> cp, std::uint64_t seq,
                       int rank, Op op, const void* src, void* dst,
                       std::size_t count, int dtype) {
  auto& c = *cp;
  const int n = c.n;
  const DType dt = dtype_of(dtype);
  const std::size_t esz = dtype_bytes(dt);
  std::unique_lock<std::mutex> lk(c.m);
  auto& r = c.rounds[seq];
  if (r.arrived == 0) {
    r.op = op;
    r.count = count;
    r.dtype = dtype;
    r.src.assign(n, nullptr);
  } else if (r.op != op || r.count != count || r.dtype != dtype) {
    r.mismatch = true;
  }
  r.src[rank] = src;
  if (++r.arrived == n) c.cv.notify_all();
  c.wait(lk, [&] { return r.arrived == n; });
  bool bad = r.mismatch;
  lk.unlock();
  std::vector<char> out;
  if (!bad) {
    switch (op) {
      case Op::AllReduce:
        out.resize(count * esz);
        for (std::size_t i = 0; i < count; ++i) {
          float acc = 0.0f;
          for (int q = 0; q < n; ++q) acc += load_element(r.src[q], i, dt);
          store_element(out.data(), i, dt, acc);
        }
        break;
      case Op::AllGather:
        out.resize(n * count * esz);
        for (int q = 0; q < n; ++q)
          std::memcpy(out.data() + q * count * esz, r.src[q], count * esz);
        break;
      case Op::ReduceScatter:
        out.resize(count * esz);
        for (std::size_t i = 0; i < count; ++i) {
          float acc = 0.0f;
          for (int q = 0; q < n; ++q)
            acc += load_element(r.src[q], rank * count + i, dt);
          store_element(out.data(), i, dt, acc);
        }
        break;
    }
  }
  lk.lock();
  if (++r.computed == n) c.cv.notify_all();
  c.wait(lk, [&] { return r.computed == n; });
  lk.unlock();
  if (!bad && !out.empty()) std::memcpy(dst, out.data(), out.size());
  lk.lock();
  if (++r.departed == n) c.rounds.erase(seq);
  lk.unlock();
  if (bad)
    throw std::runtime_error(
        "host nccl: ranks disagree on a collective's op, count or dtype");
}

inline void issue_collective(Comm comm, Op op, const void* src, void* dst,
                             std::size_t count, int dtype, Stream s) {
  CommState* p = st(comm);
  std::uint64_t seq = p->seq++;
  auto clique = p->clique;
  int rank = p->rank;
  issue(s, [=] { collective(clique, seq, rank, op, src, dst, count, dtype); },
        false);
}

inline int AllReduce(const void* src, void* dst, std::size_t count, int dt,
                     int op, Comm c, Stream s) {
  if (op != kSum) return 4;
  issue_collective(c, Op::AllReduce, src, dst, count, dt, s);
  return kSuccess;
}
inline int AllGather(const void* src, void* dst, std::size_t count, int dt,
                     Comm c, Stream s) {
  issue_collective(c, Op::AllGather, src, dst, count, dt, s);
  return kSuccess;
}
inline int ReduceScatter(const void* src, void* dst, std::size_t count,
                         int dt, int op, Comm c, Stream s) {
  if (op != kSum) return 4;
  issue_collective(c, Op::ReduceScatter, src, dst, count, dt, s);
  return kSuccess;
}
inline std::size_t bytes_of(std::size_t count, int dt) {
  return count * dtype_bytes(dtype_of(dt));
}
inline int Send(const void* src, std::size_t count, int dt, int peer,
                Comm comm, Stream s) {
  CommState* p = st(comm);
  if (peer < 0 || peer >= p->clique->n) return 4;
  std::uint64_t seq = p->p2p_seq[{p->rank, peer}]++;
  auto clique = p->clique;
  int from = p->rank;
  std::size_t bytes = bytes_of(count, dt);
  issue(s, [=] {
    auto& c = *clique;
    std::vector<char> data(static_cast<const char*>(src),
                           static_cast<const char*>(src) + bytes);
    std::lock_guard<std::mutex> lk(c.m);
    c.msgs[{from, peer}][seq] = std::move(data);
    c.cv.notify_all();
  }, true);
  return kSuccess;
}
inline int Recv(void* dst, std::size_t count, int dt, int peer, Comm comm,
                Stream s) {
  CommState* p = st(comm);
  if (peer < 0 || peer >= p->clique->n) return 4;
  // the receiver's own count of receives from `peer` pairs it with the
  // sender's count of sends to it
  std::uint64_t seq = p->p2p_seq[{-1 - peer, p->rank}]++;
  auto clique = p->clique;
  int to = p->rank;
  std::size_t bytes = bytes_of(count, dt);
  issue(s, [=] {
    auto& c = *clique;
    std::unique_lock<std::mutex> lk(c.m);
    auto& box = c.msgs[{peer, to}];
    c.wait(lk, [&] { return box.count(seq) > 0; });
    auto it = box.find(seq);
    if (it->second.size() != bytes) {
      std::size_t sent = it->second.size();
      box.erase(it);
      throw std::runtime_error(
          "host nccl: p2p size mismatch: send " + std::to_string(sent) +
          "B vs recv " + std::to_string(bytes) + "B");
    }
    std::memcpy(dst, it->second.data(), bytes);
    box.erase(it);
  }, false);
  return kSuccess;
}
inline const char* GetErrorString(int rc) {
  switch (rc) {
    case kSuccess: return "no error";
    case 4: return "invalid argument";
    case 5: return "invalid usage";
    default: return "host nccl error";
  }
}

}  // namespace host

inline Api load_host() {
  Api a;
  a.impl = "host";
  a.library = "host";
  a.GetVersion = host::GetVersion;
  a.GetUniqueId = host::GetUniqueId;
  a.CommInitRank = host::CommInitRank;
  a.CommSplit = host::CommSplit;
  a.CommDestroy = host::CommDestroy;
  a.CommCount = host::CommCount;
  a.CommUserRank = host::CommUserRank;
  a.GroupStart = host::GroupStart;
  a.GroupEnd = host::GroupEnd;
  a.AllReduce = host::AllReduce;
  a.AllGather = host::AllGather;
  a.ReduceScatter = host::ReduceScatter;
  a.Send = host::Send;
  a.Recv = host::Recv;
  a.GetErrorString = host::GetErrorString;
  return a;
}

// ---- the device runtime ---------------------------------------------------
class Device {
 public:
  virtual ~Device() = default;
  virtual std::string impl() const = 0;  // "cuda" | "host"
  virtual int count() = 0;
  virtual std::string name(int dev) = 0;
  virtual bool peer_access(int a, int b) = 0;
  virtual void set(int dev) = 0;
  virtual void* alloc(std::size_t bytes) = 0;
  virtual void release(void* p) = 0;
  virtual void h2d(void* d, const void* h, std::size_t n) = 0;
  virtual void d2h(void* h, const void* d, std::size_t n) = 0;
  virtual void d2d(void* d, const void* s, std::size_t n, Stream st) = 0;
  virtual Stream stream() = 0;
  virtual void sync(Stream s) = 0;
  virtual void destroy(Stream s) = 0;
  // the burn chain (csrc/burn.cu); a host device has none
  virtual bool can_burn() const { return false; }
  // a seeded state in (-0.5, 0.5)
  virtual void burn_init(void*, unsigned long long, Stream) {}
  // queues `iters` iterations on `s`; returns the kernel launches made.
  // A non-null `clock` (burn_clock_bytes(), zeroed) takes the first
  // launch's start as the burn's start, and no iteration starts with
  // less than `lead_ns` of `budget_ns` left.
  virtual long burn(void*, long long, Stream, void* = nullptr,
                    long long = 0, long long = 0) {
    return 0;
  }
  // queues the end of a burn of `ns` on `s`: a spin until `ns` have passed
  // since the burn's start (its own start when `stamp`), the span added
  // to the clock's total
  virtual void burn_finish(void*, long long, bool, Stream) {}
  virtual std::size_t burn_clock_bytes() const { return 0; }
  // the clock's burns, all told: ns of device time and chain iterations
  virtual void burn_clock_read(void*, std::uint64_t& spent,
                               std::uint64_t& iters) {
    spent = iters = 0;
  }
  // ms of `replays` back-to-back runs of `work` (which queues on `s`)
  // between two events, queued behind a device spin, over `replays`
  virtual double timed_ms(const std::function<void()>&, int, Stream) {
    return 0;
  }
  double timed_burn_ms(void* state, long long iters, int replays, Stream s) {
    return timed_ms([&] { burn(state, iters, s); }, replays, s);
  }
  // the smallest step of the device timer the burn's clock reads, in ns
  virtual std::uint64_t timer_tick_ns() { return 0; }
};

class HostDevice : public Device {
 public:
  std::string impl() const override { return "host"; }
  int count() override { return 1; }
  std::string name(int) override { return "host"; }
  bool peer_access(int, int) override { return true; }
  void set(int) override {}
  void* alloc(std::size_t bytes) override {
    void* p = std::aligned_alloc(64, (std::max<std::size_t>(bytes, 1) + 63) /
                                         64 * 64);
    if (!p) throw std::bad_alloc();
    std::memset(p, 0, bytes);
    return p;
  }
  void release(void* p) override { std::free(p); }
  void h2d(void* d, const void* h, std::size_t n) override {
    std::memcpy(d, h, n);
  }
  void d2h(void* h, const void* d, std::size_t n) override {
    std::memcpy(h, d, n);
  }
  void d2d(void* d, const void* s, std::size_t n, Stream st) override {
    host::issue(st, [=] { std::memmove(d, s, n); }, false);
  }
  Stream stream() override { return new host::HostStream; }
  void sync(Stream s) override {
    static_cast<host::HostStream*>(s)->worker.wait();
  }
  void destroy(Stream s) override {
    delete static_cast<host::HostStream*>(s);
  }
};

#ifdef DLNB_HAVE_CUDA
class CudaDevice : public Device {
 public:
  std::string impl() const override { return "cuda"; }
  static void check(cudaError_t e, const char* what) {
    if (e != cudaSuccess)
      throw std::runtime_error(std::string("cuda: ") + what + " failed: " +
                               cudaGetErrorString(e));
  }
  int count() override {
    int n = 0;
    cudaError_t e = cudaGetDeviceCount(&n);
    if (e != cudaSuccess) return 0;
    return n;
  }
  std::string name(int dev) override {
    cudaDeviceProp p;
    check(cudaGetDeviceProperties(&p, dev), "cudaGetDeviceProperties");
    return p.name;
  }
  bool peer_access(int a, int b) override {
    int ok = 0;
    check(cudaDeviceCanAccessPeer(&ok, a, b), "cudaDeviceCanAccessPeer");
    return ok != 0;
  }
  void set(int dev) override { check(cudaSetDevice(dev), "cudaSetDevice"); }
  void* alloc(std::size_t bytes) override {
    void* p = nullptr;
    check(cudaMalloc(&p, std::max<std::size_t>(bytes, 1)), "cudaMalloc");
    check(cudaMemset(p, 0, std::max<std::size_t>(bytes, 1)), "cudaMemset");
    return p;
  }
  void release(void* p) override { cudaFree(p); }
  void h2d(void* d, const void* h, std::size_t n) override {
    check(cudaMemcpy(d, h, n, cudaMemcpyHostToDevice), "cudaMemcpy H2D");
  }
  void d2h(void* h, const void* d, std::size_t n) override {
    check(cudaMemcpy(h, d, n, cudaMemcpyDeviceToHost), "cudaMemcpy D2H");
  }
  void d2d(void* d, const void* s, std::size_t n, Stream st) override {
    check(cudaMemcpyAsync(d, s, n, cudaMemcpyDeviceToDevice,
                          static_cast<cudaStream_t>(st)),
          "cudaMemcpyAsync D2D");
  }
  Stream stream() override {
    cudaStream_t s;
    check(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking),
          "cudaStreamCreateWithFlags");
    return s;
  }
  void sync(Stream s) override {
    check(cudaStreamSynchronize(static_cast<cudaStream_t>(s)),
          "cudaStreamSynchronize");
  }
  void destroy(Stream s) override {
    cudaStreamDestroy(static_cast<cudaStream_t>(s));
  }
  bool can_burn() const override { return true; }
  void burn_init(void* state, unsigned long long seed, Stream s) override {
    check(static_cast<cudaError_t>(dlnb_burn_init(state, seed, s)),
          "burn state init");
  }
  long burn(void* state, long long iters, Stream s, void* clock,
            long long budget_ns, long long lead_ns) override {
    long launches = 0;
    const long long chunk = dlnb_burn_chunk();
    while (iters > 0) {
      long long n = std::min(iters, chunk);
      check(static_cast<cudaError_t>(
                dlnb_burn_launch(state, n, clock, launches == 0 ? 1 : 0,
                                 budget_ns, lead_ns, s)),
            "burn kernel launch");
      iters -= n;
      ++launches;
    }
    return launches;
  }
  void burn_finish(void* clock, long long ns, bool stamp, Stream s) override {
    check(static_cast<cudaError_t>(
              dlnb_burn_finish(clock, ns, stamp ? 1 : 0, s)),
          "burn finish launch");
  }
  std::size_t burn_clock_bytes() const override {
    return static_cast<std::size_t>(dlnb_burn_clock_bytes());
  }
  void burn_clock_read(void* clock, std::uint64_t& spent,
                       std::uint64_t& iters) override {
    std::uint64_t v[3] = {0, 0, 0};  // BurnClock {t0, spent, iters}
    d2h(v, clock, sizeof v);
    spent = v[1];
    iters = v[2];
  }
  std::uint64_t timer_tick_ns() override {
    void* d = alloc(sizeof(std::uint64_t));
    Stream s = stream();
    check(static_cast<cudaError_t>(dlnb_timer_tick(d, 1000, s)),
          "timer tick launch");
    sync(s);
    std::uint64_t tick = 0;
    d2h(&tick, d, sizeof tick);
    destroy(s);
    release(d);
    return tick;
  }
  double timed_ms(const std::function<void()>& work, int replays,
                  Stream s) override {
    auto cs = static_cast<cudaStream_t>(s);
    cudaEvent_t a, b;
    check(cudaEventCreate(&a), "cudaEventCreate");
    check(cudaEventCreate(&b), "cudaEventCreate");
    sync(s);
    check(static_cast<cudaError_t>(dlnb_spin_launch(2'000'000, s)),
          "spin launch");
    check(cudaEventRecord(a, cs), "cudaEventRecord");
    for (int i = 0; i < replays; ++i) work();
    check(cudaEventRecord(b, cs), "cudaEventRecord");
    check(cudaEventSynchronize(b), "cudaEventSynchronize");
    float ms = 0;
    check(cudaEventElapsedTime(&ms, a, b), "cudaEventElapsedTime");
    cudaEventDestroy(a);
    cudaEventDestroy(b);
    return ms / replays;
  }
};
#endif

inline std::unique_ptr<Device> make_device(const std::string& impl) {
  if (impl == "host") return std::make_unique<HostDevice>();
#ifdef DLNB_HAVE_CUDA
  return std::make_unique<CudaDevice>();
#else
  throw std::runtime_error(
      "--backend nccl: this is a CPU-flavour build (no CUDA: built "
      "without DLNB_HAVE_CUDA) — build the card flavour with "
      "dlnetbench_tpu_torch.utils.native_build (flavour 'cuda'), or pass "
      "--nccl_impl host for the host test double");
#endif
}

inline Api load(const std::string& impl) {
  if (impl == "host") return load_host();
  if (impl != "real")
    throw std::runtime_error("unknown --nccl_impl '" + impl +
                             "' (real | host)");
  return load_real();
}

}  // namespace nccl
}  // namespace dlnb
