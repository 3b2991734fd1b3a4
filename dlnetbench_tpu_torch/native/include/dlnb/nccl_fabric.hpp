// NCCL rank fabric — the native proxies' card backend.
//
// The reference builds an NCCL communicator in every proxy binary and
// drives it from C++ with device buffers and one CUDA stream per request
// index (reference cpp/proxy_classes.hpp:136-342, dp.cpp:166-224).  This
// is that, behind the Fabric / ProxyCommunicator interface, in the seat
// the JAX package fills on a TPU with its PJRT fabric (one process over
// its devices) and its hierarchical fabric (several processes).  One code
// path covers three layouts:
//
//   * --procs 1: one process, one rank thread per card of --devices;
//   * --procs P --coordinator host:port --rank p: each process runs its
//     balanced share of the world (schedule.hpp balanced_local /
//     balanced_start), one card a rank;
//   * --procs = --world: one rank a process, the reference's layout.
//
// Bootstrap: processes meet over the TCP fabric (tcp_backend.hpp, one
// rank a process — its coordinator is the address every process dials);
// process 0 makes the ncclUniqueId and the others read it from a
// one-block all-gather over that mesh.  Every local rank's
// ncclCommInitRank goes in one ncclGroupStart/End.  A split is
// ncclCommSplit(parent, color, key = world rank).
//
// Buffers: proxies hold 64-byte-aligned host Tensors.  The first time a
// rank issues an operation, every Tensor its thread allocated gets a
// device twin (one cudaMalloc each, zeroed; the host contents copied
// when the host wrote any, tensor.hpp), so the warm-up makes them and no
// copy falls in a timed run; a Tensor first seen later is twinned then
// and counted (`late_twins`).  Copies are counted, and so
// are those made while the harness times (`timed_copies`, harness.hpp
// timed_window).  A blocking operation on memory that is not a Tensor
// (the harness's run-count agreement) goes through a staging buffer and
// is copied back.  Nothing is freed before the communicators are
// destroyed: cudaFree synchronises the device, and with several ranks in
// one process it could wait on a peer's NCCL kernel.
//
// Streams: each (communicator, slot) has its own non-blocking stream,
// the reference's stream per request index; Wait(i) / WaitAll(n)
// synchronise them.  Each rank has one more stream of its own: blocking
// operations issue there and synchronise it, and the burn runs there.
// burn() blocks the rank's thread until the kernel ends (the reference's
// usleep does too), while collectives already issued on slot streams run
// on; so the host's order is the device's.  A burn is the chain, stopped
// on the device timer one iteration and a launch's fixed cost short of
// the time asked, and a spin to that time (csrc/burn.cu); the record
// books the time asked (`burn_requested_us`) beside the device span the
// burns took (`burn_device_us`) and the iterations they ran.
//
// Operations NCCL lacks are composed as the reference composes them:
// Alltoall from grouped ncclSend/ncclRecv, Barrier as a one-element
// all-reduce and a sync, RingShift as one grouped send + receive.
// Send/Recv/Isend/Irecv are NCCL's p2p, matched in issue order (NCCL has
// no tags).
//
// Fault plans: delay and jitter events (step- and collective-scoped)
// apply, as on the JAX package's PJRT fabric; drop and partition need
// frames NCCL never exposes, and a crash, preempt or rejoin needs a dead
// peer to be observable — a dead NCCL peer hangs its group
// (ncclCommAbort is later work) — so those are refused by name.
#pragma once

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "dlnb/communicator.hpp"
#include "dlnb/fabric.hpp"
#include "dlnb/fault_plan.hpp"
#include "dlnb/harness.hpp"
#include "dlnb/nccl_api.hpp"
#include "dlnb/schedule.hpp"
#include "dlnb/tcp_backend.hpp"
#include "dlnb/tensor.hpp"

namespace dlnb {

// Refuse fault events the nccl fabric cannot honour (header comment).
inline void nccl_check_fault_plan() {
  auto& plan = fault::Plan::instance();
  if (!plan.active()) return;
  const Json& raw = plan.raw();
  for (const auto& e : raw.at("events").items()) {
    std::string kind = e.at("kind").as_string();
    if (kind == "delay" || kind == "jitter") continue;
    throw std::runtime_error(
        "fault plan: event kind '" + kind +
        "' is not supported on --backend nccl (only delay and jitter "
        "apply: NCCL exposes no frames to drop or partition, and a dead "
        "NCCL peer hangs its group instead of failing it) — use "
        "--backend shm or tcp");
  }
}

// Burn calibration constants: the torch burn's paired method
// (proxies/burn.py _paired_ns), at trip counts for this kernel's speed:
// at 3.4-4 us an iteration (csrc/burn.cu's cluster) the shortest timed
// call, kLo iterations, lasts about 0.4 ms, well past a launch's fixed
// cost of a few us, and the long chain is one launch (burn.cu's kChunk).
struct BurnCal {
  static constexpr long long kLo = 128, kHi = 512;  // the pair's trip counts
  static constexpr long long kLong = 1024;          // the long chain
  static constexpr int kReplays = 16, kLongReplays = 4;
  static constexpr int kPairs = 5, kTries = 6;
  static constexpr double kAgree = 0.02;
};

// The chain's cost: ns an iteration and ns a launch besides.
struct BurnFit {
  double ns_per_iter = 0;
  double fixed_ns = 0;
};

// ns an iteration from timed(iters, replays) (ms a call): the median
// slope of kPairs (lo, hi) timings in alternation, kept when it lies
// within kAgree of a long chain's figure timed before and after; after
// kTries tries, the last long chain's figure.  A launch's fixed cost is
// the median of the lo timings less lo iterations at that slope.
inline BurnFit paired_ns_per_iter(
    const std::function<double(long long, int)>& timed) {
  auto chain_ns = [&] {
    return timed(BurnCal::kLong, BurnCal::kLongReplays) * 1e6 /
           BurnCal::kLong;
  };
  auto median = [](std::vector<double> v) {
    std::sort(v.begin(), v.end());
    return v[v.size() / 2];
  };
  BurnFit fit;
  for (int t = 0; t < BurnCal::kTries; ++t) {
    double before = chain_ns();
    std::vector<double> slopes, los;
    for (int p = 0; p < BurnCal::kPairs; ++p) {
      double lo = timed(BurnCal::kLo, BurnCal::kReplays);
      double hi = timed(BurnCal::kHi, BurnCal::kReplays);
      slopes.push_back((hi - lo) * 1e6 /
                       static_cast<double>(BurnCal::kHi - BurnCal::kLo));
      los.push_back(lo * 1e6);
    }
    double ns = median(slopes);
    double after = chain_ns();
    fit.fixed_ns = std::max(0.0, median(los) - BurnCal::kLo * ns);
    fit.ns_per_iter = after;
    if (std::fabs(ns / before - 1.0) <= BurnCal::kAgree &&
        std::fabs(ns / after - 1.0) <= BurnCal::kAgree) {
      fit.ns_per_iter = ns;
      return fit;
    }
  }
  return fit;
}

constexpr std::size_t kBurnStateBytes = 256 * 256 * 2;  // bf16, width 256

// Queue a burn of `ns` on `s`: the chain, stopped on the device timer
// once one more iteration would leave less than one iteration and a
// launch's fixed cost of the time asked, then the spin to that time in
// the chain's last launch, booked on `clock`; under that lead the spin
// alone (burn_finish).  Returns the chain's launches.
inline long queue_burn(nccl::Device& dev, void* state, void* clock,
                       long long ns, const BurnFit& fit, nccl::Stream s) {
  const auto lead =
      static_cast<long long>(2 * fit.ns_per_iter + fit.fixed_ns);
  const auto iters = static_cast<long long>(
      static_cast<double>(ns - lead) / fit.ns_per_iter) + 1;
  long launches =
      ns > lead ? dev.burn(state, iters, s, clock, ns, lead, true) : 0;
  if (launches == 0) dev.burn_finish(clock, ns, true, s);
  return launches;
}

// Calibrate the burn kernel on the current card: warm it, then the
// paired method above on CUDA-event timings.
inline BurnFit calibrate_burn(nccl::Device& dev, void* state,
                              nccl::Stream s) {
  dev.burn(state, BurnCal::kLong, s);
  dev.sync(s);
  return paired_ns_per_iter([&](long long iters, int replays) {
    return dev.timed_burn_ms(state, iters, replays, s);
  });
}

// One rank's device context, shared by all its communicators and only
// touched from the rank's thread.
struct NcclRank {
  int rank = 0;    // world rank
  int device = 0;  // card index
  nccl::Stream stream = nullptr;
  nccl::Comm world = nullptr;
  std::vector<nccl::Comm> comms;  // destroyed at the end of the rank
  std::map<std::uint64_t, void*> twins;  // registry id -> device twin
  std::map<std::pair<std::uintptr_t, std::size_t>, void*> staging;
  std::vector<void*> allocs;
  std::vector<nccl::Stream> streams;
  void* scratch = nullptr;     // Barrier's element
  void* burn_state = nullptr;  // the burn chain's 256 x 256 bf16
  void* burn_clock = nullptr;  // its BurnClock (csrc/burn.cu)
  bool primed = false;
  BurnFit burn_fit;
  std::uint64_t h2d = 0, d2h = 0, timed_copies = 0, twin_count = 0,
                late_twins = 0, burn_launches = 0, burn_iters = 0,
                burn_requested_ns = 0, burn_device_ns = 0;
};

class NcclFabric;

class NcclCommunicator : public ProxyCommunicator {
 public:
  NcclCommunicator(NcclFabric& fab, NcclRank& ctx, nccl::Comm comm,
                   std::string name, int num_slots);

  int rank() const override { return rank_; }
  int size() const override { return size_; }
  std::string name() const override { return name_; }
  DType dtype() const override { return dtype_; }

  void Allreduce(const void* src, void* dst, std::int64_t count) override;
  void Allgather(const void* src, void* dst, std::int64_t cpr) override;
  void ReduceScatterBlock(const void* src, void* dst,
                          std::int64_t cpr) override;
  void Alltoall(const void* src, void* dst, std::int64_t cpr) override;
  void Barrier() override;
  void RingShift(const void* src, void* dst, std::int64_t count,
                 int shift = 1) override;
  void Send(const void* src, std::int64_t count, int dst_rank,
            int tag = 0) override;
  void Recv(void* dst, std::int64_t count, int src_rank,
            int tag = 0) override;
  void Iallreduce(const void* src, void* dst, std::int64_t count,
                  int slot) override;
  void Iallgather(const void* src, void* dst, std::int64_t cpr,
                  int slot) override;
  void Isend(const void* src, std::int64_t count, int dst_rank, int slot,
             int tag = -1) override;
  void Irecv(void* dst, std::int64_t count, int src_rank, int slot,
             int tag = -1) override;
  void Wait(int slot) override;
  void WaitAll(int num_slots) override;

 private:
  struct Buf {
    void* d;
    const void* host;  // non-null: a staged buffer to copy back
    std::size_t bytes;
  };
  Buf dev(const void* host, std::size_t bytes, bool blocking);
  void copy_back(const Buf& b);
  nccl::Stream slot_stream(int slot);
  void sync_rank();
  std::size_t nbytes(std::int64_t count) const {
    return static_cast<std::size_t>(count) * dtype_bytes(dtype_);
  }

  NcclFabric& fab_;
  NcclRank& ctx_;
  nccl::Comm comm_;
  std::string name_;
  DType dtype_;
  int rank_ = 0, size_ = 1;
  int num_slots_;
  std::vector<nccl::Stream> slots_;
};

class NcclFabric : public Fabric {
 public:
  // `devices`: card of each local rank (empty: 0..local-1).  procs > 1
  // joins the processes over TCP at `coordinator`.
  NcclFabric(int world, DType dtype, const std::string& impl,
             std::vector<int> devices, int procs = 1,
             const std::string& coordinator = "", int proc_rank = 0,
             int num_slots = 32)
      : world_(world),
        dtype_(dtype),
        procs_(procs),
        proc_rank_(proc_rank),
        num_slots_(num_slots) {
    if (world <= 0) throw std::invalid_argument("world_size must be > 0");
    nccl_check_fault_plan();
    if (impl == "host" && procs > 1)
      throw std::runtime_error(
          "--nccl_impl host is one process of rank threads; --procs > 1 "
          "needs the real NCCL on the cards");
    // the device runtime first: a CPU-flavour build or a machine with
    // too few cards is refused before NCCL is looked for
    dev_ = nccl::make_device(impl);
    local_ = static_cast<int>(balanced_local(world, procs, proc_rank));
    base_ = static_cast<int>(balanced_start(world, procs, proc_rank));
    if (devices.empty())
      for (int i = 0; i < local_; ++i) devices.push_back(i);
    if (static_cast<int>(devices.size()) < local_)
      throw std::runtime_error("--devices lists " +
                               std::to_string(devices.size()) +
                               " card(s) for local world " +
                               std::to_string(local_));
    devices.resize(local_);
    std::set<int> uniq(devices.begin(), devices.end());
    if (uniq.size() != devices.size())
      throw std::runtime_error(
          "--devices has duplicate indices (NCCL gives each rank its own "
          "card)");
    if (impl != "host") {
      int have = dev_->count();
      if (have == 0)
        throw std::runtime_error(
            "--backend nccl: no CUDA device is visible (cudaGetDeviceCount "
            "found none) — the nccl backend runs on the cards only");
      for (int d : devices)
        if (d < 0 || d >= have)
          throw std::runtime_error("--backend nccl: card " +
                                   std::to_string(d) + " does not exist (" +
                                   std::to_string(have) + " visible)");
    }
    api_ = nccl::load(impl);
    version_ = api_.version_string();
    // bootstrap: process 0's unique id reaches the others over TCP
    nccl::UniqueId id;
    if (procs > 1) {
      tcp_ = std::make_unique<TcpFabric>(coordinator, procs, proc_rank,
                                         DType::F32);
      if (proc_rank == 0) api_.check(api_.GetUniqueId(&id), "ncclGetUniqueId");
      else std::memset(&id, 0, sizeof id);
      constexpr int kWords = sizeof(nccl::UniqueId) / 4;
      std::vector<float> mine(kWords), all(kWords * procs);
      std::memcpy(mine.data(), &id, sizeof id);
      auto wc = tcp_->world_comm(proc_rank);
      wc->Allgather(mine.data(), all.data(), kWords);
      std::memcpy(&id, all.data(), sizeof id);
      hosts_ = tcp_->loopback() ? 1 : 2;
    } else {
      api_.check(api_.GetUniqueId(&id), "ncclGetUniqueId");
    }
    ranks_.resize(local_);
    api_.check(api_.GroupStart(), "ncclGroupStart");
    for (int i = 0; i < local_; ++i) {
      ranks_[i] = std::make_unique<NcclRank>();
      ranks_[i]->rank = base_ + i;
      ranks_[i]->device = devices[i];
      dev_->set(devices[i]);
      api_.check(api_.CommInitRank(&ranks_[i]->world, world, id, base_ + i),
                 "ncclCommInitRank");
    }
    api_.check(api_.GroupEnd(), "ncclGroupEnd (init)");
    for (auto& r : ranks_) r->comms.push_back(r->world);
    devices_ = devices;
  }

  ~NcclFabric() override {
    // communicators are gone (each rank destroyed its own); now the
    // memory and streams
    for (auto& r : ranks_) {
      if (!r || !released_) continue;
      dev_->set(r->device);
      for (auto s : r->streams) dev_->destroy(s);
      for (void* p : r->allocs) dev_->release(p);
    }
  }

  int world_size() const override { return world_; }
  DType dtype() const override { return dtype_; }
  std::string backend() const override { return "nccl"; }
  const nccl::Api& api() const { return api_; }
  nccl::Device& device() { return *dev_; }

  std::vector<int> local_ranks() const override {
    std::vector<int> out(local_);
    for (int i = 0; i < local_; ++i) out[i] = base_ + i;
    return out;
  }
  int process_index() const override { return proc_rank_; }

  NcclRank& rank_ctx(int world_rank) {
    int i = world_rank - base_;
    if (i < 0 || i >= local_)
      throw std::out_of_range("rank " + std::to_string(world_rank) +
                              " is not local to this process");
    return *ranks_[i];
  }

  std::unique_ptr<ProxyCommunicator> world_comm(int rank) override {
    NcclRank& r = rank_ctx(rank);
    return std::make_unique<NcclCommunicator>(*this, r, r.world,
                                              "nccl_world", num_slots_);
  }

  std::unique_ptr<ProxyCommunicator> split(int world_rank, int color,
                                           const std::string& name) override {
    NcclRank& r = rank_ctx(world_rank);
    nccl::Comm c = nullptr;
    api_.check(api_.CommSplit(r.world, color, world_rank, &c, nullptr),
               "ncclCommSplit");
    r.comms.push_back(c);
    return std::make_unique<NcclCommunicator>(*this, r, c, name, num_slots_);
  }

  void launch(const std::function<void(int)>& body) override {
    std::vector<std::thread> threads;
    std::mutex err_m;
    std::exception_ptr first_error;
    for (int i = 0; i < local_; ++i)
      threads.emplace_back([&, i] {
        NcclRank& r = *ranks_[i];
        try {
          dev_->set(r.device);
          prepare(r);
          body(r.rank);
          // the burns' device span, read once the rank's work is done
          if (r.burn_clock)
            dev_->burn_clock_read(r.burn_clock, r.burn_device_ns,
                                  r.burn_iters);
          for (nccl::Comm c : r.comms) api_.CommDestroy(c);
          r.comms.clear();
        } catch (...) {
          // the host double can fail its peers fast; a dead NCCL peer
          // hangs its group (header comment)
          if (api_.impl == "host") nccl::host::abort_all();
          std::lock_guard<std::mutex> lk(err_m);
          if (!first_error) first_error = std::current_exception();
        }
      });
    for (auto& t : threads) t.join();
    if (first_error) std::rethrow_exception(first_error);
    released_ = true;
  }

  // Real device cycles on a card (the rank's stream, blocking); the host
  // double sleeps.
  void burn(int rank, double us, double time_scale) override {
    double scaled = us * time_scale;
    if (scaled <= 0) return;
    NcclRank& r = rank_ctx(rank);
    if (!dev_->can_burn()) {
      burn_us(scaled);
      return;
    }
    auto ns = std::llround(scaled * 1000.0);
    r.burn_launches +=
        queue_burn(*dev_, r.burn_state, r.burn_clock, ns, r.burn_fit,
                   r.stream);
    r.burn_requested_ns += ns;
    dev_->sync(r.stream);
  }

  void describe(Json& meta, Json& mesh) const override {
    bool host = api_.impl == "host";
    meta["backend"] = "nccl";
    meta["nccl_impl"] = api_.impl;
    meta["nccl_version"] = version_;
    meta["nccl_library"] = api_.library;
    meta["device"] = host ? "cpu" : "cuda";
    if (!host && !devices_.empty())
      meta["device_name"] = const_cast<NcclFabric*>(this)->dev_->name(
          devices_.front());
    Json devs = Json::array();
    for (int d : devices_) devs.push_back(static_cast<std::int64_t>(d));
    meta["devices"] = devs;
    meta["transport"] = host ? "host"
                        : world_ <= 1 ? "local"
                        : hosts_ > 1  ? "nccl+network"
                                      : "nccl";
    meta["p2p_transport"] = host ? "host" : "nccl";
    meta["compute_mode"] = dev_->can_burn() ? "device_burn" : "host_sleep";
    std::uint64_t h2d = 0, d2h = 0, timed = 0, twins = 0, late = 0,
                  launches = 0, iters = 0, asked = 0, spent = 0;
    double ns = 0, fixed = 0;
    for (const auto& r : ranks_) {
      h2d += r->h2d;
      d2h += r->d2h;
      timed += r->timed_copies;
      twins += r->twin_count;
      late += r->late_twins;
      launches += r->burn_launches;
      iters += r->burn_iters;
      asked += r->burn_requested_ns;
      spent += r->burn_device_ns;
      ns = std::max(ns, r->burn_fit.ns_per_iter);
      fixed = std::max(fixed, r->burn_fit.fixed_ns);
    }
    if (ns > 0) {
      meta["burn_ns_per_iter"] = ns;
      meta["burn_fixed_ns"] = fixed;
    }
    if (dev_->can_burn()) {
      meta["burn_requested_us"] = static_cast<double>(asked) / 1e3;
      meta["burn_device_us"] = static_cast<double>(spent) / 1e3;
    }
    meta["h2d_copies"] = static_cast<std::int64_t>(h2d);
    meta["d2h_copies"] = static_cast<std::int64_t>(d2h);
    meta["timed_copies"] = static_cast<std::int64_t>(timed);
    meta["twins"] = static_cast<std::int64_t>(twins);
    meta["late_twins"] = static_cast<std::int64_t>(late);
    meta["burn_launches"] = static_cast<std::int64_t>(launches);
    meta["burn_iters"] = static_cast<std::int64_t>(iters);
    if (procs_ > 1) {
      meta["num_processes"] = procs_;
      meta["local_world"] = local_;
      Json lw = Json::array();
      for (int p = 0; p < procs_; ++p)
        lw.push_back(
            static_cast<std::int64_t>(balanced_local(world_, procs_, p)));
      meta["local_worlds"] = lw;
      meta["bootstrap"] = "tcp";
    }
    mesh["platform"] = host ? "host" : "cuda";
    mesh["device_kind"] = host ? "host-nccl-rank" : "cuda-card";
  }

  // ---- the twins (NcclCommunicator and the selftests) -------------------
  void* alloc(NcclRank& r, std::size_t bytes) {
    void* p = dev_->alloc(bytes);
    r.allocs.push_back(p);
    return p;
  }
  void count_copy(NcclRank& r, bool to_device) {
    (to_device ? r.h2d : r.d2h) += 1;
    if (timed_window()) ++r.timed_copies;
  }
  // The twin: zeroed on the card (alloc), and the host contents copied
  // only when the host ever wrote them.
  void* twin_of(NcclRank& r, const registry::Alloc& a) {
    auto it = r.twins.find(a.id);
    if (it != r.twins.end()) return it->second;
    void* d = alloc(r, a.bytes);
    if (a.written && a.written->load(std::memory_order_relaxed)) {
      dev_->h2d(d, reinterpret_cast<const void*>(a.base), a.bytes);
      count_copy(r, true);
    }
    ++r.twin_count;
    r.twins[a.id] = d;
    return d;
  }
  // Twin every Tensor this rank's thread allocated (the first operation).
  void prime(NcclRank& r) {
    if (r.primed) return;
    r.primed = true;
    for (const auto& a : registry::owned_by_caller()) twin_of(r, a);
  }
  // The device address of host range [p, p + bytes) on rank `r`, or null
  // when it is not part of a Tensor.
  void* device_ptr(NcclRank& r, const void* p, std::size_t bytes) {
    prime(r);
    registry::Alloc a;
    if (!registry::find(p, bytes, a)) return nullptr;
    bool known = r.twins.count(a.id) > 0;
    void* base = twin_of(r, a);
    if (!known) ++r.late_twins;
    return static_cast<char*>(base) +
           (reinterpret_cast<std::uintptr_t>(p) - a.base);
  }
  void* staging(NcclRank& r, const void* p, std::size_t bytes) {
    auto key = std::make_pair(reinterpret_cast<std::uintptr_t>(p), bytes);
    auto it = r.staging.find(key);
    if (it != r.staging.end()) return it->second;
    void* d = alloc(r, bytes);
    r.staging[key] = d;
    return d;
  }
  // Selftest helpers: re-send host contents to the twin, fetch it back.
  void upload(int rank, const void* p, std::size_t bytes) {
    NcclRank& r = rank_ctx(rank);
    void* d = device_ptr(r, p, bytes);
    if (!d) throw std::runtime_error("upload: not a Tensor");
    dev_->h2d(d, p, bytes);
    count_copy(r, true);
  }
  void download(int rank, void* p, std::size_t bytes) {
    NcclRank& r = rank_ctx(rank);
    void* d = device_ptr(r, p, bytes);
    if (!d) throw std::runtime_error("download: not a Tensor");
    dev_->d2h(p, d, bytes);
    count_copy(r, false);
  }
  nccl::Stream new_stream(NcclRank& r) {
    nccl::Stream s = dev_->stream();
    r.streams.push_back(s);
    return s;
  }

 private:
  // A rank thread's first steps on its card: its stream, the barrier's
  // element, and on a card the burn state and its calibration.
  void prepare(NcclRank& r) {
    r.stream = new_stream(r);
    r.scratch = alloc(r, 4);
    if (!dev_->can_burn()) return;
    r.burn_state = alloc(r, kBurnStateBytes);
    r.burn_clock = alloc(r, dev_->burn_clock_bytes());  // zeroed
    dev_->burn_init(r.burn_state, 0x5eed + r.rank, r.stream);
    r.burn_fit = calibrate_burn(*dev_, r.burn_state, r.stream);
  }

  int world_;
  DType dtype_;
  int procs_, proc_rank_;
  int num_slots_;
  int local_ = 0, base_ = 0, hosts_ = 1;
  std::unique_ptr<nccl::Device> dev_;
  nccl::Api api_;
  std::string version_;
  std::unique_ptr<TcpFabric> tcp_;
  std::vector<std::unique_ptr<NcclRank>> ranks_;
  std::vector<int> devices_;
  bool released_ = false;
};

// ---- NcclCommunicator --------------------------------------------------
inline NcclCommunicator::NcclCommunicator(NcclFabric& fab, NcclRank& ctx,
                                          nccl::Comm comm, std::string name,
                                          int num_slots)
    : fab_(fab),
      ctx_(ctx),
      comm_(comm),
      name_(std::move(name)),
      dtype_(fab.dtype()),
      num_slots_(num_slots),
      slots_(num_slots, nullptr) {
  const auto& api = fab_.api();
  api.check(api.CommUserRank(comm_, &rank_), "ncclCommUserRank");
  api.check(api.CommCount(comm_, &size_), "ncclCommCount");
}

inline NcclCommunicator::Buf NcclCommunicator::dev(const void* host,
                                                   std::size_t bytes,
                                                   bool blocking) {
  if (!host) return {nullptr, nullptr, 0};
  if (void* d = fab_.device_ptr(ctx_, host, bytes)) return {d, nullptr, bytes};
  if (!blocking)
    throw std::runtime_error(
        "nccl fabric: a nonblocking operation on memory that is not a "
        "dlnb::Tensor (it needs a device twin that outlives the call)");
  void* d = fab_.staging(ctx_, host, bytes);
  fab_.device().h2d(d, host, bytes);
  fab_.count_copy(ctx_, true);
  return {d, host, bytes};
}

inline void NcclCommunicator::copy_back(const Buf& b) {
  if (!b.host) return;
  fab_.device().d2h(const_cast<void*>(b.host), b.d, b.bytes);
  fab_.count_copy(ctx_, false);
}

inline nccl::Stream NcclCommunicator::slot_stream(int slot) {
  if (slot < 0 || slot >= num_slots_)
    throw std::out_of_range("slot " + std::to_string(slot) +
                            " out of range (num_slots=" +
                            std::to_string(num_slots_) + ")");
  if (!slots_[slot]) slots_[slot] = fab_.new_stream(ctx_);
  return slots_[slot];
}

inline void NcclCommunicator::sync_rank() { fab_.device().sync(ctx_.stream); }

inline void NcclCommunicator::Allreduce(const void* src, void* dst,
                                        std::int64_t count) {
  fault::Plan::instance().on_collective(ctx_.rank);
  Buf s = dev(src, nbytes(count), true), d = dev(dst, nbytes(count), true);
  const auto& api = fab_.api();
  api.check(api.AllReduce(s.d, d.d, count, nccl::dtype_code(dtype_),
                          nccl::kSum, comm_, ctx_.stream),
            "ncclAllReduce");
  sync_rank();
  copy_back(d);
}

inline void NcclCommunicator::Allgather(const void* src, void* dst,
                                        std::int64_t cpr) {
  fault::Plan::instance().on_collective(ctx_.rank);
  Buf s = dev(src, nbytes(cpr), true), d = dev(dst, nbytes(cpr) * size_, true);
  const auto& api = fab_.api();
  api.check(api.AllGather(s.d, d.d, cpr, nccl::dtype_code(dtype_), comm_,
                          ctx_.stream),
            "ncclAllGather");
  sync_rank();
  copy_back(d);
}

inline void NcclCommunicator::ReduceScatterBlock(const void* src, void* dst,
                                                 std::int64_t cpr) {
  fault::Plan::instance().on_collective(ctx_.rank);
  Buf s = dev(src, nbytes(cpr) * size_, true), d = dev(dst, nbytes(cpr), true);
  const auto& api = fab_.api();
  api.check(api.ReduceScatter(s.d, d.d, cpr, nccl::dtype_code(dtype_),
                              nccl::kSum, comm_, ctx_.stream),
            "ncclReduceScatter");
  sync_rank();
  copy_back(d);
}

inline void NcclCommunicator::Alltoall(const void* src, void* dst,
                                       std::int64_t cpr) {
  fault::Plan::instance().on_collective(ctx_.rank);
  std::size_t blk = nbytes(cpr);
  Buf s = dev(src, blk * size_, true), d = dev(dst, blk * size_, true);
  const auto& api = fab_.api();
  int dt = nccl::dtype_code(dtype_);
  api.check(api.GroupStart(), "ncclGroupStart");
  for (int p = 0; p < size_; ++p) {
    api.check(api.Send(static_cast<const char*>(s.d) + p * blk, cpr, dt, p,
                       comm_, ctx_.stream),
              "ncclSend");
    api.check(api.Recv(static_cast<char*>(d.d) + p * blk, cpr, dt, p, comm_,
                       ctx_.stream),
              "ncclRecv");
  }
  api.check(api.GroupEnd(), "ncclGroupEnd");
  sync_rank();
  copy_back(d);
}

inline void NcclCommunicator::Barrier() {
  const auto& api = fab_.api();
  fab_.device_ptr(ctx_, nullptr, 0);  // the first operation twins
  api.check(api.AllReduce(ctx_.scratch, ctx_.scratch, 1, nccl::kFloat32,
                          nccl::kSum, comm_, ctx_.stream),
            "ncclAllReduce (barrier)");
  sync_rank();
}

inline void NcclCommunicator::RingShift(const void* src, void* dst,
                                        std::int64_t count, int shift) {
  int n = size_, me = rank_;
  Buf s = dev(src, nbytes(count), true), d = dev(dst, nbytes(count), true);
  if (n <= 1 || shift % n == 0) {
    if (d.d != s.d) fab_.device().d2d(d.d, s.d, nbytes(count), ctx_.stream);
  } else {
    int to = (me + shift % n + n) % n;
    int from = (me - shift % n + 2 * n) % n;
    const auto& api = fab_.api();
    int dt = nccl::dtype_code(dtype_);
    api.check(api.GroupStart(), "ncclGroupStart");
    api.check(api.Send(s.d, count, dt, to, comm_, ctx_.stream), "ncclSend");
    api.check(api.Recv(d.d, count, dt, from, comm_, ctx_.stream), "ncclRecv");
    api.check(api.GroupEnd(), "ncclGroupEnd");
  }
  sync_rank();
  copy_back(d);
}

inline void NcclCommunicator::Send(const void* src, std::int64_t count,
                                   int dst_rank, int) {
  Buf s = dev(src, nbytes(count), true);
  const auto& api = fab_.api();
  api.check(api.Send(s.d, count, nccl::dtype_code(dtype_), dst_rank, comm_,
                     ctx_.stream),
            "ncclSend");
  sync_rank();
}

inline void NcclCommunicator::Recv(void* dst, std::int64_t count,
                                   int src_rank, int) {
  Buf d = dev(dst, nbytes(count), true);
  const auto& api = fab_.api();
  api.check(api.Recv(d.d, count, nccl::dtype_code(dtype_), src_rank, comm_,
                     ctx_.stream),
            "ncclRecv");
  sync_rank();
  copy_back(d);
}

inline void NcclCommunicator::Iallreduce(const void* src, void* dst,
                                         std::int64_t count, int slot) {
  fault::Plan::instance().on_collective(ctx_.rank);
  Buf s = dev(src, nbytes(count), false), d = dev(dst, nbytes(count), false);
  const auto& api = fab_.api();
  api.check(api.AllReduce(s.d, d.d, count, nccl::dtype_code(dtype_),
                          nccl::kSum, comm_, slot_stream(slot)),
            "ncclAllReduce");
}

inline void NcclCommunicator::Iallgather(const void* src, void* dst,
                                         std::int64_t cpr, int slot) {
  fault::Plan::instance().on_collective(ctx_.rank);
  Buf s = dev(src, nbytes(cpr), false),
      d = dev(dst, nbytes(cpr) * size_, false);
  const auto& api = fab_.api();
  api.check(api.AllGather(s.d, d.d, cpr, nccl::dtype_code(dtype_), comm_,
                          slot_stream(slot)),
            "ncclAllGather");
}

inline void NcclCommunicator::Isend(const void* src, std::int64_t count,
                                    int dst_rank, int slot, int) {
  Buf s = dev(src, nbytes(count), false);
  const auto& api = fab_.api();
  api.check(api.Send(s.d, count, nccl::dtype_code(dtype_), dst_rank, comm_,
                     slot_stream(slot)),
            "ncclSend");
}

inline void NcclCommunicator::Irecv(void* dst, std::int64_t count,
                                    int src_rank, int slot, int) {
  Buf d = dev(dst, nbytes(count), false);
  const auto& api = fab_.api();
  api.check(api.Recv(d.d, count, nccl::dtype_code(dtype_), src_rank, comm_,
                     slot_stream(slot)),
            "ncclRecv");
}

inline void NcclCommunicator::Wait(int slot) {
  nccl::Stream s = slot_stream(slot);
  fab_.device().sync(s);
}

inline void NcclCommunicator::WaitAll(int num_slots) {
  for (int i = 0; i < num_slots && i < num_slots_; ++i)
    if (slots_[i]) fab_.device().sync(slots_[i]);
}

}  // namespace dlnb
