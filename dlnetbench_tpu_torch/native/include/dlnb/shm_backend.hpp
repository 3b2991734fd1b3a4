// In-process threaded rank fabric — the testable fake backend.
//
// The reference's `mpi_cpu` build config runs every proxy on plain CPU
// buffers over ordinary MPI ranks, which is what makes the whole suite
// runnable on a laptop (reference README.md:96, SURVEY.md §4).  There is
// no MPI on the hosts this runs on, so the rebuild's equivalent is an
// in-process fabric: N rank *threads* share one `ShmFabric`, collectives
// rendezvous through shared memory, and nonblocking ops run on per-slot
// worker threads — reproducing the NCCL stream-per-request-index
// discipline (reference cpp/proxy_classes.hpp:143-147) with real
// asynchrony, so compute/comm overlap is genuinely exercised in tests.
//
// Collective algorithm: all group members publish (src, dst) into a
// per-(group, slot) Rendezvous; once everyone arrived, each rank computes
// its own output from the published inputs (sum-reduction in float via
// dtype conversion, gather/scatter/alltoall as copies); a second phase
// releases the round.  Mismatched op/count across ranks is detected and
// aborts — the debugging check MPI never gave the reference.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "dlnb/communicator.hpp"
#include "dlnb/fabric.hpp"
#include "dlnb/fault_plan.hpp"
#include "dlnb/tensor.hpp"

namespace dlnb {

namespace shm {

// ------------------------------------------------------------------ ops
enum class OpKind : int {
  Allreduce, Allgather, ReduceScatterBlock, Alltoall, Barrier
};

// One reusable all-arrive/compute/all-depart synchronization point.
class Rendezvous {
 public:
  explicit Rendezvous(int n) : n_(n), srcs_(n), dsts_(n) {}

  // fn(grank, srcs, dsts) runs on every rank after all pointers are
  // published; inputs stay stable until the last rank departs.
  void collective(
      int grank, OpKind op, std::int64_t count, const void* src, void* dst,
      const std::function<void(int, const std::vector<const void*>&,
                               const std::vector<void*>&)>& fn) {
    std::unique_lock<std::mutex> lk(m_);
    if (aborted_) throw std::runtime_error(abort_why_);
    std::uint64_t my_gen = gen_;
    srcs_[grank] = src;
    dsts_[grank] = dst;
    if (arrived_ == 0) {
      op_ = op;
      count_ = count;
    } else if (op_ != op || count_ != count) {
      mismatch_ = true;
    }
    if (++arrived_ == n_) cv_.notify_all();
    cv_.wait(lk, [&] {
      return aborted_ || (gen_ == my_gen && arrived_ == n_);
    });
    // abort fails ONLY a round that cannot complete (a member died
    // before arriving); a fully-arrived round still runs — otherwise
    // survivors could abandon different rounds and desync
    if (!(gen_ == my_gen && arrived_ == n_))
      throw std::runtime_error(abort_why_);
    bool bad = mismatch_;
    lk.unlock();
    // on mismatch still complete the round (skip the math) so the
    // rendezvous resets and later collectives error instead of hanging
    if (!bad) fn(grank, srcs_, dsts_);
    lk.lock();
    if (++departed_ == n_) {
      arrived_ = 0;
      departed_ = 0;
      mismatch_ = false;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lk, [&] { return aborted_ || gen_ != my_gen; });
      // the round completed (every member, including a subsequently
      // dead one, already departed it) — only a stuck reset aborts
      if (gen_ == my_gen) throw std::runtime_error(abort_why_);
    }
    lk.unlock();
    if (bad)
      throw std::runtime_error(
          "shm collective mismatch: ranks disagree on op/count");
  }

  // Permanently poison the rendezvous: every blocked and future wait
  // throws instead of waiting for a rank that will never arrive (the
  // fail-fast a dead in-process rank needs — a rendezvous group is
  // never reused after a member dies).
  void abort(const std::string& why) {
    std::lock_guard<std::mutex> lk(m_);
    if (aborted_) return;
    aborted_ = true;
    abort_why_ = why;
    cv_.notify_all();
  }

 private:
  int n_;
  std::mutex m_;
  std::condition_variable cv_;
  std::vector<const void*> srcs_;
  std::vector<void*> dsts_;
  int arrived_ = 0;
  int departed_ = 0;
  bool mismatch_ = false;
  bool aborted_ = false;
  std::string abort_why_;
  OpKind op_ = OpKind::Barrier;
  std::int64_t count_ = 0;
  std::uint64_t gen_ = 0;
};

// Synchronous-rendezvous point-to-point mailbox for one group.  The
// sender publishes a pointer and blocks until the receiver copies (NCCL
// send/recv pairing semantics); entries live in a std::list so references
// stay valid while both sides rendezvous, and the sender erases its own
// entry after the ack.  Messages match on (from, to, tag): nonblocking
// ops tag with their slot index and blocking ops with tag 0, so
// concurrent slot workers between the same rank pair never cross-match
// (the stream-per-index discipline, reference proxy_classes.hpp:143-147).
class Mailboxes {
 public:
  void send(int from, int to, int tag, const void* data, std::size_t bytes) {
    std::unique_lock<std::mutex> lk(m_);
    if (aborted_) throw std::runtime_error(abort_why_);
    Key k{from, to, tag};
    auto& box = boxes_[k];
    box.push_back(Msg{data, bytes, false});
    auto mine = std::prev(box.end());
    cv_.notify_all();
    cv_.wait(lk, [&] { return aborted_ || mine->consumed; });
    if (aborted_ && !mine->consumed) {
      box.erase(mine);
      throw std::runtime_error(abort_why_);
    }
    box.erase(mine);
  }

  void recv(int from, int to, int tag, void* out, std::size_t bytes) {
    std::unique_lock<std::mutex> lk(m_);
    Key k{from, to, tag};
    std::list<Msg>::iterator it;
    bool found = false;
    cv_.wait(lk, [&] {
      auto& box = boxes_[k];
      for (it = box.begin(); it != box.end(); ++it)
        if (!it->consumed) {
          found = true;
          return true;
        }
      return aborted_;
    });
    // an already-delivered message still completes (the sender made it
    // before dying); only an empty box aborts
    if (!found) throw std::runtime_error(abort_why_);
    if (it->bytes != bytes)
      throw std::runtime_error("shm p2p size mismatch: send " +
                               std::to_string(it->bytes) + "B vs recv " +
                               std::to_string(bytes) + "B");
    std::memcpy(out, it->data, bytes);
    it->consumed = true;
    cv_.notify_all();
  }

  // Poison the mailbox (dead member): blocked and future p2p throws.
  void abort(const std::string& why) {
    std::lock_guard<std::mutex> lk(m_);
    if (aborted_) return;
    aborted_ = true;
    abort_why_ = why;
    cv_.notify_all();
  }

 private:
  struct Key {
    int from, to, tag;
    bool operator<(const Key& o) const {
      if (from != o.from) return from < o.from;
      if (to != o.to) return to < o.to;
      return tag < o.tag;
    }
  };
  struct Msg {
    const void* data;
    std::size_t bytes;
    bool consumed;
  };
  std::mutex m_;
  std::condition_variable cv_;
  std::map<Key, std::list<Msg>> boxes_;
  bool aborted_ = false;
  std::string abort_why_;
};

// Shared state of one communicator group (all member ranks).
struct Group {
  explicit Group(std::vector<int> world_ranks, int num_slots)
      : members(std::move(world_ranks)), mailboxes() {
    int n = static_cast<int>(members.size());
    // slot rendezvous 0..num_slots-1; extra slot for blocking ops
    for (int i = 0; i <= num_slots; ++i)
      rendezvous.push_back(std::make_unique<Rendezvous>(n));
  }
  std::vector<int> members;  // world ranks, ascending == group rank order
  std::vector<std::unique_ptr<Rendezvous>> rendezvous;
  Mailboxes mailboxes;

  bool contains(int world_rank) const {
    for (int m : members)
      if (m == world_rank) return true;
    return false;
  }

  // A member died: poison every synchronization point so survivors
  // fail fast instead of waiting for a rank that will never arrive.
  void abort_all(const std::string& why) {
    for (auto& r : rendezvous) r->abort(why);
    mailboxes.abort(why);
  }
};

// Single-thread ordered task queue — one per (rank, slot); the analogue of
// one CUDA stream per request index (reference proxy_classes.hpp:143-147).
class SlotWorker {
 public:
  SlotWorker() = default;
  ~SlotWorker() { stop(); }

  void enqueue(std::function<void()> fn) {
    ensure_started();
    {
      std::lock_guard<std::mutex> lk(m_);
      q_.push_back(std::move(fn));
      ++outstanding_;
    }
    cv_.notify_all();
  }

  // Block until every enqueued task has completed (stream synchronize).
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    cv_done_.wait(lk, [&] { return outstanding_ == 0; });
    if (error_) {
      auto e = error_;
      error_ = nullptr;
      std::rethrow_exception(e);
    }
  }

  void stop() {
    // stop() is invoked concurrently when several error paths quiesce
    // one communicator's SHARED workers at once (e.g. multiple async
    // communicator legs failing together): joining the same std::thread
    // from two callers is UB that deadlocks in practice, so stoppers
    // serialize here and late arrivals find started_ already false.
    std::lock_guard<std::mutex> sl(stop_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      if (!started_) return;
      stopping_ = true;
    }
    cv_.notify_all();
    if (thread_.joinable()) thread_.join();
    std::lock_guard<std::mutex> lk(m_);
    started_ = false;
    stopping_ = false;
  }

 private:
  void ensure_started() {
    std::lock_guard<std::mutex> lk(m_);
    if (started_) return;
    started_ = true;
    thread_ = std::thread([this] { run(); });
  }

  void run() {
    while (true) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stopping_ || !q_.empty(); });
        if (stopping_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop_front();
      }
      try {
        fn();
      } catch (...) {
        std::lock_guard<std::mutex> lk(m_);
        error_ = std::current_exception();
      }
      {
        std::lock_guard<std::mutex> lk(m_);
        --outstanding_;
      }
      cv_done_.notify_all();
    }
  }

  std::mutex m_;
  std::mutex stop_m_;  // serializes concurrent stop() callers
  std::condition_variable cv_, cv_done_;
  std::deque<std::function<void()>> q_;
  int outstanding_ = 0;
  bool started_ = false;
  bool stopping_ = false;
  std::exception_ptr error_;
  std::thread thread_;
};

// Stop every worker, completing any in-flight task first.  Wait paths
// call this before rethrowing a slot's error so no sibling worker is
// still touching caller-owned buffers while the error unwinds them (the
// use-after-free window otherwise opened by one async op failing while
// others run).  stop() is restartable: later enqueues bring a worker
// back.
inline void quiesce(std::vector<SlotWorker>& workers) {
  for (auto& w : workers) w.stop();
}


}  // namespace shm

class ShmFabric;

// Per-rank view of a group — implements ProxyCommunicator.
class ShmCommunicator : public ProxyCommunicator {
 public:
  ShmCommunicator(std::shared_ptr<shm::Group> group, int group_rank,
                  DType dtype, int num_slots, std::string name)
      : group_(std::move(group)),
        grank_(group_rank),
        dtype_(dtype),
        num_slots_(num_slots),
        name_(std::move(name)),
        workers_(num_slots) {}

  ~ShmCommunicator() override {
    for (auto& w : workers_) w.stop();
  }

  int rank() const override { return grank_; }
  int size() const override {
    return static_cast<int>(group_->members.size());
  }
  std::string name() const override { return name_; }
  DType dtype() const override { return dtype_; }

  // ---- blocking ----
  void Allreduce(const void* src, void* dst, std::int64_t count) override {
    run_collective(num_slots_, shm::OpKind::Allreduce, count, src, dst);
  }
  void Allgather(const void* src, void* dst, std::int64_t cpr) override {
    run_collective(num_slots_, shm::OpKind::Allgather, cpr, src, dst);
  }
  void ReduceScatterBlock(const void* src, void* dst,
                          std::int64_t cpr) override {
    run_collective(num_slots_, shm::OpKind::ReduceScatterBlock, cpr, src, dst);
  }
  void Alltoall(const void* src, void* dst, std::int64_t cpr) override {
    run_collective(num_slots_, shm::OpKind::Alltoall, cpr, src, dst);
  }
  void Barrier() override {
    run_collective(num_slots_, shm::OpKind::Barrier, 0, nullptr, nullptr);
  }

  // ---- p2p (group-rank addressed; see communicator.hpp tag rules) ----
  void Send(const void* src, std::int64_t count, int dst_rank,
            int tag = 0) override {
    group_->mailboxes.send(grank_, dst_rank, tag, src,
                           count * dtype_bytes(dtype_));
  }
  void Recv(void* dst, std::int64_t count, int src_rank,
            int tag = 0) override {
    group_->mailboxes.recv(src_rank, grank_, tag, dst,
                           count * dtype_bytes(dtype_));
  }

  // ---- nonblocking, slot-indexed ----
  void Iallreduce(const void* src, void* dst, std::int64_t count,
                  int slot) override {
    enqueue(slot, [=] {
      run_collective(slot, shm::OpKind::Allreduce, count, src, dst);
    });
  }
  void Iallgather(const void* src, void* dst, std::int64_t cpr,
                  int slot) override {
    enqueue(slot, [=] {
      run_collective(slot, shm::OpKind::Allgather, cpr, src, dst);
    });
  }
  void Isend(const void* src, std::int64_t count, int dst_rank, int slot,
             int tag = -1) override {
    int t = tag >= 0 ? tag : 1 + slot;
    enqueue(slot, [=] {
      group_->mailboxes.send(grank_, dst_rank, t, src,
                             count * dtype_bytes(dtype_));
    });
  }
  void Irecv(void* dst, std::int64_t count, int src_rank, int slot,
             int tag = -1) override {
    int t = tag >= 0 ? tag : 1 + slot;
    enqueue(slot, [=] {
      group_->mailboxes.recv(src_rank, grank_, t, dst,
                             count * dtype_bytes(dtype_));
    });
  }
  void Wait(int slot) override {
    try {
      worker(slot).wait();
    } catch (...) {
      shm::quiesce(workers_);
      throw;
    }
  }
  void WaitAll(int num_slots) override {
    for (int i = 0; i < num_slots && i < num_slots_; ++i) {
      try {
        workers_[i].wait();
      } catch (...) {
        shm::quiesce(workers_);
        throw;
      }
    }
  }

 private:
  shm::SlotWorker& worker(int slot) {
    if (slot < 0 || slot >= num_slots_)
      throw std::out_of_range("slot " + std::to_string(slot) +
                              " out of range (num_slots=" +
                              std::to_string(num_slots_) + ")");
    return workers_[slot];
  }
  void enqueue(int slot, std::function<void()> fn) {
    worker(slot).enqueue(std::move(fn));
  }

  void run_collective(int slot, shm::OpKind op, std::int64_t count,
                      const void* src, void* dst) {
    // per-rank injected latency (fault_plan.hpp delay/jitter events
    // scoped where == "collective"); no-op without an active plan
    fault::Plan::instance().on_collective(group_->members[grank_]);
    int n = size();
    DType dt = dtype_;
    auto& rz = *group_->rendezvous[slot];
    rz.collective(
        grank_, op, count, src, dst,
        [n, dt, count, op](int g, const std::vector<const void*>& srcs,
                           const std::vector<void*>& dsts) {
          std::size_t esz = dtype_bytes(dt);
          switch (op) {
            case shm::OpKind::Barrier:
              break;
            case shm::OpKind::Allreduce: {
              // each rank computes its own full output (tree-free, but the
              // arithmetic is the real sum in float via dtype conversion)
              void* out = dsts[g];
              for (std::int64_t i = 0; i < count; ++i) {
                float acc = 0.0f;
                for (int r = 0; r < n; ++r)
                  acc += load_element(srcs[r], i, dt);
                store_element(out, i, dt, acc);
              }
              break;
            }
            case shm::OpKind::Allgather: {
              char* out = static_cast<char*>(dsts[g]);
              for (int r = 0; r < n; ++r)
                std::memcpy(out + r * count * esz, srcs[r], count * esz);
              break;
            }
            case shm::OpKind::ReduceScatterBlock: {
              void* out = dsts[g];
              for (std::int64_t i = 0; i < count; ++i) {
                float acc = 0.0f;
                for (int r = 0; r < n; ++r)
                  acc += load_element(srcs[r], g * count + i, dt);
                store_element(out, i, dt, acc);
              }
              break;
            }
            case shm::OpKind::Alltoall: {
              char* out = static_cast<char*>(dsts[g]);
              for (int r = 0; r < n; ++r)
                std::memcpy(out + r * count * esz,
                            static_cast<const char*>(srcs[r]) + g * count * esz,
                            count * esz);
              break;
            }
          }
        });
  }

  std::shared_ptr<shm::Group> group_;
  int grank_;
  DType dtype_;
  int num_slots_;
  std::string name_;
  std::vector<shm::SlotWorker> workers_;
};

// The world: spawns rank threads and arbitrates group splits.
class ShmFabric : public Fabric {
 public:
  ShmFabric(int world_size, DType dtype, int num_slots = 32)
      : world_size_(world_size), dtype_(dtype), num_slots_(num_slots) {
    if (world_size <= 0) throw std::invalid_argument("world_size must be > 0");
    std::vector<int> all(world_size);
    for (int i = 0; i < world_size; ++i) all[i] = i;
    world_group_ = std::make_shared<shm::Group>(all, num_slots_);
  }

  int world_size() const override { return world_size_; }
  DType dtype() const override { return dtype_; }
  std::string backend() const override { return "shm"; }
  int num_slots() const { return num_slots_; }

  std::unique_ptr<ProxyCommunicator> world_comm(int rank) override {
    return std::make_unique<ShmCommunicator>(world_group_, rank, dtype_,
                                             num_slots_, "shm_world");
  }

  // Returns this rank's communicator for its color group (see Fabric).
  std::unique_ptr<ProxyCommunicator> split(int world_rank, int color,
                                           const std::string& name) override {
    std::uint64_t seq;
    {
      std::unique_lock<std::mutex> lk(split_m_);
      // pair up with the ongoing round, or start a new one
      if (split_arrived_ == 0) split_colors_.assign(world_size_, 0);
      split_colors_[world_rank] = color;
      seq = split_seq_;
      if (++split_arrived_ == world_size_) {
        // build groups for this round
        std::map<int, std::vector<int>> by_color;
        for (int r = 0; r < world_size_; ++r)
          by_color[split_colors_[r]].push_back(r);
        for (auto& [c, members] : by_color)
          split_groups_[{seq, c}] =
              std::make_shared<shm::Group>(members, num_slots_);
        split_arrived_ = 0;
        ++split_seq_;
        split_cv_.notify_all();
      } else {
        split_cv_.wait(lk, [&] { return split_seq_ > seq; });
      }
    }
    std::shared_ptr<shm::Group> g;
    {
      std::lock_guard<std::mutex> lk(split_m_);
      g = split_groups_.at({seq, color});
    }
    int grank = 0;
    for (std::size_t i = 0; i < g->members.size(); ++i)
      if (g->members[i] == world_rank) grank = static_cast<int>(i);
    return std::make_unique<ShmCommunicator>(g, grank, dtype_, num_slots_,
                                             name);
  }

  void describe(Json& meta, Json& mesh) const override {
    meta["backend"] = "shm";
    meta["device"] = "cpu";
    meta["compute_mode"] = "host_sleep";
    // in-process thread fabric: the timed bytes never leave this
    // process's memory — the provenance that keeps these rows from
    // reading as fabric bandwidth (analysis/bandwidth.py `transport`)
    meta["transport"] = "shm";
    mesh["platform"] = "shm";
    mesh["device_kind"] = "thread-rank";
  }

  // A rank thread died mid-run: poison every group containing it so
  // survivors blocked in a rendezvous/mailbox THROW instead of hanging
  // forever — the in-process analogue of the TCP fabric's per-peer
  // death tracking (fail-fast on the threaded fabric).  Groups without
  // the dead rank (e.g. a fault plan's pre-split survivor group) keep
  // working, which is what lets the `shrink` policy continue the run.
  void mark_rank_dead(int world_rank) override {
    std::string why = "rank " + std::to_string(world_rank) +
                      " died during a collective (shm fail-fast)";
    std::vector<std::shared_ptr<shm::Group>> groups;
    groups.push_back(world_group_);
    {
      std::lock_guard<std::mutex> lk(split_m_);
      for (auto& [key, g] : split_groups_) groups.push_back(g);
    }
    for (auto& g : groups)
      if (g && g->contains(world_rank)) g->abort_all(why);
  }

  // Run body(rank) on world_size threads; rethrows the first rank failure.
  void launch(const std::function<void(int)>& body) override {
    std::vector<std::thread> threads;
    std::mutex err_m;
    std::exception_ptr first_error;
    threads.reserve(world_size_);
    for (int r = 0; r < world_size_; ++r)
      threads.emplace_back([&, r] {
        try {
          body(r);
        } catch (...) {
          // fail-fast: the sibling rank threads must observe the death
          // (abort shared groups) rather than wait forever on a rank
          // that will never arrive
          mark_rank_dead(r);
          std::lock_guard<std::mutex> lk(err_m);
          if (!first_error) first_error = std::current_exception();
        }
      });
    for (auto& t : threads) t.join();
    if (first_error) std::rethrow_exception(first_error);
  }

 private:
  int world_size_;
  DType dtype_;
  int num_slots_;
  std::shared_ptr<shm::Group> world_group_;

  std::mutex split_m_;
  std::condition_variable split_cv_;
  std::vector<int> split_colors_;
  int split_arrived_ = 0;
  std::uint64_t split_seq_ = 0;
  std::map<std::pair<std::uint64_t, int>, std::shared_ptr<shm::Group>>
      split_groups_;
};

}  // namespace dlnb
