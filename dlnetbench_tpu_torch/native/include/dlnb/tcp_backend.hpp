// Cross-process rank fabric over TCP sockets — the native tier's
// multi-process path.
//
// The reference goes multi-process by launching N MPI ranks and
// bootstrapping vendor communicators over them (reference
// cpp/data_parallel/dp.cpp:166-189: MPI_Init + ncclUniqueId broadcast).
// There is no MPI on the hosts this runs on, so the rebuild bootstraps the way
// NCCL itself does under the hood: rank 0 listens on a well-known
// address (the ncclUniqueId role), every rank announces itself and its
// own listen port, rank 0 broadcasts the address book, and the ranks
// dial each other into a FULL MESH of pairwise sockets.
//
// Collectives are symmetric (no coordinator in the data path): every
// group member sends its buffer to every other member and reduces
// locally — the same each-rank-computes-its-own-output model as the
// in-process ShmFabric, so the two fabrics are behaviorally
// interchangeable behind the Fabric interface.  Framing carries
// (comm id, slot, sequence, op, element count, tag), a per-peer reader
// thread demultiplexes frames into an inbox, and mismatched op/count
// across ranks aborts with a clear error instead of hanging.
//
// Communicator splits need no extra round-trips: colors are allgathered
// over the world communicator and every process derives the same group
// memberships and the same new comm id (splits are collective and
// ordered, exactly MPI_Comm_split's contract).
#pragma once

#include <arpa/inet.h>
#include <ifaddrs.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <exception>
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
#include "dlnb/shm_backend.hpp"  // SlotWorker (stream-per-slot discipline)
#include "dlnb/tensor.hpp"

namespace dlnb {
namespace tcp {

// ------------------------------------------------------------- framing
// Bye is the clean-goodbye frame a departing fabric sends every peer
// before closing its sockets: it lets the receiver distinguish "rank X
// finished its run and left" (everything X was supposed to send is
// already ordered before the Bye) from "rank X died mid-run" (frames
// may be lost) — the distinction the transitive ring-dependency check
// needs to avoid false-positive aborts when a fast rank legitimately
// exits while slower ranks are still mid-collective.
enum class FrameKind : std::uint32_t { Coll = 1, P2P = 2, Bye = 3 };

struct FrameHeader {
  std::uint32_t kind;     // FrameKind
  std::uint32_t comm_id;  // 0 = world; splits count up identically everywhere
  std::uint32_t slot;     // slot index (num_slots = blocking ops' slot)
  std::uint32_t seq;      // per-(comm, slot) sequence number at the sender
  std::uint32_t op;       // OpKind for Coll; tag for P2P
  std::uint32_t src;      // sender's WORLD rank
  std::uint64_t count;    // element count (both Coll and P2P)
  std::uint64_t bytes;    // payload size
};

inline void send_all(int fd, const void* data, std::size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) throw std::runtime_error("tcp: send failed (peer gone?)");
    p += w;
    n -= static_cast<std::size_t>(w);
  }
}

// Deterministic-interleaving test hook: delays this process's FINAL
// allgather-phase ring receive so every peer finishes its ring and
// exits first — the clean-early-exit interleaving the Bye protocol
// exists for.  No-op unless the env var is set (pytest sets it on one
// process only: test_native_tcp_ring_survives_clean_early_exit).
inline void test_delay_final_recv() {
  static const int ms = [] {
    const char* e = std::getenv("DLNB_TEST_RING_FINAL_RECV_DELAY_MS");
    return e && *e ? std::atoi(e) : 0;
  }();
  if (ms > 0) ::usleep(static_cast<useconds_t>(ms) * 1000);
}

inline bool recv_all(int fd, void* data, std::size_t n) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r == 0) return false;  // orderly shutdown
    if (r < 0) throw std::runtime_error("tcp: recv failed");
    p += r;
    n -= static_cast<std::size_t>(r);
  }
  return true;
}

// Received frames, keyed for matching.  Collectives match on
// (comm, slot, seq, src); p2p matches on (comm, tag, src) in FIFO order.
//
// Failure is tracked PER PEER: a take waiting on rank X fails only when
// X itself is gone, never because some OTHER rank finished its work and
// exited cleanly.  (The subtle race this kills: rank A blocks on rank
// B's barrier frame, still in flight, while rank C — already done —
// exits; a global error flag would fail A's wait even though B is alive
// and its frame lands a moment later.  Per-peer tracking is sound
// because TCP orders a socket's FIN after its data: by the time we see
// X's EOF, everything X sent US has been pushed.)
class Inbox {
 public:
  struct Frame {
    FrameHeader h;
    std::vector<char> payload;
  };

  void push(Frame f) {
    std::lock_guard<std::mutex> lk(m_);
    frames_.push_back(std::move(f));
    cv_.notify_all();
  }

  // Mark `peer` dead (EOF or reader error); takes waiting on that peer
  // fail after draining any frames it already delivered.
  void fail(int peer, const std::string& why) {
    std::lock_guard<std::mutex> lk(m_);
    dead_.emplace(peer, why);
    cv_.notify_all();
  }

  // Mark `peer` cleanly departed (Bye frame): everything it owed the
  // fabric was sent before the Bye, so waits that merely DEPEND on it
  // transitively must keep waiting (their data rides other, still-alive
  // ranks), while a direct wait for one of its frames that never
  // matched is a protocol desync and must error rather than hang.
  void depart(int peer) {
    std::lock_guard<std::mutex> lk(m_);
    departed_.emplace(peer);
    cv_.notify_all();
  }

  // Blocking take of the first frame matching `pred`, which must only
  // accept frames from world rank `want_src` (all matching here is
  // per-source).  Queued frames are matched BEFORE the death flag is
  // consulted, so an op whose frames already landed still completes.
  // `also_dep` lists ranks the awaited frame TRANSITIVELY depends on
  // (a ring step's data has passed through every group member): their
  // DEATH fails the wait too, even though want_src itself is alive —
  // otherwise a mid-ring death would hang non-neighbors until the
  // failure cascaded around the ring via process exits.  A CLEAN
  // departure of a dep rank does NOT fail the wait: the departed rank
  // finished its contribution before leaving, so the awaited frame is
  // still coming from the (alive) want_src.
  template <typename Pred>
  Frame take(int want_src, const Pred& pred,
             const std::vector<int>& also_dep = {}) {
    std::unique_lock<std::mutex> lk(m_);
    std::deque<Frame>::iterator it;
    auto find = [&] {
      for (it = frames_.begin(); it != frames_.end(); ++it)
        if (pred(it->h)) return true;
      return false;
    };
    const int* dead_dep = nullptr;  // null at throw time => departed src
    auto failed = [&] {
      dead_dep = nullptr;
      if (dead_.count(want_src)) {
        dead_dep = &want_src;
        return true;
      }
      if (departed_.count(want_src)) return true;
      for (const int& d : also_dep)
        if (dead_.count(d)) {
          dead_dep = &d;
          return true;
        }
      return false;
    };
    cv_.wait(lk, [&] { return find() || failed(); });
    if (!find()) {
      if (dead_dep)
        throw std::runtime_error("tcp fabric: " + dead_.at(*dead_dep));
      throw std::runtime_error(
          "tcp fabric: rank " + std::to_string(want_src) +
          " finished its run and left, but a frame expected from it "
          "never arrived (collective schedules desynchronized?)");
    }
    Frame f = std::move(*it);
    frames_.erase(it);
    return f;
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  std::deque<Frame> frames_;
  std::map<int, std::string> dead_;
  std::set<int> departed_;
};

}  // namespace tcp

class TcpFabric;

// One process's view of a communicator group over the TCP mesh.
class TcpCommunicator : public ProxyCommunicator {
 public:
  TcpCommunicator(TcpFabric* fab, std::uint32_t comm_id,
                  std::vector<int> members, int world_rank, DType dtype,
                  int num_slots, std::string name)
      : fab_(fab),
        comm_id_(comm_id),
        members_(std::move(members)),
        wrank_(world_rank),
        dtype_(dtype),
        num_slots_(num_slots),
        name_(std::move(name)),
        seq_(num_slots + 1, 0),
        workers_(num_slots) {
    for (std::size_t i = 0; i < members_.size(); ++i)
      if (members_[i] == wrank_) grank_ = static_cast<int>(i);
  }

  ~TcpCommunicator() override {
    for (auto& w : workers_) w.stop();
  }

  int rank() const override { return grank_; }
  int size() const override { return static_cast<int>(members_.size()); }
  std::string name() const override { return name_; }
  DType dtype() const override { return dtype_; }

  void Allreduce(const void* src, void* dst, std::int64_t count) override {
    collective(num_slots_, shm::OpKind::Allreduce, count, src, dst);
  }
  void Allgather(const void* src, void* dst, std::int64_t cpr) override {
    collective(num_slots_, shm::OpKind::Allgather, cpr, src, dst);
  }
  void ReduceScatterBlock(const void* src, void* dst,
                          std::int64_t cpr) override {
    collective(num_slots_, shm::OpKind::ReduceScatterBlock, cpr, src, dst);
  }
  void Alltoall(const void* src, void* dst, std::int64_t cpr) override {
    collective(num_slots_, shm::OpKind::Alltoall, cpr, src, dst);
  }
  void Barrier() override {
    collective(num_slots_, shm::OpKind::Barrier, 0, nullptr, nullptr);
  }

  void Send(const void* src, std::int64_t count, int dst_rank,
            int tag = 0) override;
  void Recv(void* dst, std::int64_t count, int src_rank,
            int tag = 0) override;

  void Iallreduce(const void* src, void* dst, std::int64_t count,
                  int slot) override {
    enqueue(slot, [=] {
      collective(slot, shm::OpKind::Allreduce, count, src, dst);
    });
  }
  void Iallgather(const void* src, void* dst, std::int64_t cpr,
                  int slot) override {
    enqueue(slot, [=] {
      collective(slot, shm::OpKind::Allgather, cpr, src, dst);
    });
  }
  void Isend(const void* src, std::int64_t count, int dst_rank, int slot,
             int tag = -1) override {
    int t = tag >= 0 ? tag : 1 + slot;
    enqueue(slot, [=] { Send(src, count, dst_rank, t); });
  }
  void Irecv(void* dst, std::int64_t count, int src_rank, int slot,
             int tag = -1) override {
    int t = tag >= 0 ? tag : 1 + slot;
    enqueue(slot, [=] { Recv(dst, count, src_rank, t); });
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
  friend class TcpFabric;
  void collective(int slot, shm::OpKind op, std::int64_t count,
                  const void* src, void* dst);
  void ring_allreduce(int slot, std::int64_t count, const void* src,
                      void* dst);

  shm::SlotWorker& worker(int slot) {
    if (slot < 0 || slot >= num_slots_)
      throw std::out_of_range("slot " + std::to_string(slot) +
                              " out of range");
    return workers_[slot];
  }
  void enqueue(int slot, std::function<void()> fn) {
    worker(slot).enqueue(std::move(fn));
  }

  TcpFabric* fab_;
  std::uint32_t comm_id_;
  std::vector<int> members_;  // world ranks, ascending (group rank order)
  int wrank_;
  int grank_ = 0;
  DType dtype_;
  int num_slots_;
  std::string name_;
  std::vector<std::uint32_t> seq_;  // per-slot collective sequence
  std::mutex seq_m_;
  std::vector<shm::SlotWorker> workers_;
};

// The world: bootstrap, pairwise sockets, reader threads, comm registry.
class TcpFabric : public Fabric {
 public:
  // Rank 0 listens on `coordinator` ("host:port"); everyone else dials
  // it.  After the address-book exchange all ranks hold one socket per
  // peer.  One fabric = one process = one rank (the MPI model).
  TcpFabric(const std::string& coordinator, int world_size, int rank,
            DType dtype, int num_slots = 32)
      : world_(world_size),
        rank_(rank),
        dtype_(dtype),
        num_slots_(num_slots),
        fds_(world_size, -1) {
    if (world_size <= 0 || rank < 0 || rank >= world_size)
      throw std::invalid_argument("tcp fabric: bad world/rank");
    // NOTE: the override must be set identically on every process — the
    // algorithm choice is part of the collective's wire protocol
    if (const char* env = std::getenv("DLNB_TCP_RING_THRESHOLD");
        env && *env)
      ring_threshold_bytes_ = static_cast<std::size_t>(std::stoll(env));
    if (world_size > 1) bootstrap(coordinator);
    // Transport provenance from the CONNECTED peer sockets (not the
    // coordinator string, which could be a hostname resolving to
    // loopback): the mesh is loopback only when every peer is THIS
    // machine — a 127/8 (or ::1) address, or one of this host's own
    // interface addresses (co-hosted ranks dialing the eth0 IP still
    // move kernel memory, not wire bytes).  This classifies uniformly
    // across processes — co-hosted worlds see all-local peers
    // everywhere, and in any world with a remote host the full mesh
    // gives EVERY process a remote peer — so the per-process records a
    // multi-host merge compares always agree.
    for (int fd : fds_)
      if (fd >= 0 && !fd_peer_is_local(fd)) {
        loopback_ = false;
        break;
      }
    for (int r = 0; r < world_; ++r)
      if (r != rank_) start_reader(r);
  }

  static bool sockaddr_is_loopback(const sockaddr_storage& ss) {
    if (ss.ss_family == AF_INET) {
      const auto& a = reinterpret_cast<const sockaddr_in&>(ss);
      return (ntohl(a.sin_addr.s_addr) >> 24) == 127;
    }
    if (ss.ss_family == AF_INET6) {
      const auto& a6 = reinterpret_cast<const sockaddr_in6&>(ss);
      if (IN6_IS_ADDR_LOOPBACK(&a6.sin6_addr)) return true;
      if (IN6_IS_ADDR_V4MAPPED(&a6.sin6_addr))
        return a6.sin6_addr.s6_addr[12] == 127;  // ::ffff:127.x.y.z
    }
    return false;
  }

  static bool fd_peer_is_local(int fd) {
    sockaddr_storage ss{};
    socklen_t len = sizeof ss;
    if (::getpeername(fd, reinterpret_cast<sockaddr*>(&ss), &len) != 0)
      return true;  // unknowable: never over-credit as network physics
    if (sockaddr_is_loopback(ss)) return true;
    // same-host via a non-loopback interface address: compare against
    // this machine's own addresses (kernel-routed either way)
    ifaddrs* ifs = nullptr;
    bool local = false;
    if (::getifaddrs(&ifs) == 0) {
      for (const ifaddrs* i = ifs; i; i = i->ifa_next) {
        if (!i->ifa_addr || i->ifa_addr->sa_family != ss.ss_family)
          continue;
        if (ss.ss_family == AF_INET) {
          const auto* ia = reinterpret_cast<const sockaddr_in*>(i->ifa_addr);
          if (ia->sin_addr.s_addr ==
              reinterpret_cast<const sockaddr_in&>(ss).sin_addr.s_addr) {
            local = true;
            break;
          }
        } else if (ss.ss_family == AF_INET6) {
          const auto* ia6 =
              reinterpret_cast<const sockaddr_in6*>(i->ifa_addr);
          if (std::memcmp(&ia6->sin6_addr,
                          &reinterpret_cast<const sockaddr_in6&>(ss)
                               .sin6_addr,
                          sizeof(in6_addr)) == 0) {
            local = true;
            break;
          }
        }
      }
      ::freeifaddrs(ifs);
    }
    return local;
  }

  ~TcpFabric() override {
    // clean goodbye first (FrameKind::Bye): TCP orders it after every
    // data frame this process sent, so peers can tell "finished and
    // left" from "died mid-run" — a slower rank must keep waiting for
    // frames from STILL-ALIVE ranks after a fast rank legitimately
    // exits (the ring's transitive-dependency check would otherwise
    // false-positive on the Bye'd rank's EOF).  But ONLY on clean
    // completion: if this destructor runs during exception unwinding,
    // the rank is DYING mid-run, and advertising that as a clean
    // departure would disarm the transitive (also_dep) fail-fast on
    // every waiter — failure would then surface only as a serial
    // cascade of direct-wait desync errors masking the real cause.
    // Skipping the Bye lets peers see the EOF for what it is: a death.  ``uncaught_exceptions()`` is THREAD-LOCAL: when
    // the failing rank's exception was caught on another thread (a
    // launch wrapper storing it to rethrow, a test harness swallowing
    // it) and the fabric is destroyed later on the main thread, the
    // count here reads 0 — so the rank-thread exception handlers also
    // latch the ``dying_`` flag, and a dying fabric never says Bye
    // regardless of which thread runs the destructor.
    if (std::uncaught_exceptions() == 0 &&
        !dying_.load(std::memory_order_acquire)) {
      for (int r = 0; r < world_; ++r) {
        if (r == rank_ || fds_[r] < 0) continue;
        tcp::FrameHeader h{};
        h.kind = static_cast<std::uint32_t>(tcp::FrameKind::Bye);
        h.src = static_cast<std::uint32_t>(rank_);
        try {
          send_frame(r, h, nullptr);
        } catch (...) {
          // peer already gone: nothing to tell it
        }
      }
    }
    closing_.store(true, std::memory_order_release);
    for (int fd : fds_)
      if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
    for (auto& t : readers_)
      if (t.joinable()) t.join();
    for (int fd : fds_)
      if (fd >= 0) ::close(fd);
  }

  int world_size() const override { return world_; }
  int rank() const { return rank_; }
  DType dtype() const override { return dtype_; }
  std::string backend() const override { return "tcp"; }

  std::unique_ptr<ProxyCommunicator> world_comm(int /*rank*/) override {
    return std::make_unique<TcpCommunicator>(this, 0, all_ranks(), rank_,
                                             dtype_, num_slots_, "tcp_world");
  }

  // Collective split: colors are allgathered over an internal world
  // communicator; every process derives the same groups and the same
  // comm id (splits are ordered, the MPI_Comm_split contract).
  std::unique_ptr<ProxyCommunicator> split(
      int /*world_rank*/, int color, const std::string& name) override {
    std::vector<std::int32_t> colors(world_);
    {
      // f32 allgather of colors — exact for |color| < 2^24.  NOTE the
      // seq-matching contract: every process must create and use its
      // communicators in the same order (the SPMD/MPI discipline the
      // proxies already follow), since sequence counters are per object.
      Tensor s(1, DType::F32), d(world_, DType::F32);
      s.set(0, static_cast<float>(color));
      TcpCommunicator tmp(this, 0, all_ranks(), rank_, DType::F32,
                          num_slots_, "split_tmp");
      tmp.Allgather(s.data(), d.data(), 1);
      for (int r = 0; r < world_; ++r)
        colors[r] = static_cast<std::int32_t>(d.get(r));
    }
    std::vector<int> members;
    for (int r = 0; r < world_; ++r)
      if (colors[r] == colors[rank_]) members.push_back(r);
    std::uint32_t id = ++next_comm_id_;
    return std::make_unique<TcpCommunicator>(this, id, std::move(members),
                                             rank_, dtype_, num_slots_, name);
  }

  // The rank is dying mid-run: suppress the clean-departure Bye even if
  // the destructor later runs on a thread with no in-flight exception.
  void mark_dying() { dying_.store(true, std::memory_order_release); }

  // Fault-plan crash path (one process = one rank): a scripted death
  // must look exactly like a real one — no Bye, so every peer reads the
  // EOF as a mid-run death and the transitive fail-fast fires.
  void mark_rank_dead(int /*world_rank*/) override { mark_dying(); }

  // One process = one rank: body runs once, in this thread.
  void launch(const std::function<void(int)>& body) override {
    try {
      body(rank_);
    } catch (...) {
      mark_dying();  // fail-fast must survive destruction elsewhere
      throw;
    }
  }

  std::vector<int> local_ranks() const override { return {rank_}; }
  int process_index() const override { return rank_; }

  void describe(Json& meta, Json& mesh) const override {
    meta["backend"] = "tcp";
    meta["device"] = "cpu";
    meta["compute_mode"] = "host_sleep";
    meta["num_processes"] = world_;
    // loopback sockets move kernel memory at memcpy speed; only the
    // ethernet classification is network physics (analysis/bandwidth.py
    // surfaces this as the summary table's `transport` column)
    meta["transport"] = loopback_ ? "tcp:loopback" : "tcp:ethernet";
    // allreduces at/above this many bytes ride the bandwidth-optimal
    // ring (2(n-1)/n x count on the wire); smaller ones and the
    // gather-style ops use the pairwise full mesh (which for
    // allgather/reduce-scatter/alltoall already moves the optimal
    // (n-1)/n x bytes).  analysis/bandwidth.py refuses busbw for
    // allreduce timers below the threshold — full-mesh allreduce moves
    // (n-1) x count and is not an algorithm any real fabric runs.
    meta["tcp_ring_threshold_bytes"] =
        static_cast<std::int64_t>(ring_threshold_bytes_);
    // this process's payload+header bytes actually written to sockets —
    // lets tests pin the algorithm's wire cost without timing flakiness
    meta["tcp_bytes_sent"] = static_cast<std::int64_t>(
        bytes_sent_.load(std::memory_order_relaxed));
    mesh["platform"] = "tcp";
    mesh["device_kind"] = "process-rank";
  }

  std::size_t ring_threshold_bytes() const { return ring_threshold_bytes_; }
  bool loopback() const { return loopback_; }

  // payload+header bytes this process actually wrote to sockets —
  // layered fabrics stamp it into their own records
  std::uint64_t bytes_sent() const {
    return bytes_sent_.load(std::memory_order_relaxed);
  }

  tcp::Inbox& inbox() { return inbox_; }

  // Reserve the next communicator id without creating a communicator —
  // layered fabrics construct TcpCommunicators with
  // explicit member lists and keep ids aligned across processes by
  // allocating in the same deterministic order everywhere.
  std::uint32_t allocate_comm_id() { return ++next_comm_id_; }

  void send_frame(int dst, const tcp::FrameHeader& h, const void* payload) {
    if (dst == rank_) {  // self-delivery (degenerate groups, self-sends)
      tcp::Inbox::Frame f;
      f.h = h;
      f.payload.assign(static_cast<const char*>(payload),
                       static_cast<const char*>(payload) + h.bytes);
      inbox_.push(std::move(f));
      return;
    }
    // fault injection at the transmission point (fault_plan.hpp): drop
    // events model loss + sender-side retransmission — backoff sleeps
    // under policy `retry` (counted into the record), an abort under
    // `fail_fast`; partition events fail sends across the boundary.
    // Applies to every frame this process writes, including a
    // layered fabric's bootstrap traffic.
    fault::Plan::instance().on_send(rank_, dst);
    std::lock_guard<std::mutex> lk(send_m_[dst]);
    tcp::send_all(fds_[dst], &h, sizeof h);
    if (h.bytes) tcp::send_all(fds_[dst], payload, h.bytes);
    bytes_sent_.fetch_add(sizeof h + h.bytes, std::memory_order_relaxed);
  }

 private:
  std::vector<int> all_ranks() const {
    std::vector<int> all(world_);
    for (int i = 0; i < world_; ++i) all[i] = i;
    return all;
  }

  static int dial(const std::string& host, int port, int timeout_s = 30) {
    // resolve names as well as dotted quads (multi-host address books
    // carry whatever the peer's kernel reported)
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<std::uint16_t>(port));
    if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
      addrinfo hints{}, *res = nullptr;
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      if (::getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
        throw std::runtime_error("tcp: cannot resolve " + host);
      addr.sin_addr =
          reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
      ::freeaddrinfo(res);
    }
    for (int attempt = 0; attempt < timeout_s * 10; ++attempt) {
      int fd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd < 0) throw std::runtime_error("tcp: socket() failed");
      if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) ==
          0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        return fd;
      }
      ::close(fd);
      ::usleep(100 * 1000);  // coordinator may not be up yet
    }
    throw std::runtime_error("tcp: cannot reach " + host + ":" +
                             std::to_string(port));
  }

  static int listen_any(int& port_out) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) throw std::runtime_error("tcp: socket() failed");
    int one = 1;
    ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<std::uint16_t>(port_out));
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0)
      throw std::runtime_error("tcp: bind failed (port " +
                               std::to_string(port_out) + ")");
    socklen_t len = sizeof addr;
    ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port_out = ntohs(addr.sin_port);
    if (::listen(fd, 64) != 0) throw std::runtime_error("tcp: listen failed");
    return fd;
  }

  void bootstrap(const std::string& coordinator) {
    auto colon = coordinator.rfind(':');
    if (colon == std::string::npos)
      throw std::runtime_error("tcp: coordinator must be host:port, got " +
                               coordinator);
    std::string host = coordinator.substr(0, colon);
    int coord_port = std::stoi(coordinator.substr(colon + 1));
    send_m_ = std::vector<std::mutex>(world_);

    // address book entry: the host each rank is reachable at (learned
    // by rank 0 from the accepted connection's peer address — always a
    // routable address, unlike a self-reported hostname) + listen port
    struct Entry {
      char host[64];
      std::int32_t port;
    };

    if (rank_ == 0) {
      // the ncclUniqueId role: accept every rank, note where it dialed
      // from and its own listen port, then broadcast the address book
      int port = coord_port;
      int lfd = listen_any(port);
      std::vector<Entry> book(world_);
      std::memset(book.data(), 0, book.size() * sizeof(Entry));
      for (int n = 1; n < world_; ++n) {
        sockaddr_in peer_addr{};
        socklen_t alen = sizeof peer_addr;
        int fd = ::accept(lfd, reinterpret_cast<sockaddr*>(&peer_addr),
                          &alen);
        if (fd < 0) throw std::runtime_error("tcp: accept failed");
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        std::int32_t hello[2];  // {rank, my own listen port}
        if (!tcp::recv_all(fd, hello, sizeof hello))
          throw std::runtime_error("tcp: rank hello truncated");
        fds_[hello[0]] = fd;
        Entry& e = book[hello[0]];
        ::inet_ntop(AF_INET, &peer_addr.sin_addr, e.host, sizeof e.host);
        e.port = hello[1];
      }
      ::close(lfd);
      for (int r = 1; r < world_; ++r)
        tcp::send_all(fds_[r], book.data(), book.size() * sizeof(Entry));
      // rank 0 reuses its accepted sockets; higher ranks dial each other:
      // rank i accepts from ranks j > i on its own listener
    } else {
      // listen for higher ranks first so the book can be acted on
      int my_port = 0;
      int lfd = listen_any(my_port);
      int fd0 = dial(host, coord_port);
      std::int32_t hello[2] = {static_cast<std::int32_t>(rank_),
                               static_cast<std::int32_t>(my_port)};
      tcp::send_all(fd0, hello, sizeof hello);
      fds_[0] = fd0;
      std::vector<Entry> book(world_);
      if (!tcp::recv_all(fd0, book.data(), book.size() * sizeof(Entry)))
        throw std::runtime_error("tcp: address book truncated");
      // dial every lower-ranked peer (except 0, already connected) AT ITS
      // OWN HOST; accept from every higher-ranked peer
      for (int r = 1; r < rank_; ++r) {
        int fd = dial(book[r].host, book[r].port);
        std::int32_t me = rank_;
        tcp::send_all(fd, &me, sizeof me);
        fds_[r] = fd;
      }
      for (int r = rank_ + 1; r < world_; ++r) {
        int fd = ::accept(lfd, nullptr, nullptr);
        if (fd < 0) throw std::runtime_error("tcp: accept failed");
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        std::int32_t peer;
        if (!tcp::recv_all(fd, &peer, sizeof peer))
          throw std::runtime_error("tcp: peer hello truncated");
        fds_[peer] = fd;
      }
      ::close(lfd);
    }
  }

  void start_reader(int peer) {
    readers_.emplace_back([this, peer] {
      bool bye = false;
      try {
        while (true) {
          tcp::FrameHeader h;
          if (!tcp::recv_all(fds_[peer], &h, sizeof h)) {
            // EOF: silent when the peer said goodbye (clean departure,
            // already recorded) or during our own orderly teardown — a
            // peer dying mid-run must fail waits on THAT peer (its own
            // sent frames were delivered before the FIN), without
            // poisoning waits on still-alive ranks
            if (!bye && !closing_.load(std::memory_order_acquire))
              inbox_.fail(peer, "rank " + std::to_string(peer) +
                                    " disconnected mid-run");
            return;
          }
          if (h.kind == static_cast<std::uint32_t>(tcp::FrameKind::Bye)) {
            bye = true;
            inbox_.depart(peer);
            continue;  // keep draining until the FIN
          }
          tcp::Inbox::Frame f;
          f.h = h;
          f.payload.resize(h.bytes);
          if (h.bytes && !tcp::recv_all(fds_[peer], f.payload.data(), h.bytes))
            throw std::runtime_error("payload truncated");
          inbox_.push(std::move(f));
        }
      } catch (const std::exception& e) {
        // post-Bye socket errors (e.g. an RST racing the FIN) carry no
        // information: everything the peer owed us already arrived
        if (!bye && !closing_.load(std::memory_order_acquire))
          inbox_.fail(peer, std::string("reader for rank ") +
                                std::to_string(peer) + ": " + e.what());
      }
    });
  }

  int world_;
  int rank_;
  DType dtype_;
  int num_slots_;
  std::vector<int> fds_;
  std::vector<std::mutex> send_m_{1};
  std::vector<std::thread> readers_;
  tcp::Inbox inbox_;
  std::atomic<std::uint32_t> next_comm_id_{0};
  std::atomic<bool> closing_{false};
  // set by the rank-thread exception handlers (launch wrappers here and
  // in a layered fabric): the destructor must not send Bye for a dying rank
  // even when it runs on a thread whose uncaught_exceptions() is 0
  std::atomic<bool> dying_{false};
  bool loopback_ = true;
  std::size_t ring_threshold_bytes_ = 64 * 1024;
  std::atomic<std::uint64_t> bytes_sent_{0};
};

// ---- TcpCommunicator method bodies needing the fabric ----

inline void TcpCommunicator::Send(const void* src, std::int64_t count,
                                  int dst_rank, int tag) {
  tcp::FrameHeader h{};
  h.kind = static_cast<std::uint32_t>(tcp::FrameKind::P2P);
  h.comm_id = comm_id_;
  h.op = static_cast<std::uint32_t>(tag);
  h.src = static_cast<std::uint32_t>(wrank_);
  h.count = static_cast<std::uint64_t>(count);
  h.bytes = static_cast<std::uint64_t>(count) * dtype_bytes(dtype_);
  fab_->send_frame(members_.at(dst_rank), h, src);
}

inline void TcpCommunicator::Recv(void* dst, std::int64_t count,
                                  int src_rank, int tag) {
  std::uint32_t want_src = static_cast<std::uint32_t>(members_.at(src_rank));
  std::uint32_t want_tag = static_cast<std::uint32_t>(tag);
  std::uint32_t cid = comm_id_;
  auto f = fab_->inbox().take(
      static_cast<int>(want_src), [&](const tcp::FrameHeader& h) {
        return h.kind == static_cast<std::uint32_t>(tcp::FrameKind::P2P) &&
               h.comm_id == cid && h.src == want_src && h.op == want_tag;
      });
  std::size_t want = static_cast<std::size_t>(count) * dtype_bytes(dtype_);
  if (f.payload.size() != want)
    throw std::runtime_error("tcp p2p size mismatch: got " +
                             std::to_string(f.payload.size()) + "B, want " +
                             std::to_string(want) + "B");
  std::memcpy(dst, f.payload.data(), want);
}

inline void TcpCommunicator::collective(int slot, shm::OpKind op,
                                        std::int64_t count, const void* src,
                                        void* dst) {
  // per-rank injected latency (fault_plan.hpp collective-scoped events)
  fault::Plan::instance().on_collective(wrank_);
  const int n = size();
  const std::size_t esz = dtype_bytes(dtype_);
  // Large allreduces ride the bandwidth-optimal ring: the full mesh
  // moves (n-1) x count per rank where a ring moves 2(n-1)/n x count —
  // at n=8 a 4x difference no real fabric's algorithm would show.  The
  // gather-style ops keep the pairwise mesh (already (n-1)/n-optimal);
  // small allreduces stay full-mesh (latency-bound: 1 round trip vs the
  // ring's 2(n-1) serial steps).
  if (op == shm::OpKind::Allreduce && n > 2 &&
      static_cast<std::size_t>(count) * esz >= fab_->ring_threshold_bytes())
    return ring_allreduce(slot, count, src, dst);
  std::uint32_t seq;
  {
    std::lock_guard<std::mutex> lk(seq_m_);
    seq = seq_[static_cast<std::size_t>(slot)]++;
  }
  // payload per op: what the OTHER side needs from us
  std::size_t bytes = 0;
  switch (op) {
    case shm::OpKind::Barrier: bytes = 0; break;
    case shm::OpKind::Allreduce:
    case shm::OpKind::Allgather:
      bytes = static_cast<std::size_t>(count) * esz;  // my full contribution
      break;
    case shm::OpKind::ReduceScatterBlock:
    case shm::OpKind::Alltoall:
      bytes = static_cast<std::size_t>(count) * esz;  // one block per peer
      break;
  }
  tcp::FrameHeader h{};
  h.kind = static_cast<std::uint32_t>(tcp::FrameKind::Coll);
  h.comm_id = comm_id_;
  h.slot = static_cast<std::uint32_t>(slot);
  h.seq = seq;
  h.op = static_cast<std::uint32_t>(op);
  h.src = static_cast<std::uint32_t>(wrank_);
  h.count = static_cast<std::uint64_t>(count);
  const char* me = static_cast<const char*>(src);
  for (int g = 0; g < n; ++g) {
    int peer = members_[g];
    if (peer == wrank_) continue;
    const void* payload = me;
    // scatter-style ops send peer g its own block
    if (op == shm::OpKind::ReduceScatterBlock ||
        op == shm::OpKind::Alltoall)
      payload = me + static_cast<std::size_t>(g) * bytes;
    h.bytes = bytes;
    fab_->send_frame(peer, h, payload);
  }

  // gather everyone's frame for (comm, slot, seq), then combine locally
  std::map<int, std::vector<char>> got;
  for (int g = 0; g < n; ++g) {
    int peer = members_[g];
    if (peer == wrank_) continue;
    std::uint32_t want_src = static_cast<std::uint32_t>(peer);
    auto f = fab_->inbox().take(peer, [&](const tcp::FrameHeader& fh) {
      return fh.kind == static_cast<std::uint32_t>(tcp::FrameKind::Coll) &&
             fh.comm_id == comm_id_ &&
             fh.slot == static_cast<std::uint32_t>(slot) && fh.seq == seq &&
             fh.src == want_src;
    });
    if (static_cast<shm::OpKind>(f.h.op) != op ||
        static_cast<std::int64_t>(f.h.count) != count)
      throw std::runtime_error(
          "tcp collective mismatch: ranks disagree on op/count (got op " +
          std::to_string(f.h.op) + " count " + std::to_string(f.h.count) +
          ", expected op " + std::to_string(static_cast<int>(op)) +
          " count " + std::to_string(count) + ")");
    got[g] = std::move(f.payload);
  }

  switch (op) {
    case shm::OpKind::Barrier:
      break;
    case shm::OpKind::Allreduce: {
      for (std::int64_t i = 0; i < count; ++i) {
        float acc = load_element(src, static_cast<std::size_t>(i), dtype_);
        for (auto& [g, buf] : got)
          acc += load_element(buf.data(), static_cast<std::size_t>(i),
                              dtype_);
        store_element(dst, static_cast<std::size_t>(i), dtype_, acc);
      }
      break;
    }
    case shm::OpKind::Allgather: {
      char* out = static_cast<char*>(dst);
      std::size_t blk = static_cast<std::size_t>(count) * esz;
      std::memcpy(out + static_cast<std::size_t>(grank_) * blk, src, blk);
      for (auto& [g, buf] : got)
        std::memcpy(out + static_cast<std::size_t>(g) * blk, buf.data(),
                    blk);
      break;
    }
    case shm::OpKind::ReduceScatterBlock: {
      // my own block g=grank_ from src, plus each peer's sent block
      const char* mine =
          static_cast<const char*>(src) +
          static_cast<std::size_t>(grank_) * static_cast<std::size_t>(count) *
              esz;
      for (std::int64_t i = 0; i < count; ++i) {
        float acc = load_element(mine, static_cast<std::size_t>(i), dtype_);
        for (auto& [g, buf] : got)
          acc += load_element(buf.data(), static_cast<std::size_t>(i),
                              dtype_);
        store_element(dst, static_cast<std::size_t>(i), dtype_, acc);
      }
      break;
    }
    case shm::OpKind::Alltoall: {
      char* out = static_cast<char*>(dst);
      std::size_t blk = static_cast<std::size_t>(count) * esz;
      std::memcpy(out + static_cast<std::size_t>(grank_) * blk,
                  static_cast<const char*>(src) +
                      static_cast<std::size_t>(grank_) * blk,
                  blk);
      for (auto& [g, buf] : got)
        std::memcpy(out + static_cast<std::size_t>(g) * blk, buf.data(), blk);
      break;
    }
  }
}

// Ring allreduce (NCCL's ring algorithm): n-1 reduce-scatter steps —
// each rank passes a partial-sum block to its successor, accumulating
// the block it receives — then n-1 allgather steps rotating the
// completed blocks.  After the first phase rank r owns the fully
// reduced block (r+1) mod n (the standard rotation).  Each step is one
// frame to the successor matched by (comm, slot, seq, src); every rank
// advances the slot's sequence counter by the same 2(n-1), so later
// collectives on the slot stay aligned.  The per-peer reader threads
// drain sockets independently of this rank's send, so a blocking
// send_all can never deadlock against a peer doing the same.
inline void TcpCommunicator::ring_allreduce(int slot, std::int64_t count,
                                            const void* src, void* dst) {
  const int n = size();
  const std::size_t esz = dtype_bytes(dtype_);
  const std::int64_t block = (count + n - 1) / n;
  auto blen = [&](std::int64_t bi) {
    std::int64_t left = count - bi * block;
    return left < 0 ? 0 : (left > block ? block : left);
  };
  if (dst != src)
    std::memcpy(dst, src, static_cast<std::size_t>(count) * esz);
  std::uint32_t base;
  {
    std::lock_guard<std::mutex> lk(seq_m_);
    base = seq_[static_cast<std::size_t>(slot)];
    seq_[static_cast<std::size_t>(slot)] +=
        2 * static_cast<std::uint32_t>(n - 1);
  }
  const int to = members_[(grank_ + 1) % n];
  const int from = members_[(grank_ - 1 + n) % n];

  auto send_block = [&](std::int64_t bi, std::uint32_t seq) {
    tcp::FrameHeader h{};
    h.kind = static_cast<std::uint32_t>(tcp::FrameKind::Coll);
    h.comm_id = comm_id_;
    h.slot = static_cast<std::uint32_t>(slot);
    h.seq = seq;
    h.op = static_cast<std::uint32_t>(shm::OpKind::Allreduce);
    h.src = static_cast<std::uint32_t>(wrank_);
    h.count = static_cast<std::uint64_t>(count);
    std::int64_t len = blen(bi);
    h.bytes = static_cast<std::uint64_t>(len) * esz;
    // a zero-length tail block (count small vs n) must not even FORM the
    // out-of-range bi*block offset pointer — UB the UBSan preset exists
    // to catch; the frame still goes out so seq counters stay aligned
    fab_->send_frame(to, h,
                     len == 0 ? dst
                              : static_cast<const char*>(dst) +
                                    static_cast<std::size_t>(bi) * block *
                                        esz);
  };
  // ring data has passed through every member: any member's death must
  // fail this wait, not just the immediate predecessor's
  std::vector<int> ring_deps;
  for (int m : members_)
    if (m != wrank_ && m != from) ring_deps.push_back(m);
  auto recv_block = [&](std::uint32_t seq) {
    auto f = fab_->inbox().take(
        from,
        [&](const tcp::FrameHeader& fh) {
          return fh.kind ==
                     static_cast<std::uint32_t>(tcp::FrameKind::Coll) &&
                 fh.comm_id == comm_id_ &&
                 fh.slot == static_cast<std::uint32_t>(slot) &&
                 fh.seq == seq &&
                 fh.src == static_cast<std::uint32_t>(from);
        },
        ring_deps);
    if (static_cast<shm::OpKind>(f.h.op) != shm::OpKind::Allreduce ||
        static_cast<std::int64_t>(f.h.count) != count)
      throw std::runtime_error(
          "tcp ring allreduce mismatch: ranks disagree on op/count "
          "(is DLNB_TCP_RING_THRESHOLD set identically everywhere?)");
    return f;
  };

  for (int step = 0; step < n - 1; ++step) {  // reduce-scatter phase
    std::int64_t sb = ((grank_ - step) % n + n) % n;
    std::int64_t rb = ((grank_ - step - 1) % n + n) % n;
    send_block(sb, base + static_cast<std::uint32_t>(step));
    auto f = recv_block(base + static_cast<std::uint32_t>(step));
    std::int64_t len = blen(rb);
    if (f.payload.size() != static_cast<std::size_t>(len) * esz)
      throw std::runtime_error("tcp ring allreduce: block size mismatch");
    if (len == 0) continue;  // zero tail block: no valid rb offset exists
    char* d = static_cast<char*>(dst) +
              static_cast<std::size_t>(rb) * block * esz;
    for (std::int64_t i = 0; i < len; ++i)
      store_element(d, static_cast<std::size_t>(i), dtype_,
                    load_element(d, static_cast<std::size_t>(i), dtype_) +
                        load_element(f.payload.data(),
                                     static_cast<std::size_t>(i), dtype_));
  }
  for (int step = 0; step < n - 1; ++step) {  // allgather phase
    std::int64_t sb = ((grank_ + 1 - step) % n + n) % n;
    std::int64_t rb = ((grank_ - step) % n + n) % n;
    send_block(sb, base + static_cast<std::uint32_t>(n - 1 + step));
    if (step == n - 2) tcp::test_delay_final_recv();
    auto f = recv_block(base + static_cast<std::uint32_t>(n - 1 + step));
    std::int64_t len = blen(rb);
    if (f.payload.size() != static_cast<std::size_t>(len) * esz)
      throw std::runtime_error("tcp ring allreduce: block size mismatch");
    if (len == 0) continue;  // zero tail block: no valid rb offset exists
    std::memcpy(static_cast<char*>(dst) +
                    static_cast<std::size_t>(rb) * block * esz,
                f.payload.data(), static_cast<std::size_t>(len) * esz);
  }
}

}  // namespace dlnb
