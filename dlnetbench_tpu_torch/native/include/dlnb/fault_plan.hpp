// Deterministic fault plans — provoking the failures the detection layer
// can only observe.
//
// The fabrics already DETECT failure (tcp_backend.hpp per-peer death
// tracking + transitive ring fail-fast, the `dying_` Bye suppression,
// SURVEY §5.3's missing watchdog rebuilt in utils/watchdog.py) — but
// until now nothing could *provoke* one on purpose, survive it, or price
// it.  A FaultPlan is a JSON-serializable schedule of fault events
// (shared schema with the Python tier's dlnetbench_tpu_torch/faults/plan.py):
//
//   {"policy": "fail_fast" | "retry" | "shrink",
//    "events": [{"kind": "delay|jitter|drop|crash|partition|preempt|rejoin",
//                "ranks": [..], "iteration": K, "until": -1,
//                "magnitude_us": 20000, "rate": 0.05, "seed": 7,
//                "where": "step" | "collective",
//                "group": [..]  // partition: the ranks on THIS side
//               }, ...]}
//
// Elastic eviction (policy `shrink` required, like the python tier):
//   preempt — a scripted GRACEFUL drain: the victim sleeps its
//             magnitude_us grace window at the trigger, then idles out
//             of the run (no Bye-less death — the departure is
//             plan-known to every rank, so survivors pre-split their
//             degraded communicator like shrink does).
//   rejoin  — the evicted ranks return at `iteration`: fault::Session
//             re-splits everyone onto a pre-built FULL-world
//             communicator with a fresh comm id (the grow half of
//             shrink) and the record clears degraded_world.
//
// Injection points (all driven through the process-global Plan
// singleton, loaded from --fault / DLNB_FAULT_PLAN):
//   * on_step_begin(rank)    — harness step boundary: delay/jitter
//                              sleeps on target ranks inside the
//                              [iteration, until) window; crash targets
//                              throw RankFailure at their trigger.
//   * on_collective(rank)    — per-collective injected latency
//                              (events with where == "collective"),
//                              called by ShmCommunicator /
//                              NcclCommunicator at collective entry.
//   * on_send(rank, dst)     — TCP frame-drop injection at the sender:
//                              a dropped transmission is retried with
//                              exponential backoff under policy
//                              "retry" (counts stamped into the
//                              record), or aborts the run under
//                              "fail_fast".  Also enforces partitions:
//                              sends across the partition boundary fail
//                              once the event triggers.
//
// Degradation policy on a detected rank death:
//   fail_fast — today's behavior: every survivor raises (the
//               transitive fail-fast path, now provokable on demand).
//   retry     — applies to drop events (bounded re-send with backoff);
//               a dead rank still fails fast.
//   shrink    — survivors regroup WITHOUT the dead rank(s) mid-run:
//               fault::Session pre-splits a survivor communicator
//               (a normal collective split while everyone is alive —
//               the plan is deterministic, so every rank knows who
//               dies), detects the death through the fabric's own
//               failure path, stamps detection/recovery wall time, and
//               re-runs the failed step on the survivor group.  The
//               record carries degraded_world; metrics.merge accepts
//               the shrunken rank set through its degraded pathway.
//
// Determinism: per-rank iteration counters + a splitmix64 RNG seeded
// from (seed, rank), so a plan replays identically across runs and
// across the two tiers' studies.
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "dlnb/json.hpp"

namespace dlnb {
namespace fault {

// A plan-triggered rank death.  Distinct from generic runtime errors so
// the policy layer can tell "this rank is the scripted victim" from
// "a collective failed under me" (the survivor-side signal).
struct RankFailure : std::runtime_error {
  RankFailure(int rank, long long iteration)
      : std::runtime_error("rank " + std::to_string(rank) +
                           " crashed by fault plan (iteration " +
                           std::to_string(iteration) + ")"),
        rank(rank),
        iteration(iteration) {}
  int rank;
  long long iteration;
};

enum class Kind { Delay, Jitter, Drop, Crash, Partition, Preempt, Rejoin };

inline const char* kind_name(Kind k) {
  switch (k) {
    case Kind::Delay: return "delay";
    case Kind::Jitter: return "jitter";
    case Kind::Drop: return "drop";
    case Kind::Crash: return "crash";
    case Kind::Partition: return "partition";
    case Kind::Preempt: return "preempt";
    case Kind::Rejoin: return "rejoin";
  }
  return "?";
}

inline Kind kind_from_name(const std::string& s) {
  if (s == "delay") return Kind::Delay;
  if (s == "jitter") return Kind::Jitter;
  if (s == "drop") return Kind::Drop;
  if (s == "crash") return Kind::Crash;
  if (s == "partition") return Kind::Partition;
  if (s == "preempt") return Kind::Preempt;
  if (s == "rejoin") return Kind::Rejoin;
  throw std::runtime_error("fault plan: unknown kind '" + s + "'");
}

struct Event {
  Kind kind = Kind::Delay;
  std::vector<int> ranks;      // target ranks (crash victims, stragglers,
                               // lossy senders); empty = every rank
  long long iteration = 0;     // first step index the event is live at
  long long until = -1;        // first step index it stops (-1 = never)
  double magnitude_us = 0.0;   // delay/jitter sleep; drop backoff base
  double rate = 0.0;           // drop probability per send
  std::uint64_t seed = 0;      // jitter/drop determinism
  std::string where = "step";  // "step" | "collective" (delay/jitter)
  std::vector<int> group;      // partition: ranks on the target's side

  bool targets(int rank) const {
    return ranks.empty() ||
           std::find(ranks.begin(), ranks.end(), rank) != ranks.end();
  }
  bool live_at(long long iter) const {
    return iter >= iteration && (until < 0 || iter < until);
  }
};

// splitmix64 — deterministic, seedable, no global state.
inline std::uint64_t splitmix64(std::uint64_t& s) {
  std::uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Per-rank fault outcome, written by fault::Session (shrink path) and
// the drop injector; read by proxy_runner when assembling the record.
struct Report {
  std::atomic<long long> steps{0};
  std::atomic<double> detection_us{0.0};
  std::atomic<double> recovery_us{0.0};
  std::atomic<bool> shrunk{false};
  std::atomic<double> injected_delay_us{0.0};
  // elastic grow (preempt -> rejoin): did this rank reach the
  // full-world re-split, and what did its first rejoined step cost
  // (the grow-side recovery — waiting for the returning rank to
  // rendezvous on the fresh comm)?
  std::atomic<bool> rejoined{false};
  std::atomic<double> rejoin_us{0.0};
};

class Plan {
 public:
  static Plan& instance() {
    static Plan p;
    return p;
  }

  // Parse and install a plan for `world` ranks.  Empty text clears it.
  void load(const std::string& text, const std::string& policy, int world) {
    std::lock_guard<std::mutex> lk(m_);
    events_.clear();
    policy_ = policy.empty() ? "fail_fast" : policy;
    world_ = world;
    iters_ = std::vector<std::atomic<long long>>(world < 1 ? 1 : world);
    for (auto& it : iters_) it.store(0);
    reports_ = std::vector<Report>(world < 1 ? 1 : world);
    drops_.store(0);
    retries_.store(0);
    active_ = false;
    if (text.empty()) return;
    Json j = Json::parse(text);
    if (j.contains("policy") && policy.empty())
      policy_ = j.at("policy").as_string();
    if (!j.contains("events"))
      throw std::runtime_error("fault plan: missing 'events'");
    for (const auto& e : j.at("events").items()) {
      Event ev;
      ev.kind = kind_from_name(e.at("kind").as_string());
      if (e.contains("ranks"))
        for (const auto& r : e.at("ranks").items())
          ev.ranks.push_back(static_cast<int>(r.as_int()));
      if (e.contains("iteration")) ev.iteration = e.at("iteration").as_int();
      if (e.contains("until")) ev.until = e.at("until").as_int();
      if (e.contains("magnitude_us"))
        ev.magnitude_us = e.at("magnitude_us").as_double();
      if (e.contains("rate")) ev.rate = e.at("rate").as_double();
      if (e.contains("seed"))
        ev.seed = static_cast<std::uint64_t>(e.at("seed").as_int());
      if (e.contains("where")) ev.where = e.at("where").as_string();
      if (e.contains("group"))
        for (const auto& r : e.at("group").items())
          ev.group.push_back(static_cast<int>(r.as_int()));
      if (ev.kind == Kind::Drop && !(ev.rate > 0.0 && ev.rate < 1.0))
        throw std::runtime_error(
            "fault plan: drop rate must be in (0, 1) — rate 1 never "
            "delivers and would hang any policy");
      if (ev.kind == Kind::Partition && ev.group.empty())
        throw std::runtime_error(
            "fault plan: partition needs 'group' (the ranks on one side)");
      if (ev.kind == Kind::Preempt && ev.ranks.empty())
        throw std::runtime_error(
            "fault plan: preempt needs explicit 'ranks' (the evicted "
            "ranks must be plan-known on every tier)");
      events_.push_back(std::move(ev));
    }
    if (policy_ != "fail_fast" && policy_ != "retry" && policy_ != "shrink")
      throw std::runtime_error("fault plan: unknown policy '" + policy_ +
                               "' (fail_fast | retry | shrink)");
    {
      bool has_pre = false, has_rej = false;
      for (const auto& e : events_) {
        has_pre = has_pre || e.kind == Kind::Preempt;
        has_rej = has_rej || e.kind == Kind::Rejoin;
      }
      if ((has_pre || has_rej) && policy_ != "shrink")
        throw std::runtime_error(
            "fault plan: preempt/rejoin model elastic eviction and "
            "recovery — they need policy 'shrink' (an eviction under "
            "fail_fast is just a crash; script that instead)");
      if (has_rej && !has_pre)
        throw std::runtime_error(
            "fault plan: rejoin without a preempt — nobody left to "
            "return");
      for (const auto& r : events_) {
        if (r.kind != Kind::Rejoin) continue;
        for (const auto& p : events_) {
          if (p.kind != Kind::Preempt) continue;
          bool related = r.ranks.empty();
          for (int rr : r.ranks)
            for (int pp : p.ranks) related = related || rr == pp;
          if (related && r.iteration <= p.iteration)
            throw std::runtime_error(
                "fault plan: rejoin at iteration " +
                std::to_string(r.iteration) +
                " does not follow its preempt at " +
                std::to_string(p.iteration));
        }
      }
    }
    raw_ = j;
    active_ = !events_.empty();
  }

  bool active() const { return active_; }
  const std::string& policy() const { return policy_; }
  const Json& raw() const { return raw_; }
  std::uint64_t drops() const { return drops_.load(); }
  std::uint64_t retries() const { return retries_.load(); }
  Report& report(int rank) { return reports_.at(clamp_rank(rank)); }

  // Does the plan carry events that need a STEP-boundary driver
  // (fault::Session / fault::step_guard)?  Collective-scoped
  // delay/jitter and drop events ride the fabric hooks and apply to
  // every proxy; step-scoped events only fire where a proxy wired the
  // step hook — a proxy that did not must refuse such a plan instead
  // of stamping fault provenance onto an actually-clean run.
  bool has_step_events() const {
    for (const auto& e : events_) {
      if (e.kind == Kind::Crash || e.kind == Kind::Partition ||
          e.kind == Kind::Preempt || e.kind == Kind::Rejoin)
        return true;
      if ((e.kind == Kind::Delay || e.kind == Kind::Jitter) &&
          e.where == "step")
        return true;
    }
    return false;
  }

  // Ranks that a crash event will remove (the survivor split's color
  // key) — deterministic, known to every rank up front.
  std::vector<int> crash_victims() const {
    std::vector<int> out;
    for (const auto& e : events_)
      if (e.kind == Kind::Crash)
        for (int r : e.ranks)
          if (std::find(out.begin(), out.end(), r) == out.end())
            out.push_back(r);
    std::sort(out.begin(), out.end());
    return out;
  }

  std::vector<int> survivors() const {
    auto dead = crash_victims();
    std::vector<int> out;
    for (int r = 0; r < world_; ++r)
      if (std::find(dead.begin(), dead.end(), r) == dead.end())
        out.push_back(r);
    return out;
  }

  // ---- elastic eviction (preempt/rejoin) queries -------------------
  std::vector<int> preempt_victims() const {
    std::vector<int> out;
    for (const auto& e : events_)
      if (e.kind == Kind::Preempt)
        for (int r : e.ranks)
          if (std::find(out.begin(), out.end(), r) == out.end())
            out.push_back(r);
    std::sort(out.begin(), out.end());
    return out;
  }

  bool has_preempt() const { return !preempt_victims().empty(); }

  // first step index at which evicted ranks return (-1: never grows)
  long long rejoin_iteration() const {
    long long at = -1;
    for (const auto& e : events_)
      if (e.kind == Kind::Rejoin && (at < 0 || e.iteration < at))
        at = e.iteration;
    return at;
  }

  // Is `rank` out of the run at `iter` — inside a preempt window no
  // rejoin (or `until`) has closed yet?  Mirrors faults/plan.py.
  bool evicted(int rank, long long iter) const {
    for (const auto& e : events_) {
      if (e.kind != Kind::Preempt ||
          std::find(e.ranks.begin(), e.ranks.end(), rank) == e.ranks.end())
        continue;
      long long end = e.until;
      for (const auto& r : events_) {
        if (r.kind != Kind::Rejoin || r.iteration <= e.iteration) continue;
        if (!r.targets(rank)) continue;
        end = end < 0 ? r.iteration : std::min(end, r.iteration);
      }
      if (iter >= e.iteration && (end < 0 || iter < end)) return true;
    }
    return false;
  }

  bool any_evicted(long long iter) const {
    for (int r : preempt_victims())
      if (evicted(r, iter)) return true;
    return false;
  }

  // Survivor set of the elastic eviction window (crash victims are
  // gone forever, preempt victims only inside their window).
  std::vector<int> elastic_survivors() const {
    auto pre = preempt_victims();
    std::vector<int> out;
    for (int r : survivors())
      if (std::find(pre.begin(), pre.end(), r) == pre.end())
        out.push_back(r);
    return out;
  }

  // ---- step boundary: delay/jitter sleeps, crash throw -------------
  // Returns the injected sleep in microseconds (already slept).
  double on_step_begin(int rank) {
    if (!active_) return 0.0;
    long long iter = iters_.at(clamp_rank(rank)).fetch_add(1);
    report(rank).steps.store(iter + 1);
    double slept = 0.0;
    for (const auto& e : events_) {
      if (!e.targets(rank) || !e.live_at(iter)) continue;
      switch (e.kind) {
        case Kind::Delay:
          if (e.where == "step") slept += sleep_us(e.magnitude_us);
          break;
        case Kind::Jitter:
          if (e.where == "step")
            slept += sleep_us(jitter_draw(e, rank, iter));
          break;
        case Kind::Crash:
          if (iter == e.iteration) throw RankFailure(rank, iter);
          break;
        case Kind::Preempt:
          // the scripted graceful drain: the victim spends its grace
          // window at the eviction trigger (the SIGTERM-notice cost),
          // then fault::Session idles it out — no throw, no Bye-less
          // death; the departure is announced
          if (iter == e.iteration) slept += sleep_us(e.magnitude_us);
          break;
        case Kind::Drop:
        case Kind::Partition:
        case Kind::Rejoin:
          break;  // transport-layer / Session-driven events
      }
    }
    if (slept > 0) add_delay(rank, slept);
    return slept;
  }

  long long iteration_of(int rank) const {
    if (!active_) return 0;
    return iters_.at(clamp_rank(rank)).load();
  }

  // ---- collective entry: per-collective injected latency -----------
  void on_collective(int rank) {
    if (!active_) return;
    long long iter = iters_.at(clamp_rank(rank)).load();
    double slept = 0.0;
    for (const auto& e : events_) {
      if (e.where != "collective" || !e.targets(rank) || !e.live_at(iter))
        continue;
      if (e.kind == Kind::Delay)
        slept += sleep_us(e.magnitude_us);
      else if (e.kind == Kind::Jitter)
        slept += sleep_us(jitter_draw(e, rank, iter));
    }
    if (slept > 0) add_delay(rank, slept);
  }

  // ---- TCP sender: frame drop + backoff, partition enforcement -----
  // Called before each physical frame transmission.  A "dropped" send
  // never actually skips the write (that would desync the framing
  // protocol); it models the LOSS + RETRANSMIT cost: under `retry` the
  // sender backs off exponentially per consecutive loss and then
  // transmits (drops/retries counted into the record), under
  // `fail_fast` the first loss aborts the run.  Partition events make
  // sends across the boundary fail outright once triggered.
  void on_send(int rank, int dst) {
    if (!active_) return;
    long long iter = iters_.at(clamp_rank(rank)).load();
    for (const auto& e : events_) {
      if (!e.live_at(iter)) continue;
      if (e.kind == Kind::Partition) {
        bool src_in = std::find(e.group.begin(), e.group.end(), rank) !=
                      e.group.end();
        bool dst_in = std::find(e.group.begin(), e.group.end(), dst) !=
                      e.group.end();
        if (src_in != dst_in)
          throw std::runtime_error(
              "tcp: send failed (peer gone?) — fault plan partitioned "
              "rank " + std::to_string(rank) + " from rank " +
              std::to_string(dst));
      }
      if (e.kind != Kind::Drop || !e.targets(rank)) continue;
      int losses = 0;
      std::uint64_t s = e.seed ^ (0x517cc1b727220a95ULL *
                                  static_cast<std::uint64_t>(rank + 1)) ^
                        send_draws_.fetch_add(1);
      while (uniform(s) < e.rate) {
        ++losses;
        drops_.fetch_add(1);
        if (policy_ == "fail_fast")
          throw std::runtime_error(
              "injected frame drop (fault plan, policy fail_fast): rank " +
              std::to_string(rank) + " -> " + std::to_string(dst));
        retries_.fetch_add(1);
        // exponential backoff: base * 2^(losses-1), capped
        double backoff = e.magnitude_us > 0 ? e.magnitude_us : 100.0;
        double us = std::min(backoff * static_cast<double>(1ULL << std::min(
                                 losses - 1, 10)),
                             50'000.0);
        add_delay(rank, sleep_us(us));
      }
    }
  }

  // Is `rank` partitioned from `dst` at its current iteration?  (Used
  // by receive-side checks wanting symmetric failure.)
  bool partitioned(int rank, int dst) const {
    if (!active_) return false;
    long long iter = iters_.at(clamp_rank(rank)).load();
    for (const auto& e : events_) {
      if (e.kind != Kind::Partition || !e.live_at(iter)) continue;
      bool a = std::find(e.group.begin(), e.group.end(), rank) !=
               e.group.end();
      bool b = std::find(e.group.begin(), e.group.end(), dst) !=
               e.group.end();
      if (a != b) return true;
    }
    return false;
  }

  // Record stamps (proxy_runner): the plan itself plus run-wide
  // counters; per-rank detection/recovery ride the Report slots.
  void describe(Json& meta) const {
    if (!active_) return;
    meta["fault_plan"] = raw_;
    meta["fault_policy"] = policy_;
    meta["fault_drops"] = static_cast<std::int64_t>(drops_.load());
    meta["fault_retries"] = static_cast<std::int64_t>(retries_.load());
  }

 private:
  Plan() {
    // env fallback so layered launchers (pod_study's multi-process points) can
    // inject without threading a flag through every argv
    if (const char* e = std::getenv("DLNB_FAULT_PLAN"); e && *e) {
      const char* p = std::getenv("DLNB_FAULT_POLICY");
      const char* w = std::getenv("DLNB_FAULT_WORLD");
      load(e, p ? p : "", w ? std::atoi(w) : 1);
    }
  }

  std::size_t clamp_rank(int rank) const {
    if (rank < 0) return 0;
    std::size_t r = static_cast<std::size_t>(rank);
    return r < iters_.size() ? r : iters_.size() - 1;
  }

  static double sleep_us(double us) {
    if (us <= 0) return 0.0;
    std::this_thread::sleep_for(std::chrono::duration<double, std::micro>(us));
    return us;
  }

  static double uniform(std::uint64_t& s) {
    return static_cast<double>(splitmix64(s) >> 11) /
           static_cast<double>(1ULL << 53);
  }

  double jitter_draw(const Event& e, int rank, long long iter) const {
    std::uint64_t s = e.seed ^ (0x9e3779b97f4a7c15ULL *
                                static_cast<std::uint64_t>(rank + 1)) ^
                      static_cast<std::uint64_t>(iter);
    return e.magnitude_us * uniform(s);
  }

  void add_delay(int rank, double us) {
    auto& slot = report(rank).injected_delay_us;
    double cur = slot.load();
    while (!slot.compare_exchange_weak(cur, cur + us)) {
    }
  }

  mutable std::mutex m_;
  std::vector<Event> events_;
  std::string policy_ = "fail_fast";
  int world_ = 1;
  // written once at startup (load, before the fabric launches rank
  // threads), read by every hook: atomic so a late loader can never
  // race the hot-path check
  std::atomic<bool> active_{false};
  Json raw_;
  // parenthesized copy-init (NOT braces: atomics have no copy ctor for
  // an initializer_list) — one slot until load() sizes them to world
  std::vector<std::atomic<long long>> iters_ =
      std::vector<std::atomic<long long>>(1);
  std::vector<Report> reports_ = std::vector<Report>(1);
  std::atomic<std::uint64_t> drops_{0};
  std::atomic<std::uint64_t> retries_{0};
  std::atomic<std::uint64_t> send_draws_{0};
};

}  // namespace fault
}  // namespace dlnb
