// Per-rank fault session: the degradation-policy harness around a
// proxy's step (fault_plan.hpp has the plan/injection layer; this file
// is the part that needs the Fabric).
//
// Usage (see src/proxies/dp.cc):
//
//   fault::Session fses(fab, rank);              // pre-splits survivors
//   run = run_measured(cfg, *comm, ts, [&](TimerSet& t) {
//     fses.step(t, *comm, [&](ProxyCommunicator& c) { ...schedule...(c) });
//   });
//
// Behavior per policy when the plan scripts a crash:
//   * The victim rank throws RankFailure at its trigger iteration,
//     AFTER marking the fabric (shm: abort the victim's groups so
//     blocked survivors throw; tcp: suppress the Bye so the EOF
//     reads as a death).  The throw propagates — a crashed rank emits
//     nothing, exactly like a real death.
//   * fail_fast (default): survivors' next collective on a group
//     containing the victim throws (the existing detection paths,
//     provoked deterministically for the first time) and the run dies.
//   * shrink: the constructor pre-split a survivor communicator while
//     everyone was alive (the plan is deterministic — every rank knows
//     the victims up front, so no runtime agreement protocol is
//     needed).  A survivor catches the failed step, rolls its timers
//     back to the pre-attempt snapshot, stamps detection wall time
//     (step start -> failure surfaced), re-runs the step on the
//     survivor group, stamps recovery wall time, and continues the
//     remaining iterations degraded.  The failed attempt's cost stays
//     visible: that iteration's recorded runtime includes detection +
//     recovery + the re-run.
//
// Delay/jitter sleeps and the step-boundary crash trigger ride
// Plan::on_step_begin; drop/partition events live in the transport
// hooks and need nothing from this layer.
#pragma once

#include <algorithm>
#include <memory>
#include <vector>

#include "dlnb/fabric.hpp"
#include "dlnb/fault_plan.hpp"
#include "dlnb/timers.hpp"

namespace dlnb {
namespace fault {

// Step-boundary injection WITHOUT the shrink machinery: delay/jitter
// sleeps + the crash trigger, with the fabric marked before a scripted
// death propagates (so survivors fail fast instead of hanging).  For
// proxies whose communicator grid cannot shrink (fsdp's
// sharding_factor x replicas, the pipelines) — they support
// fail_fast/retry plans and must REFUSE a crash+shrink plan loudly
// (guard below) rather than half-apply it.
inline void step_guard(Fabric& fab, int rank) {
  auto& plan = Plan::instance();
  if (!plan.active()) return;
  try {
    plan.on_step_begin(rank);
  } catch (const RankFailure&) {
    fab.mark_rank_dead(rank);
    throw;
  }
}

inline void require_no_shrink(const char* proxy) {
  auto& plan = Plan::instance();
  if (plan.active() && plan.policy() == "shrink" &&
      (!plan.crash_victims().empty() || plan.has_preempt()))
    throw std::runtime_error(
        std::string(proxy) +
        ": the shrink policy (and the preempt/rejoin elastic arc) "
        "needs a survivor regrouping this proxy's communicator grid "
        "does not support — use the dp proxy (or the python tier's "
        "rebuild path), or policy fail_fast/retry");
}

// For proxies with NO step-boundary fault driver at all: refuse plans
// whose events could only fire at step boundaries.  Without this, the
// record would stamp the plan (run_proxy_main describes it for every
// proxy) while the faults silently never fired — and the analysis
// layer would refuse busbw on runs that were actually clean.
inline void require_collective_scope_only(const char* proxy) {
  auto& plan = Plan::instance();
  if (plan.active() && plan.has_step_events())
    throw std::runtime_error(
        std::string(proxy) +
        ": this proxy has no step-boundary fault driver — only "
        "collective-scoped delay/jitter (where == \"collective\") and "
        "drop events apply here; step-scoped delay/jitter, crash and "
        "partition plans are wired for dp (full policies) and fsdp "
        "(injection + fail-fast)");
}

class Session {
 public:
  Session(Fabric& fab, int world_rank)
      : fab_(fab), rank_(world_rank), plan_(Plan::instance()) {
    if (!plan_.active()) return;
    auto victims = plan_.crash_victims();
    victim_ = std::find(victims.begin(), victims.end(), rank_) !=
              victims.end();
    auto evictees = plan_.preempt_victims();
    evictee_ = std::find(evictees.begin(), evictees.end(), rank_) !=
               evictees.end();
    if (plan_.policy() == "shrink" &&
        (!victims.empty() || !evictees.empty())) {
      // collective split while everyone is still alive: survivors get
      // color 0 — a new comm id everywhere, so stale frames of a
      // failed world-comm step can never match the survivor group's
      // traffic.  Crash victims share color 1 (their group is never
      // used — they die); each PREEMPT victim gets its own singleton
      // group (color 2 + rank): an evicted rank keeps replaying its
      // schedule locally while drained (staying hot to rejoin
      // quickly), so its timer arrays keep one sample per iteration —
      // the record shape every parser validates — while it moves no
      // fabric bytes.  The faulted-window busbw refusal keeps those
      // local samples out of every bandwidth figure.
      int color = 0;
      if (victim_) color = 1;
      if (evictee_) color = 2 + rank_;
      surv_ = fab.split(world_rank, color, "fault_survivors");
    }
    if (plan_.policy() == "shrink" && plan_.rejoin_iteration() >= 0)
      // the grow half, pre-split like shrink's: every rank (including
      // the future evictee) takes color 0 on a FRESH comm id, so the
      // returning rank is accepted deterministically — no runtime
      // agreement protocol, the plan already told everyone
      rejoin_ = fab.split(world_rank, 0, "fault_rejoin");
  }

  template <typename Body>
  void step(TimerSet& t, ProxyCommunicator& world, Body&& body) {
    if (!plan_.active()) {
      body(world);
      return;
    }
    try {
      plan_.on_step_begin(rank_);
    } catch (const RankFailure&) {
      fab_.mark_rank_dead(rank_);
      throw;
    }
    long long it = plan_.iteration_of(rank_) - 1;  // the step running now
    // ---- elastic eviction window (preempt -> rejoin) ----
    evicted_now_ = plan_.evicted(rank_, it);
    long long rejoin_at = plan_.rejoin_iteration();
    if (rejoin_ && rejoin_at >= 0 && it >= rejoin_at) {
      // grow back: everyone — the returning evictee included — runs on
      // the pre-split full-world comm from the rejoin trigger on.  The
      // first step's wall time is the measured grow cost (the
      // rendezvous waits for the returning rank) and degraded_world is
      // cleared by the emitter (proxy_runner.hpp).
      evicted_now_ = false;
      if (!rejoined_) {
        auto r0 = Clock::now();
        body(*rejoin_);
        auto& rep = plan_.report(rank_);
        rep.rejoin_us.store(us_since(r0));
        rep.rejoined.store(true);
        rejoined_ = true;
        return;
      }
      body(*rejoin_);
      return;
    }
    if (evicted_now_ && surv_) {
      // the drained victim: local singleton replay (see ctor comment)
      body(*surv_);
      return;
    }
    ProxyCommunicator& c =
        ((shrunk_ || (plan_.any_evicted(it) && !evictee_)) && surv_)
            ? *surv_ : world;
    auto snapshot = t.sizes();
    auto t0 = Clock::now();
    try {
      body(c);
    } catch (const RankFailure&) {
      throw;  // scripted deaths never degrade into a shrink
    } catch (const std::exception&) {
      if (victim_ || shrunk_ || !surv_ || plan_.policy() != "shrink")
        throw;
      double detection = us_since(t0);
      t.truncate(snapshot);  // drop the failed attempt's partial timers
      shrunk_ = true;
      auto r0 = Clock::now();
      body(*surv_);
      auto& rep = plan_.report(rank_);
      rep.detection_us.store(detection);
      rep.recovery_us.store(us_since(r0));
      rep.shrunk.store(true);
    }
  }

  bool shrunk() const { return shrunk_; }
  bool victim() const { return victim_; }
  // elastic-eviction state as of the LAST step() call — the selftest's
  // expected-sum oracle
  bool evicted_now() const { return evicted_now_; }
  bool rejoined() const { return rejoined_; }
  // degraded membership while any rank is drained (survivor view)
  bool degraded_now() const {
    return !rejoined_ && !evicted_now_ &&
           plan_.any_evicted(plan_.iteration_of(rank_) - 1);
  }

 private:
  Fabric& fab_;
  int rank_;
  Plan& plan_;
  bool victim_ = false;    // scripted crash victim
  bool evictee_ = false;   // scripted preempt victim
  bool shrunk_ = false;
  bool evicted_now_ = false;
  bool rejoined_ = false;
  std::unique_ptr<ProxyCommunicator> surv_;
  std::unique_ptr<ProxyCommunicator> rejoin_;
};

}  // namespace fault
}  // namespace dlnb
