// fault_selftest — deterministic fault-plan correctness check across the
// shm (in-process threads) and tcp (one process per rank) fabrics.
//
// Runs --iters allreduce steps through a fault::Session and VERIFIES THE
// MATH at every step against the live membership: sum of (r+1) over the
// full world before a shrink, over the survivor group after.  Covers:
//
//   * delay/jitter — injected latency, run completes, sums exact,
//     injected_delay_us reported;
//   * drop + retry — every frame eventually delivered (backoff counted),
//     sums exact;
//   * drop + fail_fast — the first loss aborts (exit != 0);
//   * crash + fail_fast — the victim dies at its trigger and EVERY
//     survivor raises (not hangs): shm ranks via the group abort, tcp
//     ranks via the per-peer death tracking + suppressed Bye — the
//     controlled end-to-end proof of the PR-2 dying_/transitive path;
//   * crash + shrink — survivors regroup on the pre-split survivor comm,
//     finish all remaining iterations with exact survivor-group sums,
//     and report detection/recovery wall time (exit 0; the tcp victim
//     process still exits != 0 — it is dead).
//
//   fault_selftest --backend shm --world 4 --iters 6
//       --fault '{"events":[{"kind":"crash","ranks":[2],"iteration":3}]}'
//       --fault_policy shrink
#include <algorithm>
#include <cstdio>
#include <iostream>
#include <string>
#include <vector>

#include "dlnb/args.hpp"
#include "dlnb/fault_session.hpp"
#include "dlnb/shm_backend.hpp"
#include "dlnb/tcp_backend.hpp"
#include "dlnb/tensor.hpp"
#include "dlnb/timers.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("fault_selftest — fault-plan policies on the shm/tcp fabrics");
  args.required_int("world", "total rank count")
      .optional_str("backend", "shm", "shm (threads) | tcp (processes)")
      .optional_int("rank", 0, "tcp: this process's rank")
      .optional_str("coordinator", "127.0.0.1:0",
                    "tcp: rank 0's listen host:port")
      .optional_int("iters", 6, "allreduce steps to run")
      .optional_int("count", 64, "elements per allreduce")
      .optional_str("fault", "", "JSON fault plan (fault_plan.hpp schema)")
      .optional_str("fault_policy", "", "fail_fast | retry | shrink");
  args.parse(argc, argv);
  const int world = static_cast<int>(args.integer("world"));
  const int iters = static_cast<int>(args.integer("iters"));
  const std::int64_t count = args.integer("count");
  const std::string backend = args.str("backend");

  try {
    auto& plan = fault::Plan::instance();
    plan.load(args.str("fault"), args.str("fault_policy"), world);

    std::unique_ptr<Fabric> fab;
    if (backend == "tcp")
      fab = std::make_unique<TcpFabric>(args.str("coordinator"), world,
                                        static_cast<int>(args.integer("rank")),
                                        DType::F32);
    else
      fab = std::make_unique<ShmFabric>(world, DType::F32);

    std::vector<int> checks_ok(world, 0);
    std::vector<int> done(world, 0);

    auto body = [&](int r) {
      auto comm = fab->world_comm(r);
      fault::Session fses(*fab, r);
      TimerSet ts;
      Tensor src(count, DType::F32), dst(count, DType::F32);
      src.fill(static_cast<float>(r + 1));
      bool ok = true;
      for (int i = 0; i < iters; ++i) {
        fses.step(ts, *comm, [&](ProxyCommunicator& c) {
          c.Allreduce(src.data(), dst.data(), count);
          // expected sum over the LIVE membership of this step
          float expect = 0;
          if (fses.rejoined())
            expect = world * (world + 1) / 2.0f;  // full world again
          else if (fses.evicted_now())
            expect = static_cast<float>(r + 1);   // singleton replay
          else if (fses.shrunk())
            for (int s : plan.survivors()) expect += s + 1;
          else if (fses.degraded_now())
            for (int s : plan.elastic_survivors()) expect += s + 1;
          else
            expect = world * (world + 1) / 2.0f;
          if (dst.get(0) != expect ||
              dst.get(static_cast<std::size_t>(count - 1)) != expect)
            ok = false;
        });
        done[r] = i + 1;
      }
      checks_ok[r] = ok ? 1 : 0;
    };

    auto report = [&](int r) {
      auto& rep = plan.report(r);
      Json j = Json::object();
      j["rank"] = r;
      j["world"] = world;
      j["backend"] = backend;
      j["iters_done"] = done[r];
      j["checks"] = checks_ok[r] ? "OK" : "FAILED";
      if (plan.active()) {
        j["policy"] = plan.policy();
        j["shrunk"] = rep.shrunk.load();
        j["detection_us"] = rep.detection_us.load();
        j["recovery_us"] = rep.recovery_us.load();
        j["injected_delay_us"] = rep.injected_delay_us.load();
        j["drops"] = static_cast<std::int64_t>(plan.drops());
        j["retries"] = static_cast<std::int64_t>(plan.retries());
        j["rejoined"] = rep.rejoined.load();
        j["rejoin_us"] = rep.rejoin_us.load();
        Json dw = Json::array();
        // a rejoined run ended full-world: degraded_world is cleared
        for (int s : (rep.rejoined.load() ? plan.survivors()
                                          : plan.elastic_survivors()))
          dw.push_back(s);
        j["degraded_world"] = dw;
      }
      std::cout << j.dump() << std::endl;
    };

    bool victim_died = false;
    try {
      fab->launch(body);
    } catch (const fault::RankFailure& e) {
      // the scripted victim's death: under shrink the surviving rank
      // threads (shm) finished degraded — report them and exit by
      // their checks; any other policy is a real (provoked) crash
      if (plan.policy() != "shrink") throw;
      auto surv = plan.survivors();
      bool any = false;
      for (int r : fab->local_ranks())
        if (std::find(surv.begin(), surv.end(), r) != surv.end()) any = true;
      if (!any) throw;  // tcp victim process: dead is dead
      (void)e;
      victim_died = true;
    }

    auto surv = plan.active() ? plan.survivors() : std::vector<int>();
    bool all_ok = true;
    for (int r : fab->local_ranks()) {
      bool is_victim =
          victim_died &&
          std::find(surv.begin(), surv.end(), r) == surv.end();
      if (is_victim) continue;  // died on schedule; no report row
      report(r);
      if (!checks_ok[r] || done[r] != iters) all_ok = false;
    }
    if (!all_ok) {
      std::cerr << "fault_selftest: checks failed\n";
      return 1;
    }
    if (backend == "tcp")
      std::printf("fault_selftest rank %lld OK\n", args.integer("rank"));
    else
      std::printf("fault_selftest all ranks OK\n");
    return 0;
  } catch (const std::exception& e) {
    std::cerr << "fault_selftest: " << e.what() << "\n";
    return 1;
  }
}
