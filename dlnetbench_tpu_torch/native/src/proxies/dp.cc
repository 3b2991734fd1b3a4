// Native DP proxy: bucketed data-parallel gradient sync.
//
// Schedule (reference cpp/data_parallel/dp.cpp:87-106): per iteration,
// simulated forward compute, then per bucket simulated backward compute
// followed by an async Iallreduce on that bucket's slot — overlapping
// communication with the remaining backward — and a final WaitAll timed
// as "barrier_time": the communication NOT hidden by compute, the
// benchmark's core signal (dp.cpp:191).
#include "proxy_runner.hpp"

#include "dlnb/schedule.hpp"
#include "dlnb/tensor.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args(
      "dp — bucketed data-parallel allreduce proxy (native tier)");
  add_common_args(args);
  args.required_int("num_buckets", "gradient buckets per iteration");
  args.parse(argc, argv);

  try {
    ProxyEnv env = make_env(args);
    auto num_buckets = args.integer("num_buckets");
    DPSchedule sched = dp_schedule(env.stats, num_buckets);

    Json meta = Json::object();
    meta["proxy"] = "dp";
    meta["num_buckets"] = num_buckets;
    {
      Json bb = Json::array();
      for (i64 b : sched.bucket_bytes()) bb.push_back(b);
      meta["schedule_bucket_bytes"] = bb;
      Json sb = Json::array();
      for (i64 s : sched.bucket_sizes)
        sb.push_back(static_cast<i64>(scale_count(s, env.cfg.size_scale) *
                                      dtype_bytes(env.dtype)));
      meta["bucket_bytes"] = sb;
    }
    meta["fwd_us"] = sched.fwd_us * env.cfg.time_scale;
    meta["bwd_us_per_bucket"] = sched.bwd_us_per_bucket * env.cfg.time_scale;

    return run_proxy_main(
        "dp", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          auto comm = fab.world_comm(r);
          // fault harness (no-op without --fault): step-boundary
          // delay/jitter/crash injection + the shrink policy's
          // pre-split survivor group (fault_session.hpp)
          fault::Session fses(fab, r);
          // every rank holds full buckets (allreduce semantics,
          // dp.cpp:227-232); grads zero-init like the reference Tensor
          std::vector<Tensor> grads, sums;
          std::vector<i64> counts;
          for (i64 s : sched.bucket_sizes) {
            i64 c = scale_count(s, env.cfg.size_scale);
            counts.push_back(c);
            grads.emplace_back(c, env.dtype);
            sums.emplace_back(c, env.dtype);
          }

          // device-backed fabrics burn real device cycles, others sleep
          auto burn = [&](double us) { fab.burn(r, us, env.cfg.time_scale); };
          run = run_measured(env.cfg, *comm, ts, [&](TimerSet& t) {
            fses.step(t, *comm, [&](ProxyCommunicator& c) {
              burn(sched.fwd_us);
              for (i64 b = 0; b < sched.num_buckets; ++b) {
                burn(sched.bwd_us_per_bucket);
                c.Iallreduce(grads[b].data(), sums[b].data(), counts[b],
                             static_cast<int>(b));
              }
              auto sc = t.scoped("barrier_time");
              c.WaitAll(static_cast<int>(sched.num_buckets));
            });
          });
          return Json::object();
        });
  } catch (const std::exception& e) {
    std::cerr << "dp: " << e.what() << "\n";
    return 1;
  }
}
