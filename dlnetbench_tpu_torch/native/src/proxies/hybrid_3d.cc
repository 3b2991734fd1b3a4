// Native DP+PP+TP proxy — reference cpp/hybrid_parallel/hybrid_3d.cpp.
// Adds Megatron-style tensor parallelism to the GPipe engine: two TP
// allreduces per microbatch per direction (column+row parallel linear,
// hybrid_3d.cpp:142-148, 177-183), per-microbatch compute divided by tp.
#include "pipeline_engine.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("hybrid_3d — DP + PP + tensor-parallel proxy (native shm)");
  add_common_args(args);
  args.required_int("num_stages", "pipeline stages")
      .required_int("num_microbatches", "microbatches per iteration")
      .required_int("tp", "tensor-parallel degree")
      .optional_int("dp", 0, "data-parallel degree (0 = infer from world)");
  add_schedule_arg(args);
  args.parse(argc, argv);

  try {
    ProxyEnv env = make_env(args);
    // no step-boundary fault driver here: refuse plans whose
    // events could only fire at step boundaries, so a record
    // never stamps fault provenance onto an actually-clean run
    // (collective-scoped and drop plans still apply via the
    // fabric hooks; fault_session.hpp)
    fault::require_collective_scope_only("hybrid_3d");
    ModelCard card = load_card_for(env);
    i64 stages = args.integer("num_stages");
    i64 mbs = args.integer("num_microbatches");
    i64 tp = args.integer("tp");
    i64 dp = infer_dp(env.world, stages * tp, args.integer("dp"),
                      "num_stages*tp");

    HybridSpec spec;
    spec.pipe = pipeline_schedule(env.stats, card, stages, mbs, dp, tp);
    set_schedule(spec, args);

    Json meta = Json::object();
    meta["proxy"] = "hybrid_3d";
    hybrid_meta(meta, spec, env.dtype, env.cfg.size_scale, env.procs);

    return run_proxy_main(
        "hybrid_3d", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          return hybrid_rank_body(spec, env, r, fab, ts, run);
        });
  } catch (const std::exception& e) {
    std::cerr << "hybrid_3d: " << e.what() << "\n";
    return 1;
  }
}
