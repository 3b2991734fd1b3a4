// Native DP+PP proxy (GPipe) — reference cpp/hybrid_parallel/hybrid_2d.cpp.
#include "pipeline_engine.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("hybrid_2d — DP + GPipe pipeline proxy (native tier)");
  add_common_args(args);
  args.required_int("num_stages", "pipeline stages")
      .required_int("num_microbatches", "microbatches per iteration")
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
    fault::require_collective_scope_only("hybrid_2d");
    ModelCard card = load_card_for(env);
    i64 stages = args.integer("num_stages");
    i64 mbs = args.integer("num_microbatches");
    i64 dp = infer_dp(env.world, stages, args.integer("dp"), "num_stages");

    HybridSpec spec;
    spec.pipe = pipeline_schedule(env.stats, card, stages, mbs, dp, 1);
    set_schedule(spec, args);

    Json meta = Json::object();
    meta["proxy"] = "hybrid_2d";
    hybrid_meta(meta, spec, env.dtype, env.cfg.size_scale, env.procs);

    return run_proxy_main(
        "hybrid_2d", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          return hybrid_rank_body(spec, env, r, fab, ts, run);
        });
  } catch (const std::exception& e) {
    std::cerr << "hybrid_2d: " << e.what() << "\n";
    return 1;
  }
}
