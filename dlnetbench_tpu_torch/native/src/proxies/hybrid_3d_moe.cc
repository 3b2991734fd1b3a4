// Native DP+PP+EP (MoE) proxy — reference
// cpp/hybrid_parallel/hybrid_3d_moe.cpp.  Adds expert parallelism to the
// GPipe engine: per microbatch, 2 x layers_per_stage token
// dispatch/combine all-to-alls per direction (hybrid_3d_moe.cpp:161-165)
// and a two-level gradient sync (non-expert params over EP, expert stage
// shard over DP, :202-208).  top_k comes from the model card, not a
// hardcoded 2 (reference quirk, :354-359).
#include "pipeline_engine.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("hybrid_3d_moe — DP + PP + expert-parallel proxy (native shm)");
  add_common_args(args);
  args.required_int("num_stages", "pipeline stages")
      .required_int("num_microbatches", "microbatches per iteration")
      .required_int("num_expert_shards", "expert-parallel degree")
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
    fault::require_collective_scope_only("hybrid_3d_moe");
    ModelCard card = load_card_for(env);
    if (card.num_experts <= 1)
      throw std::runtime_error(card.name +
                               " has no moe_params; the MoE proxy needs an "
                               "MoE architecture card");
    i64 stages = args.integer("num_stages");
    i64 mbs = args.integer("num_microbatches");
    i64 ep = args.integer("num_expert_shards");
    i64 dp = infer_dp(env.world, stages * ep, args.integer("dp"),
                      "num_stages*ep");

    MoESchedule moe = moe_schedule(env.stats, card, stages, mbs, ep, dp);
    HybridSpec spec;
    spec.pipe = moe.pipe;
    set_schedule(spec, args);
    spec.is_moe = true;
    spec.ep = ep;
    spec.a2a_elems = moe.a2a_elems;
    spec.a2a_per_direction = moe.a2a_per_direction;
    spec.nonexpert_sync = moe.nonexpert_sync_elems;
    spec.expert_sync = moe.expert_sync_elems;

    Json meta = Json::object();
    meta["proxy"] = "hybrid_3d_moe";
    meta["top_k"] = moe.top_k;
    hybrid_meta(meta, spec, env.dtype, env.cfg.size_scale, env.procs);

    return run_proxy_main(
        "hybrid_3d_moe", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          return hybrid_rank_body(spec, env, r, fab, ts, run);
        });
  } catch (const std::exception& e) {
    std::cerr << "hybrid_3d_moe: " << e.what() << "\n";
    return 1;
  }
}
