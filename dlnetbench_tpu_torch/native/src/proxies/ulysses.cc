// Native Ulysses (sequence-parallel) proxy — rebuild extension.
//
// No reference counterpart (SURVEY.md §5.7).  Mirrors the Python tier's
// proxies/ulysses.py: attention heads<->sequence resharding via two
// all-to-alls per attention layer forward (scatter heads / gather
// sequence, then back), two more backward, with attention + MLP compute
// between; dp > 1 closes the step with a gradient allreduce.
#include "pipeline_engine.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("ulysses — sequence-parallel all-to-all proxy (native shm)");
  add_common_args(args);
  args.required_int("sp", "sequence-parallel degree")
      .optional_int("dp", 0, "data-parallel degree (0 = infer from world)")
      .optional_int("max_layers", 0, "cap simulated layers (0 = all)");
  args.parse(argc, argv);

  try {
    ProxyEnv env = make_env(args);
    // no step-boundary fault driver here: refuse plans whose
    // events could only fire at step boundaries, so a record
    // never stamps fault provenance onto an actually-clean run
    // (collective-scoped and drop plans still apply via the
    // fabric hooks; fault_session.hpp)
    fault::require_collective_scope_only("ulysses");
    ModelCard card = load_card_for(env);
    i64 sp = args.integer("sp");
    i64 dp = infer_dp(env.world, sp, args.integer("dp"), "sp");
    SequenceSchedule sched = sequence_schedule(env.stats, card, sp);
    i64 max_layers = args.integer("max_layers");
    i64 layers = max_layers > 0 ? std::min(sched.layers, max_layers)
                                : sched.layers;
    // per-layer compute: whole-layer attention (all sp^2 block pairs
    // land on this rank's heads) + MLP share
    double attn_us_per_layer = sched.attn_us_per_block * sp * sp;
    double mlp_us_per_layer =
        (env.stats.ffn_fwd_us / std::max<i64>(sched.layers, 1)) / sp;

    i64 a2a_total = scale_count(sched.a2a_elems, env.cfg.size_scale);
    i64 a2a_per_rank = (a2a_total + sp - 1) / sp;
    i64 grad_elems = scale_count(env.stats.model_size / std::max<i64>(sp, 1),
                                 env.cfg.size_scale);

    Json meta = Json::object();
    meta["proxy"] = "ulysses";
    meta["sp"] = sp;
    meta["dp"] = dp;
    meta["layers"] = layers;
    meta["attn_time_source"] = sched.attn_time_source;
    meta["a2a_bytes"] =
        static_cast<i64>(a2a_per_rank * sp * dtype_bytes(env.dtype));
    meta["schedule_a2a_bytes"] =
        static_cast<i64>(sched.a2a_elems * sched.bytes_per_element);
    {
      i64 n_a2a = 4 * layers;  // 2 reshards per layer, fwd + bwd
      const Grid3D mg{dp, 1, sp};  // same grid the rank body runs
      Json cm = Json::object();
      cm["a2a_comm"] = comm_timer(comm_component(
          "alltoall", sp,
          n_a2a * a2a_per_rank * sp *
              static_cast<i64>(dtype_bytes(env.dtype))));
      if (dp > 1)
        cm["dp_comm"] = comm_timer(comm_component(
            "allreduce", dp,
            grad_elems * static_cast<i64>(dtype_bytes(env.dtype)),
            /*bound=*/"", /*ops=*/1,
            /*span=*/env.procs > 1
                ? axis_span_procs(env.world, env.procs,
                                  [&](i64 r) { return mg.dp_color(r); })
                : 0));
      meta["comm_model"] = cm;
    }

    return run_proxy_main(
        "ulysses", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          Grid3D grid{dp, 1, sp};
          auto c = grid.coords(r);
          auto world = fab.world_comm(r);
          auto sp_comm =
              fab.split(r, static_cast<int>(grid.tp_color(r)), "sp_comm");
          std::unique_ptr<ProxyCommunicator> dp_comm;
          if (dp > 1)
            dp_comm =
                fab.split(r, static_cast<int>(grid.dp_color(r)), "dp_comm");

          auto burn = [&](double us) { fab.burn(r, us, env.cfg.time_scale); };
          Tensor a2a_src(a2a_per_rank * sp, env.dtype);
          Tensor a2a_dst(a2a_per_rank * sp, env.dtype);
          Tensor g_src(grad_elems, env.dtype), g_dst(grad_elems, env.dtype);

          auto layer_pass = [&](TimerSet& t, double scale) {
            {  // reshard seq -> heads
              auto sc = t.scoped("a2a_comm");
              sp_comm->Alltoall(a2a_src.data(), a2a_dst.data(), a2a_per_rank);
            }
            burn(attn_us_per_layer * scale);
            {  // reshard heads -> seq
              auto sc = t.scoped("a2a_comm");
              sp_comm->Alltoall(a2a_dst.data(), a2a_src.data(), a2a_per_rank);
            }
            burn(mlp_us_per_layer * scale);
          };

          run = run_measured(env.cfg, *world, ts, [&](TimerSet& t) {
            for (i64 l = 0; l < layers; ++l) layer_pass(t, 1.0);  // fwd
            for (i64 l = 0; l < layers; ++l) layer_pass(t, 2.0);  // bwd
            if (dp_comm) {
              auto sc = t.scoped("dp_comm");
              dp_comm->Allreduce(g_src.data(), g_dst.data(), grad_elems);
            }
          });
          ts.merge_entries("a2a_comm", 4 * layers);

          Json extra = Json::object();
          extra["sp_id"] = c.tp_id;
          extra["dp_id"] = c.dp_id;
          return extra;
        });
  } catch (const std::exception& e) {
    std::cerr << "ulysses: " << e.what() << "\n";
    return 1;
  }
}
