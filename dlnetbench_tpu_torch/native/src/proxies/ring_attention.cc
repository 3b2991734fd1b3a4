// Native ring-attention (context-parallel) proxy — rebuild extension.
//
// No reference counterpart (SURVEY.md §2.5/§5.7: the reference has no
// sequence parallelism).  Schedule mirrors the Python tier's
// proxies/ring_attention.py: the sequence axis is sharded over `sp` ranks;
// each attention layer rotates K/V blocks around the ring (sp-1 hops of
// Isend/Irecv with the next/prev rank) while computing block-local
// attention, so communication hides behind compute; backward mirrors the
// ring at ~2x compute; MLP compute burns between layers; dp > 1 closes the
// step with a gradient allreduce.
#include "pipeline_engine.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("ring_attention — context-parallel KV-ring proxy (native shm)");
  add_common_args(args);
  args.required_int("sp", "sequence-parallel (ring) degree")
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
    fault::require_collective_scope_only("ring_attention");
    ModelCard card = load_card_for(env);
    i64 sp = args.integer("sp");
    i64 dp = infer_dp(env.world, sp, args.integer("dp"), "sp");
    SequenceSchedule sched = sequence_schedule(env.stats, card, sp);
    i64 max_layers = args.integer("max_layers");
    i64 layers = max_layers > 0 ? std::min(sched.layers, max_layers)
                                : sched.layers;
    double mlp_us_per_layer =
        (env.stats.ffn_fwd_us / std::max<i64>(sched.layers, 1)) / sp;

    i64 kv_elems = scale_count(sched.kv_block_elems, env.cfg.size_scale);
    i64 grad_elems = scale_count(env.stats.model_size / std::max<i64>(sp, 1),
                                 env.cfg.size_scale);

    Json meta = Json::object();
    meta["proxy"] = "ring_attention";
    meta["sp"] = sp;
    meta["dp"] = dp;
    meta["layers"] = layers;
    meta["num_ring_hops"] = sched.num_ring_hops;
    meta["kv_block_bytes"] =
        static_cast<i64>(kv_elems * dtype_bytes(env.dtype));
    meta["schedule_kv_block_bytes"] =
        static_cast<i64>(sched.kv_block_elems * sched.bytes_per_element);
    meta["attn_us_per_block"] = sched.attn_us_per_block * env.cfg.time_scale;
    meta["attn_time_source"] = sched.attn_time_source;
    {
      i64 shifts = 2 * layers * (sp - 1);  // fwd + bwd ring passes
      const Grid3D mg{dp, 1, sp};  // same grid the rank body runs
      Json cm = Json::object();
      cm["ring_comm"] = comm_timer(comm_component(
          "p2p", sp, shifts * kv_elems *
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
        "ring_attention", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          // sp fastest-varying: ring peers are consecutive world ranks
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
          Tensor kv_out(kv_elems, env.dtype), kv_in(kv_elems, env.dtype);
          Tensor g_src(grad_elems, env.dtype), g_dst(grad_elems, env.dtype);

          auto ring_pass = [&](TimerSet& t, double block_us) {
            for (i64 hop = 0; hop < sp; ++hop) {
              burn(block_us);
              if (hop < sp - 1) {
                auto sc = t.scoped("ring_comm");
                // rotate every rank's KV block to its successor — the
                // ppermute idiom; one grouped NCCL send + recv on the nccl
                // backend, paired Isend/Irecv on shm
                sp_comm->RingShift(kv_out.data(), kv_in.data(), kv_elems);
              }
            }
          };

          run = run_measured(env.cfg, *world, ts, [&](TimerSet& t) {
            for (i64 l = 0; l < layers; ++l) {  // forward
              ring_pass(t, sched.attn_us_per_block);
              burn(mlp_us_per_layer);
            }
            for (i64 l = 0; l < layers; ++l) {  // backward ~2x
              ring_pass(t, 2 * sched.attn_us_per_block);
              burn(2 * mlp_us_per_layer);
            }
            if (dp_comm) {
              auto sc = t.scoped("dp_comm");
              dp_comm->Allreduce(g_src.data(), g_dst.data(), grad_elems);
            }
          });
          if (sp > 1)
            ts.merge_entries("ring_comm", 2 * layers * (sp - 1));

          Json extra = Json::object();
          extra["sp_id"] = c.tp_id;
          extra["dp_id"] = c.dp_id;
          return extra;
        });
  } catch (const std::exception& e) {
    std::cerr << "ring_attention: " << e.what() << "\n";
    return 1;
  }
}
