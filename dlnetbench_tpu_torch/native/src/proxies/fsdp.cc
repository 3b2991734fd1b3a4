// Native FSDP proxy: ZeRO-3 unit allgather prefetch + reduce-scatter.
//
// Schedule (reference cpp/data_parallel/fsdp.cpp:73-163): the model is
// split into units, each sharded across `sharding_factor` ranks; world =
// sharding_factor x num_replicas (fsdp.cpp:217,258).  Forward allgathers
// unit u+1 asynchronously while computing unit u (prefetch); backward
// prefetches unit u-1, reduce-scatters unit u's gradients, and — with
// replicas — cross-replica Iallreduces each gradient shard, drained by a
// final WaitAll timed as "barrier_time".  Two communicators: intra-shard
// `unit_comm` (color = rank / sharding_factor) and inter-replica
// `allreduce_comm` (color = rank % sharding_factor) (fsdp.cpp:257-265).
#include "proxy_runner.hpp"

#include "dlnb/schedule.hpp"
#include "dlnb/tensor.hpp"

using namespace dlnb;

int main(int argc, char** argv) {
  Args args("fsdp — ZeRO-3 allgather/reduce-scatter proxy (native shm)");
  add_common_args(args);
  args.required_int("num_units", "model units (allgather granularity)");
  args.optional_int("sharding_factor", 0,
                    "ranks per shard group (0 = whole world, no replicas)");
  args.parse(argc, argv);

  try {
    ProxyEnv env = make_env(args);
    i64 num_units = args.integer("num_units");
    i64 sf = args.integer("sharding_factor");
    FSDPSchedule sched =
        fsdp_schedule(env.stats, num_units, env.world, sf);
    bool has_replicas = sched.num_replicas > 1;

    Json meta = Json::object();
    meta["proxy"] = "fsdp";
    meta["num_units"] = num_units;
    meta["sharding_factor"] = sched.sharding_factor;
    meta["num_replicas"] = sched.num_replicas;
    i64 shard_elems = scale_count(sched.shard_size, env.cfg.size_scale);
    meta["shard_bytes"] =
        static_cast<i64>(shard_elems * dtype_bytes(env.dtype));
    meta["schedule_shard_bytes"] = static_cast<i64>(
        sched.shard_size * env.stats.bytes_per_element);
    i64 unit_bytes = static_cast<i64>(
        shard_elems * sched.sharding_factor * dtype_bytes(env.dtype));
    meta["unit_bytes"] = unit_bytes;
    meta["fwd_us_per_unit"] = sched.fwd_us_per_unit * env.cfg.time_scale;
    meta["bwd_us_per_unit"] = sched.bwd_us_per_unit * env.cfg.time_scale;
    {
      // blocking timers only: "allgather" brackets the one initial
      // blocking gather, "reduce_scatter" all U scatters; the
      // allgather_wait_* timers measure exposed tails of async gathers
      // (bandwidth from a wait would read as infinite under overlap)
      Json cm = Json::object();
      cm["allgather"] = comm_timer(comm_component(
          "allgather", sched.sharding_factor, unit_bytes));
      cm["reduce_scatter"] = comm_timer(comm_component(
          "reduce_scatter", sched.sharding_factor,
          sched.num_units * unit_bytes, /*bound=*/"",
          /*ops=*/sched.num_units));
      meta["comm_model"] = cm;
    }

    // fault plans apply (step/collective delay, drop, crash fail-fast),
    // but the ZeRO grid cannot regroup around a dead rank: refuse a
    // crash+shrink plan instead of half-applying it (dp supports it)
    fault::require_no_shrink("fsdp");

    return run_proxy_main(
        "fsdp", env, meta,
        [&](int r, Fabric& fab, TimerSet& ts, RankRun& run) {
          // grid colors (reference fsdp.cpp:257-265)
          int unit_color = r / static_cast<int>(sched.sharding_factor);
          int repl_color = r % static_cast<int>(sched.sharding_factor);
          auto world = fab.world_comm(r);
          auto unit_comm = fab.split(r, unit_color, "unit_comm");
          auto ar_comm = fab.split(r, repl_color, "allreduce_comm");

          const int U = static_cast<int>(sched.num_units);
          i64 unit_elems = shard_elems * sched.sharding_factor;
          // per-unit: local shard, gathered full unit, grad shard out
          std::vector<Tensor> shards, fulls, grad_shards;
          for (int u = 0; u < U; ++u) {
            shards.emplace_back(shard_elems, env.dtype);
            fulls.emplace_back(unit_elems, env.dtype);
            grad_shards.emplace_back(shard_elems, env.dtype);
          }
          std::vector<Tensor> repl_sums;
          if (has_replicas)
            for (int u = 0; u < U; ++u)
              repl_sums.emplace_back(shard_elems, env.dtype);

          auto burn = [&](double us) { fab.burn(r, us, env.cfg.time_scale); };
          run = run_measured(env.cfg, *world, ts, [&](TimerSet& t) {
            // step-boundary fault injection (delay/jitter sleeps,
            // crash fail-fast); no-op without an active plan
            fault::step_guard(fab, r);
            // initial blocking allgather of unit 0 (fsdp.cpp:86-91)
            {
              auto sc = t.scoped("allgather");
              unit_comm->Allgather(shards[0].data(), fulls[0].data(),
                                   shard_elems);
            }
            // forward: prefetch next unit while computing (fsdp.cpp:95-108)
            for (int u = 0; u < U - 1; ++u) {
              unit_comm->Iallgather(shards[u + 1].data(), fulls[u + 1].data(),
                                    shard_elems, u + 1);
              burn(sched.fwd_us_per_unit);
              auto sc = t.scoped("allgather_wait_fwd");
              unit_comm->Wait(u + 1);
            }
            burn(sched.fwd_us_per_unit);  // last unit

            // backward: prefetch prev, compute, reduce-scatter grads
            // (fsdp.cpp:111-140)
            for (int u = U - 1; u >= 1; --u) {
              unit_comm->Iallgather(shards[u - 1].data(), fulls[u - 1].data(),
                                    shard_elems, u - 1);
              burn(sched.bwd_us_per_unit);
              {
                auto sc = t.scoped("reduce_scatter");
                unit_comm->ReduceScatterBlock(fulls[u].data(),
                                              grad_shards[u].data(),
                                              shard_elems);
              }
              if (has_replicas)
                ar_comm->Iallreduce(grad_shards[u].data(),
                                    repl_sums[u].data(), shard_elems, u);
              auto sc = t.scoped("allgather_wait_bwd");
              unit_comm->Wait(u - 1);
            }
            // unit 0 backward + reduce-scatter (fsdp.cpp:143-152)
            burn(sched.bwd_us_per_unit);
            {
              auto sc = t.scoped("reduce_scatter");
              unit_comm->ReduceScatterBlock(fulls[0].data(),
                                            grad_shards[0].data(),
                                            shard_elems);
            }
            if (has_replicas) {
              ar_comm->Iallreduce(grad_shards[0].data(), repl_sums[0].data(),
                                  shard_elems, 0);
              // drain cross-replica syncs (fsdp.cpp:153-162)
              auto sc = t.scoped("barrier_time");
              ar_comm->WaitAll(U);
            }
          });

          // collapse per-unit entries into per-iteration totals so every
          // timer has one value per run (the reference does the same merge
          // for middle-stage PP timers, hybrid_2d.cpp:416-439)
          if (U > 1) {
            ts.merge_entries("allgather_wait_fwd", U - 1);
            ts.merge_entries("allgather_wait_bwd", U - 1);
          }
          ts.merge_entries("reduce_scatter", U);

          Json extra = Json::object();
          extra["shard_group"] = unit_color;
          extra["replica_id"] = repl_color;
          return extra;
        });
  } catch (const std::exception& e) {
    std::cerr << "fsdp: " << e.what() << "\n";
    return 1;
  }
}
