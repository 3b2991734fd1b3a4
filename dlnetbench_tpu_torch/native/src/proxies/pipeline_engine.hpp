// Shared GPipe pipeline engine for the native hybrid proxies.
//
// One engine serves DP+PP (hybrid_2d), DP+PP+TP (hybrid_3d) and DP+PP+EP
// (hybrid_3d_moe), mirroring the reference's three near-identical inner
// loops (reference cpp/hybrid_parallel/hybrid_2d.cpp:90-169,
// hybrid_3d.cpp:142-183, hybrid_3d_moe.cpp:161-208):
//
//   phase 1  all microbatches FORWARD: stage-position-dependent
//            recv/compute/send over the pipeline axis
//            (+ per-mb TP allreduces | MoE dispatch/combine all-to-alls)
//   phase 2  all microbatches BACKWARD, directions mirrored
//   phase 3  gradient sync: DP allreduce of the stage shard
//            (MoE: two-level — non-expert over EP, then stage shard over DP)
//
// Rank grids use the Grid3D color math (tp/ep fastest-varying,
// hybrid_3d.cpp:283-300); pipeline neighbors are group-rank +-1 because
// members are ordered by world rank, which makes group rank == stage id.
#pragma once

#include "proxy_runner.hpp"

#include "dlnb/schedule.hpp"
#include "dlnb/tensor.hpp"

namespace dlnb {

struct HybridSpec {
  PipelineSchedule pipe;
  // "gpipe" (reference parity), "1f1b" (rebuild extra: per-stage warmup
  // of S-1-stage forwards, steady fwd/bwd pairs with slot-indexed Isend so
  // opposite-direction hops are in flight together, backward cooldown), or
  // "zb" (rebuild extra: ZB-H1 zero-bubble, schedule.hpp zb_ops)
  std::string schedule = "gpipe";
  // MoE extras (zero/unused unless is_moe)
  bool is_moe = false;
  i64 ep = 1;
  i64 a2a_elems = 0;          // total per-rank all-to-all buffer, elements
  i64 a2a_per_direction = 0;  // A2As per microbatch per direction
  i64 nonexpert_sync = 0;     // level-1 grad sync elems (EP group)
  i64 expert_sync = 0;        // level-2 expert stage shard elems (DP group)
};

// Fill the record's shared pipeline metadata.  `procs` is the multi-process
// fabric's OS-process count (1 on single-process fabrics): allreduce
// comm-model components get their split's real spanning process count
// stamped so the busbw full-mesh refusal keys on the actual network mesh
// width (analysis/bandwidth.py).
inline void hybrid_meta(Json& meta, const HybridSpec& spec, DType dtype,
                        double size_scale, i64 procs = 1) {
  const auto& p = spec.pipe;
  // the grid the engine actually runs (see run body): MoE replaces the
  // tp axis with ep, so splits/colors — and spans — follow that grid
  const Grid3D rg = spec.is_moe ? Grid3D{p.grid.dp, p.grid.pp, spec.ep}
                                : p.grid;
  const i64 world = rg.world_size();
  const i64 dp_span = procs > 1 ? axis_span_procs(
      world, procs, [&](i64 r) { return rg.dp_color(r); }) : 0;
  const i64 axis_span = procs > 1 ? axis_span_procs(
      world, procs, [&](i64 r) { return rg.tp_color(r); }) : 0;
  meta["num_stages"] = p.grid.pp;
  meta["num_microbatches"] = p.num_microbatches;
  meta["schedule"] = spec.schedule;
  // fill/drain bubble clock: stage s's first compute serializes behind s
  // upstream computes through the blocking rendezvous send/recv chain
  // (reference hybrid_2d.cpp:106-133), so measured runtime spans
  // (M + S - 1) ticks per direction, not M — same clock as the JAX tier
  meta["ticks_per_direction"] = p.num_microbatches + p.grid.pp - 1;
  // pipeline clock in UNIT ticks (1 unit = one fwd): the 2-phase
  // schedules span (1 + r)(M+S-1) and zb its greedy table's REAL
  // weighted makespan, where r = the stats' bwd/fwd ratio (2.0 for the
  // stat model — derived, not hardcoded, so a stats file breaking the
  // 2x convention reweights instead of skewing comparisons; matches the
  // JAX tier's ticks_total so cross-tier analyses divide alike)
  const double bwd_units = p.fwd_us_per_stage_mb > 0
                               ? p.bwd_us_per_stage_mb / p.fwd_us_per_stage_mb
                               : 2.0;
  meta["ticks_total"] =
      spec.schedule == "zb"
          ? zb_unit_ticks(p.grid.pp, p.num_microbatches, bwd_units)
          : (1.0 + bwd_units) * (p.num_microbatches + p.grid.pp - 1);
  meta["dp"] = p.grid.dp;
  meta["layers_per_stage"] = p.layers_per_stage;
  meta["pipe_msg_bytes"] = static_cast<i64>(
      scale_count(p.pipe_msg_elems, size_scale) * dtype_bytes(dtype));
  meta["schedule_pipe_msg_bytes"] =
      static_cast<i64>(p.pipe_msg_elems * p.bytes_per_element);
  meta["dp_sync_bytes"] = static_cast<i64>(
      scale_count(p.dp_sync_elems, size_scale) * dtype_bytes(dtype));
  if (p.grid.tp > 1) {
    meta["tp"] = p.grid.tp;
    meta["tp_msg_bytes"] = static_cast<i64>(
        scale_count(p.tp_msg_elems, size_scale) * dtype_bytes(dtype));
  }
  if (spec.is_moe) {
    meta["num_expert_shards"] = spec.ep;
    meta["a2a_bytes"] = static_cast<i64>(
        scale_count(spec.a2a_elems, size_scale) * dtype_bytes(dtype));
    meta["a2a_per_direction"] = spec.a2a_per_direction;
    meta["nonexpert_sync_bytes"] = static_cast<i64>(
        scale_count(spec.nonexpert_sync, size_scale) * dtype_bytes(dtype));
    meta["expert_sync_bytes"] = static_cast<i64>(
        scale_count(spec.expert_sync, size_scale) * dtype_bytes(dtype));
  }
  {
    // per-iteration bytes per blocking timer (analysis/bandwidth.py).
    // pp_comm: one activation message per microbatch per edge per
    // direction; middle stages bracket BOTH their recv and their send in
    // the timer, so their per-rank busbw reads conservatively (time
    // spans 2x the declared one-direction bytes) — declared as a LOWER
    // bound so the emitted table carries the caveat, not just this
    // comment.
    const i64 esz = static_cast<i64>(dtype_bytes(dtype));
    const i64 M = p.num_microbatches;
    Json cm = Json::object();
    cm["pp_comm"] = comm_timer(comm_component(
        "p2p", p.grid.pp,
        2 * M * scale_count(p.pipe_msg_elems, size_scale) * esz,
        /*bound=*/"lower", /*ops=*/2 * M));
    if (spec.is_moe) {
      cm["ep_comm"] = comm_timer(comm_component(
          "alltoall", spec.ep,
          2 * M * spec.a2a_per_direction *
              scale_count(spec.a2a_elems, size_scale) * esz,
          /*bound=*/"", /*ops=*/2 * M * spec.a2a_per_direction));
      cm["dp_ep_comm"] = comm_timer(comm_component(
          "allreduce", spec.ep,
          scale_count(spec.nonexpert_sync, size_scale) * esz,
          /*bound=*/"", /*ops=*/1, /*span=*/axis_span));
      cm["dp_comm"] = comm_timer(comm_component(
          "allreduce", p.grid.dp,
          scale_count(spec.expert_sync, size_scale) * esz,
          /*bound=*/"", /*ops=*/1, /*span=*/dp_span));
    } else {
      cm["dp_comm"] = comm_timer(comm_component(
          "allreduce", p.grid.dp,
          scale_count(p.dp_sync_elems, size_scale) * esz,
          /*bound=*/"", /*ops=*/1, /*span=*/dp_span));
      if (p.grid.tp > 1)
        cm["tp_comm"] = comm_timer(comm_component(
            "allreduce", p.grid.tp,
            4 * M * scale_count(p.tp_msg_elems, size_scale) * esz,
            /*bound=*/"", /*ops=*/4 * M, /*span=*/axis_span));
    }
    meta["comm_model"] = cm;
  }
}

// The per-rank body shared by all three hybrid proxies.
inline Json hybrid_rank_body(const HybridSpec& spec, const ProxyEnv& env,
                             int r, Fabric& fab, TimerSet& ts,
                             RankRun& run) {
  const PipelineSchedule& p = spec.pipe;
  Grid3D grid = spec.is_moe
                    ? Grid3D{p.grid.dp, p.grid.pp, spec.ep}
                    : p.grid;
  auto c = grid.coords(r);
  const int S = static_cast<int>(grid.pp);
  const int M = static_cast<int>(p.num_microbatches);
  const bool has_axis = grid.tp > 1;  // TP or EP axis present

  auto world = fab.world_comm(r);
  auto burn = [&](double us) { fab.burn(r, us, env.cfg.time_scale); };
  auto pp_comm = fab.split(r, static_cast<int>(grid.pp_color(r)), "pp_comm");
  auto dp_comm = fab.split(r, static_cast<int>(grid.dp_color(r)), "dp_comm");
  std::unique_ptr<ProxyCommunicator> axis_comm;
  // MoE always needs the EP communicator, even at ep=1 (the dispatch/
  // combine all-to-alls and the non-expert sync still run, degenerating
  // to local copies)
  if (has_axis || spec.is_moe)
    axis_comm = fab.split(r, static_cast<int>(grid.tp_color(r)),
                          spec.is_moe ? "ep_comm" : "tp_comm");

  const int stage = static_cast<int>(c.pp_id);
  const bool first = stage == 0, last = stage == S - 1;

  // buffers (zero-init RAII tensors, reference dp.cpp:227-232 style)
  i64 pipe_elems = scale_count(p.pipe_msg_elems, env.cfg.size_scale);
  i64 dp_elems = scale_count(
      spec.is_moe ? spec.expert_sync : p.dp_sync_elems, env.cfg.size_scale);
  Tensor act_out(pipe_elems, env.dtype), act_in(pipe_elems, env.dtype);
  Tensor dp_src(dp_elems, env.dtype), dp_dst(dp_elems, env.dtype);
  i64 tp_elems = 0, a2a_per_rank = 0;
  Tensor tp_src, tp_dst, a2a_src, a2a_dst, ne_src, ne_dst;
  if (has_axis && !spec.is_moe) {
    tp_elems = scale_count(p.tp_msg_elems, env.cfg.size_scale);
    tp_src = Tensor(tp_elems, env.dtype);
    tp_dst = Tensor(tp_elems, env.dtype);
  }
  if (spec.is_moe) {
    i64 total = scale_count(spec.a2a_elems, env.cfg.size_scale);
    a2a_per_rank = (total + spec.ep - 1) / spec.ep;
    a2a_src = Tensor(a2a_per_rank * spec.ep, env.dtype);
    a2a_dst = Tensor(a2a_per_rank * spec.ep, env.dtype);
    i64 ne = scale_count(spec.nonexpert_sync, env.cfg.size_scale);
    ne_src = Tensor(ne, env.dtype);
    ne_dst = Tensor(ne, env.dtype);
  }

  auto axis_traffic = [&](TimerSet& t) {
    if (spec.is_moe) {
      // dispatch + combine per MoE layer (hybrid_3d_moe.cpp:161-165)
      for (i64 a = 0; a < spec.a2a_per_direction; ++a) {
        auto sc = t.scoped("ep_comm");
        axis_comm->Alltoall(a2a_src.data(), a2a_dst.data(), a2a_per_rank);
      }
    } else if (has_axis) {
      // column+row parallel linear allreduces (hybrid_3d.cpp:142-148)
      for (int i = 0; i < 2; ++i) {
        auto sc = t.scoped("tp_comm");
        axis_comm->Allreduce(tp_src.data(), tp_dst.data(), tp_elems);
      }
    }
  };

  // 1f1b and zb use slot-indexed Isend (slot 0 = up, slot 1 = down) so
  // the two directions can be in flight together; the slot is drained
  // (untimed) right before reuse, and each direction has its own out
  // buffer (allocated for every non-gpipe schedule).
  Tensor act_out2(spec.schedule != "gpipe" ? pipe_elems : 0,
                  env.dtype);
  bool up_pending = false, down_pending = false;

  auto fwd_mb = [&](TimerSet& t) {
    if (S == 1) {
      burn(p.fwd_us_per_stage_mb);
      return;
    }
    if (!first) {
      auto sc = t.scoped("pp_comm");
      pp_comm->Recv(act_in.data(), pipe_elems, stage - 1);
    }
    burn(p.fwd_us_per_stage_mb);
    if (!last) {
      if (spec.schedule == "gpipe") {
        auto sc = t.scoped("pp_comm");
        pp_comm->Send(act_out.data(), pipe_elems, stage + 1);
      } else {
        if (up_pending) pp_comm->Wait(0);
        auto sc = t.scoped("pp_comm");
        pp_comm->Isend(act_out.data(), pipe_elems, stage + 1, 0, /*tag=*/0);
        up_pending = true;
      }
    }
  };
  auto bwd_mb = [&](TimerSet& t, bool half = false) {
    double bwd_us = p.bwd_us_per_stage_mb * (half ? 0.5 : 1.0);
    if (S == 1) {
      burn(bwd_us);
      return;
    }
    if (!last) {
      auto sc = t.scoped("pp_comm");
      pp_comm->Recv(act_in.data(), pipe_elems, stage + 1);
    }
    burn(bwd_us);
    if (!first) {
      if (spec.schedule == "gpipe") {
        auto sc = t.scoped("pp_comm");
        pp_comm->Send(act_out.data(), pipe_elems, stage - 1);
      } else {
        if (down_pending) pp_comm->Wait(1);
        auto sc = t.scoped("pp_comm");
        pp_comm->Isend(act_out2.data(), pipe_elems, stage - 1, 1, /*tag=*/0);
        down_pending = true;
      }
    }
  };

  // zb's op program is a pure function of (S, M, stage): built once,
  // outside the measured region (the greedy is O(S x ticks))
  const std::vector<ZBOp> zb_program =
      spec.schedule == "zb" ? zb_ops(S, M, stage) : std::vector<ZBOp>{};
  run = run_measured(env.cfg, *world, ts, [&](TimerSet& t) {
    if (spec.schedule == "gpipe") {
      // ---- phase 1: all microbatches forward (hybrid_2d.cpp:106-133),
      //      phase 2: all backward, mirrored (hybrid_2d.cpp:135-161) ----
      for (int mb = 0; mb < M; ++mb) {
        fwd_mb(t);
        axis_traffic(t);
      }
      for (int mb = 0; mb < M; ++mb) {
        bwd_mb(t);
        axis_traffic(t);
      }
    } else if (spec.schedule == "zb") {
      // ---- ZB-H1 zero-bubble: execute this stage's op program from the
      // shared greedy tables (schedule.hpp zb_ops, mirroring the JAX
      // tier's core/schedule.py zb_tables).  F hops up, the input-grad
      // half B hops down (slot-indexed Isends as in 1f1b), and the local
      // weight-grad half W burns without any hop — the op that fills the
      // 1f1b drain bubble. ----
      for (const ZBOp& op : zb_program) {
        if (op.kind == 'F') {
          fwd_mb(t);
          axis_traffic(t);
        } else if (op.kind == 'B') {
          bwd_mb(t, /*half=*/true);
          axis_traffic(t);
        } else {
          burn(p.bwd_us_per_stage_mb / 2);
        }
      }
      if (up_pending) { pp_comm->Wait(0); up_pending = false; }
      if (down_pending) { pp_comm->Wait(1); down_pending = false; }
    } else {
      // ---- 1f1b: per-stage warmup, steady pairs, cooldown ----
      const int warm = std::min(S - 1 - stage, M);
      for (int i = 0; i < warm; ++i) {
        fwd_mb(t);
        axis_traffic(t);
      }
      for (int i = 0; i < M - warm; ++i) {
        fwd_mb(t);
        axis_traffic(t);
        bwd_mb(t);
        axis_traffic(t);
      }
      for (int i = 0; i < warm; ++i) {
        bwd_mb(t);
        axis_traffic(t);
      }
      if (up_pending) { pp_comm->Wait(0); up_pending = false; }
      if (down_pending) { pp_comm->Wait(1); down_pending = false; }
    }
    // ---- phase 3: gradient sync ----
    if (spec.is_moe) {
      // two-level: non-expert params over EP, expert stage shard over DP
      // (hybrid_3d_moe.cpp:202-208)
      {
        auto sc = t.scoped("dp_ep_comm");
        axis_comm->Allreduce(ne_src.data(), ne_dst.data(), ne_src.count());
      }
      auto sc = t.scoped("dp_comm");
      dp_comm->Allreduce(dp_src.data(), dp_dst.data(), dp_elems);
    } else {
      // blocking DP allreduce of this stage's shard (hybrid_2d.cpp:163-166)
      auto sc = t.scoped("dp_comm");
      dp_comm->Allreduce(dp_src.data(), dp_dst.data(), dp_elems);
    }
  });

  // one entry per run for every timer (reference merge,
  // hybrid_2d.cpp:416-439): edge stages make 2M pp entries per iteration,
  // middle stages 4M
  if (S > 1) ts.merge_entries("pp_comm", (first || last) ? 2 * M : 4 * M);
  if (has_axis && !spec.is_moe) ts.merge_entries("tp_comm", 4 * M);
  if (spec.is_moe)
    ts.merge_entries("ep_comm",
                     2 * M * static_cast<std::size_t>(spec.a2a_per_direction));

  Json extra = Json::object();
  extra["stage_id"] = stage;
  extra["dp_id"] = c.dp_id;
  if (has_axis) extra[spec.is_moe ? "ep_id" : "tp_id"] = c.tp_id;
  return extra;
}

// Shared --schedule flag registration + validated assignment (keeps the
// three proxy mains in lockstep).
inline void add_schedule_arg(Args& args) {
  args.optional_str("schedule", "gpipe",
                    "pipeline schedule: gpipe (reference parity), 1f1b, "
                    "or zb (ZB-H1 zero-bubble)");
}

inline void set_schedule(HybridSpec& spec, const Args& args) {
  spec.schedule = args.str("schedule");
  if (spec.schedule != "gpipe" && spec.schedule != "1f1b" &&
      spec.schedule != "zb")
    throw std::runtime_error("unknown schedule: " + spec.schedule);
}

// Infer dp from world when not given (matches the Python tier's _infer_dp).
inline i64 infer_dp(i64 world, i64 inner, i64 dp_flag,
                    const std::string& label) {
  if (dp_flag > 0) {
    if (dp_flag * inner != world)
      throw std::runtime_error("world " + std::to_string(world) +
                               " != dp " + std::to_string(dp_flag) + " x " +
                               label + " " + std::to_string(inner));
    return dp_flag;
  }
  if (world % inner != 0)
    throw std::runtime_error("world " + std::to_string(world) +
                             " not divisible by " + label + " " +
                             std::to_string(inner));
  return world / inner;
}

}  // namespace dlnb
