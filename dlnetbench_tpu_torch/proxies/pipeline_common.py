"""The pipeline engine of the hybrid proxies (2D / 3D / 3D-MoE) — the
JAX package's ``proxies/pipeline_common.py`` on ``torch.distributed``.

Reference structure (cpp/hybrid_parallel/hybrid_2d.cpp:90-169): GPipe
runs all microbatches forward, then all backward, then one blocking DP
allreduce of the stage's gradient shard; per rank and microbatch the
work is recv -> compute -> send, mirrored in the backward.  The 3D
variant adds two TP allreduces per microbatch wave and direction
(hybrid_3d.cpp:142-148, 177-183); the MoE variant instead adds
``2 x layers_per_stage`` all-to-alls (hybrid_3d_moe.cpp:161-165,
196-200) and syncs its gradients in two levels: the non-expert
parameters over EP, the expert shard over DP (:202-208).  1F1B and
ZB-H1 are the JAX package's extras.

Every rank runs the JAX program's tick clock, sender tables and
collectives.  What differs is how a stage with nothing to do waits.
One SPMD program cannot branch by rank, so JAX gates each tick's burn
on the stage (``burn_if``) while every device joins every hop.  Here
each rank knows its stage: its step is a list of ops made once for it
(``rank_ops``) that burns only its active ticks, and an idle stage
simply waits for its next receive, as the reference's blocking recv
chains do (hybrid_2d.cpp:106-133).  The compute-only program burns the
same ticks and never waits, so ``barrier_time`` holds the bubble, as
in the JAX package.

A step issues on three comm streams (``collectives.CommStream``), one
``Order`` between them:

  a     GPipe's hops (forward, then backward) and the forward hops of
        1F1B and ZB, on the pp group;
  b     the backward hops of 1F1B and ZB, on a second group over the
        same ranks (``mesh.second_group``): NCCL runs one group's calls
        one after another, and the two directions run side by side;
  side  the TP allreduces or the MoE all-to-alls of each wave, and the
        gradient sync.

The compute joins a hop where the JAX program ties the burn state to it:
GPipe after every hop, so its inner comms follow the hop; 1F1B and ZB
at the tick's end, after both directions, so a steady tick's up-hop, its
down-hop and its inner comms depend only on the burns before them (the
JAX package's ``pipeline_common.py:275-313``).  Each hop moves a
``Carry``.
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.core import executor
from dlnetbench_tpu_torch.core.model_card import ModelCard
from dlnetbench_tpu_torch.core.model_stats import ModelStats
from dlnetbench_tpu_torch.core.schedule import (moe_schedule,
                                                pipeline_schedule,
                                                zb_tables, zb_unit_ticks)
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.parallel.buffers import Carry, scaled_elems, zeros
from dlnetbench_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_PP, AXIS_TP,
                                                describe_mesh,
                                                make_grid_mesh,
                                                second_group)
from dlnetbench_tpu_torch.proxies import burn as burnlib
from dlnetbench_tpu_torch.proxies.base import ProxyConfig, StepBundle

MODES = {"2d": "hybrid_2d", "3d": "hybrid_3d", "moe": "hybrid_3d_moe"}
SCHEDULES = ("gpipe", "1f1b", "zb")
LANES = ("a", "b", "side")


class _Step:
    """A zero-argument step program running ``ops``; ``order`` holds its
    last call's ``collectives.Order``."""

    def __init__(self, run, ops: list):
        self.run, self.ops, self.order = run, ops, None

    def __call__(self) -> None:
        self.order = self.run(self.ops)


def _infer_dp(world: int, num_stages: int, tp: int, dp: int,
              label: str = "stages*tp (reference hybrid_3d.cpp:272)") -> int:
    if dp:
        return dp
    if world % (num_stages * tp) != 0:
        raise ValueError(f"world {world} not divisible by "
                         f"{label} = {num_stages * tp}")
    return world // (num_stages * tp)


def sender_tables(schedule: str, S: int, M: int, zb=None) -> tuple:
    """The stages that send in each tick of each hop table, the JAX
    package's (``pipeline_common.py:155-187`` there): gpipe's forward
    and backward; 1f1b's fill, steady forward, steady backward and
    drain; zb's forward and backward (``core/schedule.zb_tables``)."""
    T = M + S - 1
    if schedule == "gpipe":
        # stage s computes mb k at tick s+k (fwd) / (S-1-s)+k (bwd)
        return ([[s for s in range(S - 1) if s <= t < s + M]
                 for t in range(T)],
                [[s for s in range(1, S) if (S - 1 - s) <= t < (S - 1 - s) + M]
                 for t in range(T)])
    if schedule == "zb":
        return zb.f_senders(S), zb.b_senders()
    return ([[s for s in range(min(t + 1, S - 1)) if t - s < M]
             for t in range(S - 1)],
            [[s for s in range(S - 1) if (S - 1 - s + i) < M]
             for i in range(M)],
            [[s for s in range(1, S) if i >= (S - 1 - s)]
             for i in range(M)],
            [[s for s in range(1, S) if (S - 1 - s) - M <= d < (S - 1 - s)]
             for d in range(S - 1)])


def rank_ops(schedule: str, S: int, M: int, stage: int, iters: dict, *,
             with_compute: bool = True, with_comm: bool = True,
             zb=None) -> list[tuple]:
    """One stage's step, in issue order:

      ("burn", tick, kind, iters)   the compute: kind f (forward), b
                                    (backward; zb's input-grad half) or
                                    w (zb's weight-grad half)
      ("hop", tick, lane, up, senders)  shift_up (up) or shift_down on
                                    lane a or b, with the tick's senders
      ("join", tick, lanes)         the compute waits on those lanes'
                                    last hops
      ("inner", tick)               one wave's TP or EP collectives
      ("sync",)                     the gradient sync

    ``iters`` maps f, b and h (half a backward) to burn iterations.  The
    clock is the JAX program's: gpipe M+S-1 forward then M+S-1 backward
    ticks, 1f1b S-1 fill, M steady and S-1 drain ticks, zb the greedy
    table's ticks."""
    tabs = sender_tables(schedule, S, M, zb)
    ops: list[tuple] = []

    def burn(t, kind, n, active):
        if with_compute and active and n > 0:
            ops.append(("burn", t, kind, n))

    def hop(t, lane, up, senders, lanes):
        if with_comm and senders:
            ops.append(("hop", t, lane, up, tuple(senders)))
            lanes.append(lane)

    def inner(t):
        if with_comm:
            ops.append(("inner", t))

    def join(t, lanes):
        if lanes:
            ops.append(("join", t, tuple(lanes)))

    T = M + S - 1
    if schedule == "gpipe":
        fwd, bwd = tabs
        for t in range(T):
            lanes = []
            burn(t, "f", iters["f"], stage <= t < stage + M)
            hop(t, "a", True, fwd[t], lanes)
            join(t, lanes)                  # blocking send: inner comms
            if t >= S - 1:                  # follow the hop
                inner(t)
        off = (S - 1) - stage
        for t in range(T):
            lanes = []
            burn(T + t, "b", iters["b"], off <= t < off + M)
            hop(T + t, "a", False, bwd[t], lanes)
            join(T + t, lanes)
            if t >= S - 1:
                inner(T + t)
    elif schedule == "zb":
        f_send, b_send = tabs
        for t in range(zb.ticks):
            burn(t, "f", iters["f"], stage in zb.f_stages[t])
            burn(t, "b", iters["h"], stage in zb.b_stages[t])
            burn(t, "w", iters["h"], stage in zb.w_stages[t])
            lanes = []
            hop(t, "a", True, f_send[t], lanes)
            hop(t, "b", False, b_send[t], lanes)
            # inner traffic rides wave completions: 2 calls x M in all
            if (S - 1) in zb.f_stages[t]:
                inner(t)
            if 0 in zb.b_stages[t]:
                inner(t)
            join(t, lanes)
    else:
        fill, steady_f, steady_b, drain = tabs
        for t in range(S - 1):
            lanes = []
            burn(t, "f", iters["f"], stage <= t and t - stage < M)
            hop(t, "a", True, fill[t], lanes)
            join(t, lanes)
        for i in range(M):
            t, lanes = S - 1 + i, []
            burn(t, "f", iters["f"], (S - 1 - stage + i) < M)
            hop(t, "a", True, steady_f[i], lanes)
            inner(t)
            burn(t, "b", iters["b"], i >= (S - 1 - stage))
            hop(t, "b", False, steady_b[i], lanes)
            inner(t)
            join(t, lanes)                  # the tick's end ties both
        off = (S - 1) - stage
        for d in range(S - 1):
            t, lanes = S - 1 + M + d, []
            burn(t, "b", iters["b"], off - M <= d < off)
            hop(t, "b", False, drain[d], lanes)
            join(t, lanes)
    if with_comm:
        ops.append(("sync",))
    return ops


def build(stats: ModelStats, card: ModelCard, cfg: ProxyConfig,
          device: torch.device, *, mode: str, num_stages: int,
          num_microbatches: int, tp: int = 1, num_expert_shards: int = 1,
          dp: int = 0, schedule: str = "gpipe",
          dtype=torch.float32) -> StepBundle:
    """``schedule``: gpipe (the reference's), 1f1b or zb (the JAX
    package's extras; see its ``pipeline_common.build``)."""
    assert mode in MODES
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    world = multihost.world_size()
    inner = num_expert_shards if mode == "moe" else tp
    dp = _infer_dp(world, num_stages, inner, dp)

    moe = None
    if mode == "moe":
        moe = moe_schedule(stats, card, num_stages=num_stages,
                           num_microbatches=num_microbatches,
                           num_expert_shards=num_expert_shards, dp=dp)
        sched = moe.pipe
    else:
        sched = pipeline_schedule(stats, card, num_stages=num_stages,
                                  num_microbatches=num_microbatches,
                                  dp=dp, tp=tp)
    mesh = make_grid_mesh(dp, num_stages, inner, device)
    stage = mesh.coords[1]
    burner = burnlib.Burner(device)
    cal = burnlib.calibrate(burner)
    iters = {"f": cal.iters_for_us(sched.fwd_us_per_stage_mb
                                   * cfg.time_scale),
             "b": cal.iters_for_us(sched.bwd_us_per_stage_mb
                                   * cfg.time_scale),
             # zb splits the backward into equal input-grad (B) and
             # weight-grad (W) halves
             "h": cal.iters_for_us(sched.bwd_us_per_stage_mb / 2
                                   * cfg.time_scale)}

    pipe_elems = scaled_elems(sched.pipe_msg_elems, cfg.size_scale)
    dp_elems = scaled_elems(sched.dp_sync_elems, cfg.size_scale)
    tp_elems = scaled_elems(sched.tp_msg_elems, cfg.size_scale) \
        if sched.tp_msg_elems else 0
    a2a_elems = ne_elems = ex_elems = 0
    if moe is not None:
        a2a_elems = scaled_elems(moe.a2a_elems, cfg.size_scale)
        a2a_elems += (-a2a_elems) % num_expert_shards  # divisible for A2A
        ne_elems = scaled_elems(moe.nonexpert_sync_elems, cfg.size_scale)
        ex_elems = scaled_elems(moe.expert_sync_elems, cfg.size_scale)

    S, M = num_stages, num_microbatches
    ticks_per_direction = M + S - 1
    zb = zb_tables(S, M) if schedule == "zb" else None
    tables = sender_tables(schedule, S, M, zb)
    # hop calls a step and edge messages (exactly one per microbatch per
    # edge per direction — the masking invariant)
    pp_permute_ticks = sum(1 for tab in tables for x in tab if x)
    pp_edge_messages = sum(len(x) for tab in tables for x in tab)
    assert pp_edge_messages == 2 * M * (S - 1), \
        f"sender masks lost messages: {pp_edge_messages} != {2 * M * (S-1)}"
    # the backward's weight in forward units, from the stats
    bwd_units = (sched.bwd_us_per_stage_mb / sched.fwd_us_per_stage_mb
                 if sched.fwd_us_per_stage_mb > 0 else 2.0)

    groups = {"a": mesh.groups[AXIS_PP]}
    carries = {"a": Carry(pipe_elems, dtype, device)}
    if schedule != "gpipe" and S > 1:
        groups["b"] = second_group(mesh, AXIS_PP)
        carries["b"] = Carry(pipe_elems, dtype, device)
    tp_group, dp_group = mesh.groups[AXIS_TP], mesh.groups[AXIS_DP]
    if mode == "moe":
        a2a = Carry(max(a2a_elems, num_expert_shards), dtype, device)
        ne, ex = (zeros(max(ne_elems, 1), dtype, device),
                  zeros(max(ex_elems, 1), dtype, device))
    else:
        grad = zeros(dp_elems, dtype, device)
        if mode == "3d":
            tp_buf = zeros(max(tp_elems, 1), dtype, device)

    a2a_count = moe.a2a_per_direction if moe is not None else 0
    # per-step collective counts, shared by the variants and comm_model
    pp_hops = 2 * M
    tp_allreduces = 2 * 2 * M                      # 2 a wave and direction
    ep_alltoalls = 2 * M * a2a_count

    def inner_comms(side):
        """One wave's TP allreduces (column + row parallel linear) or MoE
        all-to-alls (dispatch + combine per MoE layer)."""
        if mode == "3d":
            for _ in range(2):
                side.issue(col.allreduce, tp_buf, group=tp_group)
        elif mode == "moe":
            for _ in range(a2a_count):
                a2a.hop(side, col.alltoall, tp_group)

    def grad_sync(side):
        if mode == "moe":
            # two-level: non-expert over EP, expert shard over DP
            side.issue(col.allreduce, ne, group=tp_group)
            side.issue(col.allreduce, ex, group=dp_group)
        else:
            side.issue(col.allreduce, grad, group=dp_group)

    def run(ops: list) -> col.Order:
        """Issue ``ops``; returns what its collectives were ordered
        after."""
        order = col.Order()
        streams = {k: col.CommStream(device, order) for k in LANES}
        last = {}
        for op in ops:
            kind = op[0]
            if kind == "burn":
                burner(op[3])
            elif kind == "hop":
                _, _, lane, up, senders = op
                last[lane] = carries[lane].hop(
                    streams[lane], col.shift_up if up else col.shift_down,
                    groups[lane], senders=senders)
            elif kind == "join":
                for lane in op[2]:
                    streams[lane].wait(last[lane])
            elif kind == "inner":
                inner_comms(streams["side"])
            else:
                grad_sync(streams["side"])
        for s in streams.values():
            s.wait_all()
        return order

    def program(ops: list) -> "_Step":
        return _Step(run, ops)

    def ops(with_compute, with_comm):
        return rank_ops(schedule, S, M, stage, iters, zb=zb,
                        with_compute=with_compute, with_comm=with_comm)

    comm_ops = ops(False, True)
    programs = {"full": program(ops(True, True)),
                "compute": program(ops(True, False)),
                "comm": program(comm_ops),
                # hop-only replay of the schedule's ticks: the same
                # sender sets, lanes and order, burns and joins elided
                "pp_comm": program([o for o in comm_ops if o[0] == "hop"])}
    if mode == "moe":
        programs["ep_comm"] = program([("inner",)] * (2 * M))
        programs["dp_ep_comm"] = program([("sync",)])
    else:
        programs["dp_comm"] = program([("sync",)])
        if mode == "3d":
            programs["tp_comm"] = program([("inner",)] * (2 * M))

    itemsize = torch.empty((), dtype=dtype).element_size()
    meta = {
        "proxy": MODES[mode],
        "model": stats.name,
        "world_size": world,
        "dp": dp, "num_stages": num_stages, "tp": tp,
        "num_expert_shards": num_expert_shards if mode == "moe" else 0,
        "num_microbatches": num_microbatches,
        "schedule": schedule,
        "ticks_per_direction": ticks_per_direction,
        # the clock in forward units: (1 + bwd) x (M+S-1) for gpipe and
        # 1f1b, the greedy table's weighted makespan for zb
        "ticks_total": (zb_unit_ticks(zb, bwd_units) if zb is not None
                        else (1.0 + bwd_units) * ticks_per_direction),
        "pp_permute_ticks": pp_permute_ticks,
        "pp_edge_messages": pp_edge_messages,
        "layers_per_stage": sched.layers_per_stage,
        "pipe_msg_bytes": int(pipe_elems * itemsize),
        "schedule_pipe_msg_bytes": int(sched.pipe_msg_elems
                                       * stats.bytes_per_element),
        "dp_sync_bytes": int(dp_elems * itemsize),
        "tp_msg_bytes": int(tp_elems * itemsize),
        "a2a_bytes": int(a2a_elems * itemsize),
        "fwd_us_per_stage_mb": sched.fwd_us_per_stage_mb * cfg.time_scale,
        "bwd_us_per_stage_mb": sched.bwd_us_per_stage_mb * cfg.time_scale,
        "burn_ns_per_iter": cal.ns_per_iter,
        # bytes each timed region moves a step
        "comm_model": {
            "pp_comm_time": [{"kind": "p2p", "group": num_stages,
                              "bytes": int(pp_hops * pipe_elems * itemsize)}],
            **({"ep_comm_time": [{"kind": "alltoall",
                                  "group": num_expert_shards,
                                  "bytes": int(ep_alltoalls * a2a_elems
                                               * itemsize)}],
                "dp_ep_comm_time": [
                    {"kind": "allreduce", "group": num_expert_shards,
                     "bytes": int(ne_elems * itemsize)},
                    {"kind": "allreduce", "group": dp,
                     "bytes": int(ex_elems * itemsize)}]}
               if mode == "moe" else
               {"dp_comm_time": [{"kind": "allreduce", "group": dp,
                                  "bytes": int(dp_elems * itemsize)}],
                **({"tp_comm_time": [
                    {"kind": "allreduce", "group": tp,
                     "bytes": int(tp_allreduces * tp_elems * itemsize)}]}
                   if mode == "3d" else {})}),
        },
        "mesh": describe_mesh(mesh),
        "size_scale": cfg.size_scale,
        "time_scale": cfg.time_scale,
    }
    progs = executor.compile_programs(programs, device, meta)
    burned = sum(o[3] for o in ops(True, False))
    return StepBundle(
        full=progs["full"], compute=progs["compute"], comm=progs["comm"],
        variants={k: v for k, v in progs.items()
                  if k not in ("full", "compute", "comm")},
        global_meta=meta, device=device,
        rank_meta={"burn": burnlib.plan(cal, burned)})
