"""Ulysses (DeepSpeed-style) sequence-parallel proxy — the JAX package's
``proxies/ulysses.py`` (no reference counterpart).

Activations are sequence-sharded over ``sp`` ranks; each attention
layer reshards sequence -> heads with an all-to-all (every rank then
holds the full sequence for ``heads / sp`` heads), burns the attention
over the full sequence, and reshards back with a second all-to-all; the
MLP burns between layers, the compute waiting on each all-to-all as the
JAX program ties its state to it.  Two all-to-alls a layer forward, two
backward at twice the compute; with ``dp > 1`` a gradient allreduce
over dp.  Message = B x (N/sp) x d elements
(``core.schedule.sequence_schedule``).
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.core import executor
from dlnetbench_tpu_torch.core.model_card import ModelCard
from dlnetbench_tpu_torch.core.model_stats import ModelStats
from dlnetbench_tpu_torch.core.schedule import sequence_schedule
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.parallel.buffers import Carry, scaled_elems, zeros
from dlnetbench_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_SP,
                                                describe_mesh, make_sp_mesh)
from dlnetbench_tpu_torch.proxies import burn as burnlib
from dlnetbench_tpu_torch.proxies.base import ProxyConfig, StepBundle
from dlnetbench_tpu_torch.proxies.pipeline_common import _infer_dp


def build(stats: ModelStats, card: ModelCard, cfg: ProxyConfig,
          device: torch.device, *, sp: int, dp: int = 0,
          dtype=torch.float32, max_layers: int | None = None) -> StepBundle:
    world = multihost.world_size()
    dp = _infer_dp(world, sp, 1, dp, label="sp")
    if card.num_heads % sp != 0:
        raise ValueError(f"num_heads {card.num_heads} not divisible by "
                         f"sp={sp} (Ulysses shards the head axis)")
    sched = sequence_schedule(stats, card, sp)
    mesh = make_sp_mesh(sp, dp, device)
    sp_group, dp_group = mesh.groups[AXIS_SP], mesh.groups[AXIS_DP]
    burner = burnlib.Burner(device)
    cal = burnlib.calibrate(burner)

    # attention a layer: the full sequence x heads/sp, all sp blocks' worth
    attn_iters = cal.iters_for_us(sched.attn_us_per_block * sp
                                  * cfg.time_scale)
    mlp_us_per_layer = (stats.ffn_fwd_us / max(sched.layers, 1)) / sp
    mlp_iters = cal.iters_for_us(mlp_us_per_layer * cfg.time_scale)
    layers = min(sched.layers, max_layers) if max_layers else sched.layers

    a2a_elems = scaled_elems(sched.a2a_elems, cfg.size_scale)
    a2a_elems += (-a2a_elems) % sp  # divisible for the A2A split
    grad_elems = scaled_elems(stats.model_size // max(sp, 1), cfg.size_scale)
    acts = Carry(max(a2a_elems, sp), dtype, device)
    grads = zeros(grad_elems, dtype, device)
    passes = [(attn_iters, mlp_iters)] * layers \
        + [(2 * attn_iters, 2 * mlp_iters)] * layers

    def make(with_compute: bool, with_comm: bool):
        def step():
            comm = col.CommStream(device)
            for attn, mlp in passes:
                if with_comm:                     # seq -> heads
                    comm.wait(acts.hop(comm, col.alltoall, sp_group))
                if with_compute:
                    burner(attn)
                if with_comm:                     # heads -> seq
                    comm.wait(acts.hop(comm, col.alltoall, sp_group))
                if with_compute:
                    burner(mlp)
            if with_comm and dp > 1:
                comm.issue(col.allreduce, grads, group=dp_group)
            comm.wait_all()
        return step

    a2a_total = layers * 4  # 2 a layer forward + 2 backward

    def a2a_only():
        comm = col.CommStream(device)
        for _ in range(a2a_total):
            acts.hop(comm, col.alltoall, sp_group)
        comm.wait_all()

    itemsize = torch.empty((), dtype=dtype).element_size()
    meta = {
        "proxy": "ulysses",
        "model": stats.name,
        "world_size": world,
        "dp": dp, "sp": sp,
        "layers": layers,
        "seq_per_rank": sched.seq_per_rank,
        "a2a_bytes": int(a2a_elems * itemsize),
        "schedule_a2a_bytes": int(sched.a2a_elems * stats.bytes_per_element),
        "a2a_per_layer": 4,
        # the estimator behind the attention burn budget
        # (core/schedule.sequence_schedule)
        "attn_time_source": sched.attn_time_source,
        "burn_ns_per_iter": cal.ns_per_iter,
        "comm_model": {"a2a_comm_time": [
            {"kind": "alltoall", "group": sp,
             "bytes": int(a2a_total * a2a_elems * itemsize)}]},
        "mesh": describe_mesh(mesh),
        "size_scale": cfg.size_scale,
        "time_scale": cfg.time_scale,
    }
    progs = executor.compile_programs(
        {"full": make(True, True), "compute": make(True, False),
         "comm": make(False, True), "a2a_comm": a2a_only}, device, meta)
    return StepBundle(
        full=progs["full"], compute=progs["compute"], comm=progs["comm"],
        variants={"a2a_comm": progs["a2a_comm"]}, global_meta=meta,
        device=device, rank_meta={"burn": burnlib.plan(
            cal, sum(a + m for a, m in passes))})
