"""Ring-attention (context-parallel) proxy — the JAX package's
``proxies/ring_attention.py`` (no reference counterpart: the reference
has no sequence parallelism).

The sequence is sharded over ``sp`` ranks; each attention layer burns
one KV block's attention and passes the block on around the ring
(``collectives.ring_shift``), so each rank sees all ``sp`` blocks in
``sp - 1`` hops, the compute waiting on each hop as the JAX program ties
its state to it.  The backward mirrors the ring with twice the compute;
the MLP burns between layers; with ``dp > 1`` a gradient allreduce over
dp closes the step.  KV block = 2 x B x (N/sp) x kv_dim elements
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
    sched = sequence_schedule(stats, card, sp)
    mesh = make_sp_mesh(sp, dp, device)
    sp_group, dp_group = mesh.groups[AXIS_SP], mesh.groups[AXIS_DP]
    burner = burnlib.Burner(device)
    cal = burnlib.calibrate(burner)

    # one burn per (layer, KV block); an MLP burn per layer
    attn_iters = cal.iters_for_us(sched.attn_us_per_block * cfg.time_scale)
    mlp_us_per_layer = (stats.ffn_fwd_us / max(sched.layers, 1)) / sp
    mlp_iters = cal.iters_for_us(mlp_us_per_layer * cfg.time_scale)
    layers = min(sched.layers, max_layers) if max_layers else sched.layers

    kv_elems = scaled_elems(sched.kv_block_elems, cfg.size_scale)
    grad_elems = scaled_elems(stats.model_size // max(sp, 1), cfg.size_scale)
    kv = Carry(kv_elems, dtype, device)
    grads = zeros(grad_elems, dtype, device)
    # forward, then the backward at twice the compute
    passes = [(attn_iters, mlp_iters)] * layers \
        + [(2 * attn_iters, 2 * mlp_iters)] * layers

    def make(with_compute: bool, with_comm: bool):
        def step():
            comm = col.CommStream(device)
            for attn, mlp in passes:
                for hop in range(sp):
                    if with_compute:
                        burner(attn)
                    if with_comm and hop < sp - 1:
                        comm.wait(kv.hop(comm, col.ring_shift, sp_group))
                if with_compute:
                    burner(mlp)
            if with_comm and dp > 1:
                comm.issue(col.allreduce, grads, group=dp_group)
            comm.wait_all()
        return step

    # one ring pass per layer forward and one backward (the backward
    # doubles the compute, not the hops)
    ring_shifts = layers * 2 * (sp - 1)

    def ring_only():
        comm = col.CommStream(device)
        for _ in range(ring_shifts):
            kv.hop(comm, col.ring_shift, sp_group)
        comm.wait_all()

    itemsize = torch.empty((), dtype=dtype).element_size()
    meta = {
        "proxy": "ring_attention",
        "model": stats.name,
        "world_size": world,
        "dp": dp, "sp": sp,
        "layers": layers,
        "seq_per_rank": sched.seq_per_rank,
        "kv_block_bytes": int(kv_elems * itemsize),
        "schedule_kv_block_bytes": int(sched.kv_block_elems
                                       * stats.bytes_per_element),
        "ring_hops_per_layer": sp - 1,
        "attn_us_per_block": sched.attn_us_per_block * cfg.time_scale,
        # the estimator behind attn_us_per_block: "ffn_stats" or
        # "even_split_fallback" (core/schedule.sequence_schedule)
        "attn_time_source": sched.attn_time_source,
        "burn_ns_per_iter": cal.ns_per_iter,
        "comm_model": {"ring_comm_time": [
            {"kind": "p2p", "group": sp,
             "bytes": int(ring_shifts * kv_elems * itemsize)}]},
        "mesh": describe_mesh(mesh),
        "size_scale": cfg.size_scale,
        "time_scale": cfg.time_scale,
    }
    progs = executor.compile_programs(
        {"full": make(True, True), "compute": make(True, False),
         "comm": make(False, True), "ring_comm": ring_only}, device, meta)
    return StepBundle(
        full=progs["full"], compute=progs["compute"], comm=progs["comm"],
        variants={"ring_comm": progs["ring_comm"]}, global_meta=meta,
        device=device, rank_meta={"burn": burnlib.plan(
            cal, sum(sp * a + m for a, m in passes))})
