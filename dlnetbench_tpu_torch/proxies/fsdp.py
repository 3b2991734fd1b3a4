"""FSDP / ZeRO-3 proxy: prefetched unit allgathers and gradient
reduce-scatters, with optional hybrid-sharding replicas (the JAX
package's ``proxies/fsdp.py``).

Reference hot loop (cpp/data_parallel/fsdp.cpp:73-163):

    Allgather(unit 0)
    for u in 0..units-2:                      # forward
        Iallgather(unit u+1)                  # prefetch next unit
        usleep(fwd/units); Wait(u+1)          # compute hides the gather
    for u in units-1..1:                      # backward
        Iallgather(unit u-1)                  # prefetch previous unit
        usleep(bwd/units)
        Reduce_Scatter_block(unit u grads)
        [replicas>1] Iallreduce(shard u) on the replica comm
        Wait(u-1)
    unit 0 bwd + reduce-scatter [+ final allreduce]; WaitAll

World = sharding_factor x num_replicas over the ``(dp, tp)`` mesh.
Unit N-1 is still gathered when the backward starts, so a step makes
2N-1 gathers.  The gathered units live in a ping-pong pair allocated
at build time (unit u in buffer u % 2), so a step allocates nothing;
each unit's reduce-scatter writes its shard in place.
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.core import executor
from dlnetbench_tpu_torch.core.model_stats import ModelStats
from dlnetbench_tpu_torch.core.schedule import fsdp_schedule
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.parallel.buffers import scaled_elems, zeros
from dlnetbench_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_TP,
                                                describe_mesh,
                                                make_fsdp_mesh)
from dlnetbench_tpu_torch.proxies import burn as burnlib
from dlnetbench_tpu_torch.proxies.base import ProxyConfig, StepBundle


def build(stats: ModelStats, num_units: int, cfg: ProxyConfig,
          device: torch.device, sharding_factor: int | None = None,
          dtype=torch.float32) -> StepBundle:
    world = multihost.world_size()
    sched = fsdp_schedule(stats, num_units, world, sharding_factor)
    mesh = make_fsdp_mesh(sched.num_replicas, sched.sharding_factor, device)
    tp, dp = mesh.groups[AXIS_TP], mesh.groups[AXIS_DP]
    burner = burnlib.Burner(device)
    cal = burnlib.calibrate(burner)

    fwd_iters = cal.iters_for_us(sched.fwd_us_per_unit * cfg.time_scale)
    bwd_iters = cal.iters_for_us(sched.bwd_us_per_unit * cfg.time_scale)
    shard_elems = scaled_elems(sched.shard_size, cfg.size_scale)
    unit_elems = shard_elems * sched.sharding_factor
    has_replicas = sched.num_replicas > 1

    # per rank: one shard per unit (parameters, overwritten by the
    # unit's gradient shard) and the gathered ping-pong pair
    shards = [zeros(shard_elems, dtype, device) for _ in range(num_units)]
    units = [zeros(unit_elems, dtype, device) for _ in range(2)]

    def grad_sync(comm, u):
        """Reduce-scatter unit u's grads into its shard; cross-replica
        allreduce of the shard."""
        comm.issue(col.reduce_scatter, shards[u], units[u % 2], group=tp)
        if has_replicas:
            comm.issue(col.allreduce, shards[u], group=dp)

    def make(with_compute: bool, with_comm: bool):
        def burn(iters):
            if with_compute:
                burner(iters)

        def step():
            comm = col.CommStream(device)

            def gather(u):
                if not with_comm:
                    return None
                return comm.issue(col.allgather, units[u % 2], shards[u],
                                  group=tp)

            def wait(token):
                if token is not None:
                    comm.wait(token)

            # forward: gather unit 0, then prefetch u+1 under unit u
            full = gather(0)
            for u in range(num_units - 1):
                nxt = gather(u + 1)                   # issue before burn
                burn(fwd_iters)
                wait(full)                            # Wait(u)
                full = nxt
            burn(fwd_iters)                           # last unit fwd
            wait(full)
            # backward: unit N-1 still resident; prefetch u-1 under u
            for u in range(num_units - 1, 0, -1):
                prv = gather(u - 1)
                burn(bwd_iters)
                if with_comm:
                    grad_sync(comm, u)
                wait(prv)
            burn(bwd_iters)                           # unit 0 bwd
            if with_comm:
                grad_sync(comm, 0)
            comm.wait_all()                           # WaitAll
        return step

    def allgather_only():
        """N forward + N-1 backward gathers, as in the full step."""
        comm = col.CommStream(device)
        for u in [*range(num_units), *range(num_units - 2, -1, -1)]:
            comm.issue(col.allgather, units[u % 2], shards[u], group=tp)
        comm.wait_all()

    def reduce_scatter_only():
        comm = col.CommStream(device)
        for u in range(num_units - 1, -1, -1):
            grad_sync(comm, u)
        comm.wait_all()

    itemsize = torch.empty((), dtype=dtype).element_size()
    meta = {
        "proxy": "fsdp",
        "model": stats.name,
        "world_size": world,
        "num_units": num_units,
        "sharding_factor": sched.sharding_factor,
        "num_replicas": sched.num_replicas,
        "shard_bytes": int(shard_elems * itemsize),
        "schedule_shard_bytes": int(sched.shard_size
                                    * stats.bytes_per_element),
        "unit_bytes": int(unit_elems * itemsize),
        "fwd_us_per_unit": sched.fwd_us_per_unit * cfg.time_scale,
        "bwd_us_per_unit": sched.bwd_us_per_unit * cfg.time_scale,
        "burn_ns_per_iter": cal.ns_per_iter,
        # bytes per iteration per timed region: 2N-1 gathers of a full
        # unit; N reduce-scatters (+ N cross-replica shard allreduces)
        "comm_model": {
            "allgather_time": [
                {"kind": "allgather", "group": sched.sharding_factor,
                 "bytes": int((2 * num_units - 1) * unit_elems
                              * itemsize)}],
            "reduce_scatter_time": [
                {"kind": "reduce_scatter", "group": sched.sharding_factor,
                 "bytes": int(num_units * unit_elems * itemsize)}] + (
                [{"kind": "allreduce", "group": sched.num_replicas,
                  "bytes": int(num_units * shard_elems * itemsize)}]
                if has_replicas else []),
        },
        "mesh": describe_mesh(mesh),
        "size_scale": cfg.size_scale,
        "time_scale": cfg.time_scale,
    }
    progs = executor.compile_programs(
        {"full": make(True, True), "compute": make(True, False),
         "comm": make(False, True), "allgather": allgather_only,
         "reduce_scatter": reduce_scatter_only}, device, meta)
    return StepBundle(full=progs["full"], compute=progs["compute"],
                      comm=progs["comm"], global_meta=meta, device=device,
                      variants={"allgather": progs["allgather"],
                                "reduce_scatter": progs["reduce_scatter"]},
                      rank_meta={"burn": burnlib.plan(
                          cal, num_units * (fwd_iters + bwd_iters))})
