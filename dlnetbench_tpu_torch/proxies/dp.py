"""Data-parallel proxy: bucketed gradient allreduce overlapped with the
backward (the JAX package's ``proxies/dp.py``).

Reference hot loop (cpp/data_parallel/dp.cpp:87-106):

    usleep(fwd)                         # simulated forward
    for each bucket i:
        usleep(bwd / num_buckets)       # simulated bucket backward
        Iallreduce(bucket i)            # async, request/stream i
    WaitAll                             # timed: exposed comm ("barrier")

Here the burn plays the compute on the current stream and each bucket's
allreduce is issued on the comm stream after that bucket's burn, so it
runs beside every burn that follows; the step ends with the compute
stream waiting on all of them (``parallel/collectives.CommStream``).
The bundle declares its checkpointable state as the JAX package's does:
the gradient buckets and the burn's state (``{"grads": [...],
"burn_state": ...}``).
"""
from __future__ import annotations

import torch

from dlnetbench_tpu_torch.core import executor
from dlnetbench_tpu_torch.core.model_stats import ModelStats
from dlnetbench_tpu_torch.core.schedule import dp_schedule
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel.buffers import scaled_elems, zeros
from dlnetbench_tpu_torch.parallel.mesh import (AXIS_FLAT, Mesh,
                                                describe_mesh)
from dlnetbench_tpu_torch.proxies import burn as burnlib
from dlnetbench_tpu_torch.proxies.base import ProxyConfig, StepBundle


def build(stats: ModelStats, num_buckets: int, cfg: ProxyConfig,
          mesh: Mesh, dtype=torch.float32) -> StepBundle:
    device = mesh.device
    world = mesh.size
    group = mesh.groups[AXIS_FLAT]
    sched = dp_schedule(stats, num_buckets)
    burner = burnlib.Burner(device)
    cal = burnlib.calibrate(burner)

    fwd_iters = cal.iters_for_us(sched.fwd_us * cfg.time_scale)
    bwd_iters = cal.iters_for_us(sched.bwd_us_per_bucket * cfg.time_scale)
    bucket_elems = [scaled_elems(s, cfg.size_scale)
                    for s in sched.bucket_sizes]
    # every rank holds every bucket (allreduce semantics, dp.cpp:227-232)
    grads = [zeros(e, dtype, device) for e in bucket_elems]

    def make(with_compute: bool, with_comm: bool):
        def step():
            comm = col.CommStream(device)
            if with_compute:
                burner(fwd_iters)
            for g in grads:
                if with_compute:
                    burner(bwd_iters)
                if with_comm:
                    comm.issue(col.allreduce, g, group=group)
            comm.wait_all()                       # WaitAll (dp.cpp:191)
        return step

    itemsize = torch.empty((), dtype=dtype).element_size()
    bucket_bytes = [int(e * itemsize) for e in bucket_elems]
    meta = {
        "proxy": "dp",
        "model": stats.name,
        "world_size": world,
        "num_buckets": num_buckets,
        "bucket_bytes": bucket_bytes,
        "schedule_bucket_bytes": sched.bucket_bytes,
        "fwd_us": sched.fwd_us * cfg.time_scale,
        "bwd_us_per_bucket": sched.bwd_us_per_bucket * cfg.time_scale,
        "burn_ns_per_iter": cal.ns_per_iter,
        # bytes the comm-only variant moves per iteration (the exposed
        # barrier_time shrinks with overlap and bounds no link)
        "comm_model": {"comm_time": [
            {"kind": "allreduce", "group": world,
             "bytes": sum(bucket_bytes)}]},
        "mesh": describe_mesh(mesh),
        "size_scale": cfg.size_scale,
        "time_scale": cfg.time_scale,
    }
    progs = executor.compile_programs(
        {"full": make(True, True), "compute": make(True, False),
         "comm": make(False, True)}, device, meta)
    return StepBundle(full=progs["full"], compute=progs["compute"],
                      comm=progs["comm"], global_meta=meta, device=device,
                      rank_meta={"burn": burnlib.plan(
                          cal, fwd_iters + num_buckets * bwd_iters)},
                      # what a dp trainer of this schedule would snapshot
                      state={"grads": grads, "burn_state": burner.state})
