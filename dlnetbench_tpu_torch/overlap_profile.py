"""Rank 0's per-op breakdown of one full step of each config of the
overlap line (``models/overlap_bench.build_programs``: the blocking
baseline and ``tp_overlap="decomposed"`` + ``grad_sync="bucketed"``)
under ``torch.profiler``, at the bench's SPMD shape on the cards or
``CARD_TINY`` on the CPU:

    torchrun --nproc_per_node 4 -m dlnetbench_tpu_torch.overlap_profile
    torchrun --nproc_per_node 2 -m dlnetbench_tpu_torch.overlap_profile --cpu

Each config runs two warm steps, a barrier, then one profiled step.
The rows are ``key_averages()`` by self device time (self CPU time with
``--cpu``), the largest 14.  They hold both the host-side ops (an
``aten::`` op, ``nccl:*``, ``record_param_comms``, an autograd node)
with the device time of the kernels they launched, and the kernels
themselves, so a kernel's time appears under its op and again on its
own row: the printed sum counts it twice and is no device busy time.
"""
from __future__ import annotations

import sys

import torch

ROWS = 14


def main(argv=None) -> int:
    from dlnetbench_tpu_torch.entry import BENCH_SPMD, CARD_TINY
    from dlnetbench_tpu_torch.models import overlap_bench, spmd
    from dlnetbench_tpu_torch.parallel import multihost
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    device = multihost.initialize("cpu" if cpu else "cuda")
    try:
        mesh = spmd.grid_mesh(*spmd.factor_mesh(multihost.world_size()),
                              device)
        _, programs, params, tokens = overlap_bench.build_programs(
            mesh, dict(CARD_TINY if cpu else BENCH_SPMD))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if not cpu:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        key = "self_cpu_time_total" if cpu else "self_device_time_total"
        for name in ("baseline", "overlapped"):
            fn = programs[name]["full"]
            for _ in range(2):
                fn(params, tokens)
            multihost.barrier(device)
            with torch.profiler.profile(activities=acts) as prof:
                fn(params, tokens)
                if not cpu:
                    torch.cuda.synchronize()
            if multihost.rank() != 0:
                continue
            ka = prof.key_averages()
            tot = sum(getattr(e, key) for e in ka)
            print(f"=== {name}: sum over ops and kernels {tot / 1e3:.1f} "
                  f"ms ({key})", flush=True)
            for e in sorted(ka, key=lambda e: -getattr(e, key))[:ROWS]:
                print(f"{getattr(e, key) / 1e3:9.2f} ms {e.count:6d}  "
                      f"{e.key[:110]}", flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
