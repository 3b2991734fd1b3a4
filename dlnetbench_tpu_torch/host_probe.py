"""The host's part in two of the card's measurements, on one card:

    python -m dlnetbench_tpu_torch.host_probe

1. ``sleep``: how late ``time.sleep(0.02)`` wakes, against the fault
   injector's ``wait(0.02)`` (a sleep to ``SPIN_S`` short of the
   deadline, then a spin); 60 of each, median, p90 and max in µs.
2. ``delay``: the DP proxy at llama3_8b's stats, sizes and times scaled
   by 1e-3, six fenced runs under a 20 ms delay plan from the fourth
   (``tests/test_torch_card_faults.py``'s case); each of ``REPS`` runs
   gives the median inflation of the delayed runs over the clean ones,
   with the injector's ``wait`` and with a plain ``time.sleep`` in its
   place.
3. ``issue``: one full step of the MoE proxy at ``chip_smoke.py``'s
   proxy configuration (mixtral_8x7b, size scale 0.5, time scale 0.01,
   one stage, four microbatches): the host time to issue it and its
   share of the fenced step, 12 steps, each variant in a process of its
   own: NCCL's trace buffer at torch's 2000 entries, and at 0 (the
   port's default, ``multihost.quiet_nccl_trace``).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

REPS = 25
ISSUE_STEPS = 12
MOE_MODEL, MOE_SIZE_SCALE, MOE_TIME_SCALE = \
    "mixtral_8x7b_16_bfloat16", 0.5, 0.01


def _spread(us: list) -> str:
    us = sorted(us)
    return (f"median {statistics.median(us):.1f} p90 "
            f"{us[int(0.9 * len(us))]:.1f} max {us[-1]:.1f} us")


def sleep_overshoot() -> None:
    from dlnetbench_tpu_torch.faults import inject
    for name, fn in (("time.sleep", time.sleep),
                     ("inject.wait", inject.wait)):
        late = []
        for _ in range(60):
            t0 = time.perf_counter()
            fn(0.02)
            late.append((time.perf_counter() - t0 - 0.02) * 1e6)
        print(f"sleep: {name}(0.02) wakes late by {_spread(late)}",
              flush=True)


def delay_inflation(device) -> None:
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.faults import inject
    from dlnetbench_tpu_torch.faults.plan import FaultPlan
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig, run_proxy
    waits = (("inject.wait", inject.wait), ("time.sleep", time.sleep))
    try:
        for name, fn in waits:
            inject.wait = fn
            out = []
            for _ in range(REPS):
                bundle = dp.build(
                    load_model_stats("llama3_8b_16_bfloat16"), 2,
                    ProxyConfig(warmup=1, runs=6, size_scale=1e-3,
                                time_scale=1e-3), make_flat_mesh(device))
                plan = FaultPlan.from_dict({"events": [
                    {"kind": "delay", "iteration": 4,
                     "magnitude_us": 20000.0}]})
                rt = run_proxy("dp", bundle, ProxyConfig(
                    warmup=1, runs=6,
                    fault_injector=inject.FaultInjector(plan))
                ).timers_us["runtimes"]
                out.append(statistics.median(rt[3:])
                           - statistics.median(rt[:3]))
            print(f"delay: under {name}, a 20000 us delay inflates the "
                  f"step by {[round(x, 1) for x in sorted(out)]} us",
                  flush=True)
    finally:
        inject.wait = waits[0][1]


def issue_share(device) -> None:
    import torch

    from dlnetbench_tpu_torch.core.model_card import (
        arch_name_from_stats_name, load_model_card)
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.proxies import hybrid_3d_moe
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    bundle = hybrid_3d_moe.build(
        load_model_stats(MOE_MODEL),
        load_model_card(arch_name_from_stats_name(MOE_MODEL)),
        ProxyConfig(size_scale=MOE_SIZE_SCALE, time_scale=MOE_TIME_SCALE),
        device, num_expert_shards=1, num_stages=1, num_microbatches=4,
        dtype=torch.bfloat16)
    bundle.full()
    torch.cuda.synchronize()
    issue, share = [], []
    for _ in range(ISSUE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.full()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append(round((t1 - t0) * 1e3, 2))
        share.append(round((t1 - t0) / (time.perf_counter() - t0), 4))
    size = os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE")
    print(f"issue: NCCL trace buffer {size}: a MoE step's issue {issue} "
          f"ms, share of the fenced step {share} (median "
          f"{statistics.median(share):.4f})", flush=True)


def main(argv=None) -> int:
    from dlnetbench_tpu_torch.parallel import multihost
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] != ["--issue"]:
        sleep_overshoot()
        for size in ("2000", None):
            env = {k: v for k, v in os.environ.items()
                   if k not in multihost.NCCL_TRACE_VARS}
            if size is not None:
                env["TORCH_NCCL_TRACE_BUFFER_SIZE"] = size
            rc = subprocess.run([sys.executable, "-m", __spec__.name,
                                 "--issue"], env=env).returncode
            if rc != 0:
                return rc
    device = multihost.initialize("cuda")
    try:
        if argv[:1] == ["--issue"]:
            issue_share(device)
        else:
            delay_inflation(device)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
