"""A proxy record's headline numbers: the legs, each timed region's
bandwidth and the pipeline bubble.

    python -m dlnetbench_tpu_torch.proxy_summary RECORD.jsonl [...]

For each record (rank 0's line of a ``cli`` proxy run) prints one JSON
line: the median over runs of each rank's ``runtimes``,
``compute_time``, ``barrier_time`` and ``comm_time`` and of every
region its ``comm_model`` names (``pp_comm_time``, ``ep_comm_time``,
...), the slowest rank's median in ms; each region's bytes over that
time as algorithm bandwidth and as bus bandwidth (NCCL's factors:
allreduce 2(n-1)/n, all-to-all, allgather and reduce-scatter (n-1)/n,
a hop 1: ``analysis/bandwidth.bus_factor``) — for the pipeline's hops also ``hop_GBps``, one message's
bytes times the hop ticks over the time, the rate of one edge were the
ticks one after another (above one edge's rate where the two
directions overlap); and ``runtime / compute`` beside the schedule's
own bubble, ``ticks_total / (M x (1 + bwd/fwd))`` for a pipeline ((M+S-1)/M for
gpipe and 1f1b, (3M+S-1)/3M for zb) and 1 elsewhere.  The card's name
and the world come from the record.  A faulted record (``--fault``)
adds ``fault``: its fault globals (``FAULT_KEYS``) and the straggler
amplification (``analysis/bandwidth.straggler_amplification``).
"""
from __future__ import annotations

import json
import statistics
import sys

from dlnetbench_tpu_torch.analysis.bandwidth import (bus_factor,
                                                     straggler_amplification)

FAULT_KEYS = ("fault_policy", "fault_injected_delay_us", "degraded_world",
              "fault_iteration", "detection_ms", "recovery_ms",
              "restore_ms", "lost_steps", "rejoin_ms", "fault_rejoin_step",
              "goodput", "goodput_useful_steps", "goodput_wall_s",
              "checkpoint_mode", "checkpoint_backend", "checkpoint_saves",
              "checkpoint_ms", "checkpoint_stall_ms",
              "checkpoint_ms_samples", "checkpoint_state_bytes",
              "checkpoint_drain_saved")


def _ms(rec: dict, timer: str) -> float:
    """The slowest rank's median of ``timer``, in ms."""
    return max(statistics.median(r[timer]) for r in rec["ranks"]) / 1e3


def summarize(rec: dict) -> dict:
    g = rec["global"]
    out = {"proxy": g["proxy"], "model": g["model"],
           "world": g["world_size"], "device": rec["mesh"]["device_kind"],
           "schedule": g.get("schedule")}
    for t in ("runtimes", "compute_time", "barrier_time", "comm_time"):
        out[f"{t}_ms"] = _ms(rec, t)
    for region, parts in g["comm_model"].items():
        ms = _ms(rec, region)
        nbytes = sum(p["bytes"] for p in parts)
        bus = sum(p["bytes"] * bus_factor(p["kind"], p["group"])
                  for p in parts)
        out[region] = {"ms": ms, "bytes": nbytes,
                       "algbw_GBps": nbytes / ms / 1e6 if ms else None,
                       "busbw_GBps": bus / ms / 1e6 if ms else None}
    if "pp_permute_ticks" in g and out["pp_comm_time"]["ms"]:
        out["pp_comm_time"]["hop_GBps"] = (
            g["pipe_msg_bytes"] * g["pp_permute_ticks"]
            / out["pp_comm_time"]["ms"] / 1e6)
    out["bubble"] = out["runtimes_ms"] / out["compute_time_ms"]
    if "ticks_total" in g:
        bwd_units = g["bwd_us_per_stage_mb"] / g["fwd_us_per_stage_mb"]
        out["bubble_model"] = g["ticks_total"] / (
            g["num_microbatches"] * (1 + bwd_units))
    else:
        out["bubble_model"] = 1.0
    if "fault_plan" in g:
        out["fault"] = {k: g[k] for k in FAULT_KEYS if k in g}
        amp = straggler_amplification(rec)
        out["fault"]["straggler_amp"] = None if amp != amp else amp
        out["fault"]["ranks"] = [r["rank"] for r in rec["ranks"]]
    return out


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    print(json.dumps(summarize(json.loads(line))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
