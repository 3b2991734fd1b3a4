"""Schema-v2 record emission (the JAX package's ``metrics/emit.py``).

One run becomes one self-describing JSON object:

    {"section": "<proxy>", "version": 2, "process": 0,
     "global": {..., "transport": "..."}, "mesh": {...},
     "num_runs": N, "warmup_times": [...],
     "ranks": [{"rank": 0, "device_id": ..., "<timer>": [...],
                "summary": {"<timer>": {"value", "best", "band", "n"}}}]}

A proxy record written by rank 0 of a multi-process world carries each
rank's own timers in its row (``rank_timers_us``), beside the rank's
dict-valued ``rank_meta`` (its burn plan, the card's state), which the
parser reads no column from.  Such a record holds every rank's own
clocks, and its mesh header says so (``"gathered": true``, a key
neither package's parser makes a column of): ``metrics/merge.py`` takes
it as complete.  The JAX package's ``metrics/parser.py`` reads these
records as it reads its own.

A degraded run (a fault plan's shrink, ``faults/policy.py``) declares
the ranks left standing in ``global.degraded_world``: its rows are
theirs, each keeping its ORIGINAL rank id (row i is rank
``degraded_world[i]``), and the dead ranks' timers and meta, gathered
with the rest, are left out.

With the flight recorder on (``metrics/telemetry.py``) the record
stamps ``global.telemetry`` (this process's ring geometry and tail:
rank 0's on a multi-rank run) and, when anything fired,
``global.anomalies``: every rank's anomaly blocks pooled (counts by
trigger, the last 16 events, each tagged with its ``rank``), as the
JAX package's ``metrics/merge.py`` pools processes.  With it off
nothing is stamped: the record is byte for byte what a build without
the recorder writes.

Every record is stamped last with ``global.attribution``
(``analysis/attribution.attribute_record``; a serving record's from its
dispatch decomposition): the fractions of the wall-clock spent in
compute, HBM, exposed communication and the host, and the verdict word
of the hardware that ran it (``sm``, ``nvlink``, ``network``,
``host``).  It is derived data: a failure to stamp it is printed and
never costs the measurement.  ``global.tuning`` (``stamp_tuning``) says
which tuned configs the process's kernels and SPMD knobs ran under, and
is absent when nothing consulted the tuning DB.
"""
from __future__ import annotations

import json
import socket
import sys

from dlnetbench_tpu_torch.metrics import telemetry
from dlnetbench_tpu_torch.metrics.stats import summarize
from dlnetbench_tpu_torch.proxies.base import ProxyResult

SCHEMA_VERSION = 2


def scheduler_variables(environ=None) -> dict:
    """Job variables from the launcher's environment: ``DLNB_TAG_<k>=v``
    tags and the scheduler identity variables, hoisted by the parser to
    DataFrame columns.  Explicit ``--tag`` flags override them."""
    import os
    env = os.environ if environ is None else environ
    out = {}
    for k, v in env.items():
        if k.startswith("DLNB_TAG_") and v:
            out[k[len("DLNB_TAG_"):].lower()] = v
    for k in ("SLURM_JOB_ID", "SLURM_PROCID", "SLURM_NNODES",
              "JOB_COMPLETION_INDEX"):
        if env.get(k):
            out[k.lower()] = env[k]
    return out


def _process_identity() -> tuple[int, int]:
    """(this process's rank, process count) from ``torch.distributed``
    when a process group is up; (0, 1) otherwise."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def transport_label(mesh_info: dict) -> str:
    """What timed bytes moved over: nothing but the device itself for a
    one-device run, loopback between CPU processes (gloo), NCCL between
    the cards of one host, NCCL with a network leg across hosts."""
    if mesh_info.get("num_devices", 1) <= 1:
        return "local"
    platform = mesh_info.get("platform")
    if platform == "cpu":
        return "virtual-host"
    if platform == "gpu":
        return ("nccl+network" if mesh_info.get("num_hosts", 1) > 1
                else "nccl")
    return platform or "unknown"


def stamp_attribution(record: dict) -> dict:
    """Stamp ``global.attribution`` on ``record`` (in place; returned)
    when its samples can be attributed.  Derived data: a failure is
    printed and leaves the record as it was."""
    try:
        from dlnetbench_tpu_torch.analysis.attribution import \
            attribute_record
        block = attribute_record(record)
        if block is not None:
            record["global"]["attribution"] = block
    except Exception as e:
        print(f"attribution stamping failed ({type(e).__name__}: {e}); "
              f"record unaffected", file=sys.stderr)
    return record


def stamp_tuning(g: dict) -> dict:
    """Stamp ``tuning``, the process's consult provenance
    (``tuning.provenance``: ``{db_dir, hits, misses, sites}``), into the
    global block ``g`` (in place; returned).  Nothing is stamped when no
    tunable site consulted (tuning off, or no site on the path), so an
    untuned record is byte for byte a build's without the tuner.  It is
    derived data: a failure to stamp it is printed and never costs the
    measurement."""
    try:
        from dlnetbench_tpu_torch import tuning
        prov = tuning.provenance()
        if prov is not None:
            g.setdefault("tuning", prov)
    except Exception as e:
        print(f"tuning provenance stamping failed ({type(e).__name__}: "
              f"{e}); record unaffected", file=sys.stderr)
    return g


def pool_anomalies(rank_blocks: list) -> dict | None:
    """Every rank's ``anomalies_block`` (None where a rank's run was
    clean), in rank order, as one block: counts summed by trigger, the
    last 16 events, each tagged with its ``rank``; None when no rank
    saw an anomaly."""
    counts: dict[str, int] = {}
    events: list[dict] = []
    for r, block in enumerate(rank_blocks):
        if not block:
            continue
        for k, v in (block.get("triggers") or {}).items():
            counts[k] = counts.get(k, 0) + int(v)
        events += [{**ev, "rank": r} for ev in block.get("events") or []]
    if not counts:
        return None
    return {"count": sum(counts.values()), "triggers": counts,
            "events": events[-16:]}


def result_to_record(result: ProxyResult,
                     rank_timers_us: list | None = None,
                     rank_meta: list | None = None,
                     rank_anomalies: list | None = None) -> dict:
    """The record of ``result``; ``rank_timers_us`` holds every rank's
    own timers in rank order (None: ``result.timers_us`` on every row),
    ``rank_meta`` every rank's dict-valued meta (None: none),
    ``rank_anomalies`` every rank's ``anomalies_block`` (None: this
    process's own, unpooled).  Under ``degraded_world`` the first two
    may hold the whole world's, of which the survivors' are kept."""
    mesh_info = result.global_meta.get("mesh", {})
    devices = mesh_info.get("devices", [{"id": 0, "process": 0}])
    hostname = socket.gethostname()
    proc, num_procs = _process_identity()
    rank_ids = result.global_meta.get("degraded_world")
    if rank_ids is not None:
        if len(rank_ids) != len(devices):
            raise ValueError(
                f"degraded_world names {len(rank_ids)} survivors but the "
                f"mesh has {len(devices)} devices — the shrink rebuild "
                f"and the plan disagree")
        world = result.global_meta.get("world_size")
        if rank_timers_us is not None and len(rank_timers_us) == world:
            rank_timers_us = [rank_timers_us[r] for r in rank_ids]
        if rank_meta is not None and len(rank_meta) == world:
            rank_meta = [rank_meta[r] for r in rank_ids]
    if rank_timers_us is not None and len(rank_timers_us) != len(devices):
        raise ValueError(f"{len(rank_timers_us)} ranks' timers for "
                         f"{len(devices)} devices")
    ranks = []
    for i, dev in enumerate(devices):
        timers = (rank_timers_us[i] if rank_timers_us is not None
                  else result.timers_us)
        row = {
            "rank": int(rank_ids[i]) if rank_ids is not None else i,
            "device_id": dev.get("id", i),
            "process_index": dev.get("process", 0),
            "hostname": dev.get("hostname", hostname),
        }
        if rank_meta is not None:
            row.update(rank_meta[i])
        row.update(timers)
        row["summary"] = {name: summarize(vals, ndigits=3)
                          for name, vals in timers.items()}
        ranks.append(row)
    g = {k: v for k, v in result.global_meta.items() if k != "mesh"}
    g.setdefault("transport", transport_label(mesh_info))
    stamp_tuning(g)
    rec_now = telemetry.current()
    if rec_now is not None:
        g.setdefault("telemetry", rec_now.telemetry_block())
        anom = (rec_now.anomalies_block() if rank_anomalies is None
                else pool_anomalies(rank_anomalies))
        if anom is not None:
            g.setdefault("anomalies", anom)
    if num_procs > 1:
        g.setdefault("num_processes", num_procs)
    mesh = {k: v for k, v in mesh_info.items() if k != "devices"}
    if rank_timers_us is not None:
        mesh["gathered"] = True
    return stamp_attribution({
        "section": result.name,
        "version": SCHEMA_VERSION,
        "process": proc,
        "global": g,
        "mesh": mesh,
        "num_runs": result.num_runs,
        "warmup_times": result.warmup_times_us,
        "ranks": ranks,
    })


def emit_result(result: ProxyResult, stream=None, path: str | None = None,
                rank_timers_us: list | None = None,
                rank_meta: list | None = None,
                rank_anomalies: list | None = None) -> dict:
    """Append the record as one JSON line to ``path`` (or write it to
    ``stream``, stdout by default); returns the record."""
    record = result_to_record(result, rank_timers_us, rank_meta,
                              rank_anomalies)
    line = json.dumps(record)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
    else:
        (stream or sys.stdout).write(line + "\n")
    return record
