"""Schema-v2 record emission (the JAX package's ``metrics/emit.py``).

One run becomes one self-describing JSON object:

    {"section": "<proxy>", "version": 2, "process": 0,
     "global": {..., "transport": "..."}, "mesh": {...},
     "num_runs": N, "warmup_times": [...],
     "ranks": [{"rank": 0, "device_id": ..., "<timer>": [...],
                "summary": {"<timer>": {"value", "best", "band", "n"}}}]}

The JAX package's ``metrics/parser.py`` reads these records as it reads
its own.  Not ported yet: the tuning, telemetry and attribution stamps.
"""
from __future__ import annotations

import json
import socket
import sys

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
    one-device run."""
    if mesh_info.get("num_devices", 1) <= 1:
        return "local"
    return mesh_info.get("platform") or "unknown"


def result_to_record(result: ProxyResult) -> dict:
    mesh_info = result.global_meta.get("mesh", {})
    devices = mesh_info.get("devices", [{"id": 0, "process": 0}])
    hostname = socket.gethostname()
    proc, num_procs = _process_identity()
    summary = {name: summarize(vals, ndigits=3)
               for name, vals in result.timers_us.items()}
    ranks = []
    for i, dev in enumerate(devices):
        row = {
            "rank": i,
            "device_id": dev.get("id", i),
            "process_index": dev.get("process", 0),
            "hostname": hostname,
        }
        row.update(result.timers_us)
        row["summary"] = dict(summary)
        ranks.append(row)
    g = {k: v for k, v in result.global_meta.items() if k != "mesh"}
    g.setdefault("transport", transport_label(mesh_info))
    if num_procs > 1:
        g.setdefault("num_processes", num_procs)
    return {
        "section": result.name,
        "version": SCHEMA_VERSION,
        "process": proc,
        "global": g,
        "mesh": {k: v for k, v in mesh_info.items() if k != "devices"},
        "num_runs": result.num_runs,
        "warmup_times": result.warmup_times_us,
        "ranks": ranks,
    }


def emit_result(result: ProxyResult, stream=None,
                path: str | None = None) -> dict:
    """Append the record as one JSON line to ``path`` (or write it to
    ``stream``, stdout by default); returns the record."""
    record = result_to_record(result)
    line = json.dumps(record)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
    else:
        (stream or sys.stdout).write(line + "\n")
    return record
