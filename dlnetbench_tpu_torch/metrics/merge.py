"""Merge one-record-per-process multi-host outputs into a single record
(the port's copy of the JAX package's ``metrics/merge.py``).

The JAX package's multi-controller runtime has one *process* per host:
each process measures its own wall-clock timers and emits one record
whose rank rows cover every device of the global mesh — but only the
rows of the emitting process carry that process's real measurements.
``merge_records`` keeps from each record exactly the rows measured by
the emitting process and returns one record with true per-process
timers.  Rank coverage and process coverage are validated; mismatched
schedule metadata aborts the merge (records from different runs must
never silently combine).

On ``torch.distributed`` rank 0 gathers every rank's own timers into
one record (``metrics/emit.py``), whose mesh header says so
(``"gathered": true``).  Such a record is complete: merged alone it
gives itself back, its attribution stamped again over every row; it
never merges with another record.

CLI:  python -m dlnetbench_tpu_torch.metrics.merge [--section NAME]
          [--trace-out TRACE.json] out.jsonl in0.jsonl in1.jsonl ...
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from dlnetbench_tpu_torch.metrics.parser import load_records, validate_record

# global keys that legitimately differ between the emitting processes
# of one run: per-process measurements and host-local identity — never
# evidence of records from different runs.  Plans (fault_plan,
# arrival_plan, degraded_world, fault_rejoin_step), the sampling
# identity, kv_cache_dtype, disaggregated and fleet_routing /
# fleet_replicas are run IDENTITY and stay comparable.
_VOLATILE_GLOBALS = {"energy_source", "energy_scope", "burn_ns_per_iter",
                     "cache_hits", "cache_misses", "tcp_bytes_sent",
                     # the per-process share of an uneven-locals run
                     "local_world",
                     # per-process fault measurements: each process
                     # detects, recovers and counts on its own clock
                     "detection_ms", "recovery_ms", "fault_drops",
                     "fault_retries", "fault_injected_delay_us",
                     "fault_iteration", "watchdog_heartbeat_age_s",
                     "watchdog_stalls", "watchdog_stall_spans",
                     # elastic-recovery measurements, per process
                     "rejoin_ms", "checkpoint_ms", "checkpoint_stall_ms",
                     "checkpoint_ms_samples", "checkpoint_saves",
                     "checkpoint_drain_saved", "restore_ms",
                     "lost_steps", "goodput", "goodput_useful_steps",
                     "goodput_wall_s", "last_checkpoint_age_s",
                     "last_checkpoint_step",
                     # each process times its own fence RTT, profiles
                     # its own device ops, and attributes its own
                     # clocks; the merged record gets attribution
                     # recomputed over the pooled rows below
                     "host_rtt_us", "attribution", "device_top_ops",
                     # serving measurements: each process clocks its
                     # own requests; prefix-hit statistics depend on
                     # arrival timing against engine speed
                     "serving", "prefix_hit_rate", "prefix_bytes_saved",
                     "spec_acceptance_by_temp",
                     # tuning provenance: per-process warm state
                     "tuning",
                     # telemetry: each process's own ring and anomalies
                     # (pooled below)
                     "telemetry", "anomalies",
                     "watchdog_stall_telemetry",
                     # MoE and fleet measurements, per process
                     "moe", "fleet",
                     # the native nccl fabric's per-process counters and
                     # each process's own cards
                     "h2d_copies", "d2h_copies", "timed_copies", "twins",
                     "late_twins", "burn_launches", "burn_iters",
                     "burn_fixed_ns", "burn_requested_us", "burn_device_us",
                     "devices"}

# scheduler-stamped variables that identify the PROCESS, not the run
# (metrics.emit.scheduler_variables): they legitimately differ between
# the per-host records of one run and must not abort the merge, while
# genuine sweep-axis variables still must match
_PER_PROCESS_VARIABLES = {"slurm_procid", "tpu_worker_id",
                          "job_completion_index", "megascale_slice_id"}


def _comparable_global(g: dict) -> dict:
    out = {k: v for k, v in g.items() if k not in _VOLATILE_GLOBALS}
    if isinstance(out.get("variables"), dict):
        out["variables"] = {k: v for k, v in out["variables"].items()
                            if k not in _PER_PROCESS_VARIABLES}
        if not out["variables"]:
            del out["variables"]
    return out


def is_gathered(rec: dict) -> bool:
    """Does ``rec`` hold every rank's own clocks (the port's gathered
    record, marked in its mesh header by ``metrics/emit.py``)?"""
    return bool((rec.get("mesh") or {}).get("gathered"))


def merge_records(records: list[dict]) -> dict:
    """Combine per-process records of ONE run into a single record.

    Each input record contributes the rank rows whose ``process_index``
    equals its emitting ``process`` (every process measures only its own
    clock).  The result carries the union of rows, per-process warmup
    times, and process-0's globals.  A gathered record (``is_gathered``)
    is complete already: alone it merges to itself, with attribution
    stamped again over its rows.
    """
    if not records:
        raise ValueError("merge_records: no records given")
    if any(is_gathered(r) for r in records):
        if len(records) != 1:
            raise ValueError(
                "merge_records: a gathered record holds every rank's own "
                "clocks — merge it alone, never with another record")
        validate_record(records[0])
        merged = {**records[0], "global": dict(records[0]["global"])}
        _stamp_attribution(merged)
        return merged
    by_process: dict[int, dict] = {}
    for rec in records:
        proc = rec.get("process", 0)
        if proc in by_process:
            raise ValueError(
                f"merge_records: two records claim process {proc} — inputs "
                f"must be one record per process of one run")
        by_process[proc] = rec

    base = by_process.get(0)
    if base is None:
        # degraded pathway (fault-plan shrink runs): rank 0's process
        # may BE the scripted victim — record-less by design.  Accept
        # the lowest surviving process as the base iff the survivors
        # themselves declare the degradation; anything else is still a
        # missing host.
        first = by_process[min(by_process)]
        if first["global"].get("degraded_world") is None:
            raise ValueError("merge_records: no record from process 0")
        base = first
    want = _comparable_global(base["global"])
    for proc, rec in sorted(by_process.items()):
        if rec.get("section") != base.get("section"):
            raise ValueError(
                f"merge_records: section mismatch "
                f"({rec.get('section')!r} vs {base.get('section')!r})")
        if _comparable_global(rec["global"]) != want:
            diff = {k for k in set(want) | set(_comparable_global(rec["global"]))
                    if want.get(k) != rec["global"].get(k)}
            raise ValueError(
                f"merge_records: process {proc} global metadata differs on "
                f"{sorted(diff)} — records are not from the same run")
        if rec.get("num_runs") != base.get("num_runs"):
            raise ValueError(
                f"merge_records: process {proc} ran {rec.get('num_runs')} "
                f"iterations, process 0 ran {base.get('num_runs')}")
        # v1 and v2 records both merge, but never with each other — a
        # mixed set means the hosts ran different harness builds, and
        # half the merged rows would silently lack their band summaries
        if rec.get("version") != base.get("version"):
            raise ValueError(
                f"merge_records: process {proc} emitted schema version "
                f"{rec.get('version')}, process 0 emitted "
                f"{base.get('version')} — records are from different "
                f"harness builds")

    declared = base["global"].get("num_processes")
    degraded = base["global"].get("degraded_world")
    if declared is not None and sorted(by_process) != list(range(declared)):
        if degraded is None:
            raise ValueError(
                f"merge_records: have records from processes "
                f"{sorted(by_process)}, expected range({declared}) — a "
                f"host's output is missing")
        # shrink run: dead ranks' processes emit nothing.  The survivor
        # records must still jointly cover degraded_world exactly (the
        # final validate_record), so a missing SURVIVOR is still caught.
        if any(p < 0 or p >= declared for p in by_process):
            raise ValueError(
                f"merge_records: process ids {sorted(by_process)} outside "
                f"range({declared})")

    ranks = []
    for proc, rec in sorted(by_process.items()):
        local = [row for row in rec.get("ranks", [])
                 if row.get("process_index", 0) == proc]
        if not local:
            raise ValueError(
                f"merge_records: process {proc}'s record has no rows for "
                f"its own process_index")
        ranks.extend(local)

    # energy_consumed brackets a HOST counter (RAPL/hwmon), but every
    # process's designated rank records it — with several processes per
    # host (the --procs N hier runs, co-hosted congestion pairs) the
    # merged record would carry the host's energy once per process and
    # Pareto/average analyses would double-count.  Keep one energy row
    # per hostname: the lowest (process, rank) wins, the rest drop the
    # key.  Rows without a hostname are conservatively left alone.
    seen_hosts: set = set()
    for row in sorted(ranks, key=lambda r: (r.get("process_index", 0),
                                            r.get("rank", 0))):
        if "energy_consumed" not in row:
            continue
        host = row.get("hostname")
        if host is None:
            continue
        if host in seen_hosts:
            del row["energy_consumed"]
            # the v2 band summary is the channel readers are told to
            # consume — it must not keep reporting the deduped energy
            if isinstance(row.get("summary"), dict):
                row["summary"].pop("energy_consumed", None)
        else:
            seen_hosts.add(host)

    ranks.sort(key=lambda row: row["rank"])

    merged = {k: v for k, v in base.items() if k != "ranks"}
    merged["ranks"] = ranks
    merged["warmup_times_by_process"] = {
        str(proc): rec.get("warmup_times", [])
        for proc, rec in sorted(by_process.items())
    }
    validate_record(merged)
    # anomalies pooled over the processes: each process's
    # flight recorder detects on its own clock, and an anomaly anywhere
    # in the fleet matters — base-process-only globals would silently
    # drop a straggler's step_time trigger recorded on another host.
    # Events keep their origin via a "process" tag; the telemetry RING
    # stays per-process (process 0's block) like every other volatile.
    pooled_events, pooled_counts = [], {}
    for proc, rec in sorted(by_process.items()):
        anom = rec["global"].get("anomalies")
        if not isinstance(anom, dict):
            continue
        for k, v in (anom.get("triggers") or {}).items():
            pooled_counts[k] = pooled_counts.get(k, 0) + int(v)
        for ev in anom.get("events") or []:
            pooled_events.append({**ev, "process": proc})
    if pooled_counts:
        merged["global"] = dict(merged["global"])
        merged["global"]["anomalies"] = {
            "count": sum(pooled_counts.values()),
            "triggers": pooled_counts,
            "events": pooled_events[-16:]}
    _stamp_attribution(merged)
    return merged


def _stamp_attribution(merged: dict) -> None:
    """Attribution over the POOLED rows (each per-process record's block
    covered only its own clocks; a native record carries none).  Derived
    data: a failure must never abort a merge of valid measurements."""
    try:
        from dlnetbench_tpu_torch.analysis.attribution import attribute_record
        merged["global"] = dict(merged["global"])
        block = attribute_record(merged)
        if block is not None:
            merged["global"]["attribution"] = block
        else:
            merged["global"].pop("attribution", None)
    except Exception as e:  # pragma: no cover - defensive
        print(f"merge attribution failed ({type(e).__name__}: {e}); "
              f"merged record keeps its inputs", file=sys.stderr)


def merge_files(out_path: str | Path, in_paths: list[str | Path],
                section: str | None = None) -> dict:
    """Load one record per input file (per process), merge, append the
    merged record to ``out_path``."""
    records = []
    for p in in_paths:
        recs = load_records(p, section)
        if len(recs) != 1:
            raise ValueError(
                f"{p}: expected exactly one record"
                f"{f' for section {section!r}' if section else ''}, "
                f"found {len(recs)} — merge one run at a time")
        records.append(recs[0])
    merged = merge_records(records)
    with open(out_path, "a") as f:
        f.write(json.dumps(merged) + "\n")
    return merged


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m dlnetbench_tpu_torch.metrics.merge "
             "[--section NAME] [--trace-out TRACE.json] "
             "OUT.jsonl IN0.jsonl IN1.jsonl ...")
    section = None
    trace_out = None
    while args and args[0] in ("--section", "--trace-out", "--trace_out"):
        if len(args) < 2:
            print(usage, file=sys.stderr)
            return 2
        if args[0] == "--section":
            section = args[1]
        else:
            trace_out = args[1]
        args = args[2:]
    if len(args) < 2:
        print(usage, file=sys.stderr)
        return 2
    merged = merge_files(args[0], args[1:], section)
    print(f"merged {len(args) - 1} process record(s): "
          f"{merged['section']}, {len(merged['ranks'])} ranks "
          f"-> {args[0]}", file=sys.stderr)
    if trace_out:
        # the record's per-rank timers, band summaries and (post-merge)
        # attribution block as Perfetto counter/duration tracks
        from dlnetbench_tpu_torch.metrics import spans
        try:
            spans.write_chrome_trace(
                trace_out, None, align_span=None,
                extra_events=spans.record_track_events(merged))
            print(f"record trace -> {trace_out}", file=sys.stderr)
        except OSError as e:
            print(f"trace-out write failed ({e}); merged record "
                  f"unaffected", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
