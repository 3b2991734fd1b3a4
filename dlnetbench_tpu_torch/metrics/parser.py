"""Metrics parsing: JSON-lines run records -> pandas DataFrames (the
port's copy of the JAX package's ``metrics/parser.py``, which reads the
records of either package alike).

``load_records`` reads a JSON-lines file; ``validate_record`` checks that
every rank and every declared process reported (a degraded record's
declared survivor set instead); ``records_to_dataframe`` makes one row
per rank x run with ``runtime`` and the per-collective timers, the
globals and job variables as columns, and the groupby-grade columns of
the dict-valued globals (``attr_bound``, ``anomaly_count``, ``tuned``,
``moe_*``, ``serving_*``, ``fleet_*``).  pandas is imported only by the
DataFrame functions.
"""
from __future__ import annotations

import json
from pathlib import Path

# non-timer per-rank keys; "summary" is the schema-v2 per-timer band
# summaries (dict, not a sample array — must never be iterated as runs)
_TIMER_KEYS_EXCLUDE = {"rank", "device_id", "process_index", "hostname",
                       "coords", "summary"}


def load_records(path: str | Path, section: str | None = None) -> list[dict]:
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad JSON record: {e}") from e
            if section is None or rec.get("section") == section:
                records.append(rec)
    return records


def validate_record(rec: dict) -> None:
    """Every device rank must have reported (reference
    plots/parser.py:102-136 'did every rank report'), every declared
    process must be represented, and the host set must be plausible for
    the process count (the reference's hostname-vs-node-count check).

    Degraded pathway: a record whose globals declare ``degraded_world``
    (a fault-plan ``shrink`` run — faults/, native fault_plan.hpp) must
    cover exactly the SURVIVOR rank set instead of range(world), and
    processes owned entirely by dead ranks may legitimately be absent.
    Only an explicit declaration relaxes the checks — a record missing
    ranks without saying why still fails."""
    world = rec["global"].get("world_size")
    rows = rec.get("ranks", [])
    ranks = [r["rank"] for r in rows]
    degraded = rec["global"].get("degraded_world")
    if degraded is not None:
        degraded = sorted(int(r) for r in degraded)
        if world is not None and not all(0 <= r < world for r in degraded):
            raise ValueError(
                f"record for {rec.get('section')}: degraded_world "
                f"{degraded} outside range({world})")
        if sorted(ranks) != degraded:
            raise ValueError(
                f"record for {rec.get('section')}/"
                f"{rec['global'].get('model')}: rank set {sorted(ranks)} "
                f"!= declared degraded_world {degraded}")
    elif world is not None and sorted(ranks) != list(range(world)):
        raise ValueError(
            f"record for {rec.get('section')}/{rec['global'].get('model')}: "
            f"rank set {sorted(ranks)} != range({world})")
    n = rec.get("num_runs")
    for row in rows:
        for k, v in row.items():
            if k not in _TIMER_KEYS_EXCLUDE and isinstance(v, list) and n \
                    and len(v) != n:
                raise ValueError(
                    f"rank {row['rank']} timer {k!r} has {len(v)} entries, "
                    f"expected {n}")
        # schema v2: a summary must describe the samples it rides with
        for k, s in (row.get("summary") or {}).items():
            vals = row.get(k)
            if isinstance(vals, list) and s.get("n") != len(vals):
                raise ValueError(
                    f"rank {row['rank']} summary for {k!r} claims n="
                    f"{s.get('n')} but the timer has {len(vals)} samples")
    num_procs = rec["global"].get("num_processes")
    if num_procs is not None:
        procs = sorted({row.get("process_index", 0) for row in rows})
        if degraded is not None:
            # a dead rank's process (tcp: one rank per process) emits
            # nothing; the surviving processes must still be a sane
            # subset of the declared set
            if not procs or not all(0 <= p < num_procs for p in procs):
                raise ValueError(
                    f"record for {rec.get('section')}: degraded process "
                    f"coverage {procs} outside range({num_procs})")
        elif procs != list(range(num_procs)):
            raise ValueError(
                f"record for {rec.get('section')}: process coverage "
                f"{procs} != range({num_procs}) — a host did not report")
        hosts = {row.get("hostname") for row in rows}
        if len(hosts) > num_procs:
            raise ValueError(
                f"record for {rec.get('section')}: {len(hosts)} distinct "
                f"hostnames for {num_procs} processes")


def records_to_dataframe(records: list[dict], validate: bool = True):
    """One row per rank x run; globals and mesh info as columns."""
    import pandas as pd

    rows = []
    for rec in records:
        if validate:
            validate_record(rec)
        g = rec.get("global", {})
        mesh = rec.get("mesh", {})
        for rank_row in rec.get("ranks", []):
            timers = {k: v for k, v in rank_row.items()
                      if k not in _TIMER_KEYS_EXCLUDE and isinstance(v, list)}
            n = rec.get("num_runs") or max((len(v) for v in timers.values()),
                                           default=0)
            for run in range(n):
                row = {
                    "section": rec.get("section"),
                    "run": run,
                    "rank": rank_row["rank"],
                    "device_id": rank_row.get("device_id"),
                    "hostname": rank_row.get("hostname"),
                    "platform": mesh.get("platform"),
                    "device_kind": mesh.get("device_kind"),
                }
                # sweep/job variables (reference: sbatchman job.variables,
                # plots/parser.py:238) hoisted to plain columns.  Globals
                # win over same-named (string-typed) tags, and neither may
                # clobber the structural columns already in the row.
                for k, v in {**g.get("variables", {}), **g}.items():
                    if k in row:
                        continue
                    if isinstance(v, list):
                        row[k] = tuple(v)  # hashable, groupby-safe
                    elif not isinstance(v, dict):
                        row[k] = v
                # attribution verdict (a dict global, skipped above):
                # the one-word bound is groupby-grade and rides as its
                # own column; v1/pre-attribution records simply lack it
                attr = g.get("attribution")
                if isinstance(attr, dict) and attr.get("bound"):
                    row["attr_bound"] = attr["bound"]
                # anomaly engine (a dict global, skipped above): the
                # groupby-grade count rides as a plain column — "did
                # this run trip its flight recorder" is the first
                # question a sweep post-mortem asks.  Clean/untelemetered
                # records simply lack the block (column absent/NaN).
                anom = g.get("anomalies")
                if isinstance(anom, dict) and anom.get("count"):
                    row["anomaly_count"] = int(anom["count"])
                # tuning provenance (a dict global, skipped above): the
                # groupby-grade summary — "hits/consults" — rides as a
                # plain column; untuned/v1 records simply lack it
                tun = g.get("tuning")
                if isinstance(tun, dict):
                    hits = int(tun.get("hits", 0))
                    total = hits + int(tun.get("misses", 0))
                    row["tuned"] = f"{hits}/{total}"
                # MoE imbalance block (a dict global, skipped above):
                # hoist the expert-load axes a skew study
                # grids by; dense/pre-MoE records simply lack them
                moe = g.get("moe")
                if isinstance(moe, dict):
                    for mk in ("load_imbalance", "rounds_mean",
                               "drop_rate", "router_entropy"):
                        if mk in moe:
                            row[f"moe_{mk}"] = moe[mk]
                    if "expert_load" in moe:
                        row["moe_expert_load_max"] = max(
                            moe["expert_load"], default=0.0)
                # serving block (a dict global, skipped above): hoist
                # the latency-vs-load axes — offered load, the tail
                # percentiles and goodput-at-SLO — to plain columns so
                # a load sweep groups like any other study grid;
                # training records simply lack them
                srv = g.get("serving")
                if isinstance(srv, dict):
                    row["serving_offered_rps"] = srv.get("offered_rps")
                    row["serving_goodput_rps"] = srv.get("goodput_rps")
                    row["serving_goodput_frac"] = srv.get("goodput_frac")
                    # capacity axis: peak concurrent resident
                    # sequences (the equal-pool-bytes A/B's y-axis);
                    # pre-density records simply lack the key.  The
                    # cache-dtype / prefix-hit globals are plain
                    # scalars and hoist via the generic loop above.
                    if "admitted_concurrency_peak" in srv:
                        row["serving_admitted_peak"] = \
                            srv["admitted_concurrency_peak"]
                    for base in ("ttft_ms", "tpot_ms", "e2e_ms"):
                        pcts = srv.get(base)
                        if isinstance(pcts, dict):
                            for p in ("p50", "p99"):
                                if p in pcts:
                                    row[f"serving_{base[:-3]}_{p}_ms"] \
                                        = pcts[p]
                    # the dispatch decomposition: how many
                    # device decode steps each host dispatch amortized
                    # and what a crossing cost — the columns the
                    # N-step A/B grids by
                    dl = srv.get("decode_loop")
                    if isinstance(dl, dict):
                        row["serving_steps_per_dispatch"] = \
                            dl.get("steps_per_dispatch")
                        row["serving_tokens_per_sync"] = \
                            dl.get("tokens_per_sync")
                        hd = dl.get("host_dispatch_us")
                        if isinstance(hd, dict):
                            row["serving_host_dispatch_us_p50"] = \
                                hd.get("p50")
                        spec = dl.get("spec")
                        if isinstance(spec, dict):
                            row["serving_spec_acceptance"] = \
                                spec.get("acceptance_rate")
                    # disaggregation: the page-migration wire
                    # accounting rides as plain columns so a Pareto
                    # sweep grids by wire cost next to the latency
                    # axes; monolithic/pre-disagg records simply lack
                    # the block (the `disaggregated` global itself is
                    # a plain scalar and hoists via the generic loop)
                    mig = srv.get("migration")
                    if isinstance(mig, dict):
                        row["serving_migration_bytes"] = \
                            mig.get("bytes")
                        row["serving_migration_bytes_ratio"] = \
                            mig.get("bytes_ratio_vs_bf16")
                        row["serving_migration_overlap"] = \
                            mig.get("overlap")
                        ms = mig.get("ms")
                        if isinstance(ms, dict):
                            row["serving_migration_ms_p50"] = \
                                ms.get("p50")
                # fleet block (a dict global, skipped above): hoist the routing-comparison axes — per-replica
                # spread, affinity wins, elastic chip-second spend —
                # to plain columns so a policy A/B grids like any
                # other study (fleet_routing/fleet_replicas are plain
                # scalars and hoist via the generic loop above);
                # single-engine records simply lack the block
                flt = g.get("fleet")
                if isinstance(flt, dict):
                    rpr = flt.get("requests_per_replica")
                    if isinstance(rpr, list) and rpr:
                        row["fleet_replica_req_max"] = max(rpr)
                        row["fleet_replica_req_min"] = min(rpr)
                    for fk in ("affinity_hit_rate",
                               "prefix_reuse_tokens",
                               "chip_seconds_used",
                               "chip_seconds_saved",
                               "slo_goodput_per_chip_s"):
                        if fk in flt:
                            row[f"fleet_{fk}"] = flt[fk]
                    ev = flt.get("scale_events")
                    if isinstance(ev, list):
                        row["fleet_scale_events"] = len(ev)
                for tname, tvals in timers.items():
                    if run < len(tvals):
                        # singular column names a la reference ('runtime')
                        col = tname[:-1] if tname.endswith("s") else tname
                        row[col] = tvals[run]
                rows.append(row)
    return pd.DataFrame(rows)


def get_metrics_dataframe(path: str | Path, strategy: str | None = None,
                          validate: bool = True):
    """Reference-parity convenience: ``get_metrics_dataframe('runs.jsonl',
    'dp')`` -> DataFrame (reference plots/parser.py:213-256)."""
    return records_to_dataframe(load_records(path, strategy), validate)
