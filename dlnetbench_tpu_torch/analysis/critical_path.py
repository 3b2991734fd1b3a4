"""Cross-rank critical-path blame from per-rank step timelines (the
port's copy of the JAX package's ``analysis/critical_path.py``).

A record whose rank rows carry genuinely per-rank step series — a
merged multi-process record, a native record, or the port's gathered
record (rank 0 holds every rank's own timers) — gives each rank's wall
clock for every measured step, on its own clock.  The harness's
schedules all rendezvous at collective/fence boundaries, so **step
index IS the alignment**: sample ``i`` on every rank covers the same
inter-fence interval, and the per-step critical path is the slowest
rank at each index.

Given that alignment:

* per step ``i``: the **critical rank** is ``argmax_r t_r(i)`` and the
  step's **excess** is ``max_r t_r(i) - median_r t_r(i)``;
* per rank: **blame** is the excess summed over the steps the rank was
  critical for; ``blame_frac`` normalizes by the total excess;
* the **noise band** is the ``metrics/stats.summarize`` band of all
  per-rank deviations outside any fault window — a rank is a
  **suspect** only when its deviation band sits entirely above it;
* per-phase blame decomposes the excess over the named timer arrays
  riding the same rows (``compute_time``, ``comm_time``, ...).

The record's ``fault_plan`` (when present) scopes the verdict to the
injected window (``faults/plan.py`` owns the window arithmetic, through
the bandwidth layer's ``_fault_run_window``).

Flight dumps (``metrics/telemetry.py``) feed the same engine via
``matrix_from_flights``.  The port's recorder writes one dump per rank,
``flight_<trigger>[_<n>]_rank<r>.json``; ``load_flights`` groups them by
trigger and tags every sample with the rank its file names, so the
matrix comes out rank by rank.

CLI::

    python -m dlnetbench_tpu_torch.analysis.critical_path report \
        [--section NAME] [--json] RUNS.jsonl|flight_*.json|DIR [...]

A directory stands for the flight dumps in it.
"""
from __future__ import annotations

import json
import math
import re
import sys
from pathlib import Path

from dlnetbench_tpu_torch.metrics.stats import bands_overlap, summarize

CLOCK_ALIGNMENT = "collective-fence"   # stamped into every report


# ---------------------------------------------------------------------
# Timeline extraction.

def step_matrix(record: dict, timer: str = "runtimes"
                ) -> tuple[list[int], list[list[float]]]:
    """Rank rows -> ``(ranks, matrix)`` where ``matrix[r][i]`` is rank
    ``r``'s wall for sample ``i`` (us).  Rows are truncated to the
    shortest common length (a degraded record's survivor rows must
    still align by index)."""
    ranks, series = [], []
    for row in record.get("ranks", []):
        vals = row.get(timer)
        if not isinstance(vals, list) or not vals:
            continue
        ranks.append(int(row.get("rank", len(ranks))))
        series.append([float(v) for v in vals])
    if not series:
        raise ValueError(
            f"critical_path: record "
            f"{record.get('section')}/{record.get('global', {}).get('model')} "
            f"has no per-rank {timer!r} arrays")
    n = min(len(s) for s in series)
    return ranks, [s[:n] for s in series]


def matrix_from_flights(dumps: list[dict], field: str = "step_wall_us"
                        ) -> tuple[list[int], list[list[float]]]:
    """Merge per-rank flight dumps (``flight_<trigger>.json`` payloads
    or raw ``telemetry_block``-shaped dicts) into a step matrix: each
    dump contributes the samples carrying ``field``, keyed by their
    ``step`` index (rank identity from the samples' ``rank`` when
    present, else the dump's position)."""
    per_rank: dict[int, dict[int, float]] = {}
    for di, dump in enumerate(dumps):
        for s in dump.get("samples", dump.get("last", [])):
            if field not in s or "step" not in s:
                continue
            r = int(s.get("rank", di))
            per_rank.setdefault(r, {})[int(s["step"])] = float(s[field])
    if not per_rank:
        raise ValueError(f"critical_path: no {field!r} samples with "
                         f"step indices in the given flight dumps")
    steps = sorted(set.intersection(*(set(m) for m in per_rank.values())))
    if not steps:
        raise ValueError("critical_path: flight dumps share no common "
                         "step window (rings rolled past each other)")
    ranks = sorted(per_rank)
    return ranks, [[per_rank[r][i] for i in steps] for r in ranks]


_FLIGHT_RE = re.compile(r"^flight_(?P<group>.+?)(?:_rank(?P<rank>\d+))?"
                        r"\.json$")


def is_flight_dump(path: str | Path) -> bool:
    """Is ``path`` named as a flight dump, ``flight_<trigger>[_<n>]
    [_rank<r>].json``?"""
    return _FLIGHT_RE.match(Path(path).name) is not None


def load_flights(paths: list[str | Path]) -> dict[str, list[dict]]:
    """Flight dumps grouped by ``<trigger>[_<n>]``, each group in rank
    order: a dump named ``..._rank<r>.json`` has every sample that lacks
    a ``rank`` tagged with ``r`` (the port's per-rank dumps); an unsuffixed
    dump (the JAX package's one process) keeps its samples as they are.
    A directory stands for the flight dumps in it."""
    files: list[Path] = []
    for p in map(Path, paths):
        files.extend(sorted(p.glob("flight_*.json")) if p.is_dir() else [p])
    groups: dict[str, list[tuple[int, dict]]] = {}
    for f in files:
        m = _FLIGHT_RE.match(f.name)
        if m is None:
            raise ValueError(f"{f}: not a flight dump name")
        dump = json.loads(f.read_text())
        rank = m.group("rank")
        if rank is not None:
            dump = {**dump, "samples": [
                s if "rank" in s else {**s, "rank": int(rank)}
                for s in dump.get("samples", dump.get("last", []))]}
        groups.setdefault(m.group("group"), []).append(
            (-1 if rank is None else int(rank), dump))
    return {g: [d for _, d in sorted(ds, key=lambda rd: rd[0])]
            for g, ds in sorted(groups.items())}


def flight_report(group: str, dumps: list[dict],
                  field: str = "step_wall_us") -> dict:
    """Blame report of one trigger's flight dumps (``load_flights``):
    the aligned step matrix through ``blame_from_matrix``; ``section``
    names the dump group."""
    ranks, mat = matrix_from_flights(dumps, field)
    report = blame_from_matrix(ranks, mat)
    report["section"] = f"flight_{group}"
    report["model"] = field
    return report


def _fault_sample_window(record: dict) -> tuple[int, int | None] | None:
    """The record's fault window in SAMPLE units (warmup-rebased,
    fence-chain aware) — one definition, owned by the bandwidth layer."""
    from dlnetbench_tpu_torch.analysis.bandwidth import _fault_run_window
    w = _fault_run_window(record)
    if w is None:
        return None
    s, e, k = w
    # sample j covers steps [j*k, (j+1)*k): first/last sample touching
    return (s // k, None if e is None else max(s // k + 1,
                                               math.ceil(e / k)))


def _in_window(i: int, window: tuple[int, int | None] | None) -> bool:
    if window is None:
        return False
    lo, hi = window
    return i >= lo and (hi is None or i < hi)


def _median(vals: list[float]) -> float:
    import statistics
    return statistics.median(vals)


# ---------------------------------------------------------------------
# The blame engine.

def blame_from_matrix(ranks: list[int], mat: list[list[float]], *,
                      window: tuple[int, int | None] | None = None,
                      phases: dict[int, dict[str, list[float]]]
                      | None = None) -> dict:
    """Core per-step critical-path blame over an aligned step matrix.

    ``window`` scopes the *verdict* (suspects, window blame) to the
    fault steps while the noise band is fit on the steps OUTSIDE it —
    a clean record (window None) fits the band on everything and can
    only produce suspects whose deviations escape their peers' band.
    ``phases``: rank -> {phase: per-sample us} for phase decomposition.
    """
    n_ranks, n = len(ranks), len(mat[0])
    crit = []            # per-step (critical rank index, excess us)
    walls = []           # per-step critical wall
    dev = [[0.0] * n for _ in range(n_ranks)]
    for i in range(n):
        col = [mat[r][i] for r in range(n_ranks)]
        med = _median(col)
        top = max(range(n_ranks), key=lambda r: col[r])
        crit.append((top, max(0.0, col[top] - med)))
        walls.append(col[top])
        for r in range(n_ranks):
            dev[r][i] = col[r] - med
    # noise band: every rank's deviation on the steps outside the
    # window (all steps when no window) — what "ordinary" spread looks
    # like on this record
    noise_vals = [dev[r][i] for r in range(n_ranks) for i in range(n)
                  if not _in_window(i, window)]
    noise = summarize(noise_vals or [0.0])

    def _rank_block(steps: list[int]) -> list[dict]:
        total_excess = sum(crit[i][1] for i in steps) or 0.0
        out = []
        for r in range(n_ranks):
            blame = sum(exc for i in steps
                        for top, exc in [crit[i]] if top == r)
            out.append({
                "rank": ranks[r],
                "critical_steps": sum(1 for i in steps
                                      if crit[i][0] == r),
                "blame_us": round(blame, 3),
                "blame_frac": (round(blame / total_excess, 4)
                               if total_excess > 0 else 0.0),
                "dev_us": summarize([dev[r][i] for i in steps],
                                    ndigits=3),
            })
        return out

    all_steps = list(range(n))
    per_rank = _rank_block(all_steps)
    # suspects: deviation band disjoint ABOVE the noise band — judged
    # on the window steps when a window exists (that is where an
    # injected straggler lives), on everything otherwise
    verdict_steps = ([i for i in all_steps if _in_window(i, window)]
                     if window is not None else all_steps)
    verdict = (_rank_block(verdict_steps) if verdict_steps else [])
    suspects = [b["rank"] for b in verdict
                if bands_overlap(b["dev_us"]["band"], noise["band"])
                is False and b["dev_us"]["value"] > noise["band"][1]]

    report = {
        "clock_alignment": CLOCK_ALIGNMENT,
        "ranks": list(ranks),
        "steps": n,
        "step_wall_us": summarize(walls, ndigits=3),
        "noise_band_us": [round(v, 3) for v in noise["band"]],
        "per_rank": per_rank,
        "suspects": suspects,
    }
    if window is not None and verdict_steps:
        excess = sum(crit[i][1] for i in verdict_steps)
        top = max(verdict, key=lambda b: b["blame_us"])
        report["window"] = {
            "sample_range": [window[0],
                             window[1] if window[1] is not None else n],
            "excess_us": round(excess, 3),
            "top_rank": top["rank"],
            "top_frac": top["blame_frac"],
            "per_rank": verdict,
        }
    if phases:
        report["phases"] = _phase_blame(ranks, phases, crit,
                                        verdict_steps)
    return report


def _phase_blame(ranks: list[int],
                 phases: dict[int, dict[str, list[float]]],
                 crit: list[tuple[int, float]],
                 steps: list[int]) -> dict:
    """Which phase carries the excess: for every named per-step timer
    shared by all ranks, the critical rank's positive deviation from
    the per-step median, summed over the analysis steps."""
    names = None
    for per in phases.values():
        names = set(per) if names is None else names & set(per)
    out: dict[str, float] = {}
    for name in sorted(names or ()):
        total = 0.0
        for i in steps:
            top = crit[i][0]
            col = [phases[r][name][i] for r in range(len(ranks))
                   if i < len(phases[r][name])]
            if len(col) != len(ranks):
                continue
            total += max(0.0, col[top] - _median(col))
        out[name] = round(total, 3)
    return out


# per-rank row timers that are NOT per-step phase series
_NON_PHASE = {"runtimes", "coords"}


def blame_report(record: dict, timer: str = "runtimes") -> dict:
    """Record -> blame report: step matrix from the rank rows, fault
    window from ``global.fault_plan``, phase series from every other
    per-rank timer array of matching length (``compute_time``,
    ``barrier_time``, ``fault_delay_us``, ``energy_consumed``, ...)."""
    ranks, mat = step_matrix(record, timer)
    n = len(mat[0])
    phases: dict[int, dict[str, list[float]]] = {}
    for r, row in zip(range(len(ranks)),
                      [rw for rw in record.get("ranks", [])
                       if isinstance(rw.get(timer), list)
                       and rw.get(timer)]):
        per = {}
        for k, v in row.items():
            if k in _NON_PHASE or k == timer or not isinstance(v, list):
                continue
            if len(v) >= n and all(isinstance(x, (int, float))
                                   for x in v[:n]):
                per[k] = [float(x) for x in v[:n]]
        if per:
            phases[r] = per
    report = blame_from_matrix(
        ranks, mat, window=_fault_sample_window(record),
        phases=phases if len(phases) == len(ranks) else None)
    report["section"] = record.get("section")
    report["model"] = record.get("global", {}).get("model")
    # the energy axis, where a sampler existed (per-host counters —
    # window sums per rank so a straggler's extra joules are visible)
    energy = {}
    for r, row in zip(ranks, record.get("ranks", [])):
        ej = row.get("energy_consumed")
        if isinstance(ej, list) and ej:
            energy[str(r)] = round(sum(float(x) for x in ej[:n]), 4)
    if energy:
        report["energy_j"] = energy
    return report


def blame_columns(record: dict) -> dict:
    """The two groupby-grade columns the bandwidth summaries carry:
    the top-blamed rank and its blame fraction (judged over the fault
    window when one exists).  Degrades to the no-signal shape — a
    single-controller record whose rank rows share one clock has no
    per-rank signal, and must never fabricate a verdict."""
    try:
        rep = blame_report(record)
    except (ValueError, KeyError, TypeError):
        return {"blame_rank": "-", "blame_frac": float("nan")}
    block = rep.get("window") or {}
    per = block.get("per_rank") or rep["per_rank"]
    top = max(per, key=lambda b: b["blame_us"], default=None)
    # the same gate on BOTH paths: a windowed record whose rank rows
    # share one clock (single-controller duplication) has zero excess
    # and no suspect — it must degrade, not crown rank 0 with 0% blame
    if top is None or top["blame_us"] <= 0 \
            or top["rank"] not in rep["suspects"]:
        return {"blame_rank": "-", "blame_frac": float("nan")}
    return {"blame_rank": str(top["rank"]),
            "blame_frac": top["blame_frac"]}


def prefill_stall_blame(record: dict) -> dict | None:
    """Disaggregated serving: how much of the decode
    replica's time the PREFILL side is to blame for — the migration
    wall not hidden behind in-flight decode.  The monolithic engine's
    interference shows up as inflated decode steps (this module's
    per-rank blame can't separate it — one clock); the disaggregated
    record decomposes it explicitly: ``exposed_ms`` is the migration
    wall scaled by the UNhidden fraction of the measured overlap, and
    ``stall_frac`` sets it against the decode device time.  None on
    monolithic / pre-disagg records; ``exposed_ms`` is NaN when the
    run never measured all three overlap legs (an unmeasured overlap
    must not be scored as either 0 or 1)."""
    g = record.get("global", {})
    if not g.get("disaggregated"):
        return None
    srv = g.get("serving") or {}
    mig = srv.get("migration")
    if not isinstance(mig, dict):
        return None
    total_ms = float((mig.get("ms") or {}).get("total", 0.0))
    ov = float(mig.get("overlap", float("nan")))
    dl = srv.get("decode_loop") or {}
    dev_ms = float((dl.get("decode_device_us") or {}
                    ).get("total", 0.0)) / 1e3
    if math.isnan(ov):
        exposed = float("nan")
        frac = float("nan")
    else:
        exposed = total_ms * (1.0 - min(max(ov, 0.0), 1.0))
        frac = (exposed / (dev_ms + exposed)
                if dev_ms + exposed > 0 else 0.0)
    return {"migration_ms_total": round(total_ms, 3),
            "migration_overlap": ov,
            "exposed_ms": (round(exposed, 3)
                           if not math.isnan(exposed) else exposed),
            "decode_device_ms": round(dev_ms, 3),
            "stall_frac": (round(frac, 4)
                           if not math.isnan(frac) else frac)}


# ---------------------------------------------------------------------
# CLI: python -m dlnetbench_tpu_torch.analysis.critical_path report ...

def _format_report(rep: dict) -> str:
    lines = [f"critical path: {rep.get('section')}/"
             f"{rep.get('model')} — {rep['steps']} steps x "
             f"{len(rep['ranks'])} ranks "
             f"(alignment: {rep['clock_alignment']})",
             f"  step wall us: value={rep['step_wall_us']['value']} "
             f"band={rep['step_wall_us']['band']}",
             f"  noise band (rank deviation, us): "
             f"{rep['noise_band_us']}"]
    for b in rep["per_rank"]:
        lines.append(
            f"  rank {b['rank']:>3}: critical for "
            f"{b['critical_steps']} steps, blame "
            f"{b['blame_us']:.1f} us ({b['blame_frac']:.0%})")
    win = rep.get("window")
    if win:
        lines.append(
            f"  fault window samples {win['sample_range']}: excess "
            f"{win['excess_us']:.1f} us, top rank {win['top_rank']} "
            f"({win['top_frac']:.0%})")
    for name, us in (rep.get("phases") or {}).items():
        lines.append(f"  phase {name}: critical-rank excess "
                     f"{us:.1f} us")
    if rep.get("energy_j"):
        lines.append(f"  energy J per rank: {rep['energy_j']}")
    lines.append("  suspects: "
                 + (", ".join(str(r) for r in rep["suspects"])
                    if rep["suspects"]
                    else "none above the noise band"))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m dlnetbench_tpu_torch.analysis.critical_path "
             "report [--section NAME] [--json] RUNS.jsonl|flight_*.json|DIR "
             "[...]")
    if not args or args[0] != "report":
        print(usage, file=sys.stderr)
        return 2
    args = args[1:]
    section = None
    as_json = False
    paths: list[str] = []
    while args:
        a = args.pop(0)
        if a == "--section":
            if not args:
                print(usage, file=sys.stderr)
                return 2
            section = args.pop(0)
        elif a == "--json":
            as_json = True
        else:
            paths.append(a)
    if not paths:
        print(usage, file=sys.stderr)
        return 2
    from dlnetbench_tpu_torch.metrics.parser import load_records
    reports = []
    flights = [p for p in paths if Path(p).is_dir() or is_flight_dump(p)]
    if flights:
        try:
            for group, dumps in load_flights(flights).items():
                reports.append(flight_report(group, dumps))
        except ValueError as e:
            print(f"flight dumps: {e}", file=sys.stderr)
    for p in paths:
        if p in flights:
            continue
        for rec in load_records(Path(p), section):
            try:
                reports.append(blame_report(rec))
            except ValueError as e:
                print(f"{p}: {e}", file=sys.stderr)
    if not reports:
        print("critical_path: no analyzable records", file=sys.stderr)
        return 1
    for rep in reports:
        if as_json:
            print(json.dumps(rep))
        else:
            print(_format_report(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
