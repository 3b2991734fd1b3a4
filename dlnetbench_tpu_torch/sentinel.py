"""Bench regression sentinel: stat-band-aware artifact comparison (the
port's copy of the JAX package's ``sentinel.py``).

* ``python -m dlnetbench_tpu_torch.bench --check BASELINE`` compares the
  run it just measured against a baseline artifact, writes a
  ``sentinel`` section into the headline line, and exits 3 on a
  regression (2 when the baseline has no comparable headline);
* ``python -m dlnetbench_tpu_torch.sentinel DIR`` walks a directory of
  BENCH_r*.json bench captures chronologically and reports every
  transition (exit non-zero when the LATEST artifact regressed against
  its predecessor);
* ``python -m dlnetbench_tpu_torch.sentinel --baseline A.json B.json``
  compares two specific artifacts.

Comparison semantics (per comparable line — the headline plus every
embedded ms-unit aux line present on both sides):

* a **regression** needs BOTH signals: the median moved worse by more
  than ``--threshold`` percent AND the stat bands do not overlap.  A
  band-overlapping slowdown is indistinguishable from run-to-run noise
  (the bands exist precisely to say so, metrics/stats.py); a
  non-overlapping shift under the threshold is real but too small to
  fail a build over.  Lines without bands on either side (pre-band
  artifacts) fall back to the %-threshold alone.
* the **attribution delta** names the resource that moved: per-resource
  wall-clock (fraction x time) is differenced between baseline and
  current, and the largest increase is reported (``resource_moved``),
  so a sentinel failure says "comm_exposed grew 3.1 ms", not just
  "slower".
"""
from __future__ import annotations

import glob
import json
import sys
from pathlib import Path

from dlnetbench_tpu_torch.analysis.attribution import RESOURCES, attribute_line

DEFAULT_THRESHOLD_PCT = 5.0

# exit codes: 0 clean, 2 usage, 3 regression
RC_REGRESSION = 3


def is_ms_line(v) -> bool:
    """Is ``v`` a comparable bench measurement line?  Public: bench.py
    uses it to assemble the current run's comparable-line map."""
    return (isinstance(v, dict) and v.get("unit") == "ms"
            and isinstance(v.get("value"), (int, float))
            and "metric" in v)


def bench_lines(path: str | Path) -> dict[str, dict]:
    """``{"headline": line, "<aux key>": line, ...}`` from a bench
    artifact: a bench capture (.json carrying ``parsed``/``tail``,
    headline preferring the capture's ``parsed`` object), a bench stdout
    JSONL (headline is the LAST ms line), or a single headline object.
    Artifact-shape parsing is shared with the explain CLI
    (attribution.load_artifact).  Empty dict when nothing comparable is
    found."""
    from dlnetbench_tpu_torch.analysis.attribution import load_artifact
    objs, parsed = load_artifact(path)
    headline = parsed if is_ms_line(parsed) else None
    if headline is None:
        ms = [o for o in objs if is_ms_line(o)]
        headline = ms[-1] if ms else None
    if not is_ms_line(headline):
        return {}
    out = {"headline": headline}
    for k, v in headline.items():
        if is_ms_line(v):
            out[k] = v
    return out


def _resource_moved(base: dict, cur: dict) -> tuple[str, float] | None:
    """(resource, delta_ms) of the attribution resource whose wall-clock
    grew most between baseline and current — derives blocks for legacy
    lines so pre-stamping artifacts still get a named resource."""
    ab = attribute_line(base)
    ac = attribute_line(cur)
    if not ab or not ac:
        return None
    fb, fc = ab.get("fractions", {}), ac.get("fractions", {})
    bv, cv = float(base["value"]), float(cur["value"])
    deltas = {r: fc.get(r, 0.0) * cv - fb.get(r, 0.0) * bv
              for r in RESOURCES}
    r = max(deltas, key=lambda k: deltas[k])
    return r, round(deltas[r], 3)


def compare_line(name: str, base: dict, cur: dict,
                 threshold_pct: float = DEFAULT_THRESHOLD_PCT) -> dict | None:
    """One line's comparison record; None when incomparable.

    A line that names its recipe (``recommended_step``) is only
    comparable when both sides picked the SAME recipe: a flipped
    recommendation (e.g. the int8 aux line was skipped this run, so
    the recommendation fell back to bf16) is a selection change, not a
    slowdown of either recipe — the headline comparison still covers
    the run getting slower."""
    if not (is_ms_line(base) and is_ms_line(cur)):
        return None
    if base.get("recipe") != cur.get("recipe"):
        return None
    bv, cv = float(base["value"]), float(cur["value"])
    if not bv > 0:
        return None
    delta_pct = (cv - bv) / bv * 100.0
    from dlnetbench_tpu_torch.metrics.stats import bands_overlap
    overlap = bands_overlap(base.get("band"), cur.get("band"))
    regression = delta_pct > threshold_pct and overlap is not True
    improvement = delta_pct < -threshold_pct and overlap is not True
    res = {"line": name, "baseline_ms": round(bv, 3),
           "current_ms": round(cv, 3), "delta_pct": round(delta_pct, 2),
           "bands_overlap": overlap, "regression": regression,
           "improvement": improvement}
    moved = _resource_moved(base, cur)
    if moved is not None:
        res["resource_moved"], res["resource_delta_ms"] = moved
    return res


def check(baseline_lines: dict, current_lines: dict,
          threshold_pct: float = DEFAULT_THRESHOLD_PCT,
          baseline_label: str = "") -> dict:
    """The ``sentinel`` section: every comparable line judged.  A
    baseline without a comparable headline yields verdict
    ``no-baseline`` (nothing to regress against — never a failure)."""
    sentinel = {"baseline": baseline_label,
                "threshold_pct": threshold_pct}
    if not baseline_lines.get("headline") or not current_lines.get(
            "headline"):
        sentinel.update({"verdict": "no-baseline", "lines": [],
                         "regressions": [], "improvements": [],
                         "missing": []})
        return sentinel
    names = ["headline"] + sorted(k for k in baseline_lines
                                  if k != "headline" and k in current_lines)
    # a baseline aux line that vanished from the current run can't be
    # judged slower/faster, but silence would let a disappeared
    # measurement pass as "clean" — surface it.  Not a failure: skipped
    # aux lines (--skip-aux, skip markers) are legitimate runs.
    missing = sorted(k for k in baseline_lines
                     if k != "headline" and k not in current_lines)
    results = []
    for name in names:
        r = compare_line(name, baseline_lines[name], current_lines[name],
                         threshold_pct)
        if r is not None:
            results.append(r)
    regressions = [r["line"] for r in results if r["regression"]]
    improvements = [r["line"] for r in results if r["improvement"]]
    sentinel.update({
        "lines": results,
        "regressions": regressions,
        "improvements": improvements,
        "missing": missing,
        "verdict": "regression" if regressions else "clean",
    })
    return sentinel


def check_paths(baseline_path: str | Path, current_path: str | Path,
                threshold_pct: float = DEFAULT_THRESHOLD_PCT) -> dict:
    return check(bench_lines(baseline_path), bench_lines(current_path),
                 threshold_pct, baseline_label=str(baseline_path))


def _render(sent: dict, label: str, out) -> None:
    print(f"\n== sentinel: {label} (baseline {sent.get('baseline')}, "
          f"threshold {sent.get('threshold_pct')}%) ==", file=out)
    if sent.get("verdict") == "no-baseline":
        print("  no comparable headline on one side — nothing to check",
              file=out)
        return
    for r in sent.get("lines", []):
        mark = ("REGRESSION" if r["regression"]
                else "improved" if r["improvement"] else "ok")
        moved = (f"  [{r['resource_moved']} "
                 f"{r['resource_delta_ms']:+.3f} ms]"
                 if "resource_moved" in r else "")
        band = ("" if r["bands_overlap"] is None
                else " bands-overlap" if r["bands_overlap"]
                else " bands-disjoint")
        print(f"  {mark:<10} {r['line']:<24} "
              f"{r['baseline_ms']:>10.3f} -> {r['current_ms']:>10.3f} ms "
              f"({r['delta_pct']:+.1f}%){band}{moved}", file=out)
    if sent.get("missing"):
        print(f"  missing    baseline lines absent from this run: "
              f"{', '.join(sent['missing'])}", file=out)
    print(f"  verdict: {sent['verdict']}"
          + (f" ({', '.join(sent['regressions'])})"
             if sent["regressions"] else ""), file=out)


def scan_dir(dirpath: str | Path, pattern: str = "BENCH_r*.json",
             threshold_pct: float = DEFAULT_THRESHOLD_PCT,
             out=None) -> int:
    """Walk a directory of bench captures chronologically (name
    order), compare every consecutive pair, and return the exit code:
    ``RC_REGRESSION`` when the LATEST transition regressed.

    MID-walk artifacts with no comparable headline (a failed capture
    records rc and tail even when the bench died) are skipped
    with a note and the last GOOD artifact stays the baseline: one dead
    capture must not blind the sentinel for two transitions.  A dead
    LATEST artifact is different — the tripwire cannot evaluate the
    newest round, and the newest round is the one CI is asking about —
    so it exits 2 instead of riding an older clean verdict (the same
    disarmed-is-not-clean convention as ``--baseline`` mode)."""
    out = out or sys.stdout
    paths = sorted(glob.glob(str(Path(dirpath) / pattern)))
    if len(paths) < 2:
        print(f"sentinel: need >= 2 artifacts matching {pattern} under "
              f"{dirpath}, found {len(paths)}", file=out)
        return 2
    last = None
    prev = None
    dead_latest = False
    for cur in paths:
        cur_lines = bench_lines(cur)
        if not cur_lines.get("headline"):
            print(f"\n== sentinel: {Path(cur).name} — no comparable "
                  f"headline (failed capture?), skipped ==", file=out)
            dead_latest = True
            continue
        dead_latest = False
        if prev is not None:
            sent = check(bench_lines(prev), cur_lines, threshold_pct,
                         baseline_label=str(prev))
            _render(sent, Path(cur).name, out)
            last = sent
        prev = cur
    if dead_latest:
        print("sentinel: the LATEST artifact has no comparable headline "
              "(failed capture?) — the newest round cannot be checked",
              file=out)
        return 2
    if last is None:
        # >= 2 artifacts but zero comparisons: every capture (or all
        # but one) was dead — the sentinel never armed, which must not
        # read as a clean walk
        print("sentinel: no artifact pair was comparable — nothing "
              "checked", file=out)
        return 2
    if last.get("verdict") == "regression":
        return RC_REGRESSION
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m dlnetbench_tpu_torch.sentinel", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path", help="directory of BENCH_r*.json artifacts, "
                                "or (with --baseline) one artifact")
    p.add_argument("--baseline", default=None,
                   help="compare PATH against this artifact instead of "
                        "walking a directory")
    p.add_argument("--pattern", default="BENCH_r*.json")
    p.add_argument("--threshold", type=float,
                   default=DEFAULT_THRESHOLD_PCT,
                   help="percent slowdown that (with disjoint bands) "
                        "counts as a regression")
    args = p.parse_args(argv)
    if args.baseline:
        sent = check_paths(args.baseline, args.path, args.threshold)
        _render(sent, str(args.path), sys.stdout)
        print(json.dumps({"sentinel": sent}))
        if sent.get("verdict") == "regression":
            return RC_REGRESSION
        if sent.get("verdict") == "no-baseline":
            # a tripwire that silently disarms is worse than no
            # tripwire (same convention as bench.py --check): an
            # artifact pair that can't be compared — a dead capture on
            # either side — is a usage error, not a clean bill
            print("sentinel: nothing compared — no comparable headline "
                  "on one side", file=sys.stderr)
            return 2
        return 0
    return scan_dir(args.path, args.pattern, args.threshold)


if __name__ == "__main__":
    raise SystemExit(main())
