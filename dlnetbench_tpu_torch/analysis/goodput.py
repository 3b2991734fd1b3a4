"""Checkpoint-interval planning: goodput, MTBF, and the Daly optimum (the
port's copy of the JAX package's ``analysis/goodput.py``).

A faulted, checkpointing run's record carries everything a
checkpoint-interval decision needs (the JAX package's resilience loop
writes these globals; the port's proxies do not run it yet):

  * ``checkpoint_stall_ms`` — the in-window cost one save puts ON the
    timed critical path (the whole write under ``mode="stall"``, just
    the device sync + host snapshot under ``mode="async"``);
  * ``restore_ms`` / ``detection_ms`` / ``recovery_ms`` — what one
    eviction costs beyond the redone work;
  * ``lost_steps`` — completed steps a restore-from-latest redid;
  * ``goodput`` — useful steps per wall second over the whole
    preempt -> restore -> rejoin arc (useful = total - lost).

This module fits those measurements into the classic exponential-MTBF
checkpoint model and emits the optimal interval:

  * ``daly_interval_s`` — Daly's higher-order approximation of the
    optimal useful-compute time between saves,

        tau_opt = sqrt(2*d*M) * (1 + sqrt(d/(2M))/3 + (d/(2M))/9) - d
        (d < 2M; else tau_opt = M)

    with d the per-save critical-path cost and M the MTBF;
  * ``efficiency`` — the exact exponential-model expected fraction of
    wall time doing useful work at interval tau,

        eff(tau) = tau / (M * e^(R/M) * (e^((tau+d)/M) - 1))

    (R = per-failure restart cost: restore + detection + recovery;
    the rejoin re-split is excluded — it is paid once per eviction at a
    plan-fixed step, so it shifts every interval's goodput equally and
    cannot move the optimum);
  * ``validate_sweep`` — the acceptance check: given a seeded sweep of
    faulted runs over several ``checkpoint_every`` values, the measured
    goodput-vs-interval optimum must fall inside the Daly prediction
    band.  Bands are honest about both sides: the model band propagates
    the measured cost ranges (checkpoint band x MTBF band, worst/best
    corners) and snaps to the swept grid (a discrete sweep localizes
    the optimum only to grid resolution); the measured side admits
    every interval whose goodput band overlaps the argmax's band (with
    n this small, overlapping bands are indistinguishable — declaring
    a unique winner would be theater, per metrics/stats.py).

CLI::

    python -m dlnetbench_tpu_torch.analysis.goodput report records.jsonl

prints the interval table, the fitted cost model, and the verdict
(exit 2 when the artifact carries no goodput records, 1 when the sweep
optimum falls OUTSIDE the prediction band, 0 otherwise).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import sys

from dlnetbench_tpu_torch.metrics.stats import bands_overlap, summarize


@dataclasses.dataclass
class CostModel:
    """Measured inputs to the interval model, in seconds."""
    step_s: float                    # clean per-step time
    ckpt_s: float                    # per-save critical-path cost (d)
    ckpt_band_s: tuple[float, float]
    restart_s: float                 # per-failure R (restore+detect+recover)
    mtbf_s: float                    # exponential-MTBF estimate (M)
    mtbf_band_s: tuple[float, float]
    n_records: int = 0

    def to_dict(self) -> dict:
        return {"step_s": round(self.step_s, 6),
                "ckpt_s": round(self.ckpt_s, 6),
                "ckpt_band_s": [round(v, 6) for v in self.ckpt_band_s],
                "restart_s": round(self.restart_s, 6),
                "mtbf_s": round(self.mtbf_s, 4),
                "mtbf_band_s": [round(v, 4) for v in self.mtbf_band_s],
                "n_records": self.n_records}


def daly_interval_s(ckpt_s: float, mtbf_s: float) -> float:
    """Daly's higher-order optimum for the useful-compute time between
    saves (seconds).  Degenerate inputs collapse to "save always"
    (tau = 0): a zero MTBF loses everything it does not save, and
    zero-COST saves lose nothing by saving constantly — eff(tau) with
    d = 0 is strictly decreasing in tau, which is also the closed
    form's continuous limit (sqrt(2dM)·(...) - d -> 0).  "Save never"
    only emerges the honest way, from M -> inf.  The caller's grid
    snap turns the edges into the sweep's edge."""
    d, M = float(ckpt_s), float(mtbf_s)
    if M <= 0 or d <= 0:
        return 0.0
    if d >= 2 * M:
        return M
    x = d / (2 * M)
    return math.sqrt(2 * d * M) * (1 + math.sqrt(x) / 3 + x / 9) - d


def efficiency(tau_s: float, ckpt_s: float, mtbf_s: float,
               restart_s: float = 0.0) -> float:
    """Expected useful fraction of wall time at interval ``tau_s``
    under the exponential failure model (module docstring)."""
    tau, d, M, R = (float(v) for v in (tau_s, ckpt_s, mtbf_s, restart_s))
    if tau <= 0 or M <= 0:
        return 0.0
    return tau / (M * math.exp(R / M) * math.expm1((tau + d) / M))


# ------------------------------------------------------- record fitting
def _goodput_records(records: list[dict]) -> list[dict]:
    return [r for r in records
            if isinstance(r.get("global", {}).get("goodput"), (int, float))
            and r["global"].get("checkpoint_every")]


def _pooled_runtimes_us(rec: dict) -> list[float]:
    out: list[float] = []
    for row in rec.get("ranks", []):
        out.extend(float(v) for v in row.get("runtimes", []) if v > 0)
    return out


def fit_costs(records: list[dict]) -> CostModel:
    """Fit the cost model from a sweep's records (every record carries
    its own measured costs; the fit pools them).

    * ``step_s`` comes from the SPARSEST-checkpoint records (largest
      ``checkpoint_every``): at most 1/every of their samples rode a
      save, so their pooled median is the clean step estimator — the
      densest records' medians are save-inflated by construction.
    * ``mtbf_s`` treats each record's seeded preempt trigger as one
      draw from the eviction process: time-to-eviction = trigger step x
      step_s, and the mean arrival time estimates the exponential M.
      The band is the observed arrival range (metrics/stats.py band
      convention: with draws this few, "samples fell in here").
    """
    recs = _goodput_records(records)
    if not recs:
        raise ValueError("no records with goodput + checkpoint_every "
                         "(a preempt sweep with checkpointing enabled)")
    max_every = max(int(r["global"]["checkpoint_every"]) for r in recs)
    sparse = [r for r in recs
              if int(r["global"]["checkpoint_every"]) == max_every]
    step_samples = [u for r in sparse for u in _pooled_runtimes_us(r)]
    step_s = statistics.median(step_samples) / 1e6

    ckpt_ms = [float(r["global"]["checkpoint_stall_ms"]) for r in recs
               if isinstance(r["global"].get("checkpoint_stall_ms"),
                             (int, float))]
    if not ckpt_ms:
        raise ValueError("no checkpoint_stall_ms in the sweep records")
    ck = summarize(ckpt_ms)

    restart_ms = [sum(float(r["global"].get(k) or 0.0)
                      for k in ("restore_ms", "detection_ms",
                                "recovery_ms"))
                  for r in recs]
    arrivals_s = [int(r["global"].get("fault_iteration", 0)) * step_s
                  for r in recs
                  if r["global"].get("fault_iteration") is not None]
    if not arrivals_s:
        raise ValueError("no fault_iteration in the sweep records")
    mtbf = sum(arrivals_s) / len(arrivals_s)
    return CostModel(
        step_s=step_s,
        ckpt_s=ck["value"] / 1e3,
        ckpt_band_s=(ck["band"][0] / 1e3, ck["band"][1] / 1e3),
        restart_s=statistics.median(restart_ms) / 1e3,
        mtbf_s=mtbf,
        mtbf_band_s=(min(arrivals_s), max(arrivals_s)),
        n_records=len(recs))


def interval_prediction(model: CostModel) -> dict:
    """The Daly optimum in seconds AND in harness steps, with the band
    propagated from the measured cost ranges: tau_opt is monotone
    increasing in both d and M, so the (d, M) corner extremes bound
    it."""
    opt_s = daly_interval_s(model.ckpt_s, model.mtbf_s)
    corners = [daly_interval_s(d, M)
               for d in model.ckpt_band_s for M in model.mtbf_band_s]
    lo_s, hi_s = min(corners), max(corners)
    to_steps = (lambda s: s / model.step_s if model.step_s > 0
                else math.inf)
    return {"tau_opt_s": round(opt_s, 6),
            "tau_band_s": [round(lo_s, 6), round(hi_s, 6)],
            "opt_steps": round(to_steps(opt_s), 3),
            "band_steps": [round(to_steps(lo_s), 3),
                           round(to_steps(hi_s), 3)]}


def _snap_band_to_grid(band_steps, grid: list[int]) -> tuple[int, int]:
    """Widen a continuous step band to the swept grid: the largest grid
    point <= lo and the smallest >= hi (grid edges when the band falls
    off either end) — a discrete sweep cannot localize the optimum
    finer than its own resolution."""
    lo, hi = band_steps
    below = [g for g in grid if g <= lo]
    above = [g for g in grid if g >= hi]
    return (max(below) if below else min(grid),
            min(above) if above else max(grid))


def validate_sweep(records: list[dict]) -> dict:
    """The acceptance check (module docstring): measured goodput per
    swept ``checkpoint_every``, the fitted model's Daly band snapped to
    the grid, and whether any statistically-admissible measured optimum
    lands inside it."""
    recs = _goodput_records(records)
    model = fit_costs(recs)
    by_every: dict[int, list[float]] = {}
    for r in recs:
        by_every.setdefault(int(r["global"]["checkpoint_every"]),
                            []).append(float(r["global"]["goodput"]))
    grid = sorted(by_every)
    intervals = {e: summarize(v, ndigits=4) for e, v in by_every.items()}
    measured_opt = max(grid, key=lambda e: intervals[e]["value"])
    # every interval whose band overlaps the winner's is a candidate
    # optimum — n is small and overlapping bands cannot be ranked
    candidates = [e for e in grid
                  if bands_overlap(intervals[e]["band"],
                                   intervals[measured_opt]["band"])]
    pred = interval_prediction(model)
    band_lo, band_hi = _snap_band_to_grid(pred["band_steps"], grid)
    in_band = any(band_lo <= e <= band_hi for e in candidates)
    # the model's SHAPE over the grid, normalized to its max: the
    # steady-state model assumes failures recur every MTBF forever,
    # which a single-eviction run does not match, so its absolute
    # goodput is not comparable to the measured column — only the
    # interval-dependence (and hence the optimum) transfers
    raw = {e: efficiency(e * model.step_s, model.ckpt_s, model.mtbf_s,
                         model.restart_s) for e in grid}
    peak = max(raw.values()) or 1.0
    predicted = {e: round(v / peak, 4) for e, v in raw.items()}
    return {"intervals": intervals,
            "predicted_rel": predicted,
            "measured_opt_every": measured_opt,
            "candidate_optima": candidates,
            "model": model.to_dict(),
            "daly": {**pred, "band_grid": [band_lo, band_hi]},
            "in_band": in_band}


# ----------------------------------------------------------------- CLI
def _load(path: str) -> list[dict]:
    from dlnetbench_tpu_torch.metrics.parser import load_records
    return load_records(path)


def report(path: str, out=None, verdict: dict | None = None) -> int:
    """Render the interval table for ``path``.  A caller that already
    ran ``validate_sweep`` over the same records passes it as
    ``verdict`` — the table and the caller's written verdict then come
    from ONE computation (and the file is not re-read)."""
    out = out or sys.stdout
    if verdict is None:
        try:
            verdict = validate_sweep(_load(path))
        except ValueError as e:
            print(f"goodput: {e}", file=sys.stderr)
            return 2
    v = verdict
    m, d = v["model"], v["daly"]
    print(f"fitted cost model over {m['n_records']} records:", file=out)
    print(f"  step      {m['step_s'] * 1e3:9.3f} ms", file=out)
    print(f"  save      {m['ckpt_s'] * 1e3:9.3f} ms in-window  "
          f"band [{m['ckpt_band_s'][0] * 1e3:.3f}, "
          f"{m['ckpt_band_s'][1] * 1e3:.3f}]", file=out)
    print(f"  restart   {m['restart_s'] * 1e3:9.3f} ms per eviction",
          file=out)
    print(f"  MTBF      {m['mtbf_s']:9.3f} s       "
          f"band [{m['mtbf_band_s'][0]:.3f}, {m['mtbf_band_s'][1]:.3f}]",
          file=out)
    print(f"Daly optimum: {d['tau_opt_s'] * 1e3:.3f} ms "
          f"= {d['opt_steps']:.2f} steps; band {d['band_steps']} steps "
          f"-> grid {d['band_grid']}", file=out)
    print(f"{'every':>6} {'goodput steps/s':>16} {'band':>22} "
          f"{'model rel':>9}", file=out)
    for e, s in sorted(v["intervals"].items()):
        mark = " <- measured optimum" if e == v["measured_opt_every"] \
            else (" (candidate)" if e in v["candidate_optima"] else "")
        print(f"{e:>6} {s['value']:>16.4f} "
              f"{str(s['band']):>22} {v['predicted_rel'][e]:>9.4f}"
              f"{mark}", file=out)
    print(f"verdict: measured optimum "
          f"{'INSIDE' if v['in_band'] else 'OUTSIDE'} the Daly band",
          file=out)
    return 0 if v["in_band"] else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "report":
        return report(argv[1])
    if len(argv) == 2 and argv[0] == "json":
        try:
            print(json.dumps(validate_sweep(_load(argv[1])), indent=1))
        except ValueError as e:
            print(f"goodput: {e}", file=sys.stderr)
            return 2
        return 0
    print("usage: python -m dlnetbench_tpu_torch.analysis.goodput "
          "{report|json} records.jsonl", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
