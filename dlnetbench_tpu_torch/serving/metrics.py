"""Serving metrics: per-request TTFT/TPOT, percentiles, goodput-at-SLO
(the JAX package's ``serving/metrics.py``).

* **TTFT** — ``first_token - arrival``, queue wait included.
* **TPOT** — ``(finish - first_token) / (output_len - 1)``; requests
  with one output token give no sample.
* **e2e** — ``finish - arrival``.
* **goodput-at-SLO** — completed requests meeting both SLOs per wall
  second; ``goodput_timeline`` windows it over finish times, and
  ``rolling_slo_breach`` applies the windowing live (the engine's
  flight recorder fires ``slo`` on it).

``build_result`` shapes a run as a ``ProxyResult`` so the record is the
JAX package's schema v2: per-request arrays as timers, the aggregate
``serving`` block and the arrival plan as globals.  ``LiveMetricsWriter``
is the live channel (``cli serve --live_metrics``): one JSONL snapshot
line per window of engine time.
"""
from __future__ import annotations

import dataclasses
import json
import math

from dlnetbench_tpu_torch.proxies.base import ProxyResult
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan


@dataclasses.dataclass
class Completed:
    """One finished request's stamps (seconds, engine-clock relative)."""
    rid: int
    arrival_s: float
    admitted_s: float
    first_token_s: float
    finish_s: float
    prompt_len: int
    output_len: int

    @property
    def ttft_ms(self) -> float:
        return (self.first_token_s - self.arrival_s) * 1e3

    @property
    def tpot_ms(self) -> float:
        """NaN for single-token outputs (no inter-token interval)."""
        if self.output_len < 2:
            return float("nan")
        return ((self.finish_s - self.first_token_s)
                / (self.output_len - 1)) * 1e3

    @property
    def e2e_ms(self) -> float:
        return (self.finish_s - self.arrival_s) * 1e3


def percentile(vals: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); NaN on empty input."""
    vals = sorted(v for v in vals if not math.isnan(v))
    if not vals:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[min(rank, len(vals)) - 1]


def latency_summary(vals_ms: list[float], ndigits: int = 3) -> dict:
    clean = [v for v in vals_ms if not math.isnan(v)]
    if not clean:
        return {"p50": float("nan"), "p95": float("nan"),
                "p99": float("nan"), "mean": float("nan"), "n": 0}
    return {
        "p50": round(percentile(clean, 50), ndigits),
        "p95": round(percentile(clean, 95), ndigits),
        "p99": round(percentile(clean, 99), ndigits),
        "mean": round(sum(clean) / len(clean), ndigits),
        "n": len(clean),
    }


def meets_slo(c: Completed, slo_ttft_ms: float, slo_tpot_ms: float) -> bool:
    """Both budgets must hold; a request without a TPOT sample is judged
    on TTFT alone."""
    if c.ttft_ms > slo_ttft_ms:
        return False
    tpot = c.tpot_ms
    return math.isnan(tpot) or tpot <= slo_tpot_ms


def goodput_timeline(completed: list[Completed], slo_ttft_ms: float,
                     slo_tpot_ms: float, window_s: float = 0.5) -> list:
    """Windowed SLO-goodput over finish times; a window with no
    completion states ``goodput_frac: None``."""
    if not completed:
        return []
    horizon = max(c.finish_s for c in completed)
    n_win = max(1, math.ceil(horizon / window_s))
    out = []
    for w in range(n_win):
        lo, hi = w * window_s, (w + 1) * window_s
        done = [c for c in completed if lo <= c.finish_s < hi]
        ok = sum(1 for c in done if meets_slo(c, slo_ttft_ms,
                                              slo_tpot_ms))
        out.append({
            "t_s": round(hi, 3),
            "completed": len(done),
            "slo_ok": ok,
            "goodput_frac": round(ok / len(done), 4) if done else None,
        })
    return out


def rolling_slo_breach(recent: list[Completed], *, slo_ttft_ms: float,
                       slo_tpot_ms: float, now_s: float,
                       window_s: float = 0.5, min_completed: int = 4,
                       breach_frac: float = 0.5) -> dict | None:
    """Live SLO-breach detection: the ``goodput_timeline`` windowing
    applied to the trailing window at ``now_s``.  Returns the breaching
    window entry ``{"t_s", "completed", "slo_ok", "goodput_frac"}``
    when the last ``window_s`` seconds completed at least
    ``min_completed`` requests and their SLO-ok fraction fell below
    ``breach_frac``; None otherwise."""
    tail = [c for c in recent if c.finish_s >= now_s - window_s]
    if len(tail) < min_completed:
        return None
    ok = sum(1 for c in tail if meets_slo(c, slo_ttft_ms, slo_tpot_ms))
    frac = ok / len(tail)
    if frac >= breach_frac:
        return None
    return {"t_s": round(now_s, 3), "completed": len(tail),
            "slo_ok": ok, "goodput_frac": round(frac, 4)}


class LiveMetricsWriter:
    """Windowed live-metrics JSONL stream: one snapshot line per
    ``window_s`` of engine time — TTFT/TPOT percentiles over the
    window's completions, queue depth, admitted concurrency, KV
    occupancy.  The JAX package's schema, line for line; pure except
    for the appends to ``path``."""

    def __init__(self, path, *, window_s: float = 0.5):
        self.path = path
        self.window_s = float(window_s)
        self._last_emit_s: float | None = None
        self._run = 0
        self.lines_written = 0
        # one invocation, one stream: lines of an earlier run would
        # interleave stale snapshots into the feed
        open(self.path, "w").close()

    def reset_run(self) -> None:
        """A new engine run: the engine clock restarts at 0, so the
        window stamp does too, and the ``run`` stamp counts up so that
        (run, t_s) orders the feed.  Called by the engine's
        ``_reset_state``."""
        self._last_emit_s = None
        self._run += 1

    @staticmethod
    def snapshot_line(*, t_s: float, window_s: float,
                      window_completed: list[Completed],
                      queue_depth: int, active_slots: int,
                      kv_occupancy: float,
                      engine_steps: int, run: int = 0,
                      replica_id: int | None = None) -> dict:
        """One snapshot (pure).  The latency percentiles cover the
        window's completions only; ``replica_id`` attributes the line in
        an interleaved multi-replica stream and is absent otherwise."""
        ttft = [c.ttft_ms for c in window_completed]
        tpot = [c.tpot_ms for c in window_completed]
        line = {
            "run": int(run),
            "t_s": round(t_s, 3),
            "window_s": window_s,
            "completed": len(window_completed),
            "ttft_ms": latency_summary(ttft),
            "tpot_ms": latency_summary(tpot),
            "queue_depth": int(queue_depth),
            "active_slots": int(active_slots),
            "kv_occupancy": round(float(kv_occupancy), 4),
            "engine_steps": int(engine_steps),
        }
        if replica_id is not None:
            line["replica_id"] = int(replica_id)
        return line

    def maybe_emit(self, engine, now_s: float) -> dict | None:
        """Called by the engine once a step: writes (and returns) a
        snapshot when a full window has passed since the last one."""
        if self._last_emit_s is not None \
                and now_s - self._last_emit_s < self.window_s:
            return None
        t0 = (self._last_emit_s if self._last_emit_s is not None
              else max(0.0, now_s - self.window_s))
        self._last_emit_s = now_s
        line = self.snapshot_line(
            t_s=now_s, window_s=self.window_s,
            window_completed=[c for c in engine.completed
                              if c.finish_s >= t0],
            queue_depth=len(engine.pending),
            active_slots=sum(1 for s in engine.slots if s is not None),
            kv_occupancy=engine.cache.stats()["occupancy"],
            engine_steps=engine.engine_steps, run=self._run,
            replica_id=getattr(engine, "replica_id", None))
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
        self.lines_written += 1
        return line


def serving_block(completed: list[Completed], plan: ArrivalPlan, *,
                  slo_ttft_ms: float, slo_tpot_ms: float,
                  wall_s: float, engine_steps: int,
                  cache_stats: dict | None = None,
                  queue_depth_max: int = 0,
                  batch_occupancy_mean: float = 0.0,
                  decode_loop: dict | None = None,
                  admitted_peak: int | None = None,
                  migration: dict | None = None) -> dict:
    """The record's ``serving`` global: latency percentiles, throughput
    and goodput-at-SLO for one run, with the cache and decode-dispatch
    blocks when given, and a disaggregated run's page-migration block
    (``ops/page_migration.MigrationChannel.stats_block``)."""
    ttft = [c.ttft_ms for c in completed]
    tpot = [c.tpot_ms for c in completed]
    e2e = [c.e2e_ms for c in completed]
    tokens = sum(c.output_len for c in completed)
    ok = sum(1 for c in completed if meets_slo(c, slo_ttft_ms,
                                               slo_tpot_ms))
    block = {
        "offered_rps": round(plan.offered_rps(), 4),
        "completed": len(completed),
        "measured_rps": round(len(completed) / wall_s, 4) if wall_s > 0
        else 0.0,
        "tokens_per_s": round(tokens / wall_s, 4) if wall_s > 0 else 0.0,
        "wall_s": round(wall_s, 4),
        "engine_steps": engine_steps,
        "ttft_ms": latency_summary(ttft),
        "tpot_ms": latency_summary(tpot),
        "e2e_ms": latency_summary(e2e),
        "slo": {"ttft_ms": slo_ttft_ms, "tpot_ms": slo_tpot_ms},
        "goodput_frac": round(ok / len(completed), 4) if completed
        else 0.0,
        "goodput_rps": round(ok / wall_s, 4) if wall_s > 0 else 0.0,
        "queue_depth_max": queue_depth_max,
        "batch_occupancy_mean": round(batch_occupancy_mean, 4),
        "goodput_timeline": goodput_timeline(completed, slo_ttft_ms,
                                             slo_tpot_ms),
    }
    if admitted_peak is not None:
        block["admitted_concurrency_peak"] = admitted_peak
    if cache_stats:
        block["kv_cache"] = cache_stats
    if decode_loop:
        block["decode_loop"] = decode_loop
    if migration:
        block["migration"] = migration
    return block


def acceptance_by_temp(points: list[tuple[float, float]]) -> list[dict]:
    """Measured (temperature, acceptance_rate) pairs as the
    ``spec_acceptance_by_temp`` record global: sorted by temperature,
    rates clamped to [0, 1] and rounded."""
    out = []
    for temp, rate in sorted(points, key=lambda p: float(p[0])):
        out.append({"temperature": round(float(temp), 4),
                    "acceptance_rate": round(
                        min(1.0, max(0.0, float(rate))), 4)})
    return out


def build_result(completed: list[Completed], plan: ArrivalPlan,
                 global_meta: dict, *, section: str = "serving"
                 ) -> ProxyResult:
    """One "run" per completed request, in finish order; per-request
    ttft/tpot/e2e (ms) and output_len arrays as the timers (their names
    carry no trailing 's', which the parser's singular-column rule would
    strip)."""
    order = sorted(completed, key=lambda c: c.finish_s)
    timers = {
        "ttft": [round(c.ttft_ms, 3) for c in order],
        "tpot": [0.0 if math.isnan(c.tpot_ms) else round(c.tpot_ms, 3)
                 for c in order],
        "e2e": [round(c.e2e_ms, 3) for c in order],
        "output_len": [c.output_len for c in order],
    }
    return ProxyResult(
        name=section,
        global_meta=global_meta,
        timers_us=timers,
        warmup_times_us=[],
        num_runs=len(order),
    )
