"""Continuous telemetry: the per-step flight recorder and the anomaly
engine (the JAX package's ``metrics/telemetry.py``).

Spans time harness *phases*; the record's summaries describe a
*finished* run in medians and bands.  A mid-run anomaly — a straggler
window, an SLO breach, a KV-pool squeeze — would show only as a fatter
band after the fact.

``FlightRecorder`` is the channel for it: a fixed-capacity ring buffer
of per-step samples (step wall, the compute leg, energy, the card's SM
clock and power; the serving engine's queue depth, active slots, KV
occupancy and fragmentation), fed from the measurement loops
(``proxies/base.py``, ``serving/scheduler.py``).  Like ``spans.py``,
telemetry is OFF by default and the disabled path allocates nothing
per step: every sampling site gates on ``is_enabled()`` (one global
load + one ``is None`` test), so an untelemetered run's record is byte
for byte the one a build without this module writes.

The **anomaly engine** rides the recorder.  Triggers:

  ``stall``      — a watchdog's deadline fired
                   (utils/watchdog.StepWatchdog)
  ``fault``      — a scripted crash/preemption was detected
                   (faults/policy.run_faulted)
  ``slo``        — a rolling window of completions breached the SLO
                   (serving/metrics.rolling_slo_breach)
  ``step_time``  — band-aware step-time change detection
                   (``observe_step_wall``: the trailing window's band
                   sits above — and disjoint from — the baseline band,
                   metrics/stats.py conventions)

Each trigger appends an anomaly event and dumps the aligned ring
window as ``flight_<trigger>.json`` into ``dump_dir`` (cooldown +
per-kind dump cap, so a pathological run cannot dump-storm the disk).
A recorder given a ``rank`` (a rank of a multi-rank run) names its
dumps ``flight_<trigger>[_<n>]_rank<r>.json``, so that the ranks of
one host, sharing one directory, do not overwrite each other.
``metrics/emit.py`` stamps ``telemetry_block`` / ``anomalies_block``
into the record; ``spans.telemetry_counter_events`` renders the ring
as Perfetto counter tracks next to the host and device timelines.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from dlnetbench_tpu_torch.metrics.stats import bands_overlap, summarize

DEFAULT_CAPACITY = 512

# step-time change detector: the trailing RECENT_K samples' band must
# sit entirely above the baseline band, with the recent median at least
# (1 + STEP_TIME_MARGIN) x the baseline median — band-disjointness
# alone would trip on clock-resolution jitter for microsecond steps
RECENT_K = 5
BASELINE_MIN = 8
STEP_TIME_MARGIN = 0.5

TRIGGER_KINDS = ("stall", "fault", "slo", "step_time")


class FlightRecorder:
    """Fixed-capacity ring of per-step telemetry samples + the anomaly
    engine over them.  Thread-safe (a watchdog's Timer thread and the
    measuring thread may both touch it); one recorder per process is
    the intended shape (module-level ``enable``/``current``)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: str | Path | None = None, *,
                 cooldown_s: float = 1.0, max_dumps_per_trigger: int = 4,
                 rank: int | None = None):
        if capacity < 1:
            raise ValueError(f"telemetry: capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self.origin = time.monotonic()
        self.cooldown_s = float(cooldown_s)
        self.max_dumps_per_trigger = int(max_dumps_per_trigger)
        self.rank = rank                  # dump-name suffix when set
        self._buf: list[dict | None] = [None] * self.capacity
        self._n = 0                       # total samples ever recorded
        self._lock = threading.Lock()
        self.anomalies: list[dict] = []
        self._dump_counts: dict[str, int] = {}
        self._last_trigger_t: dict[str, float] = {}
        # step-time detector state: source -> deque of recent walls
        self._walls: dict[str, deque] = {}

    # ---- the ring ----------------------------------------------------
    def now_s(self) -> float:
        return time.monotonic() - self.origin

    def record(self, source: str, step: int | None = None,
               **fields) -> dict:
        """Append one per-step sample.  ``source`` names the feeding
        loop (``proxy``, ``serving`` ...); ``fields`` are
        numeric series (units in the name: ``step_wall_us``,
        ``queue_depth``, ``kv_occupancy`` ...)."""
        sample = {"t_s": round(self.now_s(), 6), "source": source}
        if step is not None:
            sample["step"] = int(step)
        sample.update(fields)
        with self._lock:
            self._buf[self._n % self.capacity] = sample
            self._n += 1
        return sample

    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        """Samples that fell off the ring (recorded - resident)."""
        return max(0, self._n - self.capacity)

    def samples(self) -> list[dict]:
        """Resident samples, oldest first."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [s for s in self._buf[:n] if s is not None]
            head = n % cap
            return [s for s in self._buf[head:] + self._buf[:head]
                    if s is not None]

    def last(self, k: int) -> list[dict]:
        return self.samples()[-max(int(k), 0):]

    def window(self, t_lo: float | None = None,
               t_hi: float | None = None) -> list[dict]:
        """Resident samples with ``t_lo <= t_s <= t_hi`` (None = open)."""
        return [s for s in self.samples()
                if (t_lo is None or s["t_s"] >= t_lo)
                and (t_hi is None or s["t_s"] <= t_hi)]

    # ---- band-aware step-time change detection -----------------------
    def reset_walls(self, source: str | None = None) -> None:
        """Drop the change detector's wall history for ``source`` (all
        sources when None).  Callers starting a structurally new run
        over a live recorder (a different engine in a bench A/B, a
        fresh run_proxy invocation) must re-baseline — the new run's
        honest steady state is not an anomaly against the old run's."""
        if source is None:
            self._walls.clear()
        else:
            self._walls.pop(source, None)

    def observe_step_wall(self, source: str, wall_us: float,
                          step: int | None = None) -> dict | None:
        """Feed one step's wall time to the change detector.  Fires a
        ``step_time`` anomaly when the last ``RECENT_K`` samples'
        band sits entirely above the preceding baseline's band
        (``metrics/stats`` conventions: disjoint bands are the one
        honest statement of "distinguishable from noise") AND the
        recent median exceeds the baseline median by
        ``STEP_TIME_MARGIN``.  Returns the anomaly event when fired."""
        hist = self._walls.get(source)
        if hist is None:
            hist = self._walls[source] = deque(
                maxlen=BASELINE_MIN * 8 + RECENT_K)
        hist.append(float(wall_us))
        if len(hist) < BASELINE_MIN + RECENT_K:
            return None
        vals = list(hist)
        base = summarize(vals[:-RECENT_K])
        recent = summarize(vals[-RECENT_K:])
        if bands_overlap(base["band"], recent["band"]) is not False:
            return None
        if recent["value"] <= base["value"] * (1.0 + STEP_TIME_MARGIN) \
                or recent["best"] <= base["band"][1]:
            return None
        ev = self.trigger("step_time", step=step, detail={
            "source": source,
            "baseline_us": base, "recent_us": recent,
            "ratio": round(recent["value"] / base["value"], 3)
            if base["value"] > 0 else None})
        # re-baseline so a sustained shift fires once, not every step
        hist.clear()
        return ev

    # ---- the anomaly engine ------------------------------------------
    def trigger(self, kind: str, step: int | None = None,
                detail: dict | None = None) -> dict | None:
        """Record one anomaly; dumps the aligned ring window as
        ``flight_<kind>.json`` (rank-suffixed when ``rank`` is set) when
        ``dump_dir`` is set.  Per-kind
        cooldown: re-triggers inside ``cooldown_s`` are dropped (a
        breach spanning many steps is ONE anomaly, not a dump storm).
        Returns the event, or None when throttled."""
        t = self.now_s()
        with self._lock:
            last = self._last_trigger_t.get(kind)
            if last is not None and t - last < self.cooldown_s:
                return None
            self._last_trigger_t[kind] = t
        ev: dict = {"trigger": kind, "t_s": round(t, 6)}
        if step is not None:
            ev["step"] = int(step)
        if detail:
            ev["detail"] = detail
        dump = self._write_dump(kind, ev)
        if dump is not None:
            ev["dump"] = dump
        with self._lock:
            self.anomalies.append(ev)
        return ev

    def _write_dump(self, kind: str, ev: dict) -> str | None:
        if self.dump_dir is None:
            return None
        with self._lock:
            count = self._dump_counts.get(kind, 0)
            if count >= self.max_dumps_per_trigger:
                return None
            self._dump_counts[kind] = count + 1
        name = (f"flight_{kind}" + (f"_{count + 1}" if count else "")
                + (f"_rank{self.rank}" if self.rank is not None else "")
                + ".json")
        payload = {
            "trigger": kind,
            "t_s": ev["t_s"],
            **({"step": ev["step"]} if "step" in ev else {}),
            **({"detail": ev["detail"]} if "detail" in ev else {}),
            "capacity": self.capacity,
            "recorded": self._n,
            # the aligned ring window INTO the anomaly: everything the
            # ring still holds up to the trigger instant — the trend
            # into the event, not just the frozen instant
            "samples": self.window(t_hi=ev["t_s"]),
        }
        try:
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            path = self.dump_dir / name
            with open(path, "w") as f:
                json.dump(payload, f)
            return str(path)
        except OSError as e:  # derived data must never cost the run
            import sys
            print(f"telemetry: flight dump {name} failed ({e}); "
                  f"anomaly recorded without it", file=sys.stderr)
            return None

    # ---- record stamping ---------------------------------------------
    def telemetry_block(self, last: int = 16) -> dict:
        """The record's ``telemetry`` global: ring geometry + the last
        few resident samples (the FULL ring rides flight dumps, not
        records — a 512-sample ring would bloat every artifact).
        Volatile at merge: each process records its own ring."""
        tail = self.last(last)
        return {
            "capacity": self.capacity,
            "recorded": self._n,
            "dropped": self.dropped,
            "sources": sorted({s["source"] for s in tail}
                              | set(self._walls)),
            "last": tail,
        }

    def anomalies_block(self) -> dict | None:
        """The record's ``anomalies`` global, or None when the run was
        clean (a clean telemetered record carries the telemetry block
        but no anomalies key — absence IS the verdict)."""
        with self._lock:
            events = list(self.anomalies)
        if not events:
            return None
        counts: dict[str, int] = {}
        for ev in events:
            counts[ev["trigger"]] = counts.get(ev["trigger"], 0) + 1
        return {"count": len(events), "triggers": counts,
                "events": events[-16:]}


# ---------------------------------------------------------------------
# Module-level current recorder — the spans.py no-op-singleton pattern:
# ``None`` means disabled (the common case) and every hot sampling site
# gates on ``is_enabled()`` (one global load + one ``is None`` test)
# before building its kwargs, so the disabled path allocates NOTHING
# per step (locked by tests/test_torch_telemetry.py).

_RECORDER: FlightRecorder | None = None


def enable(capacity: int | None = None,
           dump_dir: str | Path | None = None,
           rank: int | None = None) -> FlightRecorder:
    """Install (and return) a fresh recorder as the process recorder.
    ``capacity``/``dump_dir`` default from ``DLNB_TELEMETRY_CAPACITY``
    and ``DLNB_FLIGHT_DIR``; ``rank`` suffixes the dump names (a rank
    of a multi-rank run)."""
    global _RECORDER
    if capacity is None:
        capacity = int(os.environ.get("DLNB_TELEMETRY_CAPACITY",
                                      DEFAULT_CAPACITY))
    if dump_dir is None:
        dump_dir = os.environ.get("DLNB_FLIGHT_DIR") or None
    _RECORDER = FlightRecorder(capacity, dump_dir, rank=rank)
    return _RECORDER


def disable() -> FlightRecorder | None:
    """Stop recording; returns the recorder that was active (with its
    ring and anomalies) so callers can stamp/export after the run."""
    global _RECORDER
    r, _RECORDER = _RECORDER, None
    return r


def current() -> FlightRecorder | None:
    return _RECORDER


def is_enabled() -> bool:
    return _RECORDER is not None


def enable_from_env(rank: int | None = None) -> FlightRecorder | None:
    """Enable iff ``DLNB_TELEMETRY`` is set truthy (the env channel for
    drivers that cannot pass flags); an already-active recorder wins."""
    if _RECORDER is not None:
        return _RECORDER
    if os.environ.get("DLNB_TELEMETRY", "") in ("", "0", "false", "off"):
        return None
    return enable(rank=rank)


def record_step(source: str, step: int | None = None, **fields) -> None:
    """Record one sample when enabled; free when not.  Hot sites should
    additionally gate on ``is_enabled()`` BEFORE assembling ``fields``
    — a kwargs dict is an allocation the disabled contract forbids."""
    r = _RECORDER
    if r is None:
        return
    r.record(source, step, **fields)


def trigger(kind: str, step: int | None = None,
            detail: dict | None = None) -> dict | None:
    """Fire an anomaly on the current recorder ({} -> noop when off)."""
    r = _RECORDER
    if r is None:
        return None
    return r.trigger(kind, step=step, detail=detail)


def observe_step_wall(source: str, wall_us: float,
                      step: int | None = None) -> None:
    r = _RECORDER
    if r is None:
        return
    r.observe_step_wall(source, wall_us, step=step)
