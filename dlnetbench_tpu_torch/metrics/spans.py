"""Host-side span tracing (the JAX package's ``metrics/spans.py``).

Every number the harness emits is a host wall-clock measurement of
asynchronous device work.  The device side has its own trace channel
(``torch.profiler`` -> ``metrics/profiling.py``); this module gives the
host side — build, graph capture, warmup, calibration, fence waits,
sweep points — the same artifact:

* ``span("name", key=value)`` is a context manager timing a region on
  the process-wide monotonic clock (``time.perf_counter``), nestable
  across threads (each thread keeps its own depth stack).
* Tracing is OFF by default and the disabled path is near-zero cost:
  ``span()`` returns a shared no-op singleton — no span object is
  allocated, no clock is read, nothing is recorded.  (A keyword-attrs
  call still builds its kwargs dict, so the hot fence site in
  ``utils/timing.py`` additionally gates on ``is_enabled()``.)
* ``write_chrome_trace`` exports the spans as Chrome-trace ("Trace
  Event Format") complete events and MERGES them with the device
  events ``torch.profiler`` recorded for the same run on every rank,
  so ONE ``trace.json`` (Perfetto / chrome://tracing) shows where the
  wall clock went: the host track on top, one device track per rank
  below, collectives colored by kind (``profiling.classify_op``, or
  the kind the profiler linked to the launching collective).

The tracer is not a per-collective measurement channel — that is the
decomposition harness (proxies/base.py) and the device trace
(metrics/profiling.py).  Spans attribute *phases* of the harness
itself, the layer neither channel covers.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path

# ---------------------------------------------------------------------
# Tracer core.

class _NullSpan:
    """Shared disabled-mode span: entering/exiting does nothing and the
    module hands out this one instance for every disabled ``span()``
    call — the per-span allocation count when disabled is zero."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records start on __enter__, appends a finished
    record to its tracer on __exit__.  Exceptions propagate (the span
    still closes, marked ``error``) so a failing phase stays visible in
    the timeline instead of vanishing with its context."""
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._depth = self._tracer._push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._pop()
        if exc_type is not None:
            attrs = dict(self.attrs or {})
            attrs["error"] = exc_type.__name__
            self.attrs = attrs
        tr._record(self.name, self._t0, t1, self._depth, self.attrs)
        return False


class Tracer:
    """Collects finished spans as plain dicts (name, ts/dur in us on the
    tracer's own origin, thread id, nesting depth, attrs).  Thread-safe;
    one tracer per measured run is the intended shape."""

    def __init__(self):
        self.origin = time.perf_counter()
        self.spans: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # tid -> stack of OPEN span names, readable from other threads:
        # a stall handler firing on a Timer thread (the JAX package's
        # watchdog) must see where the measuring thread currently is
        self._active: dict[int, list[str]] = {}

    # -- called by _Span --------------------------------------------
    def _push(self, name: str) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        with self._lock:
            self._active.setdefault(threading.get_ident(), []).append(name)
        return depth

    def _pop(self) -> None:
        self._local.depth = getattr(self._local, "depth", 1) - 1
        with self._lock:
            stack = self._active.get(threading.get_ident())
            if stack:
                stack.pop()

    def active_stacks(self) -> dict[int, list[str]]:
        """Snapshot of every thread's open-span stack (outermost first)."""
        with self._lock:
            return {tid: list(stack)
                    for tid, stack in self._active.items() if stack}

    def _record(self, name: str, t0: float, t1: float, depth: int,
                attrs: dict | None) -> None:
        rec = {
            "name": name,
            "ts_us": (t0 - self.origin) * 1e6,
            "dur_us": (t1 - t0) * 1e6,
            "tid": threading.get_ident(),
            "depth": depth,
        }
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            self.spans.append(rec)

    # -- public ------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs or None)


# Module-level current tracer.  ``None`` means disabled — the common
# case — and the ``span()`` fast path below is one global load, one
# ``is None`` test, one return of the shared singleton.
_TRACER: Tracer | None = None


def enable() -> Tracer:
    """Install (and return) a fresh tracer as the process tracer.
    Subsequent ``span()`` calls record into it."""
    global _TRACER
    _TRACER = Tracer()
    return _TRACER


def disable() -> Tracer | None:
    """Stop tracing; returns the tracer that was active (with its
    collected spans) so callers can export after the measured region."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def current() -> Tracer | None:
    return _TRACER


def is_enabled() -> bool:
    return _TRACER is not None


def span(name: str, **attrs):
    """Time a region when tracing is enabled; free when it is not."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def active_stacks() -> dict[int, list[str]]:
    """Every thread's currently-open span stack ({} when tracing is
    off) — a stall handler's breadcrumb channel."""
    t = _TRACER
    return t.active_stacks() if t is not None else {}


# ---------------------------------------------------------------------
# Chrome-trace / Perfetto export.

HOST_PID = 0          # host spans live on one process track
_DEVICE_PID_BASE = 1  # rank r's device track is pid _DEVICE_PID_BASE + r

# chrome://tracing reserved color names per collective kind — Perfetto
# falls back to hashing the name, so the kind also rides in args.kind
_KIND_CNAME = {
    "allreduce": "thread_state_running",
    "allgather": "thread_state_runnable",
    "reduce_scatter": "thread_state_iowait",
    "alltoall": "rail_animation",
    "permute": "rail_response",
    "send_recv": "rail_idle",
}


def host_events(tracer: Tracer, *, pid: int = HOST_PID) -> list[dict]:
    """Tracer spans -> Chrome complete ('X') events on the host track."""
    events: list[dict] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": "host (harness phases)"}},
        {"ph": "M", "pid": pid, "name": "process_sort_index",
         "args": {"sort_index": -1}},  # host track above device tracks
    ]
    for s in tracer.spans:
        ev = {
            "ph": "X",
            "pid": pid,
            "tid": s["tid"],
            "name": s["name"],
            "ts": s["ts_us"],
            "dur": s["dur_us"],
        }
        args = dict(s.get("attrs") or {})
        args["depth"] = s["depth"]
        ev["args"] = args
        events.append(ev)
    return events


def _colored_device_events(device_tracks: list[tuple[str, list[dict]]],
                           align_to_us: float | None) -> list[dict]:
    """Put each rank's device events on its own track, shift them onto
    the host timeline and color the collectives.

    ``device_tracks`` holds one ``(label, events)`` pair per rank, in
    rank order (label e.g. ``"rank 0 (cuda:0)"``); rank r's events go
    to pid ``_DEVICE_PID_BASE + r`` under a ``process_name`` naming the
    label.  The profiler's timestamps are on its own epoch, shared by
    the ranks of one host, so one shift for all ranks keeps their
    relative layout: the earliest device event of any rank is aligned
    to ``align_to_us`` on the host clock (the start of the span that
    bracketed the profiled iteration when the caller knows it, else
    0).  An event's kind is the one the profiler linked to it
    (``args.kind``), else ``classify_op`` of its name."""
    from dlnetbench_tpu_torch.metrics.profiling import classify_op

    stamps = [float(e.get("ts", 0.0)) for _, evs in device_tracks
              for e in evs]
    if not stamps:
        return []
    shift = (align_to_us if align_to_us is not None else 0.0) - min(stamps)
    out = []
    for r, (label, evs) in enumerate(device_tracks):
        pid = _DEVICE_PID_BASE + r
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": label}})
        out.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                    "args": {"sort_index": r}})
        for e in evs:
            ev = {k: v for k, v in e.items() if not k.startswith("_")}
            ev["ts"] = float(e.get("ts", 0.0)) + shift
            ev["pid"] = pid
            args = dict(ev.get("args") or {})
            kind = args.get("kind") or classify_op(str(e.get("name", "")))
            if kind is not None:
                ev["cname"] = _KIND_CNAME[kind]
                args["kind"] = kind
                ev["args"] = args
            out.append(ev)
    return out


def write_chrome_trace(path: str | Path, tracer: Tracer | None,
                       device_tracks: list[tuple[str, list[dict]]]
                       | None = None,
                       align_span: str | None = "profile",
                       extra_events: list[dict] | None = None) -> dict:
    """Write ONE merged Chrome trace: host spans + every rank's device
    events (``device_tracks``: ``(label, events)`` per rank, in rank
    order).

    ``align_span`` names the host span whose start the earliest device
    event is pinned to (the span that wrapped the profiled iteration);
    when absent the device timeline starts at host ts 0.
    ``extra_events`` are appended verbatim — the telemetry counter
    tracks and record-derived per-rank tracks ride this channel.
    Returns the trace dict that was written (callers/tests can inspect
    it without re-reading the file)."""
    events: list[dict] = []
    align_to = None
    if tracer is not None:
        events.extend(host_events(tracer))
        if align_span is not None:
            for s in tracer.spans:
                if s["name"] == align_span:
                    align_to = s["ts_us"]
                    break
    if device_tracks:
        events.extend(_colored_device_events(device_tracks, align_to))
    if extra_events:
        events.extend(extra_events)
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    path = Path(path)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


# ---------------------------------------------------------------------
# Record-derived tracks: per-rank timers + attribution counters.
#
# A record alone carries what a timeline needs: per-rank per-run timer
# samples, their band summaries, the attribution block and the flight
# recorder's ring.  These exporters turn a record into Chrome/Perfetto
# counter + duration tracks (the JAX package's ``metrics.merge
# --trace-out`` reads them; the port's ``--trace-out`` takes the
# telemetry tracks).

ATTRIBUTION_PID = 50       # attribution counter track
TELEMETRY_PID = 60         # flight-recorder counter tracks
_RECORD_PID_BASE = 100     # per-rank record tracks start here


def attribution_counter_events(attr: dict, *, dur_us: float = 1.0,
                               pid: int = ATTRIBUTION_PID) -> list[dict]:
    """Counter tracks for an ``attribution`` block's fractions: one
    Chrome 'C' series per resource over [0, dur_us], so Perfetto shows
    the compute/hbm/comm/host split next to the timelines it explains.
    The ``bound`` verdict rides the track name."""
    fractions = (attr or {}).get("fractions")
    if not fractions:
        return []
    name = f"attribution (bound: {attr.get('bound', '?')})"
    events: list[dict] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": name}},
        {"ph": "M", "pid": pid, "name": "process_sort_index",
         "args": {"sort_index": 40}},
    ]
    for ts in (0.0, max(dur_us, 1.0)):
        events.append({"ph": "C", "pid": pid, "name": "fractions",
                       "ts": ts, "args": {k: round(float(v), 4)
                                          for k, v in fractions.items()}})
    return events


def telemetry_counter_events(block: dict, anomalies: dict | None = None,
                             *, pid: int = TELEMETRY_PID) -> list[dict]:
    """Flight-recorder samples -> Perfetto counter tracks: every
    numeric field of the telemetry samples becomes one 'C' series over
    the samples' own ``t_s`` clock (us on the trace timeline), and each
    anomaly event lands as a global instant ('i', scope process) at its
    trigger time, named by its trigger kind.  Accepts a record's
    ``global.telemetry`` block (tail samples), a flight dump payload
    (full ring), or a live ``FlightRecorder.telemetry_block()``."""
    samples = (block or {}).get("samples") or (block or {}).get("last") \
        or []
    events: list[dict] = []
    if samples:
        events += [
            {"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": "telemetry (flight recorder)"}},
            {"ph": "M", "pid": pid, "name": "process_sort_index",
             "args": {"sort_index": 45}},
        ]
        for s in samples:
            ts = float(s.get("t_s", 0.0)) * 1e6
            for k, v in s.items():
                if k in ("t_s", "source", "step") \
                        or not isinstance(v, (int, float)):
                    continue
                events.append({"ph": "C", "pid": pid, "name": k,
                               "ts": ts, "args": {"value": float(v)}})
    for ev in ((anomalies or {}).get("events") or []):
        events.append({"ph": "i", "pid": pid, "tid": 0, "s": "p",
                       "name": f"anomaly: {ev.get('trigger', '?')}",
                       "ts": float(ev.get("t_s", 0.0)) * 1e6,
                       "args": {k: v for k, v in ev.items()
                                if k != "detail"}})
    return events


def record_track_events(record: dict,
                        pid_base: int = _RECORD_PID_BASE) -> list[dict]:
    """Per-rank tracks from a run record (either tier): each rank
    becomes one process track whose 'runtimes' samples lay out runs as
    duration events end-to-end, every other timer rides as a counter
    series sampled per run, and the schema-v2 band summaries annotate
    the track as instant events (args = the {value, best, band, n}
    dict).  The record's attribution block (stamped by emit, or
    mirrored at merge time for native records) is appended as a counter
    track spanning the laid-out run window."""
    events: list[dict] = []
    rows = record.get("ranks") or []
    max_end = 0.0
    for i, row in enumerate(rows):
        pid = pid_base + i
        rank = row.get("rank", i)
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"rank {rank} "
                                        f"({record.get('section', '?')})"}})
        events.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                       "args": {"sort_index": 50 + i}})
        runtimes = [float(v) for v in row.get("runtimes") or []]
        # runs laid out end-to-end on the rank's own clock: ts of run j
        # is the sum of runs 0..j-1 (wall-adjacent, gaps unknowable)
        starts = []
        t = 0.0
        for v in runtimes:
            starts.append(t)
            t += v
        max_end = max(max_end, t)
        for j, (ts, dur) in enumerate(zip(starts, runtimes)):
            events.append({"ph": "X", "pid": pid, "tid": 0,
                           "name": f"run {j}", "ts": ts, "dur": dur,
                           "args": {"us": dur}})
        for timer, vals in row.items():
            # skip structural list fields (chip coords are not a timer
            # series) alongside the runtimes already laid out above
            if timer in ("runtimes", "coords") or not isinstance(vals,
                                                                 list):
                continue
            for j, v in enumerate(vals):
                if j >= len(starts):
                    break
                try:
                    fv = float(v)
                except (TypeError, ValueError):
                    break
                events.append({"ph": "C", "pid": pid, "name": timer,
                               "ts": starts[j], "args": {"value": fv}})
        for timer, summary in (row.get("summary") or {}).items():
            events.append({"ph": "i", "pid": pid, "tid": 0, "s": "p",
                           "name": f"{timer} band", "ts": 0.0,
                           "args": dict(summary)})
    attr = (record.get("global") or {}).get("attribution")
    if attr:
        events.extend(attribution_counter_events(attr, dur_us=max_end))
    tele = (record.get("global") or {}).get("telemetry")
    anom = (record.get("global") or {}).get("anomalies")
    if tele or anom:
        events.extend(telemetry_counter_events(tele or {}, anom))
    return events
