"""Profiler-trace-derived per-collective timing (the JAX package's
``metrics/profiling.py``, over ``torch.profiler``).

Fencing every collective would destroy the compute/comm overlap being
measured, so the harness measures by schedule *decomposition*
(proxies/base.py); this module is the independent cross-check channel:
run ONE step under ``torch.profiler``, read the Chrome trace it
exports, and report per-collective device occupancy (count / total /
mean / max per collective kind).  The two channels bound the truth
from different sides — decomposition gives the end-to-end exposed cost
including queueing, the trace the device time of each collective.

Which events are device occupancy (``_device_op_name``):

* on the card, the events whose ``cat`` is ``kernel``, ``gpu_memcpy``
  or ``gpu_memset`` — the kernels of one CUDA graph launch (the burn
  replays graphs of 512 iterations, four kernels each) become one
  event spanning them (``device_events``);
* on the CPU, the top-level ``cpu_op`` events of the thread that ran
  the step, which stand where the JAX package's CPU thunk ops stand
  (``device_events`` marks them ``args.device_op``);
* in a trace without categories (the JAX package's own, or a
  synthetic list), the JAX package's rule: bare op identifiers off the
  python thread.

One NCCL kernel serves several kinds: ``ncclDevKernel_SendRecv`` runs
``all_to_all_single`` and the ``batch_isend_irecv`` hops that are the
JAX package's ``ppermute``.  So each collective of
``parallel/collectives.py`` opens a ``record_function("dlnb:<kind>")``
while a profile is active, and ``device_events`` gives each device
event the kind of the annotation around the host call that launched
it: a kernel's ``correlation`` names its ``cudaLaunchKernel`` /
``cuLaunchKernelEx`` / ``cudaMemcpyAsync``, a CPU op is its own
anchor.  The kind rides the event as ``args.kind``; an event without
one is classified by its name (``classify_op``).

The JAX package's ``permute_dependencies`` (a walk over a jaxpr) is not
ported: ``parallel/collectives.Order.after_all`` records the same
dependence relation while a step issues its collectives.
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import re
import tempfile
from pathlib import Path

# op-name fragments -> collective kind (lowercased substring match): the
# JAX package's HLO names, then this stack's — c10d dispatcher ops
# (c10d::allreduce_, c10d::alltoall_base_, c10d::send), gloo's
# annotations (gloo:all_reduce, gloo:all_to_all) and NCCL's kernels
# (ncclDevKernel_AllReduce_*, _AllGather_*, _ReduceScatter_*,
# ncclDevKernel_SendRecv)
COLLECTIVE_PATTERNS: dict[str, tuple[str, ...]] = {
    "allreduce": ("all-reduce", "all_reduce", "allreduce", "psum"),
    "allgather": ("all-gather", "all_gather", "allgather"),
    "reduce_scatter": ("reduce-scatter", "reduce_scatter", "psum-scatter",
                       "psum_scatter", "reducescatter"),
    "alltoall": ("all-to-all", "all_to_all", "alltoall"),
    "permute": ("collective-permute", "collective_permute", "ppermute"),
    "send_recv": ("send-done", "recv-done", "send.", "recv.", "sendrecv",
                  "c10d::send", "c10d::recv", "gloo:send", "gloo:recv",
                  "nccl:send", "nccl:recv"),
}
# reduce_scatter names contain "psum" -> check more specific kinds first
_KIND_ORDER = ("reduce_scatter", "allgather", "alltoall", "permute",
               "send_recv", "allreduce")

# the annotation parallel/collectives.py opens around each collective
# while a profile is active: "dlnb:<kind>"
ANNOTATION_PREFIX = "dlnb:"


def classify_op(name: str) -> str | None:
    """Collective kind for a trace-event name, or None."""
    n = name.lower()
    if n.startswith("end: "):   # async completion markers, not the op
        return None
    for kind in _KIND_ORDER:
        if any(p in n for p in COLLECTIVE_PATTERNS[kind]):
            return kind
    return None


def load_trace_events(trace_dir: str | Path) -> list[dict]:
    """All complete ('X') events from a Chrome trace.

    Accepts a single trace file, plain ``.json`` or gzipped — what
    ``torch.profiler``'s ``export_chrome_trace`` writes, and the merged
    timelines ``metrics.spans.write_chrome_trace`` writes — or a
    directory, whose newest ``*.trace.json[.gz]`` is read.

    Each event is annotated with its lane's thread name (``_thread``,
    resolved from the trace's metadata events) when the trace carries
    one.  Traces without thread metadata get no annotation."""
    p = Path(trace_dir)
    if p.is_file():
        opener = gzip.open if p.name.endswith(".gz") else open
        with opener(p) as f:
            trace = json.load(f)
    else:
        paths = sorted(glob.glob(f"{trace_dir}/**/*.trace.json.gz",
                                 recursive=True)
                       + glob.glob(f"{trace_dir}/**/*.trace.json",
                                   recursive=True))
        if not paths:
            raise FileNotFoundError(f"no *.trace.json[.gz] under "
                                    f"{trace_dir}")
        opener = gzip.open if paths[-1].endswith(".gz") else open
        with opener(paths[-1]) as f:
            trace = json.load(f)
    raw = trace.get("traceEvents", [])
    threads = {(e.get("pid"), e.get("tid")): (e.get("args") or {}).get("name")
               for e in raw
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    out = []
    for e in raw:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t = threads.get((e.get("pid"), e.get("tid")))
        out.append({**e, "_thread": t} if t is not None else e)
    return out


# The JAX package's rule, for traces without categories: XLA HLO op
# names are bare identifiers (fusion.12, copy.3) — no spaces, paths,
# parens or $-prefixes — and host events that are bare identifiers too
# (compiler passes, argument bookkeeping) run on the python thread.
_XLA_OP_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")
_HOST_THREAD = "python"
# the CPU thunk executor's "call" event encloses the child ops it
# dispatches on the same lane — counting it would double-count them
_WRAPPER_OPS = frozenset({"call"})
_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def _device_op_name(e: dict) -> str | None:
    """The event's op name when it is device occupancy, else None (the
    rule is in the module docstring)."""
    name = str(e.get("name", ""))
    cat = e.get("cat")
    if cat is None:
        if e.get("_thread") == _HOST_THREAD:
            return None
        if name in _WRAPPER_OPS or not _XLA_OP_RE.match(name):
            return None
        return name
    if cat in _DEVICE_CATS or (
            cat == "cpu_op" and (e.get("args") or {}).get("device_op")):
        return name or None
    return None


def _kind(e: dict, name: str) -> str | None:
    return (e.get("args") or {}).get("kind") or classify_op(name)


def collective_stats(events: list[dict]) -> dict[str, dict]:
    """Per-collective-kind device-occupancy summary (durations in us).

    Device ops no kind fits — the burn, copies, anything unnamed — are
    NOT dropped: they bucket under ``other``, so occupancy fractions
    computed from this summary stay conservative.  Host events and
    async completion markers (``end: ...``) stay excluded."""
    by_kind: dict[str, list[float]] = {}
    for e in events:
        name = _device_op_name(e)
        if name is None:
            continue
        kind = _kind(e, name) or "other"
        by_kind.setdefault(kind, []).append(float(e["dur"]))
    return {
        kind: {
            "count": len(durs),
            "total_us": sum(durs),
            "mean_us": sum(durs) / len(durs),
            "max_us": max(durs),
        }
        for kind, durs in sorted(by_kind.items())
    }


def top_device_ops(events: list[dict], k: int = 5) -> list[dict]:
    """Top-k device ops by total duration (name-aggregated): the
    per-op channel ``cli --profile`` stamps as ``device_top_ops``.
    Host events and async completion markers are excluded like in
    ``collective_stats``."""
    totals: dict[str, list[float]] = {}
    for e in events:
        name = _device_op_name(e)
        if name is None:
            continue
        totals.setdefault(name, []).append(float(e["dur"]))
    ranked = sorted(totals.items(), key=lambda kv: -sum(kv[1]))[:max(k, 0)]
    return [{"op": name, "total_us": round(sum(durs), 1),
             "count": len(durs)} for name, durs in ranked]


# ---------------------------------------------------------------------
# torch.profiler traces -> one rank's device events, kinds linked.

class _Marks:
    """The ``dlnb:<kind>`` annotations of one trace, per host thread,
    for "which collective was open at (tid, ts)"."""

    def __init__(self, events: list[dict]):
        by_tid: dict = {}
        for e in events:
            name = str(e.get("name", ""))
            if e.get("cat") == "user_annotation" \
                    and name.startswith(ANNOTATION_PREFIX):
                ts = float(e["ts"])
                by_tid.setdefault(e.get("tid"), []).append(
                    (ts, ts + float(e["dur"]),
                     name[len(ANNOTATION_PREFIX):]))
        self._by_tid = {t: sorted(m) for t, m in by_tid.items()}
        self._starts = {t: [m[0] for m in ms]
                        for t, ms in self._by_tid.items()}

    def kind_at(self, anchor: dict | None) -> str | None:
        if anchor is None:
            return None
        tid, ts = anchor.get("tid"), float(anchor.get("ts", 0.0))
        marks = self._by_tid.get(tid)
        if not marks:
            return None
        i = bisect.bisect_right(self._starts[tid], ts) - 1
        if i >= 0 and marks[i][1] >= ts:
            return marks[i][2]
        return None


def _top_level_ops(events: list[dict], tid) -> list[dict]:
    """The ``cpu_op`` events on ``tid`` that no other ``cpu_op`` on it
    encloses."""
    ops = sorted((e for e in events
                  if e.get("cat") == "cpu_op" and e.get("tid") == tid),
                 key=lambda e: (float(e["ts"]), -float(e["dur"])))
    out, end = [], float("-inf")
    for e in ops:
        if float(e["ts"]) >= end:
            out.append(e)
            end = float(e["ts"]) + float(e["dur"])
    return out


def _step_thread(events: list[dict]):
    """The thread that ran the profiled step: the one holding the
    profiler's ``ProfilerStep#`` annotation (else the main thread,
    whose id is the process id)."""
    for e in events:
        if e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith("ProfilerStep#"):
            return e.get("tid")
    for e in events:
        if e.get("cat") == "cpu_op":
            return e.get("pid")
    return None


def _coalesce_graphs(kernels: list[dict], launches: dict) -> list[dict]:
    """The kernels of one CUDA graph launch (one correlation id whose
    launch is ``cudaGraphLaunch``) as one event spanning them, with the
    kernel count and their summed time (``busy_us``) in its args."""
    graphs: dict = {}
    out = []
    for e in kernels:
        corr = (e.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        if e.get("cat") == "kernel" and launch is not None \
                and "GraphLaunch" in str(launch.get("name", "")):
            graphs.setdefault(corr, []).append(e)
        else:
            out.append(e)
    for corr, ks in graphs.items():
        t0 = min(float(k["ts"]) for k in ks)
        t1 = max(float(k["ts"]) + float(k["dur"]) for k in ks)
        first = min(ks, key=lambda k: float(k["ts"]))
        out.append({
            "ph": "X", "cat": "kernel",
            "name": f"cudaGraphLaunch ({len(ks)} kernels)",
            "pid": first.get("pid"), "tid": first.get("tid"),
            "ts": t0, "dur": t1 - t0,
            "args": {"correlation": corr,
                     "stream": (first.get("args") or {}).get("stream"),
                     "kernels": len(ks),
                     "busy_us": round(sum(float(k["dur"]) for k in ks),
                                      3)}})
    return sorted(out, key=lambda e: float(e["ts"]))


def device_events(events: list[dict], platform: str) -> list[dict]:
    """One rank's device occupancy from its ``torch.profiler`` trace
    (``load_trace_events``), each event that a ``dlnb:<kind>``
    annotation launched tagged ``args.kind`` (module docstring).
    ``platform`` is ``"cuda"`` (kernels, copies, sets; a graph launch's
    kernels as one event) or ``"cpu"`` (the step thread's top-level
    ``cpu_op`` events, marked ``args.device_op``).  Returns new dicts;
    the loader's ``_thread`` annotation is dropped."""
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform must be 'cuda' or 'cpu', got "
                         f"{platform!r}")
    marks = _Marks(events)
    if platform == "cuda":
        launches = {(e.get("args") or {}).get("correlation"): e
                    for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")}
        picked = _coalesce_graphs(
            [e for e in events if e.get("cat") in _DEVICE_CATS], launches)
    else:
        picked = _top_level_ops(events, _step_thread(events))
    out = []
    for e in picked:
        args = dict(e.get("args") or {})
        if platform == "cpu":
            args["device_op"] = True
            kind = marks.kind_at(e)
        else:
            kind = marks.kind_at(launches.get(args.get("correlation")))
        if kind is not None:
            args["kind"] = kind
        ev = {k: v for k, v in e.items() if not k.startswith("_")}
        ev["args"] = args
        out.append(ev)
    return out


# idle host time at each end of the recorded profiler step: the
# profiler keeps a device record only when its converted timestamp lies
# inside the step, and on the card that conversion was seen shifted by
# milliseconds, dropping the step's first copy and kernels
WINDOW_PAD_S = 0.02


def trace_step(fn, device, *, trace_dir: str | Path | None = None,
               span_attrs: dict | None = None) -> list[dict]:
    """Run the zero-argument step ``fn`` twice under ``torch.profiler``
    — once to warm the profiler (CUPTI's first use), once recorded —
    fenced on ``device`` before each profiler step closes; returns the
    recorded step's ``device_events``.  The recorded step runs inside
    the host span ``profile`` (``span_attrs`` its attributes), which
    the merged trace aligns the device timeline to, with
    ``WINDOW_PAD_S`` of idle time before and after it inside the
    profiler's step.  The exported trace is written under
    ``trace_dir`` (kept) or a temporary directory (removed)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from dlnetbench_tpu_torch.metrics import spans
    from dlnetbench_tpu_torch.utils.timing import fence

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="dlnb_prof_") as tmp:
        path = Path(trace_dir if trace_dir is not None else tmp) \
            / "step.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            fence(device)
            fn()
            fence(device)
            prof.step()
            time.sleep(WINDOW_PAD_S)
            with spans.span("profile", **(span_attrs or {})):
                fn()
                fence(device)
            time.sleep(WINDOW_PAD_S)
            prof.step()
        return device_events(load_trace_events(path), device.type)


def profile_collectives(fn, *args, device="cuda",
                        trace_dir: str | Path | None = None,
                        **kwargs) -> dict[str, dict]:
    """Run ``fn(*args, **kwargs)`` once under the profiler (after one
    warming run) on ``device``; return ``collective_stats``.  ``fn``
    should be warm already (profile the steady state, not graph
    capture)."""
    return collective_stats(trace_step(lambda: fn(*args, **kwargs),
                                       device, trace_dir=trace_dir))
