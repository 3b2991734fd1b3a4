"""The port's span tracer and merged Chrome-trace exporter
(``dlnetbench_tpu_torch/metrics/spans.py``) against the JAX package's
``metrics/spans.py``: the disabled path hands out one shared no-op
object; nesting, exceptions and per-thread depth give the same spans;
``host_events``, ``attribution_counter_events``,
``telemetry_counter_events`` and ``record_track_events`` return JAX's
dicts on the same spans and records; the port's device export puts
each rank on its own track and round-trips through the port's loader.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import pytest

from dlnetbench_tpu.metrics import spans as J_spans
from dlnetbench_tpu_torch.metrics import profiling as T_prof
from dlnetbench_tpu_torch.metrics import spans as T_spans

DATA = Path(__file__).parent / "data"


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Never leak an enabled tracer into (or out of) a test."""
    T_spans.disable()
    J_spans.disable()
    yield
    T_spans.disable()
    J_spans.disable()


def test_disabled_span_is_the_one_shared_noop():
    assert not T_spans.is_enabled()
    a = T_spans.span("anything", key="value")
    b = T_spans.span("else")
    assert a is b is T_spans.NULL_SPAN
    with a:
        pass
    assert T_spans.current() is None and T_spans.active_stacks() == {}
    tr = T_spans.enable()
    assert T_spans.current() is tr and T_spans.span("x") is not a
    assert T_spans.disable() is tr
    assert T_spans.span("y") is T_spans.NULL_SPAN


def _scenario(mod) -> tuple[list, dict]:
    """Nesting, an exception, a span on another thread and the open
    stacks midway, on ``mod``'s tracer; returns its spans without the
    clock (name, depth, attrs, same-thread flag) and the stacks."""
    tr = mod.enable()
    main = threading.get_ident()
    seen = {}
    with mod.span("outer", phase="run"):
        with mod.span("inner"):
            seen["stacks"] = list(mod.active_stacks().values())
        with pytest.raises(RuntimeError):
            with mod.span("doomed", what="x"):
                raise RuntimeError("boom")
        t = threading.Thread(target=lambda: mod.span("in-thread")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    with mod.span("after"):
        pass
    mod.disable()
    return ([(s["name"], s["depth"], s.get("attrs"), s["tid"] == main)
             for s in tr.spans], seen)


def test_nesting_exceptions_and_threads_as_jax():
    got, want = _scenario(T_spans), _scenario(J_spans)
    assert got == want
    spans, seen = got
    assert [s[0] for s in spans] == ["inner", "doomed", "in-thread",
                                     "outer", "after"]
    # children close first, nest one deeper; the failed phase stays,
    # marked, and the stack unwound; the thread's span is top-level
    assert dict((s[0], s[1]) for s in spans) == {
        "inner": 1, "doomed": 1, "in-thread": 0, "outer": 0, "after": 0}
    assert spans[1][2] == {"what": "x", "error": "RuntimeError"}
    assert spans[2][3] is False
    assert seen["stacks"] == [["outer", "inner"]]


def test_children_lie_inside_their_parent():
    tr = T_spans.enable()
    with T_spans.span("outer"):
        with T_spans.span("inner"):
            pass
    T_spans.disable()
    inner, outer = tr.spans
    assert inner["ts_us"] >= outer["ts_us"]
    assert (inner["ts_us"] + inner["dur_us"]
            <= outer["ts_us"] + outer["dur_us"] + 1e-6)


_SPANS = [
    {"name": "build", "ts_us": 0.0, "dur_us": 120.5, "tid": 7, "depth": 0,
     "attrs": {"proxy": "dp"}},
    {"name": "fence", "ts_us": 130.0, "dur_us": 4.25, "tid": 7,
     "depth": 1, "attrs": {"k": 2}},
    {"name": "timed", "ts_us": 125.0, "dur_us": 40.0, "tid": 7,
     "depth": 0},
]


def test_host_events_equal_jax():
    got, want = T_spans.Tracer(), J_spans.Tracer()
    got.spans = [dict(s) for s in _SPANS]
    want.spans = [dict(s) for s in _SPANS]
    assert T_spans.host_events(got) == J_spans.host_events(want)
    assert T_spans.host_events(got, pid=3) == J_spans.host_events(want,
                                                                  pid=3)


def _records() -> list[dict]:
    rec = json.loads((DATA / "record_attrib.jsonl").read_text())
    tele = {"capacity": 8, "recorded": 3, "dropped": 0,
            "sources": ["proxy"],
            "last": [{"t_s": 0.5, "source": "proxy", "step": 0,
                      "phase": "warmup", "step_wall_us": 10.0},
                     {"t_s": 0.75, "source": "proxy", "step": 1,
                      "phase": "timed", "step_wall_us": 9.5,
                      "chain_k": 1, "power_w": 300.0}]}
    anom = {"count": 1, "triggers": {"step_time": 1},
            "events": [{"trigger": "step_time", "t_s": 0.8, "step": 1,
                        "detail": {"ratio": 2.0}, "rank": 3}]}
    with_tele = json.loads(json.dumps(rec))
    with_tele["global"]["telemetry"] = tele
    with_tele["global"]["anomalies"] = anom
    return [rec, with_tele]


@pytest.mark.parametrize("which", [0, 1])
def test_record_tracks_equal_jax(which):
    rec = _records()[which]
    assert T_spans.record_track_events(rec) == \
        J_spans.record_track_events(rec)
    g = rec["global"]
    assert T_spans.attribution_counter_events(g["attribution"],
                                              dur_us=500.0) == \
        J_spans.attribution_counter_events(g["attribution"], dur_us=500.0)
    assert T_spans.telemetry_counter_events(
        g.get("telemetry") or {}, g.get("anomalies")) == \
        J_spans.telemetry_counter_events(g.get("telemetry") or {},
                                         g.get("anomalies"))
    if which:
        counters = [e for e in T_spans.record_track_events(rec)
                    if e.get("pid") == T_spans.TELEMETRY_PID
                    and e["ph"] == "C"]
        assert {e["name"] for e in counters} == {"step_wall_us",
                                                 "chain_k", "power_w"}


def _device_track(rank: int) -> list[dict]:
    """One rank's device events as ``profiling.device_events`` gives
    them: on the profiler's epoch, a burn graph launch and collectives
    (one linked to its kind, one classified by its name)."""
    t = 9_000_000.0 + 3.0 * rank
    return [
        {"ph": "X", "cat": "kernel", "name": "cudaGraphLaunch (2048 kernels)",
         "pid": 0, "tid": 7, "ts": t, "dur": 40.0,
         "args": {"kernels": 2048, "busy_us": 38.0}},
        {"ph": "X", "cat": "kernel",
         "name": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
         "pid": 0, "tid": 13, "ts": t + 10.0, "dur": 25.0,
         "args": {"kind": "permute"}},
        {"ph": "X", "cat": "kernel",
         "name": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(x)",
         "pid": 0, "tid": 13, "ts": t + 50.0, "dur": 5.0, "args": {}},
    ]


def test_merged_trace_puts_each_rank_on_its_own_track(tmp_path):
    tr = T_spans.enable()
    with T_spans.span("build"):
        pass
    with T_spans.span("profile"):
        pass
    T_spans.disable()
    tracks = [(f"rank {r} (cuda:{r})", _device_track(r)) for r in range(2)]
    out = tmp_path / "trace.json"
    extra = T_spans.telemetry_counter_events(_records()[1]["global"]
                                             ["telemetry"])
    trace = T_spans.write_chrome_trace(out, tr, tracks, extra_events=extra)
    assert json.loads(out.read_text()) == trace
    ev = trace["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in ev
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {0: "host (harness phases)", 1: "rank 0 (cuda:0)",
                     2: "rank 1 (cuda:1)",
                     T_spans.TELEMETRY_PID: "telemetry (flight recorder)"}
    dev = [e for e in ev if e.get("ph") == "X" and e["pid"] in (1, 2)]
    assert len(dev) == 6
    # the earliest device event (rank 0's) sits where "profile" starts;
    # rank 1's keep their 3 us offset
    profile = next(s for s in tr.spans if s["name"] == "profile")
    first = min(dev, key=lambda e: e["ts"])
    assert first["pid"] == 1 and first["ts"] == pytest.approx(
        profile["ts_us"])
    r1 = min((e for e in dev if e["pid"] == 2), key=lambda e: e["ts"])
    assert r1["ts"] - first["ts"] == pytest.approx(3.0)
    kinds = {(e["pid"], e["name"][:22]): e["args"].get("kind") for e in dev}
    assert kinds[(1, "ncclDevKernel_SendRecv")] == "permute"
    assert kinds[(2, "ncclDevKernel_AllReduc")] == "allreduce"
    assert kinds[(1, "cudaGraphLaunch (2048 ")] is None
    assert all("cname" in e for e in dev if e["args"].get("kind"))
    # the merged artifact reads back through the port's loader, and its
    # device tracks feed the per-collective stats
    stats = T_prof.collective_stats([e for e in T_prof.load_trace_events(out)
                                     if e["pid"] in (1, 2)])
    assert {k: v["count"] for k, v in stats.items()} == {
        "allreduce": 2, "other": 2, "permute": 2}


def test_host_only_trace_reads_back(tmp_path):
    tr = T_spans.enable()
    with T_spans.span("only-host"):
        pass
    T_spans.disable()
    out = tmp_path / "host.json"
    T_spans.write_chrome_trace(out, tr, None)
    assert [e["name"] for e in T_prof.load_trace_events(out)] == \
        ["only-host"]
    with pytest.raises(FileNotFoundError):
        T_prof.load_trace_events(tmp_path / "empty_dir_nope")
