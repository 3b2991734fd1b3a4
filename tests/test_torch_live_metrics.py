"""The live metrics stream of the torch port (``serving/metrics.
LiveMetricsWriter``, ``cli serve --live_metrics``, ``bench
--live-metrics``), held against the JAX package's writer on the CPU:
the snapshot line equal to JAX's for the same window (the schema the
JAX tests lock), the writer's window boundaries and JSONL appends equal
on a scripted engine clock, the stream surviving the engine's run resets
(a warm-up round and the measured run in one stream, told apart by
``run``), and an engine and a ``cli serve`` run streaming
schema-complete lines."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from dlnetbench_tpu.serving.metrics import Completed as JCompleted
from dlnetbench_tpu.serving.metrics import LiveMetricsWriter as JWriter
from dlnetbench_tpu_torch import bench as tbench
from dlnetbench_tpu_torch import cli as tcli
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan
from dlnetbench_tpu_torch.serving.metrics import Completed as TCompleted
from dlnetbench_tpu_torch.serving.metrics import LiveMetricsWriter as TWriter

# the JAX package's locked line schema (tests/test_bench_aux.py)
KEYS = {"run", "t_s", "window_s", "completed", "ttft_ms", "tpot_ms",
        "queue_depth", "active_slots", "kv_occupancy", "engine_steps"}
MODEL = dict(vocab_size=64, embed_dim=32, num_heads=2, num_kv_heads=2,
             ff_dim=64, num_layers=1, seq_len=32)
PLAN = dict(kind="poisson", rate_rps=300.0, num_requests=6, seed=2,
            prompt_len=[3, 6], output_len=[2, 5])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _done(cls, n=5):
    return [cls(rid=i, arrival_s=0.1 * i, admitted_s=0.1 * i,
                first_token_s=0.1 * i + 0.02, finish_s=0.1 * i + 0.08,
                prompt_len=8, output_len=4) for i in range(n)]


def _fake_engine(done):
    class _Eng:
        completed = done
        pending = [1, 2, 3]
        slots = [object(), object(), None]
        engine_steps = 40

        class cache:
            @staticmethod
            def stats():
                return {"occupancy": 0.625}
    return _Eng()


@pytest.mark.parametrize("replica_id", [None, 2])
def test_snapshot_line_equals_jax(replica_id):
    """The same window gives the same line, key for key: the locked key
    set on a single engine, ``replica_id`` only when one is given."""
    kw = dict(t_s=0.5, window_s=0.5, queue_depth=3, active_slots=2,
              kv_occupancy=0.625, engine_steps=40, run=1,
              replica_id=replica_id)
    t = TWriter.snapshot_line(window_completed=_done(TCompleted), **kw)
    j = JWriter.snapshot_line(window_completed=_done(JCompleted), **kw)
    assert t == j
    assert set(t) == KEYS | ({"replica_id"} if replica_id is not None
                             else set())
    assert t["ttft_ms"]["p50"] == 20.0 and t["completed"] == 5
    for base in ("ttft_ms", "tpot_ms"):
        assert {"p50", "p95", "p99", "mean", "n"} <= set(t[base])


def test_writer_windows_and_appends_equal_jax(tmp_path):
    """Both writers on one scripted clock: the same emits (a window's
    first step, nothing inside it, the next after a full window), the
    same JSONL lines; a new run restarts the window and counts ``run``
    up; opening a writer truncates the file."""
    eng = _fake_engine(_done(TCompleted))
    jeng = _fake_engine(_done(JCompleted))
    tp, jp = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    tp.write_text("stale\n")
    tw, jw = TWriter(tp, window_s=0.5), JWriter(jp, window_s=0.5)
    clock = [0.5, 0.6, 1.1, 1.2, 1.61, 0.05]
    for i, now in enumerate(clock):
        if i == 5:
            tw.reset_run()
            jw.reset_run()
        got, want = tw.maybe_emit(eng, now), jw.maybe_emit(jeng, now)
        # an empty window's percentiles are NaN: compare the lines' text
        assert json.dumps(got) == json.dumps(want), now
    assert tp.read_text() == jp.read_text()
    lines = [json.loads(ln) for ln in tp.read_text().splitlines()]
    assert [ln["t_s"] for ln in lines] == [0.5, 1.1, 1.61, 0.05]
    assert [ln["run"] for ln in lines] == [0, 0, 0, 1]
    assert tw.lines_written == jw.lines_written == 4
    assert lines[0]["active_slots"] == 2 and lines[0]["queue_depth"] == 3


def test_bench_and_cli_take_the_flag(tmp_path):
    path = str(tmp_path / "live.jsonl")
    _, args = tbench._parse_args(["--live-metrics", path])
    assert args.live_metrics == path
    _, args = tbench._parse_args(["--live_metrics", path])
    assert args.live_metrics == path
    assert tbench._parse_args([])[1].live_metrics is None


def _engine():
    mc = ttfm.TransformerConfig(**MODEL, dtype="float32")
    cfg = TS.ServingConfig(slots=2, page_size=4, num_pages=24,
                           max_seq_len=16, warmup_requests=2)
    return mc, cfg, TS.Engine(mc, cfg, params=ttfm.init_params(
        mc, seed=0, device="cpu"), device="cpu")


def test_engine_streams_schema_complete_lines(tmp_path):
    """An engine with a writer attached (window 0: every step) streams
    lines of the locked schema, some with completions; the writer
    survives ``run``'s state reset and the telemetry-off fast path is
    left for the sampling one only while a stream is attached."""
    mc, cfg, eng = _engine()
    path = tmp_path / "live.jsonl"
    eng.live = TWriter(path, window_s=0.0)
    eng.run(TPlan.from_dict(PLAN).sample())
    eng.run(TPlan.from_dict(PLAN).sample())
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines and all(set(ln) == KEYS for ln in lines)
    assert any(ln["completed"] >= 1 for ln in lines)
    assert {ln["run"] for ln in lines} == {1, 2}
    steps = [ln["engine_steps"] for ln in lines if ln["run"] == 2]
    assert steps == sorted(steps) and steps[-1] == eng.engine_steps
    eng.live = None


def test_run_serving_and_cli_serve_stream(tmp_path):
    """``run_serving(live_metrics=path)`` streams the warm-up round and
    the measured run (runs 1 and 2 of one stream), and ``cli serve
    --live_metrics`` writes lines that parse under the locked schema."""
    mc, cfg, eng = _engine()
    path = tmp_path / "rs.jsonl"
    TS.run_serving(mc, cfg, TPlan.from_dict(PLAN), engine=eng,
                   live_metrics=str(path))
    assert isinstance(eng.live, TWriter)
    runs = {json.loads(ln)["run"] for ln in path.read_text().splitlines()}
    assert runs == {1, 2}
    out, live = tmp_path / "s.jsonl", tmp_path / "cli.jsonl"
    rc = tcli.main(["serve", "--platform", "cpu", "--arrival",
                    json.dumps(PLAN), "--embed", "32", "--heads", "2",
                    "--kv_heads", "2", "--ff", "64", "--layers", "1",
                    "--vocab", "64", "--max_seq_len", "16",
                    "--live_metrics", str(live), "--out", str(out)])
    assert rc == 0
    lines = [json.loads(ln) for ln in live.read_text().splitlines()]
    assert lines and all(set(ln) == KEYS for ln in lines)
    assert np.isfinite([ln["kv_occupancy"] for ln in lines]).all()
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["global"]["serving"]["completed"] == PLAN["num_requests"]
