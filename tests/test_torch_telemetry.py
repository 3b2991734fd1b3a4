"""The port's flight recorder (``dlnetbench_tpu_torch/metrics/
telemetry.py``) against the JAX package's ``metrics/telemetry.py``:
the same wall sequence and triggers on a scripted clock give the same
anomalies at the same steps, cooldowns and dump caps included, the
same ring and the same record blocks; the disabled path allocates
nothing per step; a rank's dumps carry its suffix; the record stamps
(``metrics/emit.py``) pool every rank's anomalies; the serving engine
samples every step and fires ``slo`` on a breach, and samples nothing
when telemetry is off.  Clocks are scripted: no sleeps."""
from __future__ import annotations

import json

import pytest

from dlnetbench_tpu.metrics import telemetry as J_tele
from dlnetbench_tpu_torch.metrics import telemetry as T_tele
from dlnetbench_tpu_torch.metrics.emit import pool_anomalies, result_to_record
from dlnetbench_tpu_torch.proxies.base import ProxyResult


@pytest.fixture(autouse=True)
def _clean_recorders():
    T_tele.disable()
    J_tele.disable()
    yield
    T_tele.disable()
    J_tele.disable()


class _Clock:
    """``time.monotonic`` on a script: 0.25 s a call."""

    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        self.t += 0.25
        return self.t


def _scenario(mod, tmp_path, monkeypatch) -> dict:
    """A run on ``mod``'s recorder: a noisy baseline, a shift, a
    sustained shift, a second shift; slo and fault triggers inside and
    past the cooldown, past the dump cap."""
    monkeypatch.setattr(mod.time, "monotonic", _Clock())
    rec = mod.FlightRecorder(capacity=16, dump_dir=tmp_path,
                             cooldown_s=1.0, max_dumps_per_trigger=2)
    walls = ([100.0 + (i % 3) for i in range(10)] + [400.0 + i
                                                    for i in range(5)]
             + [400.0] * 5 + [1600.0 + i for i in range(13)])
    for i, w in enumerate(walls):
        rec.record("proxy", step=i, step_wall_us=w, chain_k=1)
        rec.observe_step_wall("proxy", w, step=i)
        if i % 4 == 0:
            rec.trigger("slo", step=i, detail={"goodput_frac": 0.25})
        if i in (7, 8):
            rec.trigger("fault", step=i)
    fired = [(a["trigger"], a.get("step"), a.get("dump", "")[len(
        str(tmp_path)):]) for a in rec.anomalies]
    return {"fired": fired, "samples": rec.samples(),
            "telemetry": rec.telemetry_block(),
            "anomalies": {**rec.anomalies_block(), "events": [
                {k: v for k, v in e.items() if k != "dump"}
                for e in rec.anomalies_block()["events"]]},
            "dumps": sorted(p.name for p in tmp_path.iterdir())}


def test_same_walls_give_the_same_triggers_as_jax(tmp_path, monkeypatch):
    got = _scenario(T_tele, tmp_path / "torch", monkeypatch)
    want = _scenario(J_tele, tmp_path / "jax", monkeypatch)
    assert got == want
    kinds = [f[0] for f in got["fired"]]
    assert kinds.count("step_time") == 2           # once per shift
    assert kinds.count("fault") == 1               # 8 inside 7's cooldown
    assert got["dumps"] == ["flight_fault.json", "flight_slo.json",
                            "flight_slo_2.json", "flight_step_time.json",
                            "flight_step_time_2.json"]
    assert got["telemetry"]["recorded"] == 33
    assert got["telemetry"]["dropped"] == 33 - 16


def test_a_ranks_dumps_carry_its_suffix(tmp_path):
    rec = T_tele.FlightRecorder(capacity=8, dump_dir=tmp_path,
                                cooldown_s=0.0, max_dumps_per_trigger=2,
                                rank=3)
    for i in range(3):
        rec.record("proxy", step=i)
    assert rec.trigger("slo")["dump"] == str(tmp_path
                                             / "flight_slo_rank3.json")
    rec.trigger("slo")
    rec.trigger("slo")                                 # past the cap
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "flight_slo_2_rank3.json", "flight_slo_rank3.json"]
    dump = json.loads((tmp_path / "flight_slo_rank3.json").read_text())
    assert [s["step"] for s in dump["samples"]] == [0, 1, 2]
    assert T_tele.enable(rank=1).rank == 1


def test_enable_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("DLNB_TELEMETRY", raising=False)
    assert T_tele.enable_from_env() is None
    monkeypatch.setenv("DLNB_TELEMETRY", "1")
    monkeypatch.setenv("DLNB_TELEMETRY_CAPACITY", "32")
    monkeypatch.setenv("DLNB_FLIGHT_DIR", str(tmp_path / "fl"))
    rec = T_tele.enable_from_env(rank=2)
    assert rec is not None and rec.capacity == 32 and rec.rank == 2
    assert rec.dump_dir == tmp_path / "fl"
    assert T_tele.enable_from_env() is rec     # an active recorder wins


def test_disabled_path_allocates_nothing_per_step():
    """Every hot site gates on ``is_enabled()`` before assembling its
    kwargs (JAX's tests/test_telemetry.py contract): 1000 disabled steps
    allocate nothing in the module."""
    import tracemalloc

    assert not T_tele.is_enabled()
    gated = 0

    def loop(n: int) -> None:
        nonlocal gated
        for _ in range(n):
            if T_tele.is_enabled():
                T_tele.record_step("proxy", step=0, step_wall_us=1.0)
                gated += 1
            T_tele.record_step("also-free-when-disabled")
            T_tele.observe_step_wall("proxy", 1.0)

    loop(10)
    tracemalloc.start()
    try:
        s0 = tracemalloc.take_snapshot()
        loop(1000)
        s1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert gated == 0
    grew = sum(st.size_diff for st in s1.compare_to(s0, "filename")
               if st.traceback[0].filename == T_tele.__file__
               and st.size_diff > 0)
    assert grew < 512, f"{grew} bytes allocated over 1000 disabled steps"


def _result() -> ProxyResult:
    return ProxyResult(
        name="dp",
        global_meta={"proxy": "dp", "model": "gpt2_l_16_bfloat16",
                     "world_size": 2,
                     "mesh": {"platform": "cpu", "num_devices": 2,
                              "devices": [{"id": 0, "process": 0},
                                          {"id": 1, "process": 1}]}},
        timers_us={"runtimes": [100.0, 110.0]}, warmup_times_us=[90.0],
        num_runs=2)


def test_record_stamps_pool_every_ranks_anomalies():
    assert "telemetry" not in result_to_record(_result())["global"]
    rec = T_tele.enable(capacity=8)
    rec.record("proxy", step=0, step_wall_us=5.0)
    blocks = [None, {"count": 2, "triggers": {"step_time": 1, "slo": 1},
                     "events": [{"trigger": "step_time", "t_s": 1.0},
                                {"trigger": "slo", "t_s": 2.0}]}]
    g = result_to_record(_result(), rank_anomalies=blocks)["global"]
    assert g["telemetry"] == rec.telemetry_block()
    assert g["anomalies"] == {
        "count": 2, "triggers": {"step_time": 1, "slo": 1},
        "events": [{"trigger": "step_time", "t_s": 1.0, "rank": 1},
                   {"trigger": "slo", "t_s": 2.0, "rank": 1}]}
    # clean ranks: the telemetry block, no anomalies key
    g = result_to_record(_result(), rank_anomalies=[None, None])["global"]
    assert "telemetry" in g and "anomalies" not in g
    # unpooled (one process): its own block, as JAX's emitter stamps it
    rec.trigger("fault", step=0)
    assert result_to_record(_result())["global"]["anomalies"] == \
        rec.anomalies_block()


def test_pool_keeps_the_last_16_events_in_rank_order():
    blocks = [{"count": 10, "triggers": {"slo": 10},
               "events": [{"trigger": "slo", "i": i} for i in range(10)]}
              for _ in range(3)]
    pooled = pool_anomalies(blocks)
    assert pooled["count"] == 30 and pooled["triggers"] == {"slo": 30}
    assert [(e["rank"], e["i"]) for e in pooled["events"]] == \
        [(1, i) for i in range(4, 10)] + [(2, i) for i in range(10)]
    assert pool_anomalies([None, {}]) is None


# ------------------------------------------------------- serving engine
def _engine_and_plan():
    from dlnetbench_tpu_torch.models.transformer import TransformerConfig
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig)
    mc = TransformerConfig(vocab_size=64, embed_dim=32, num_heads=2,
                           num_kv_heads=2, ff_dim=64, num_layers=1,
                           seq_len=32, dtype="float32")
    # budgets no request meets: the rolling detector must fire
    cfg = ServingConfig(slots=2, page_size=4, num_pages=24,
                        max_seq_len=16, slo_ttft_ms=0.001,
                        slo_tpot_ms=0.001, warmup_requests=0)
    plan = ArrivalPlan(kind="poisson", rate_rps=500.0, num_requests=10,
                       seed=1, prompt_len=[4, 8], output_len=[3, 5])
    return Engine(mc, cfg, device="cpu"), plan


def test_engine_samples_every_step_and_fires_slo(tmp_path, monkeypatch):
    from dlnetbench_tpu_torch.serving import scheduler as S
    engine, plan = _engine_and_plan()
    # the engine clock on a script: 20 ms a read, so completions are
    # 10x past the budgets and land in one rolling window
    clock = iter(range(10 ** 6))
    monkeypatch.setattr(S.time, "monotonic",
                        lambda: next(clock) * 0.02)
    monkeypatch.setattr(S.time, "sleep", lambda s: None)
    rec = T_tele.enable(capacity=256, dump_dir=tmp_path)
    completed, _ = engine.run(plan.sample())
    assert len(completed) == 10 and engine._tele is rec
    steps = [s for s in rec.samples() if s["source"] == "serving"]
    assert len(steps) == engine.engine_steps
    # the step index counts engine steps taken, as JAX's engine does
    assert [s["step"] for s in steps] == list(
        range(1, engine.engine_steps + 1))
    for key in ("step_wall_us", "queue_depth", "active_slots",
                "kv_occupancy", "kv_fragmentation"):
        assert key in steps[0]
    assert rec.anomalies and rec.anomalies[0]["trigger"] == "slo"
    dump = json.loads((tmp_path / "flight_slo.json").read_text())
    assert dump["detail"]["goodput_frac"] < 0.5
    assert dump["detail"]["slo"] == {"ttft_ms": 0.001, "tpot_ms": 0.001}


def test_engine_disabled_path_never_samples(monkeypatch):
    engine, plan = _engine_and_plan()
    from dlnetbench_tpu_torch.serving import scheduler as S
    monkeypatch.setattr(S.M, "rolling_slo_breach", None)   # never called
    engine.run(plan.sample())
    assert engine._tele is None
    meta = engine.global_meta(plan)
    assert "telemetry" not in meta and "anomalies" not in meta


def test_rolling_slo_breach_equals_jax():
    from dlnetbench_tpu.serving import metrics as J_M
    from dlnetbench_tpu_torch.serving import metrics as T_M
    rows = [(0.0, 0.01, 0.02, 0.1 + 0.05 * i, 4, 3) for i in range(8)]
    for slo in ((500.0, 200.0), (5.0, 1.0)):
        for now in (0.2, 0.3, 0.6, 1.0):
            got = T_M.rolling_slo_breach(
                [T_M.Completed(i, *r) for i, r in enumerate(rows)],
                slo_ttft_ms=slo[0], slo_tpot_ms=slo[1], now_s=now)
            want = J_M.rolling_slo_breach(
                [J_M.Completed(i, *r) for i, r in enumerate(rows)],
                slo_ttft_ms=slo[0], slo_tpot_ms=slo[1], now_s=now)
            assert got == want
