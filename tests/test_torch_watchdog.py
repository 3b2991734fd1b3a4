"""The port's stall watchdog (``utils/watchdog.py``) against the JAX
package's: sections armed and fired (deadlines of tens of ms, the
stalled sections waiting on events, not sleeping blind), heartbeats and
the record stamp on a scripted clock, the stall message word for word,
the span stack, the flight ring's trend and its ``flight_stall.json``
dump, the checkpoint age, and the harness's hooks
(``ProxyConfig.watchdog``)."""
from __future__ import annotations

import json
import threading
import time

import pytest

from dlnetbench_tpu_torch.utils import watchdog as T_wd
from dlnetbench_tpu_torch.utils.watchdog import StepWatchdog

DEADLINE = 0.02


def _hold(wd: StepWatchdog, timeout: float = 2.0) -> None:
    """Inside an armed section: wait until its timer has fired and
    reported (the timer thread ends after ``on_stall`` returns)."""
    timer = wd._local.stack[-1]
    timer.join(timeout)
    assert not timer.is_alive()


def _stalled(wd: StepWatchdog, fired: threading.Event | None = None,
             timeout: float = 2.0) -> None:
    """Hold an armed section until the watchdog has fired."""
    with wd:
        if fired is not None:
            assert fired.wait(timeout)
        _hold(wd, timeout)


class Clock:
    """A scripted monotonic clock."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(T_wd.time, "monotonic", c)
    return c


def test_fast_section_does_not_fire():
    fired = []
    wd = StepWatchdog(DEADLINE, on_stall=lambda n, e: fired.append((n, e)))
    for _ in range(3):
        with wd:
            pass
    threading.Event().wait(3 * DEADLINE)  # past every disarmed deadline
    assert fired == [] and wd.stalls == 0


def test_stalled_section_fires_once_per_arming():
    fired, ev = [], threading.Event()

    def on_stall(name, elapsed):
        fired.append((name, elapsed))
        ev.set()

    wd = StepWatchdog(DEADLINE, on_stall=on_stall, name="collective")
    _stalled(wd, ev)
    assert wd.stalls == 1
    assert fired[0][0] == "collective" and fired[0][1] >= DEADLINE
    ev.clear()
    _stalled(wd, ev)
    assert wd.stalls == 2


def test_wrap_and_default_message(capsys):
    wd = StepWatchdog(DEADLINE, name="train_step")

    @wd.wrap
    def slow():
        _hold(wd)
        return 42

    assert slow() == 42
    assert wd.stalls == 1
    err = capsys.readouterr().err
    assert "train_step" in err and "deadline" in err


def _jax_wd(*a, **k):
    from dlnetbench_tpu.utils import watchdog
    return watchdog.StepWatchdog(*a, **k)


def test_heartbeats_and_stamp_equal_jax(clock, monkeypatch):
    """Per-key heartbeat ages and the record stamp on one scripted
    clock: equal to the JAX watchdog's."""
    from dlnetbench_tpu.utils import watchdog as J_wd
    monkeypatch.setattr(J_wd.time, "monotonic", clock)
    ours, theirs = StepWatchdog(5.0), _jax_wd(5.0)
    for wd in (ours, theirs):
        wd.beat("rank0")
    clock.t += 0.25
    for wd in (ours, theirs):
        wd.beat("rank1")
        wd.checkpoint_saved(7)
    clock.t += 0.5
    assert ours.heartbeat_ages() == theirs.heartbeat_ages() \
        == {"rank0": 0.75, "rank1": 0.5}
    assert ours.stamp({}) == theirs.stamp({})
    assert ours.stamp({})["last_checkpoint_step"] == 7


def test_stall_message_equals_jax_word_for_word(clock, monkeypatch,
                                                capsys):
    """The default diagnostic: the last progress (the most recent
    beat), every heartbeat, the last completed checkpoint."""
    from dlnetbench_tpu.utils import watchdog as J_wd
    monkeypatch.setattr(J_wd.time, "monotonic", clock)
    msgs = []
    for wd in (StepWatchdog(0.05, name="collective"),
               _jax_wd(0.05, name="collective")):
        wd.beat("chain_0")
        clock.t += 0.02
        wd.beat("chain_1")
        wd.checkpoint_saved(3)
        clock.t += 0.12
        wd._default_on_stall("collective", 0.12)
        msgs.append(capsys.readouterr().err)
        clock.t -= 0.14
    assert msgs[0] == msgs[1]
    assert "last progress: 'chain_1'" in msgs[0]
    assert "last completed checkpoint: step 3" in msgs[0]


def test_run_proxy_stamps_heartbeats():
    """ProxyConfig.watchdog: the harness beats per phase and chain and
    the record's globals carry the ages."""
    import torch

    from dlnetbench_tpu_torch.proxies.base import (ProxyConfig, StepBundle,
                                                   run_proxy)
    wd = StepWatchdog(30.0, name="dp_step")
    bundle = StepBundle(full=lambda: None, compute=None, comm=None,
                        global_meta={}, device=torch.device("cpu"))
    res = run_proxy("wd_test", bundle,
                    ProxyConfig(warmup=1, runs=2, watchdog=wd))
    ages = res.global_meta["watchdog_heartbeat_age_s"]
    assert set(ages) == {"warmup", "chain_0", "chain_1"}
    assert all(v >= 0.0 for v in ages.values())
    assert res.global_meta["watchdog_stalls"] == 0


def test_run_proxy_arms_every_full_chain(monkeypatch):
    """The watchdog is armed around each fenced full chain (and only
    there): a chain that outlives the deadline fires it."""
    import torch

    from dlnetbench_tpu_torch.proxies.base import (ProxyConfig, StepBundle,
                                                   run_proxy)
    armed = []

    class Spy(StepWatchdog):
        def __enter__(self):
            armed.append(True)
            return super().__enter__()

    wd = Spy(30.0)
    bundle = StepBundle(full=lambda: None, compute=lambda: None, comm=None,
                        global_meta={}, device=torch.device("cpu"))
    run_proxy("wd_test", bundle, ProxyConfig(warmup=1, runs=3,
                                             reps_per_fence=2,
                                             watchdog=wd))
    assert len(armed) == 2      # chains of 2 + 1


def test_stall_dumps_active_span_stack(capsys):
    from dlnetbench_tpu_torch.metrics import spans
    spans.enable()
    try:
        wd = StepWatchdog(DEADLINE, name="timed")
        wd.beat("chain_0")
        with spans.span("timed", what="headline"):
            with spans.span("fence"):
                _stalled(wd)
    finally:
        spans.disable()
    err = capsys.readouterr().err
    assert wd.stalls == 1
    assert "active spans:" in err and "timed > fence" in err
    meta = wd.stamp({})
    assert meta["watchdog_stall_spans"] == ["timed > fence"]


@pytest.mark.telemetry
def test_stall_dumps_telemetry_ring_trend(capsys, tmp_path):
    """A stall report carries the flight ring's last-K samples in the
    message, the record stamp and a flight_stall.json dump."""
    from dlnetbench_tpu_torch.metrics import telemetry
    rec = telemetry.enable(capacity=32, dump_dir=tmp_path)
    try:
        for i in range(12):
            telemetry.record_step("proxy", step=i,
                                  step_wall_us=100.0 + 10 * i)
        wd = StepWatchdog(DEADLINE, name="timed")
        wd.beat("chain_0")
        _stalled(wd)
    finally:
        telemetry.disable()
    err = capsys.readouterr().err
    assert wd.stalls == 1
    assert "telemetry trend" in err and "step walls us" in err
    assert [s["step"] for s in wd.last_stall_telemetry] == \
        list(range(4, 12))
    meta = wd.stamp({})
    assert meta["watchdog_stall_telemetry"] == wd.last_stall_telemetry
    dump = json.loads((tmp_path / "flight_stall.json").read_text())
    assert dump["trigger"] == "stall"
    assert dump["detail"]["section"] == "timed"
    assert dump["detail"]["elapsed_s"] >= DEADLINE
    assert [s["step"] for s in dump["samples"]] == list(range(12))
    assert rec.anomalies_block()["triggers"] == {"stall": 1}


@pytest.mark.telemetry
def test_stall_without_telemetry_has_no_trend_noise(capsys):
    wd = StepWatchdog(DEADLINE, name="timed")
    _stalled(wd)
    err = capsys.readouterr().err
    assert wd.stalls == 1 and "telemetry trend" not in err
    assert "watchdog_stall_telemetry" not in wd.stamp({})


def test_stall_without_tracing_has_no_span_noise(capsys):
    wd = StepWatchdog(DEADLINE, name="timed")
    _stalled(wd)
    err = capsys.readouterr().err
    assert wd.stalls == 1 and "active spans:" not in err
    assert "watchdog_stall_spans" not in wd.stamp({})


def test_record_stamp_without_checkpoint_has_no_age_keys():
    meta = StepWatchdog(5.0).stamp({})
    assert "last_checkpoint_age_s" not in meta
    assert "last_checkpoint_step" not in meta


def test_snapshot_checkpointer_wires_watchdog(tmp_path):
    """A SnapshotCheckpointer given a watchdog reports each COMPLETED
    save — an async one only after its write lands."""
    import torch

    from dlnetbench_tpu_torch.utils.checkpoint import SnapshotCheckpointer
    wd = StepWatchdog(30.0)
    sc = SnapshotCheckpointer(tmp_path / "c", {"w": torch.ones(4)},
                              every=2, mode="async", backend="npz",
                              watchdog=wd)
    sc.on_step(0)
    assert wd.last_checkpoint_age_s() is None
    sc.on_step(1)
    sc.wait()
    assert wd.last_checkpoint_age_s() is not None
    assert wd.stamp({})["last_checkpoint_step"] == 1
