"""The port's checkpoint-interval planning (``dlnetbench_tpu_torch/
analysis/goodput.py``) against the JAX package's, on the CPU: Daly's
optimum and the exponential-model efficiency over a grid of costs, and
``fit_costs``, ``interval_prediction``, ``validate_sweep`` and the
``report`` / ``json`` CLI on seeded preempt sweeps (the JAX-shaped
records its resilience loop writes; the port's proxies write none yet)
— equal outputs, rendered text and exit codes."""
from __future__ import annotations

import io
import json

import numpy as np
import pytest

from dlnetbench_tpu.analysis import goodput as J
from dlnetbench_tpu_torch.analysis import goodput as T

COSTS = [(d, m) for d in (0.0, 1e-4, 0.01, 0.3, 2.0, 5.0)
         for m in (0.0, 0.05, 1.0, 2.4, 1e3)]


@pytest.mark.parametrize("d,m", COSTS)
def test_daly_and_efficiency_equal(d, m):
    assert T.daly_interval_s(d, m) == J.daly_interval_s(d, m)
    for tau in (0.0, 0.001, 0.1, 1.0, 10.0):
        for r in (0.0, 0.5):
            assert T.efficiency(tau, d, m, r) == J.efficiency(tau, d, m, r)


def _record(every: int, goodput: float, rng, *, preempt_at: int) -> dict:
    step_us = float(rng.uniform(15e3, 25e3))
    stall = float(rng.uniform(5.0, 15.0))
    return {
        "section": "dp", "version": 2, "process": 0,
        "global": {"proxy": "dp", "world_size": 8,
                   "checkpoint_every": every,
                   "checkpoint_stall_ms": stall, "checkpoint_ms": stall,
                   "restore_ms": float(rng.uniform(1, 9)),
                   "detection_ms": 1.0, "recovery_ms": 100.0,
                   "lost_steps": every // 2, "goodput": goodput,
                   "fault_iteration": preempt_at},
        "mesh": {"platform": "cpu"},
        "num_runs": 8, "warmup_times": [1.0],
        "ranks": [{"rank": 0, "device_id": 0, "process_index": 0,
                   "hostname": "h",
                   "runtimes": list(step_us + rng.normal(0, 50, 8))}]}


def sweep(seed: int) -> list[dict]:
    """A seeded sweep over checkpoint intervals: two or three repeats an
    interval, goodput peaked at a seeded interval."""
    rng = np.random.default_rng(seed)
    grid = [1, 2, 4, 8, 16, 32][: 3 + seed % 4]
    peak = grid[int(rng.integers(len(grid)))]
    recs = []
    for e in grid:
        for _ in range(2 + seed % 2):
            g = 6.0 - abs(np.log2(e) - np.log2(peak)) + rng.normal(0, 0.1)
            recs.append(_record(e, float(g), rng,
                                preempt_at=int(rng.integers(4, 40))))
    return recs


@pytest.mark.parametrize("seed", range(8))
def test_fit_and_validate_equal_on_seeded_sweeps(seed):
    recs = sweep(seed)
    jm, tm = J.fit_costs(recs), T.fit_costs(recs)
    assert tm.to_dict() == jm.to_dict()
    assert T.interval_prediction(tm) == J.interval_prediction(jm)
    assert T.validate_sweep(recs) == J.validate_sweep(recs)
    for band in ((0.5, 3.0), (0.0, 100.0), (40.0, 50.0)):
        assert T._snap_band_to_grid(band, [1, 4, 16]) == \
            J._snap_band_to_grid(band, [1, 4, 16])


@pytest.mark.parametrize("recs,match", [
    ([{"global": {}, "ranks": []}], "goodput"),
    ([{"global": {"goodput": 1.0, "checkpoint_every": 2},
       "ranks": [{"runtimes": [1.0]}]}], "checkpoint_stall_ms"),
    ([{"global": {"goodput": 1.0, "checkpoint_every": 2,
                  "checkpoint_stall_ms": 1.0},
       "ranks": [{"runtimes": [1.0]}]}], "fault_iteration")])
def test_fit_costs_refuses_as_jax(recs, match):
    for mod in (J, T):
        with pytest.raises(ValueError, match=match):
            mod.fit_costs(recs)


@pytest.mark.parametrize("seed", range(4))
def test_report_and_cli_equal(seed, tmp_path, capsys):
    path = tmp_path / "sweep.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in sweep(seed)))
    outs = []
    for mod in (J, T):
        buf = io.StringIO()
        outs.append((mod.report(str(path), out=buf), buf.getvalue()))
    assert outs[1] == outs[0]
    verdict = J.validate_sweep(J._load(str(path)))
    buf = io.StringIO()
    assert T.report(str(path), out=buf, verdict=verdict) == outs[0][0]
    assert buf.getvalue() == outs[0][1]
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"global": {}, "ranks": []}) + "\n")
    for argv in (["report", str(path)], ["json", str(path)],
                 ["report", str(empty)], ["json", str(empty)], [],
                 ["report"]):
        got = []
        for mod in (J, T):
            rc = mod.main(list(argv))
            cap = capsys.readouterr()
            got.append((rc, cap.out, cap.err.replace(
                "dlnetbench_tpu_torch", "dlnetbench_tpu")))
        assert got[1] == got[0], argv
