"""The port's bandwidth table, critical-path blame and fault plans
(``dlnetbench_tpu_torch/analysis/bandwidth.py``, ``analysis/
critical_path.py``, ``faults/plan.py``) against the JAX package's, on
the CPU: the JAX fixtures ``tests/data/record_*.jsonl`` and seeded
per-rank records (a delay straggler inside a fault window, the native
tier's hierarchical and blocked records, serving records) go through
both, and the DataFrames (``pandas.testing.assert_frame_equal``), the
reports, the CLI output and the plans must be equal.

The port's own additions are held here too: ``transport_of`` knows the
port's labels, and the critical-path CLI reads the port's per-rank
flight dumps (``flight_<trigger>[_<n>]_rank<r>.json``) rank by rank.
Port-written gloo records go through both bandwidth tables in
tests/test_torch_proxies.py and tests/test_torch_pipeline_proxies.py."""
from __future__ import annotations

import copy
import json
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from dlnetbench_tpu.analysis import bandwidth as J_bw
from dlnetbench_tpu.analysis import critical_path as J_cp
from dlnetbench_tpu.faults import plan as J_plan
from dlnetbench_tpu_torch.analysis import bandwidth as T_bw
from dlnetbench_tpu_torch.analysis import critical_path as T_cp
from dlnetbench_tpu_torch.faults import plan as T_plan

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = sorted(p.name for p in DATA.glob("record_*.jsonl"))


def _records(name: str) -> list[dict]:
    return [json.loads(t) for t in (DATA / name).read_text().splitlines()
            if t.strip()]


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except (ValueError, KeyError, TypeError) as e:
        return ("raised", type(e).__name__, str(e))


def same_frames(got, want):
    if want.empty:
        assert got.empty and list(got.columns) == list(want.columns)
    else:
        pd.testing.assert_frame_equal(got, want)


def same_numbers(a, b):
    """Equal, NaN equal to NaN."""
    if isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b


def straggler_record(seed: int, *, world: int = 4, runs: int = 10,
                     warm: int = 2, delay_rank: int | None = 2,
                     delay_us: float = 4000.0, kind: str = "delay",
                     attribution: bool = True) -> dict:
    """Seeded per-rank step timelines as a merged record carries them:
    each rank's own clock, a delay on ``delay_rank`` inside the fault
    window [warm + 3, warm + 7) that the other ranks wait out in their
    collective (95 % of it), the injected delay on every row, phases and
    energy on every row."""
    rng = np.random.default_rng(seed)
    plan = None
    if delay_rank is not None:
        plan = {"policy": "fail_fast", "events": [
            {"kind": kind, "ranks": [delay_rank], "iteration": warm + 3,
             "until": warm + 7, "magnitude_us": delay_us}]}
    rows = []
    for r in range(world):
        walls = list(300 + 20 * rng.random(runs))
        comp = [w * 0.8 for w in walls]
        delay = [0.0] * runs
        if delay_rank is not None:
            for i in range(3, 7):
                walls[i] += delay_us * (1.0 if r == delay_rank else 0.95)
                delay[i] = delay_us
        rows.append({"rank": r, "device_id": r, "process_index": r,
                     "hostname": f"host{r}", "runtimes": walls,
                     "compute_time": comp,
                     "barrier_time": [w - c for w, c in zip(walls, comp)],
                     "comm_time": list(50 + 5 * rng.random(runs)),
                     "fault_delay_us": delay,
                     "overlap_fraction": list(rng.random(runs)),
                     "energy_consumed": list(rng.random(runs))})
    g = {"proxy": "dp", "model": "busywork", "world_size": world,
         "transport": "tcp:loopback", "num_processes": world,
         "comm_model": {"comm_time": [
             {"kind": "allreduce", "group": world, "bytes": 1 << 20}],
             "barrier_time": [{"kind": "allgather", "group": world,
                               "bytes": 1 << 16, "bound": "lower"}]},
         "detection_ms": 1.5, "recovery_ms": 2.5, "goodput": 3.5,
         "moe": {"load_imbalance": 1.25, "drop_rate": 0.01},
         "tuning": {"hits": 2, "misses": 1}}
    if plan is not None:
        g["fault_plan"] = plan
    if attribution:
        g["attribution"] = {"bound": "faulted" if plan else "dcn",
                            "fractions": {"compute": 0.5, "hbm": 0.0,
                                          "comm_exposed": 0.3,
                                          "host": 0.2}}
    return {"section": "dp", "version": 2, "process": 0, "global": g,
            "mesh": {"platform": "tcp", "device_kind": "process-rank"},
            "num_runs": runs, "warmup_times": [0.0] * warm, "ranks": rows}


def _native(dcn_algo=None, threshold=None, span=None, seed=0):
    rec = straggler_record(seed, delay_rank=None, attribution=False)
    comp = {"kind": "allreduce", "group": 4, "bytes": 4096, "ops": 2}
    if span is not None:
        comp["span"] = span
    rec["global"]["comm_model"] = {"comm_time": [comp]}
    if dcn_algo:
        rec["global"]["dcn_algo"] = dcn_algo
    if threshold is not None:
        rec["global"]["tcp_ring_threshold_bytes"] = threshold
    return rec


SYNTHETIC = {
    "straggler": lambda: [straggler_record(0)],
    "jitter": lambda: [straggler_record(1, kind="jitter")],
    "clean": lambda: [straggler_record(2, delay_rank=None)],
    "no_attribution": lambda: [straggler_record(3, attribution=False)],
    "hierarchical": lambda: [_native("hierarchical", 1 << 20)],
    "blocked_span1": lambda: [_native("blocked", 1 << 20, span=1)],
    "blocked_unspanned": lambda: [_native("blocked", 1 << 20)],
    "fullmesh": lambda: [_native(None, 1 << 20)],
    "ring": lambda: [_native(None, 16)],
    "mixed": lambda: [straggler_record(4), _native("blocked", 1 << 20,
                                                    span=3)],
}
ALL = {**{n: (lambda n=n: _records(n)) for n in FIXTURES}, **SYNTHETIC}


# ----------------------------------------------------------- bandwidth
@pytest.mark.parametrize("case", sorted(ALL))
def test_bandwidth_tables_equal(case):
    recs = ALL[case]()
    for fn in ("effective_bandwidth", "bandwidth_summary",
               "serving_summary"):
        same_frames(getattr(T_bw, fn)(copy.deepcopy(recs)),
                    getattr(J_bw, fn)(copy.deepcopy(recs)))
    for rec in recs:
        assert T_bw.transport_of(rec) == J_bw.transport_of(rec)
        same_numbers(T_bw.straggler_amplification(rec),
                     J_bw.straggler_amplification(rec))
        assert T_bw._fault_run_window(rec) == J_bw._fault_run_window(rec)


def test_all_records_in_one_table_equal():
    recs = [r for make in ALL.values() for r in make()]
    for fn in ("effective_bandwidth", "bandwidth_summary",
               "serving_summary"):
        same_frames(getattr(T_bw, fn)(copy.deepcopy(recs)),
                    getattr(J_bw, fn)(copy.deepcopy(recs)))


def test_straggler_amplification_on_the_faulted_fixture():
    rec = _records("record_faulted.jsonl")[0]
    same_numbers(T_bw.straggler_amplification(rec),
                 J_bw.straggler_amplification(rec))
    amp = T_bw.straggler_amplification(straggler_record(0))
    assert amp == J_bw.straggler_amplification(straggler_record(0))
    assert 0.9 < amp < 1.0          # the delay passed almost straight through


@pytest.mark.parametrize("kind", ["allreduce", "allgather",
                                  "reduce_scatter", "alltoall", "p2p",
                                  "broadcast"])
def test_bus_factor_equal(kind):
    for n in (0, 1, 2, 3, 4, 8, 64):
        assert outcome(T_bw.bus_factor, kind, n) == \
            outcome(J_bw.bus_factor, kind, n)


@pytest.mark.parametrize("mesh,want", [
    ({"platform": "gpu", "num_devices": 1}, "local"),
    ({"platform": "gpu", "num_devices": 4, "num_hosts": 1}, "nccl"),
    ({"platform": "gpu", "num_devices": 8, "num_hosts": 2},
     "nccl+network"),
    ({"platform": "cpu", "num_devices": 4}, "virtual-host")])
def test_transport_of_knows_the_ports_labels(mesh, want):
    from dlnetbench_tpu_torch.metrics.emit import transport_label
    rec = {"global": {}, "mesh": mesh}
    assert T_bw.transport_of(rec) == want == transport_label(mesh)
    # a stamped label wins, as in JAX
    rec["global"]["transport"] = "nccl"
    assert T_bw.transport_of(rec) == "nccl"


# ------------------------------------------------------- critical path
@pytest.mark.parametrize("case", sorted(ALL))
def test_blame_reports_equal(case):
    for rec in ALL[case]():
        for fn in ("blame_report", "blame_columns", "prefill_stall_blame"):
            got = outcome(getattr(T_cp, fn), copy.deepcopy(rec))
            want = outcome(getattr(J_cp, fn), copy.deepcopy(rec))
            if got[0] == "ok" and isinstance(want[1], dict):
                assert json.dumps(got[1]) == json.dumps(want[1])
            else:
                assert repr(got) == repr(want)
        assert outcome(T_cp.step_matrix, rec) == outcome(J_cp.step_matrix,
                                                         rec)


def test_blame_lands_on_the_injected_rank():
    rep = T_cp.blame_report(straggler_record(0))
    assert rep == J_cp.blame_report(straggler_record(0))
    assert rep["window"]["top_rank"] == 2 and rep["suspects"] == [2]
    assert T_cp.blame_columns(straggler_record(0))["blame_rank"] == "2"


@pytest.mark.parametrize("seed", range(5))
def test_blame_from_matrix_equal_on_seeded_matrices(seed):
    rng = np.random.default_rng(seed)
    n_ranks, n = 2 + seed, 8 + 2 * seed
    mat = (100 + 10 * rng.random((n_ranks, n))).tolist()
    ranks = list(range(0, 2 * n_ranks, 2))
    phases = {r: {"a": mat[r], "b": [v / 2 for v in mat[r]]}
              for r in range(n_ranks)}
    for window in (None, (2, 5), (3, None)):
        for ph in (None, phases):
            assert T_cp.blame_from_matrix(ranks, mat, window=window,
                                          phases=ph) == \
                J_cp.blame_from_matrix(ranks, mat, window=window,
                                       phases=ph)


def _flight_dumps(seed: int, world: int = 4, lost: int = 0) -> list[dict]:
    """Per-rank rings, samples without a ``rank`` (the port's recorder
    writes none); rank 1 slow on steps 4-6."""
    rng = np.random.default_rng(seed)
    dumps = []
    for r in range(world):
        samples = [{"t_s": 0.01 * s, "source": "proxy", "step": s,
                    "step_wall_us": float(300 + 10 * rng.random()
                                          + (5000 if r == 1 and 4 <= s < 7
                                             else 0))}
                   for s in range(lost * r, 12)]
        samples.append({"t_s": 1.0, "source": "proxy", "phase": "x"})
        dumps.append({"trigger": "step_time", "t_s": 1.0,
                      "samples": samples})
    return dumps


def test_matrix_from_flights_equal():
    dumps = _flight_dumps(0, lost=1)
    assert T_cp.matrix_from_flights(dumps) == J_cp.matrix_from_flights(dumps)
    tagged = [{**d, "samples": [{**s, "rank": 10 + i} for s in d["samples"]]}
              for i, d in enumerate(dumps)]
    assert T_cp.matrix_from_flights(tagged) == \
        J_cp.matrix_from_flights(tagged)
    for bad in ([], [{"samples": [{"step": 1}]}]):
        assert outcome(T_cp.matrix_from_flights, bad) == \
            outcome(J_cp.matrix_from_flights, bad)


def test_the_cli_reads_the_ports_per_rank_flight_dumps(tmp_path, capsys):
    """Files rank0..rank11 sort as rank0, rank1, rank10, rank11, rank2:
    the matrix still comes out rank by rank, from the file names."""
    world = 12
    dumps = _flight_dumps(3, world=world)
    for r, d in enumerate(dumps):
        (tmp_path / f"flight_step_time_rank{r}.json").write_text(
            json.dumps(d))
        (tmp_path / f"flight_step_time_2_rank{r}.json").write_text(
            json.dumps(d))
    groups = T_cp.load_flights([tmp_path])
    assert sorted(groups) == ["step_time", "step_time_2"]
    want = J_cp.blame_from_matrix(*J_cp.matrix_from_flights(
        [{**d, "samples": [{**s, "rank": r} for s in d["samples"]]}
         for r, d in enumerate(dumps)]))
    ranks, _ = T_cp.matrix_from_flights(groups["step_time"])
    assert ranks == list(range(world))
    rep = T_cp.flight_report("step_time", groups["step_time"])
    assert {k: v for k, v in rep.items()
            if k not in ("section", "model")} == want
    assert rep["per_rank"][1]["blame_frac"] > 0.9
    # the CLI: a directory, or the files themselves
    assert T_cp.main(["report", "--json", str(tmp_path)]) == 0
    reps = [json.loads(t) for t in capsys.readouterr().out.splitlines()]
    assert [r["section"] for r in reps] == ["flight_step_time",
                                           "flight_step_time_2"]
    assert T_cp.main(["report", *(str(p) for p in sorted(
        tmp_path.glob("flight_step_time_rank*.json")))]) == 0
    out = capsys.readouterr().out
    assert "critical path: flight_step_time/step_wall_us" in out
    assert f"{world} ranks" in out
    # JAX's one-process dump (no rank suffix) keeps its samples' ranks
    one = tmp_path / "one"
    one.mkdir()
    (one / "flight_slo.json").write_text(json.dumps(
        {"samples": [{**s, "rank": r} for r, d in enumerate(dumps[:2])
                     for s in d["samples"]]}))
    assert T_cp.load_flights([one])["slo"][0]["samples"][-1]["rank"] == 1


@pytest.mark.parametrize("case", ["straggler", "clean", "record_telemetry",
                                  "record_faulted", "record_attrib"])
def test_critical_path_cli_equal(case, tmp_path, capsys):
    recs = ALL[case if case in SYNTHETIC else f"{case}.jsonl"]()
    path = tmp_path / "runs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    for argv in (["report", str(path)], ["report", "--json", str(path)],
                 ["report", "--section", "dp", str(path)],
                 ["report", "--section", "serving", str(path)],
                 [], ["report"], ["report", "--section"]):
        got = []
        for mod in (J_cp, T_cp):
            rc = mod.main(list(argv))
            cap = capsys.readouterr()
            # the usage line differs by design: the port's names flight
            # dumps and directories too
            got.append((rc, cap.out, "usage" if rc == 2 else cap.err))
        assert got[1] == got[0], argv


# ---------------------------------------------------------- fault plans
def _fixture_plans() -> list[dict]:
    plans = [r["global"]["fault_plan"] for n in FIXTURES
             for r in _records(n) if r["global"].get("fault_plan")]
    assert plans
    return plans


PLANS = [
    *_fixture_plans(),
    {"policy": "shrink", "events": [
        {"kind": "preempt", "ranks": [1], "iteration": 2,
         "magnitude_us": 20000.0},
        {"kind": "rejoin", "ranks": [1], "iteration": 5}]},
    {"policy": "retry", "events": [
        {"kind": "drop", "rate": 0.1, "seed": 3, "magnitude_us": 50.0},
        {"kind": "jitter", "ranks": [0, 2], "magnitude_us": 300.0,
         "where": "collective", "iteration": 1, "until": 9}]},
    {"policy": "fail_fast", "events": [
        {"kind": "partition", "group": [0, 1], "iteration": 4},
        {"kind": "delay", "magnitude_us": 100.0},
        {"kind": "delay", "ranks": [3], "magnitude_us": 70.0}]},
    {"policy": "shrink", "events": [{"kind": "crash", "ranks": [2],
                                     "iteration": 6}]},
]
BAD_PLANS = [
    {"policy": "sometimes", "events": []},
    {"events": [{"kind": "melt"}]},
    {"events": [{"kind": "drop", "rate": 1.0}]},
    {"events": [{"kind": "partition"}]},
    {"events": [{"kind": "delay", "where": "everywhere"}]},
    {"events": [{"kind": "preempt"}]},
    {"events": [{"kind": "preempt", "ranks": [1]}]},
    {"policy": "shrink", "events": [{"kind": "rejoin", "iteration": 3}]},
    {"policy": "shrink", "events": [
        {"kind": "preempt", "ranks": [1], "iteration": 5},
        {"kind": "rejoin", "ranks": [1], "iteration": 3}]},
    {"events": [{"ranks": [1]}]},
]


@pytest.mark.parametrize("idx", range(len(PLANS)))
def test_fault_plans_round_trip_as_jax(idx, tmp_path):
    raw = PLANS[idx]
    j, t = J_plan.FaultPlan.from_dict(raw), T_plan.FaultPlan.from_dict(raw)
    assert t.to_dict() == j.to_dict() and t.dumps() == j.dumps()
    assert T_plan.FaultPlan.loads(t.dumps()).to_dict() == j.to_dict()
    path = tmp_path / "plan.json"
    path.write_text(j.dumps())
    assert T_plan.FaultPlan.loads(f" @{path} ").to_dict() == j.to_dict()
    for q in ("fault_window", "delay_per_step_us", "preempt_victims",
              "first_preempt_iteration", "rejoin_iteration",
              "first_crash_iteration"):
        assert getattr(t, q)() == getattr(j, q)(), q
    for world in (4, 8):
        for q in ("crash_victims", "survivors", "shrink_survivors"):
            assert outcome(getattr(t, q), world) == \
                outcome(getattr(j, q), world), q
    for rank in range(4):
        assert t.delay_per_step_us(rank) == j.delay_per_step_us(rank)
        for it in range(10):
            assert t.evicted(rank, it) == j.evicted(rank, it)
            for te, je in zip(t.events, j.events):
                assert te.live_at(it) == je.live_at(it)
                assert te.targets(rank) == je.targets(rank)


@pytest.mark.parametrize("idx", range(len(BAD_PLANS)))
def test_bad_fault_plans_raise_the_same(idx):
    raw = BAD_PLANS[idx]
    want = outcome(J_plan.FaultPlan.from_dict, raw)
    assert want[0] == "raised"
    assert outcome(T_plan.FaultPlan.from_dict, raw) == want
    assert T_plan.KINDS == J_plan.KINDS and \
        T_plan.POLICIES == J_plan.POLICIES
