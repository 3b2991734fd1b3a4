"""The port's record parser and merge (``dlnetbench_tpu_torch/metrics/
parser.py``, ``metrics/merge.py``) against the JAX package's, on the
CPU: the JAX fixtures ``tests/data/record_*.jsonl`` and seeded synthetic
per-process records go through both, and the loaded records, the
validation errors, the DataFrames (``pandas.testing.assert_frame_equal``),
the merged dicts, the merged files and the CLI's output must be equal.

Where the port differs by design — a gathered record (rank 0 holds every
rank's own clocks, marked in its mesh header) merges to itself in the
port and is refused by JAX's merge — the cases assert the port's
behaviour and JAX's refusal; the four-gloo-rank case is in
tests/test_torch_proxies.py, beside its harness."""
from __future__ import annotations

import copy
import io
import json
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from dlnetbench_tpu.metrics import merge as J_merge
from dlnetbench_tpu.metrics import parser as J_parser
from dlnetbench_tpu_torch.metrics import merge as T_merge
from dlnetbench_tpu_torch.metrics import parser as T_parser

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = sorted(p.name for p in DATA.glob("record_*.jsonl"))


def outcome(fn, *args, **kwargs):
    """``("ok", result)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except (ValueError, KeyError, TypeError) as e:
        return ("raised", type(e).__name__, str(e))


def assert_same_frames(got, want):
    if want.empty:
        assert got.empty and list(got.columns) == list(want.columns)
    else:
        pd.testing.assert_frame_equal(got, want)


def proc_record(proc: int, *, num_procs: int = 2, world: int = 4,
                runs: int = 3, seed: int = 0, **overrides) -> dict:
    """A per-process record as the JAX package writes one on a
    multi-host run: rows for every device, this process's seeded clock
    on all of them, a v2 band summary on each row."""
    rng = np.random.default_rng(seed + proc)
    per_proc = world // num_procs
    runtimes = [round(float(v), 3) for v in 100 + 10 * rng.random(runs)]
    barrier = [round(float(v), 3) for v in 5 + rng.random(runs)]
    rec = {
        "section": "dp", "version": 2, "process": proc,
        "global": {"proxy": "dp", "model": "gpt2_l_16_bfloat16",
                   "world_size": world, "num_processes": num_procs,
                   "num_buckets": 2, "transport": "virtual-host",
                   "host_rtt_us": 10.0 + proc,
                   "comm_model": {"comm_time": [
                       {"kind": "allreduce", "group": world,
                        "bytes": 4096}]}},
        "mesh": {"platform": "cpu", "device_kind": "host",
                 "num_hosts": num_procs},
        "num_runs": runs,
        "warmup_times": [900.0 + proc],
        "ranks": [
            {"rank": r, "device_id": r, "process_index": r // per_proc,
             "hostname": f"host{proc}", "runtimes": list(runtimes),
             "barrier_time": list(barrier),
             "compute_time": [v - b for v, b in zip(runtimes, barrier)],
             "comm_time": [b * 2 for b in barrier],
             "summary": {"runtimes": {"value": runtimes[1], "n": runs}}}
            for r in range(world)],
    }
    rec.update(overrides)
    return rec


def _load(name: str) -> list[dict]:
    return J_parser.load_records(DATA / name)


# ------------------------------------------------------------ the parser
@pytest.mark.parametrize("name", FIXTURES)
def test_load_records_equal(name):
    for section in (None, "dp", "serving"):
        assert T_parser.load_records(DATA / name, section) == \
            J_parser.load_records(DATA / name, section)


def test_load_records_bad_json_raises_the_same(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"section": "dp"}\n{"trunc\n')
    assert outcome(T_parser.load_records, path) == \
        outcome(J_parser.load_records, path)


@pytest.mark.parametrize("name", FIXTURES)
def test_validate_record_passes_as_jax(name):
    for rec in _load(name):
        assert outcome(T_parser.validate_record, rec) == \
            outcome(J_parser.validate_record, rec)


def _broken(kind: str) -> dict:
    rec = proc_record(0, num_procs=1, world=4)
    if kind == "rank_missing":
        rec["ranks"].pop(2)
    elif kind == "timer_length":
        rec["ranks"][1]["barrier_time"].append(1.0)
    elif kind == "summary_n":
        rec["ranks"][0]["summary"]["runtimes"]["n"] = 7
    elif kind == "process_missing":
        rec["global"]["num_processes"] = 2
    elif kind == "hostnames":
        for i, row in enumerate(rec["ranks"]):
            row["hostname"] = f"h{i}"
    elif kind == "degraded_outside":
        rec["global"]["degraded_world"] = [0, 1, 7]
    elif kind == "degraded_mismatch":
        rec["global"]["degraded_world"] = [0, 1]
    elif kind == "degraded_process":
        rec["global"]["degraded_world"] = [0, 1, 2, 3]
        for row in rec["ranks"]:
            row["process_index"] = 5
    return rec


@pytest.mark.parametrize("kind", [
    "rank_missing", "timer_length", "summary_n", "process_missing",
    "hostnames", "degraded_outside", "degraded_mismatch",
    "degraded_process"])
def test_validate_record_raises_the_same_errors(kind):
    rec = _broken(kind)
    want = outcome(J_parser.validate_record, copy.deepcopy(rec))
    assert want[0] == "raised"
    assert outcome(T_parser.validate_record, rec) == want


@pytest.mark.parametrize("name", FIXTURES)
def test_records_to_dataframe_equal(name):
    recs = _load(name)
    for validate in (True, False):
        want = outcome(J_parser.records_to_dataframe, recs, validate)
        got = outcome(T_parser.records_to_dataframe, recs, validate)
        assert got[0] == want[0]
        if want[0] == "ok":
            assert_same_frames(got[1], want[1])
        else:
            assert got == want


def test_dataframe_of_all_fixtures_and_synthetic_records_equal():
    recs = [r for n in FIXTURES for r in _load(n)]
    recs.append(proc_record(0, num_procs=1, seed=5))
    pd.testing.assert_frame_equal(
        T_parser.records_to_dataframe(recs, validate=False),
        J_parser.records_to_dataframe(recs, validate=False))


@pytest.mark.parametrize("name", FIXTURES)
def test_get_metrics_dataframe_equal(name):
    for strategy in (None, "dp", "serving"):
        want = outcome(J_parser.get_metrics_dataframe, DATA / name,
                       strategy)
        got = outcome(T_parser.get_metrics_dataframe, DATA / name, strategy)
        assert got[0] == want[0]
        if want[0] == "ok":
            assert_same_frames(got[1], want[1])


# ------------------------------------------------------------- the merge
@pytest.mark.parametrize("name", FIXTURES)
def test_merge_records_equal_on_fixtures(name):
    """The degraded (faulted) and rejoin fixtures are single process
    records of several-process runs: both merges refuse them alike."""
    recs = _load(name)
    assert outcome(T_merge.merge_records, copy.deepcopy(recs)) == \
        outcome(J_merge.merge_records, copy.deepcopy(recs))


def _degraded(proc: int, dead=(1,), world: int = 4) -> dict:
    survivors = [r for r in range(world) if r not in dead]
    rec = proc_record(proc, num_procs=world, world=world, seed=3)
    rec["global"].update(
        degraded_world=survivors, fault_policy="shrink",
        fault_plan={"policy": "shrink", "events": [
            {"kind": "crash", "ranks": list(dead), "iteration": 3}]},
        detection_ms=2.0 + proc, recovery_ms=3.0 + proc)
    rec["ranks"] = [dict(rec["ranks"][proc])]
    return rec


def _rejoin(proc: int, rejoin_step: int = 4) -> dict:
    rec = proc_record(proc, num_procs=3, world=3, runs=6, seed=9)
    rec["global"].update(
        fault_policy="shrink", fault_rejoin_step=rejoin_step,
        fault_plan={"policy": "shrink", "events": [
            {"kind": "preempt", "ranks": [1], "iteration": 2,
             "magnitude_us": 20000.0},
            {"kind": "rejoin", "ranks": [1], "iteration": 4}]},
        rejoin_ms=10.0 + proc, checkpoint_ms=5.0 + proc,
        restore_ms=2.0 + proc, lost_steps=proc, goodput=6.0 + proc)
    rec["ranks"] = [dict(rec["ranks"][proc])]
    return rec


def _energy(proc: int) -> dict:
    rec = proc_record(proc, num_procs=2)
    for row in rec["ranks"]:
        row["hostname"] = "shared"
        row["energy_consumed"] = [1.0 + proc] * 3
        row["summary"]["energy_consumed"] = {"value": 1.0 + proc, "n": 3}
    return rec


def _anomalies(proc: int) -> dict:
    rec = proc_record(proc, num_procs=2)
    rec["global"]["telemetry"] = {"capacity": 8, "recorded": 3 + proc}
    rec["global"]["anomalies"] = {
        "count": 1 + proc, "triggers": {"step_time": 1 + proc},
        "events": [{"kind": "step_time", "step": s} for s in
                   range(1 + proc)]}
    return rec


def with_global(rec: dict, **kw) -> dict:
    rec["global"].update(kw)
    return rec


MERGE_CASES = {
    "two_processes": lambda: [proc_record(0), proc_record(1)],
    "reversed_order": lambda: [proc_record(1), proc_record(0)],
    "volatile_globals": lambda: [
        proc_record(0), with_global(proc_record(1), burn_ns_per_iter=1.0,
                                    tuning={"hits": 1})],
    "mismatched_globals": lambda: [
        proc_record(0), with_global(proc_record(1), num_buckets=4)],
    "mismatched_runs": lambda: [proc_record(0), proc_record(1, runs=4)],
    "mixed_versions": lambda: [proc_record(0),
                               proc_record(1, version=1)],
    "duplicate_process": lambda: [proc_record(0), proc_record(0)],
    "missing_process": lambda: [proc_record(1)],
    "section_mismatch": lambda: [proc_record(0),
                                 proc_record(1, section="fsdp")],
    "scheduler_variables": lambda: [
        with_global(proc_record(p),
                    variables={"slurm_procid": str(p), "axis": "a"})
        for p in (0, 1)],
    "mismatched_variables": lambda: [
        with_global(proc_record(p), variables={"axis": str(p)})
        for p in (0, 1)],
    "energy_dedup": lambda: [_energy(0), _energy(1)],
    "anomalies_pooled": lambda: [_anomalies(0), _anomalies(1)],
    "degraded": lambda: [_degraded(p) for p in (0, 2, 3)],
    "degraded_dead_zero": lambda: [_degraded(p, dead=(0,))
                                   for p in (1, 2, 3)],
    "degraded_missing_survivor": lambda: [_degraded(p) for p in (0, 3)],
    "undeclared_missing": lambda: [proc_record(p, num_procs=4)
                                   for p in (0, 2, 3)],
    "rejoin": lambda: [_rejoin(p) for p in range(3)],
    "rejoin_mismatched_trigger": lambda: [_rejoin(0), _rejoin(1, 5),
                                          _rejoin(2)],
    "empty": lambda: [],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_records_equal_on_synthetic_runs(case):
    want = outcome(J_merge.merge_records, MERGE_CASES[case]())
    assert outcome(T_merge.merge_records, MERGE_CASES[case]()) == want


def test_merge_files_and_cli_equal(tmp_path, capsys):
    ins = []
    for p in (0, 1):
        path = tmp_path / f"in{p}.jsonl"
        path.write_text(json.dumps(proc_record(p)) + "\n"
                        + json.dumps(proc_record(p, section="fsdp")) + "\n")
        ins.append(path)
    for section in (None, "fsdp"):
        outs = {}
        for side, mod in (("jax", J_merge), ("port", T_merge)):
            out = tmp_path / f"{side}_{section}.jsonl"
            outs[side] = outcome(mod.merge_files, out, ins, section)
            if outs[side][0] == "ok":
                outs[side] = (outs[side], out.read_text())
        assert outs["port"] == outs["jax"]
    texts, rcs = {}, {}
    for side, mod in (("jax", J_merge), ("port", T_merge)):
        out = tmp_path / f"cli_{side}.jsonl"
        trace = tmp_path / f"cli_{side}.json"
        rcs[side] = mod.main(["--section", "dp", "--trace-out", str(trace),
                              str(out), *map(str, ins)])
        err = capsys.readouterr().err.replace(str(out), "OUT").replace(
            str(trace), "TRACE")
        texts[side] = (out.read_text(), json.loads(trace.read_text()), err)
    assert rcs["port"] == rcs["jax"] == 0
    assert texts["port"] == texts["jax"]
    for argv in ([], ["--section"], ["only_out.jsonl"]):
        assert T_merge.main(argv) == J_merge.main(argv) == 2
        capsys.readouterr()


# --------------------------------------------- the gathered record mark
def _gathered(world: int = 4, seed: int = 1) -> dict:
    """A record as the port's rank 0 writes one on a gloo world: every
    rank's own clock in its row, one process per rank, the mark."""
    rng = np.random.default_rng(seed)
    rec = proc_record(0, num_procs=world, world=world, seed=seed)
    for row in rec["ranks"]:
        row["runtimes"] = [round(float(v), 3)
                           for v in 100 + 10 * rng.random(3)]
        row["summary"] = {}
    rec["mesh"]["gathered"] = True
    rec["global"].pop("attribution", None)
    return rec


def test_gathered_record_merges_to_itself_and_jax_refuses_it():
    from dlnetbench_tpu_torch.metrics.emit import stamp_attribution
    rec = stamp_attribution(_gathered())
    assert rec["global"]["attribution"]["bound"] == "host"
    assert T_merge.merge_records([copy.deepcopy(rec)]) == rec
    with pytest.raises(ValueError, match=r"expected range\(4\)"):
        J_merge.merge_records([copy.deepcopy(rec)])
    # never merged with another record
    with pytest.raises(ValueError, match="merge it alone"):
        T_merge.merge_records([rec, proc_record(1, num_procs=4)])
    # a gathered record still has to cover every rank
    broken = copy.deepcopy(rec)
    broken["ranks"].pop()
    assert outcome(T_merge.merge_records, [broken]) == \
        outcome(J_parser.validate_record, broken)


def test_gathered_record_restamps_attribution_over_every_row():
    """Merged alone, a gathered record's attribution is recomputed over
    all its rows (one stamped from rank 0's rows alone is replaced)."""
    from dlnetbench_tpu_torch.analysis.attribution import attribute_record
    rec = _gathered(seed=4)
    rank0 = {**rec, "ranks": rec["ranks"][:1]}
    rec["global"]["attribution"] = attribute_record(rank0)
    merged = T_merge.merge_records([rec])
    assert merged["global"]["attribution"] == attribute_record(rec)
    assert merged["global"]["attribution"] != rec["global"]["attribution"]
    assert merged["ranks"] == rec["ranks"]


def test_gathered_mark_adds_no_parser_column():
    rec = _gathered()
    plain = copy.deepcopy(rec)
    del plain["mesh"]["gathered"]
    for mod in (J_parser, T_parser):
        pd.testing.assert_frame_equal(mod.records_to_dataframe([rec]),
                                      mod.records_to_dataframe([plain]))


def test_merge_cli_of_a_gathered_record(tmp_path, capsys):
    from dlnetbench_tpu_torch.metrics.emit import stamp_attribution
    rec = stamp_attribution(_gathered())
    src = tmp_path / "rank0.jsonl"
    src.write_text(json.dumps(rec) + "\n")
    out = tmp_path / "merged.jsonl"
    err = io.StringIO()
    with redirect_stderr(err):
        assert T_merge.main([str(out), str(src)]) == 0
    assert json.loads(out.read_text()) == rec
    assert "1 process record(s): dp, 4 ranks" in err.getvalue()
