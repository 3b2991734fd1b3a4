"""The port's sweep driver (``dlnetbench_tpu_torch/sweep.py``) against
the JAX package's ``sweep.py``: grid expansion, axis parsing and the
bottleneck tally are JAX's; a point's command differs only by the
module name and, with ``--nproc`` above 1, the ``torch.distributed.run``
prefix; a traced sweep gives one span a point; ``env:`` axes and
``--nproc`` > 1 force a subprocess a point; a sweep under ``torchrun``
is refused; a real two-point in-process sweep at world 1 appends two
tagged records."""
from __future__ import annotations

import io
import json
import sys

import pytest

from dlnetbench_tpu import sweep as J_sweep
from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch import sweep as T_sweep
from dlnetbench_tpu_torch.metrics import spans

MODEL = "gpt2_l_16_bfloat16"
TINY = ["--platform", "cpu", "-r", "1", "-w", "1", "--size_scale", "1e-5",
        "--time_scale", "1e-4", "--no_topology"]


@pytest.fixture(autouse=True)
def _no_launcher(monkeypatch):
    for k in T_sweep._LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    spans.disable()
    yield
    spans.disable()


AXES = [{}, {"a": ["1", "2"], "b": ["x"]},
        {"num_buckets": ["2", "4", "8"], "env:NCCL_ALGO": ["Ring", "Tree"]}]


@pytest.mark.parametrize("axes", AXES)
def test_expand_grid_equals_jax(axes):
    assert T_sweep.expand_grid(axes) == J_sweep.expand_grid(axes)


@pytest.mark.parametrize("spec", [
    "num_buckets=2,4,8", "env:NCCL_ALGO=Ring|Tree|NVLS",
    "env:NCCL_PROTO=Simple|LL128", "env:X=--a=1,2|--b", "k="])
def test_parse_axis_equals_jax(spec):
    assert T_sweep._parse_axis(spec) == J_sweep._parse_axis(spec)


@pytest.mark.parametrize("spec", ["novalue", "=1,2"])
def test_parse_axis_refuses_as_jax(spec):
    for mod in (T_sweep, J_sweep):
        with pytest.raises(ValueError):
            mod._parse_axis(spec)


def test_bound_tally_equals_jax(tmp_path):
    out = tmp_path / "runs.jsonl"

    def rec(bound):
        return json.dumps({"global": {"attribution": {"bound": bound}}})

    out.write_text(rec("host") + "\n" + rec("host") + "\n")
    offset = out.stat().st_size
    with out.open("a") as f:
        f.write(rec("mxu") + "\n\n{not json\n" + json.dumps({"global": {}})
                + "\n" + rec("ici") + "\n")
    for kw in ({}, {"start_offset": offset}):
        got, want = io.StringIO(), io.StringIO()
        assert T_sweep.bound_tally(str(out), got, **kw) == \
            J_sweep.bound_tally(str(out), want, **kw)
        assert got.getvalue() == want.getvalue()
    assert T_sweep.bound_tally(str(out), io.StringIO(),
                               start_offset=offset) == \
        {"mxu": 1, "ici": 1, "n/a": 1}
    assert T_sweep.bound_tally(str(tmp_path / "missing"),
                               io.StringIO()) == {}


POINT = {"num_buckets": "4", "env:NCCL_ALGO": "Tree"}


def test_point_command_differs_from_jax_only_by_module():
    argv, env = T_sweep.point_command("dp", POINT, ["--extra"])
    j_argv, j_env = J_sweep.point_command("dp", POINT, ["--extra"])
    assert env == j_env == {"NCCL_ALGO": "Tree"}
    assert argv == [a.replace("dlnetbench_tpu.cli", T_sweep.CLI_MODULE)
                    for a in j_argv]
    tags = [argv[i + 1] for i, a in enumerate(argv) if a == "--tag"]
    assert set(tags) == {"num_buckets=4", "NCCL_ALGO=Tree"}


def test_point_command_under_torchrun_prefix():
    argv, env = T_sweep.point_command("dp", POINT, ["--extra"], nproc=4)
    j_argv, _ = J_sweep.point_command("dp", POINT, ["--extra"])
    assert argv[:6] == [sys.executable, "-m", "torch.distributed.run",
                        "--nproc_per_node", "4", "--master_port"]
    assert 0 < int(argv[6]) < 65536
    assert argv[7:] == [a.replace("dlnetbench_tpu.cli", T_sweep.CLI_MODULE)
                        for a in j_argv[1:]]


def test_in_process_sweep_one_span_a_point(monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "main", lambda argv: calls.append(argv) or 0)
    monkeypatch.setattr(T_sweep.subprocess, "run", None)   # never called
    tracer = spans.enable()
    failed = T_sweep.run_sweep("dp", {"num_buckets": ["2", "4"]},
                               ["--model", "m", "--platform", "cpu"])
    spans.disable()
    assert failed == 0
    assert [c[c.index("--num_buckets") + 1] for c in calls] == ["2", "4"]
    assert calls[0][0] == "dp"
    points = [s for s in tracer.spans if s["name"] == "sweep-point"]
    assert [s["attrs"]["point"] for s in points] == \
        ["num_buckets=2", "num_buckets=4"]
    assert all(s["attrs"]["mode"] == "in-process" for s in points)


class _Proc:
    returncode = 0


@pytest.mark.parametrize("axes,nproc", [
    ({"env:NCCL_ALGO": ["Ring", "Tree"]}, 1),
    ({"num_buckets": ["2", "4"]}, 4)])
def test_env_axis_or_nproc_forces_a_subprocess(monkeypatch, axes, nproc):
    ran = []
    monkeypatch.setattr(T_sweep.subprocess, "run",
                        lambda argv, env=None: ran.append((argv, env))
                        or _Proc())
    monkeypatch.setattr(cli, "main", None)                 # never called
    assert T_sweep.run_sweep("dp", axes, ["--model", "m"],
                             nproc=nproc) == 0
    assert len(ran) == 2
    if nproc > 1:
        assert ran[0][0][2:5] == ["torch.distributed.run",
                                  "--nproc_per_node", "4"]
    else:
        assert ran[0][1]["NCCL_ALGO"] == "Ring"
    with pytest.raises(ValueError, match="fresh"):
        T_sweep.run_sweep("dp", axes, ["--model", "m"], in_process=True,
                          nproc=nproc)


def test_in_process_point_failure_counted(monkeypatch):
    monkeypatch.setattr(cli, "main",
                        lambda argv: (_ for _ in ()).throw(SystemExit(2)))
    assert T_sweep.run_sweep("dp", {"num_buckets": ["2", "4"]},
                             ["--model", "m", "--platform", "cpu"],
                             keep_going=True) == 2


def test_sweep_under_torchrun_is_refused(monkeypatch, capsys):
    monkeypatch.setenv("TORCHELASTIC_RUN_ID", "x")
    with pytest.raises(SystemExit):
        T_sweep.main(["dp", "--model", MODEL, "--out", "/dev/null"])
    assert "--nproc" in capsys.readouterr().err


def test_dry_run_prints_commands(capsys):
    assert T_sweep.main(["dp", "--model", MODEL, "--out", "/dev/null",
                         "--nproc", "2", "--axis", "num_buckets=2,4",
                         "--dry_run", "--", "--platform", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "[sweep 1/2]" in err and "[sweep 2/2]" in err
    assert "--num_buckets 2" in err and "torch.distributed.run" in err


def test_real_in_process_sweep_writes_tagged_records(tmp_path):
    """Two points at world 1 in this process: one gloo group and one
    burn calibration for both; two records tagged with the axis; a
    traced sweep keeps its tracer through the cli's points (each point's
    build nested in its span)."""
    from dlnetbench_tpu.metrics.parser import get_metrics_dataframe
    import torch.distributed as dist
    out, trace = tmp_path / "sweep.jsonl", tmp_path / "sweep_trace.json"
    assert T_sweep.main(["dp", "--model", MODEL, "--out", str(out),
                         "--axis", "num_buckets=2,4", "--trace-out",
                         str(trace), "--", *TINY]) == 0
    assert not dist.is_initialized()
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["global"]["variables"]["num_buckets"] for r in recs] == \
        ["2", "4"]
    assert [r["global"]["num_buckets"] for r in recs] == [2, 4]
    df = get_metrics_dataframe(out, "dp")
    assert sorted(df["num_buckets"].unique()) == [2, 4]
    events = json.loads(trace.read_text())["traceEvents"]
    points = [e for e in events if e.get("name") == "sweep-point"]
    builds = [e for e in events if e.get("name") == "build"]
    assert len(points) == 2 and len(builds) == 2
    for p, b in zip(points, builds):
        assert p["ts"] <= b["ts"] <= p["ts"] + p["dur"]
