"""The port's studies (``dlnetbench_tpu_torch/examples/``) held against
the JAX package's scripts in ``examples/`` on the CPU, without running a
study: the pod study's plan, arrival plans, elastic plans and constants
exactly JAX's; its ``--report_only`` run over copies of the committed
JAX study records printing JAX's stdout and writing byte-equal CSVs and
``goodput_verdict.json`` with JAX's rc; the grid's worlds and the
serving points' argv; the refusals; the report without matplotlib.

JAX's script is loaded with ``importlib`` from ``examples/pod_study.py``.
The cut runs of the studies are in tests/test_torch_examples_run.py."""
from __future__ import annotations

import importlib.util
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from dlnetbench_tpu_torch.examples import pod_study as P

REPO = Path(__file__).resolve().parent.parent
STUDIES = REPO / "docs" / "studies"


def _load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_jax_script("pod_study")


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
@pytest.mark.parametrize("models", [[P.DENSE], [P.MOE], [P.DENSE, P.MOE]],
                         ids=["dense", "moe", "both"])
def test_build_plan_equals_jax(devices, models):
    assert P.build_plan(models, devices) == J.build_plan(models, devices)


@pytest.mark.parametrize("rate,seed,n", [(10000.0, 0, None),
                                         (37.123456, 3, None),
                                         (0.5, 4, 40)])
def test_serving_arrival_equals_jax(rate, seed, n):
    args = (rate, seed) if n is None else (rate, seed, n)
    assert P.serving_arrival(*args) == J.serving_arrival(*args)


@pytest.mark.parametrize("seed", range(6))
def test_elastic_plan_equals_jax(seed):
    assert P.elastic_plan(seed) == J.elastic_plan(seed)
    assert P.elastic_plan(seed, warmup=3) == J.elastic_plan(seed, warmup=3)


@pytest.mark.parametrize("name", [
    "DENSE", "MOE", "SERVING_FRACTIONS", "SERVING_SEEDS",
    "SERVING_REQUESTS", "SERVING_FLAGS", "SERVING_FAULT_DELAY_US",
    "DISAGG_FLAGS", "FLEET_FLAGS", "KV_DENSITY_MIN_CAPACITY_X",
    "FAULT_MODEL", "ELASTIC_INTERVALS", "ELASTIC_SEEDS", "ELASTIC_RUNS"])
def test_constants_equal_jax(name):
    assert getattr(P, name) == getattr(J, name)


def test_straggler_point_runs_at_jax_load():
    """JAX's straggler point runs at 0.5x capacity, a fraction of its
    sweep; the port names that load once."""
    assert P.SERVING_FAULT_FRAC == 0.5
    assert P.SERVING_FAULT_FRAC in P.SERVING_FRACTIONS


# ------------------------------------------------------- report parity
def _report_only(tmp_path, study: str, mode: list[str], capsys,
                 monkeypatch):
    """(stdout, files, rc) of JAX's and of the port's ``--report_only``
    run over copies of ``study``'s records, out_dir normalised."""
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(STUDIES / study / "records.jsonl", d)
        argv = [*mode, "--report_only", "--out_dir", str(d)]
        capsys.readouterr()
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["pod_study.py", *argv])
            rc = J.main()
        else:
            rc = P.main(argv)
        text = capsys.readouterr().out.replace(str(d), "OUT")
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())
                 if p.suffix in (".csv", ".json")}
        out[side] = (text, files, rc)
    return out


@pytest.mark.parametrize("study,mode", [
    ("serving_study_r11", ["--serving"]),
    ("fault_study_r8", ["--fault"]),
    ("elastic_study_r10", ["--fault"]),
    ("pod_study_hier_procs3", []),
])
def test_report_only_equals_jax(tmp_path, capsys, monkeypatch, study,
                                mode):
    got = _report_only(tmp_path, study, mode, capsys, monkeypatch)
    jax_text, jax_files, jax_rc = got["jax"]
    text, files, rc = got["port"]
    assert text == jax_text
    assert files == jax_files and files
    assert rc == jax_rc
    if study == "elastic_study_r10":
        assert "goodput_verdict.json" in files
        assert json.loads(files["goodput_verdict.json"]) == json.loads(
            (STUDIES / study / "goodput_verdict.json").read_text())


def test_report_without_matplotlib_names_the_skipped_pngs(
        tmp_path, capsys, monkeypatch):
    """With matplotlib hidden (the card machine has none) the grid's
    report prints its tables, writes its CSV, names each PNG it skipped
    and exits 0; the tables are the ones printed with matplotlib."""
    d = tmp_path / "study"
    d.mkdir()
    shutil.copy(STUDIES / "pod_study_hier_procs3" / "records.jsonl", d)
    assert P.main(["--report_only", "--out_dir", str(d)]) == 0
    with_plots = capsys.readouterr().out
    for f in d.glob("*.png"):
        f.unlink()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert P.main(["--report_only", "--out_dir", str(d)]) == 0
    text = capsys.readouterr().out
    for name in ("dp_runtime_scaling", "dp_barrier_by_bucket",
                 "pareto_proxies"):
        assert f"skipped {d}/{name}.png" in text
    assert not list(d.glob("*.png"))
    assert (d / "bandwidth_summary.csv").stat().st_size > 0
    tables = with_plots.split("\nwrote ")[0]
    assert text.startswith(tables)


# ------------------------------------------------- points and refusals
def _recorded_runs(monkeypatch):
    calls = []

    def run(argv, **kw):
        calls.append(argv)
        return SimpleNamespace(returncode=0)

    monkeypatch.setattr(P.subprocess, "run", run)
    return calls


def _world(argv) -> int:
    if "torch.distributed.run" not in argv:
        return 1
    return int(argv[argv.index("--nproc_per_node") + 1])


@pytest.mark.parametrize("devices", [4, 8])
def test_grid_points_take_their_world_from_the_launcher(monkeypatch,
                                                        devices):
    """The dp scaling axis ``d`` is the point's process count and never a
    flag; every other point runs at ``--devices``; each point is
    tagged with its proxy and runs the study's flags."""
    calls = _recorded_runs(monkeypatch)
    plan = P.build_plan([P.DENSE, P.MOE], devices)
    args = SimpleNamespace(devices=devices, platform="cpu", runs=3,
                           full_scale=False, size_scale=1e-4,
                           time_scale=1e-4)
    assert P.run_plan(plan, args, Path("r.jsonl")) == 0
    assert len(calls) == len(plan)
    for (proxy, flags), argv in zip(plan, calls):
        assert _world(argv) == flags.get("d", devices)
        assert "--d" not in argv and "-d" not in argv
        i = argv.index(P.CLI)
        cli = argv[i:]
        assert argv[i - 1] == "-m" and cli[1] == proxy
        assert ["--tag", f"proxy={proxy}"] == cli[cli.index("--tag"):
                                                   cli.index("--tag") + 2]
        assert cli[cli.index("--platform") + 1] == "cpu"
        for k, v in flags.items():
            if k != "d":
                assert cli[cli.index(f"--{k}") + 1] == str(v)


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_serving_points_pin_gather_attention(platform):
    """Every serving point runs the study's flags and the gather
    attention on either platform (head_dim 16: no K1/K2)."""
    argv = P._serve_argv(Path("r.jsonl"), P.serving_arrival(1.0, 0),
                         ["load_frac=0.5"], P.DISAGG_FLAGS,
                         platform=platform)
    jargv = J._serve_argv(Path("r.jsonl"), J.serving_arrival(1.0, 0),
                          ["load_frac=0.5"], J.DISAGG_FLAGS)
    assert argv[argv.index("--attn_impl") + 1] == "gather"
    assert argv[argv.index("--platform") + 1] == platform
    assert argv[argv.index("--embed") + 1] == "64"
    assert argv[argv.index("--heads") + 1] == "4"
    # the rest is JAX's argv: the same flags in the same order
    strip = {"--attn_impl", "gather", "--platform", platform, "cpu",
             P.CLI, "dlnetbench_tpu.cli"}
    assert [a for a in argv if a not in strip] == \
        [a for a in jargv if a not in strip]


@pytest.mark.parametrize("argv,match", [
    (["--serving", "--disagg", "--fleet", "--platform", "cpu"],
     "different serving arms"),
    (["--backend", "nccl", "--platform", "cpu"],
     "--backend nccl applies to --tier native"),
    (["--tier", "native", "--platform", "cuda"],
     "--tier native --backend shm runs the C++ binaries"),
    (["--tier", "native", "--backend", "nccl", "--platform", "cpu"],
     "--backend nccl runs on the cards"),
    (["--tier", "native", "--procs", "2", "--platform", "cpu"],
     "--procs > 1 applies to --tier native --backend nccl"),
    (["--tier", "python", "--platform", "cpu"], "invalid choice"),
    (["--platform", "cuda"], "torch.cuda.is_available"),
    (["--platform", "tpu"], "invalid choice"),
])
def test_refusals(capsys, argv, match, tmp_path):
    with pytest.raises(SystemExit) as e:
        P.main([*argv, "--out_dir", str(tmp_path)])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


# ------------------------------------------------------ the native tier
def _capture_native(monkeypatch, module, runner):
    calls = []

    def run(argv, **kw):
        calls.append(list(argv))
        return SimpleNamespace(returncode=0)

    monkeypatch.setattr(module.subprocess, "run", run)
    return calls


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("full_scale", [False, True])
def test_native_plan_argv_equals_jax(monkeypatch, devices, full_scale):
    """``--tier native --backend shm``: each point's binary, world and
    flags exactly JAX's (the bin directory aside)."""
    import dlnetbench_tpu.utils.native_build as jax_build
    monkeypatch.setattr(jax_build, "native_bin",
                        lambda repo, build=True: Path("/JAX_BIN"))
    monkeypatch.setattr(P.native_build, "native_bin",
                        lambda *a, **k: Path("/PORT_BIN"))
    plan = P.build_plan([P.DENSE, P.MOE], devices)
    args = SimpleNamespace(devices=devices, platform="cpu", runs=3,
                           full_scale=full_scale, size_scale=1e-4,
                           time_scale=1e-4, tier="native", backend="shm",
                           procs=1)
    jcalls = _capture_native(monkeypatch, J, "run")
    J.run_plan(J.build_plan([J.DENSE, J.MOE], devices), args,
               Path("r.jsonl"))
    pcalls = _capture_native(monkeypatch, P, "run")
    assert P.run_plan(plan, args, Path("r.jsonl")) == 0
    norm = [[a.replace("/JAX_BIN", "BIN") for a in c] for c in jcalls]
    assert [[a.replace("/PORT_BIN", "BIN") for a in c] for c in pcalls] \
        == norm
    assert len(pcalls) == len(plan)


def test_native_nccl_points_name_the_backend(monkeypatch):
    monkeypatch.setattr(P.native_build, "native_bin",
                        lambda *a, **k: Path("/PORT_BIN"))
    monkeypatch.setattr(P.native_build, "nccl_env", lambda: {})
    calls = _capture_native(monkeypatch, P, "run")
    args = SimpleNamespace(devices=1, platform="cuda", runs=2,
                           full_scale=False, size_scale=1e-4,
                           time_scale=1e-4, tier="native", backend="nccl",
                           procs=1)
    plan = [("dp", {"model": P.DENSE, "num_buckets": 2, "d": 1})]
    assert P.run_plan(plan, args, Path("r.jsonl")) == 0
    assert calls[0][-2:] == ["--backend", "nccl"]
    assert calls[0][calls[0].index("--world") + 1] == "1"


@pytest.mark.parametrize("world,procs", [(4, 2), (5, 2), (8, 3), (3, 3)])
def test_balanced_layout_covers_the_world(world, procs):
    spans = [P._balanced(world, procs, p) for p in range(procs)]
    ranks = [r for first, n in spans for r in range(first, first + n)]
    assert ranks == list(range(world))
    assert max(n for _, n in spans) - min(n for _, n in spans) <= 1


def test_fault_drop_point_report_equals_jax(tmp_path, capsys):
    """Fault point 3 on the port's native TCP fabric (JAX's point, the
    port's binaries), then both studies' fault reports over that
    record: the same stdout and the same CSV."""
    recs = tmp_path / "records.jsonl"
    assert P._drop_point(recs) == 0
    rec = json.loads(recs.read_text())
    g = rec["global"]
    assert g["fault_policy"] == "retry" and g["fault_drops"] >= 1
    assert g["fault_retries"] == g["fault_drops"]
    assert [r["rank"] for r in rec["ranks"]] == [0, 1]
    out = {}
    for side, mod in (("jax", J), ("port", P)):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(recs, d / "records.jsonl")
        capsys.readouterr()
        rc = mod.fault_report(SimpleNamespace(out_dir=d),
                              d / "records.jsonl")
        text = capsys.readouterr().out.replace(str(d), "OUT")
        out[side] = (text, (d / "fault_bandwidth_summary.csv").read_bytes()
                     if (d / "fault_bandwidth_summary.csv").exists()
                     else None, rc)
    assert out["port"] == out["jax"]
    assert "drop" in out["port"][0]
