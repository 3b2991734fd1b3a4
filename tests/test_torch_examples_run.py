"""The port's studies run at cut sizes on the CPU (gloo, the plain
versions), their records read by the JAX package: the DP bucket study at
world 1 in this process (with and without matplotlib), one grid point at
world 2 under ``torch.distributed.run``, the serving study on a cut plan
(two load fractions, one seed, 40 requests, the calibration and the
straggler point), each record loaded through JAX's ``metrics.parser``
and taken by JAX's report functions without error; the kv-density
study's two halves against JAX's on scripted clocks.  A whole study
run as a subprocess is ``slow``, as the JAX package's are
(tests/test_sweep.py)."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from scripted_clock import scripted  # noqa: E402

from dlnetbench_tpu.analysis.bandwidth import (  # noqa: E402
    bandwidth_summary as j_bandwidth_summary)
from dlnetbench_tpu.metrics.parser import (  # noqa: E402
    load_records as j_load_records, records_to_dataframe as j_dataframe)
from dlnetbench_tpu_torch.examples import dp_bucket_study  # noqa: E402
from dlnetbench_tpu_torch.examples import pod_study as P  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_run_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _load_jax_script("pod_study")


@pytest.fixture
def keep_pythonpath(monkeypatch):
    """The studies put the checkout on PYTHONPATH for their points."""
    monkeypatch.setenv("PYTHONPATH", os.environ.get("PYTHONPATH", ""))


@pytest.mark.parametrize("plots", [True, False], ids=["png", "no_mpl"])
def test_dp_bucket_study_cut_run(tmp_path, capsys, monkeypatch,
                                 keep_pythonpath, plots):
    if not plots:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert dp_bucket_study.main([
        "--platform", "cpu", "--devices", "1", "--buckets", "2,4",
        "--out_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mean per bucket count (us):" in out
    assert "effective bandwidth (comm-only allreduce schedule):" in out
    names = ("runtime_by_bucket", "barrier_by_bucket", "pareto")
    for name in names:
        png = tmp_path / f"{name}.png"
        if plots:
            assert png.stat().st_size > 0
        else:
            assert not png.exists()
            assert f"skipped {tmp_path}/{name}.png" in out
    recs = j_load_records(tmp_path / "records.jsonl", "dp")
    assert [r["global"]["num_buckets"] for r in recs] == [2, 4]
    df = j_dataframe(recs)
    assert sorted(df["num_buckets"].unique()) == [2, 4]
    for rec in recs:
        j_bandwidth_summary([rec])


def test_grid_point_at_world_2(tmp_path, capsys, monkeypatch,
                               keep_pythonpath):
    """One DP scaling point (``d`` 2) as two gloo ranks under
    torch.distributed.run; its record goes through JAX's parser and
    JAX's report, and through the port's."""
    args = SimpleNamespace(devices=2, platform="cpu", runs=2,
                           full_scale=False, size_scale=1e-5,
                           time_scale=2e-4, out_dir=tmp_path)
    records = tmp_path / "records.jsonl"
    plan = [p for p in P.build_plan([P.DENSE], 2) if p[0] == "dp"][:1]
    assert plan == [("dp", {"model": P.DENSE, "num_buckets": 4, "d": 2})]
    assert P.run_plan(plan, args, records) == 0
    recs = j_load_records(records)
    assert len(recs) == 1 and len(recs[0]["ranks"]) == 2
    assert recs[0]["global"]["variables"]["proxy"] == "dp"
    assert recs[0]["global"]["world_size"] == 2
    capsys.readouterr()
    J.report(args, records)
    jax_out = capsys.readouterr().out
    P.report(args, records)
    out = capsys.readouterr().out
    assert "effective bandwidth per collective" in jax_out
    assert out.replace(str(tmp_path), "OUT") == \
        jax_out.replace(str(tmp_path), "OUT")


def test_cut_serving_study(tmp_path, capsys, monkeypatch, keep_pythonpath):
    """The serving study on a cut plan: every point runs (calibration,
    two fractions, the straggler point at a swept fraction), the records
    load through JAX's parser and JAX's serving report takes them; the
    verdicts read wall time and are not asserted here."""
    monkeypatch.setattr(P, "SERVING_FRACTIONS", (0.25, 2.0))
    monkeypatch.setattr(P, "SERVING_SEEDS", (0,))
    monkeypatch.setattr(P, "SERVING_REQUESTS", 40)
    monkeypatch.setattr(P, "SERVING_FAULT_FRAC", 0.25)
    args = SimpleNamespace(platform="cpu", disagg=False, fleet=False,
                           out_dir=tmp_path)
    records = tmp_path / "records.jsonl"
    assert P.run_serving_plan(args, records) == 0
    out = capsys.readouterr().out
    assert "--attn_impl gather on --platform cpu" in out
    recs = j_load_records(records)
    assert len(recs) == 3
    fracs = [r["global"]["variables"]["load_frac"] for r in recs]
    assert fracs == ["0.25", "2.0", "0.25"]
    assert recs[-1]["global"]["variables"]["serving_fault"] == "straggler"
    assert all(r["global"]["serving"]["completed"] == 40 for r in recs)
    j_dataframe(recs)
    j_args = SimpleNamespace(out_dir=tmp_path / "jax")
    j_args.out_dir.mkdir()
    J.serving_report(j_args, records)
    P.serving_report(args, records)
    assert (tmp_path / "serving_summary.csv").read_bytes() == \
        (j_args.out_dir / "serving_summary.csv").read_bytes()


# ------------------------------------------------------------ kv density
@pytest.fixture(scope="module")
def jax_kv_density(tmp_path_factory):
    """JAX's study (both halves) on scripted clocks: its
    kv_density_ab.json and prefix_sharing_ab.json."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = tmp_path_factory.mktemp("jax_kv")
    with scripted("dlnetbench_tpu"):
        J.run_kv_density_study(out)
    return (json.loads((out / "kv_density_ab.json").read_text()),
            json.loads((out / "prefix_sharing_ab.json").read_text()))


def test_kv_density_prefix_half_equals_jax(tmp_path, jax_kv_density):
    _, want = jax_kv_density
    with scripted("dlnetbench_tpu_torch"):
        rc, got = P.prefix_sharing_ab(tmp_path, CPU)
    assert rc == 0
    for key in ("lossless", "prefix_hit_rate", "prefix_bytes_saved",
                "plan"):
        assert got[key] == want[key], key
    assert got["lossless"] and got["prefix_hit_rate"] > 0
    saved = json.loads((tmp_path / "prefix_sharing_ab.json").read_text())
    assert saved == json.loads(json.dumps(got))
    recs = j_load_records(tmp_path / "records.jsonl")
    assert [r["global"]["variables"]["prefix_sharing"] for r in recs] == \
        ["off", "on"]


def test_kv_density_capacity_half_equals_jax(tmp_path, jax_kv_density):
    """capacity_x and parity_ok a recipe equal JAX's on scripted clocks
    (the goodput bands are wall time and are not compared)."""
    want, _ = jax_kv_density
    with scripted("dlnetbench_tpu_torch"):
        P.kv_capacity_ab(tmp_path, CPU)
    got = json.loads((tmp_path / "kv_density_ab.json").read_text())
    for cd in ("int8", "fp8"):
        g, w = got["variants"][cd], want["variants"][cd]
        assert g["capacity_x"] == w["capacity_x"], cd
        assert g["parity_ok"] is w["parity_ok"] is True, cd
        assert g["num_pages"] == w["num_pages"], cd
    assert got["pool_bytes_budget"] == want["pool_bytes_budget"]


# ------------------------------------------------- whole studies (slow)
@pytest.mark.slow
def test_pod_study_end_to_end(tmp_path):
    """The grid at world 4 (gloo) on mixtral, every proxy family in the
    bandwidth table, the CSV and the PNGs."""
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "dlnetbench_tpu_torch.examples.pod_study",
         "--platform", "cpu", "--out_dir", str(tmp_path), "--devices", "4",
         "--runs", "1", "--models", P.MOE],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "effective bandwidth per collective" in proc.stdout
    for proxy in ("dp", "fsdp", "hybrid_2d", "hybrid_3d", "hybrid_3d_moe",
                  "ring_attention", "ulysses"):
        assert proxy in proc.stdout, f"{proxy} missing from study output"
    assert (tmp_path / "bandwidth_summary.csv").stat().st_size > 0
    for png in ("dp_runtime_scaling", "dp_barrier_by_bucket",
                "pareto_proxies"):
        assert (tmp_path / f"{png}.png").stat().st_size > 0


@pytest.mark.slow
def test_dp_bucket_study_end_to_end(tmp_path):
    """The DP bucket study at world 4 (gloo), as a subprocess."""
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m",
         "dlnetbench_tpu_torch.examples.dp_bucket_study", "--platform",
         "cpu", "--out_dir", str(tmp_path), "--buckets", "2,4",
         "--devices", "4"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for png in ("runtime_by_bucket", "barrier_by_bucket", "pareto"):
        assert (tmp_path / f"{png}.png").stat().st_size > 0
    assert "mean per bucket count" in proc.stdout


@pytest.mark.slow
@pytest.mark.parametrize("mode", [[], ["--disagg"], ["--fleet"]],
                         ids=["mono", "disagg", "fleet"])
def test_serving_study_end_to_end(tmp_path, mode):
    """The whole serving study (each arm), as a subprocess: every point
    runs and the report writes serving_summary.csv."""
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "dlnetbench_tpu_torch.examples.pod_study",
         "--serving", *mode, "--platform", "cpu", "--devices", "2",
         "--out_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=3000, cwd=REPO)
    assert "serving study point(s) failed" not in proc.stderr, proc.stderr
    assert (tmp_path / "serving_summary.csv").stat().st_size > 0


@pytest.mark.slow
def test_fault_study_end_to_end(tmp_path):
    """The whole fault study at world 4 (gloo), as a subprocess: no point
    fails, the drop point is skipped with its note, and the goodput
    verdict is written."""
    import subprocess
    proc = subprocess.run(
        [sys.executable, "-m", "dlnetbench_tpu_torch.examples.pod_study",
         "--fault", "--platform", "cpu", "--devices", "4", "--out_dir",
         str(tmp_path)],
        capture_output=True, text=True, timeout=3000, cwd=REPO)
    assert "fault study point(s) failed" not in proc.stderr, proc.stderr
    assert "[fault 3/5] drop+retry: skipped" in proc.stdout
    assert (tmp_path / "goodput_verdict.json").stat().st_size > 0
