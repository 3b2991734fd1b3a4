"""The record pipeline on a CUDA card: a world-1 ``cli dp`` record is
stamped with an attribution block in the port's vocabulary, and the
bench's ``--check`` sentinel trips on a halved baseline.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the pipeline is held against the JAX package on the CPU in
tests/test_torch_records.py, tests/test_torch_attribution.py and
tests/test_torch_sentinel.py."""
from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from dlnetbench_tpu_torch import bench, cli
from dlnetbench_tpu_torch.analysis import attribution
from dlnetbench_tpu_torch.metrics.merge import merge_records
from dlnetbench_tpu_torch.metrics.parser import load_records, validate_record

# the bench step at a small shape (the ``DLNB_BENCH_*`` knobs, which
# bench_step reads at import): the sentinel's plumbing, not its speed
SMALL_BENCH = {"SEQ": 512, "LAYERS": 2, "VOCAB": 4096, "EMBED": 1024,
               "FF": 2048, "HEADS": 8, "KV_HEADS": 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's preset prices only card "
                    "records (the CPU path is tested against JAX in "
                    "tests/test_torch_attribution.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_world1_dp_record_carries_a_card_verdict(cuda_device, tmp_path):
    out = tmp_path / "dp.jsonl"
    assert cli.main(["dp", "--model", "gpt2_l_16_bfloat16", "--num_buckets",
                     "4", "--size_scale", "1e-5", "--time_scale", "2e-3",
                     "-w", "1", "-r", "3", "--buffer_dtype", "bfloat16",
                     "--no_topology", "--out", str(out)]) == 0
    [rec] = load_records(out)
    validate_record(rec)
    attr = rec["global"]["attribution"]
    assert attr["bound"] in ("sm", "host")
    assert abs(sum(attr["fractions"].values()) - 1.0) <= 1e-3
    assert attr["inputs"]["compute_basis"] == "measured"
    assert attr["inputs"]["transport"] == "local"
    assert "comm" not in (attr.get("achieved") or {})
    assert rec["mesh"]["platform"] == "gpu" and rec["mesh"]["gathered"]
    # a gathered record merges to itself
    assert merge_records([rec]) == rec
    # and the explain report renders it in the port's words
    text = io.StringIO()
    assert attribution.explain(out, out=text) == 0
    assert f"bound: {attr['bound'].upper()}" in text.getvalue()


def _bench(monkeypatch, *argv) -> tuple[int, dict]:
    from dlnetbench_tpu_torch.models import bench_step
    for k, v in SMALL_BENCH.items():
        monkeypatch.setattr(bench_step, k, v)
    monkeypatch.setenv("DLNB_BENCH_K", "2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--skip-aux", *argv])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
def test_bench_check_trips_on_a_halved_baseline(cuda_device, monkeypatch,
                                                tmp_path):
    rc, line = _bench(monkeypatch)
    assert rc == 0 and line["attribution"]["inputs"]["hw"].startswith(
        "NVIDIA H100")
    base = {**line, "value": line["value"] / 2,
            "band": [v / 2 for v in line["band"]]}
    path = tmp_path / "halved.jsonl"
    path.write_text(json.dumps(base) + "\n")
    rc, checked = _bench(monkeypatch, "--check", str(path))
    assert rc == 3
    assert checked["sentinel"]["verdict"] == "regression"
    assert "headline" in checked["sentinel"]["regressions"]
