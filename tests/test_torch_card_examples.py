"""The DP bucket study on a CUDA card: ``dp_bucket_study --devices 1``
in this process (one NCCL rank, three bucket points), its records on
the card, its tables printed and each PNG written or, without
matplotlib (the card machine has none), named as skipped.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the study's CPU runs are held against the JAX package in
tests/test_torch_examples.py and tests/test_torch_examples_run.py."""
from __future__ import annotations

import json
import os

import pytest
import torch

from dlnetbench_tpu_torch.examples import dp_bucket_study


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the study's points run NCCL and "
                    "the burn's CUDA graphs (its CPU runs are tested "
                    "against JAX in tests/test_torch_examples_run.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dp_bucket_study_world1_on_card(cuda_device, tmp_path, capsys,
                                        monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
    assert dp_bucket_study.main(["--devices", "1",
                                 "--out_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mean per bucket count (us):" in out
    assert "effective bandwidth (comm-only allreduce schedule):" in out
    recs = [json.loads(line) for line in
            (tmp_path / "records.jsonl").read_text().splitlines()]
    assert [r["global"]["num_buckets"] for r in recs] == [2, 4, 8]
    for rec in recs:
        assert rec["mesh"]["platform"] == "gpu"
        assert rec["global"]["world_size"] == 1
        assert rec["global"]["variables"]["num_buckets"] == \
            str(rec["global"]["num_buckets"])
    for name in ("runtime_by_bucket", "barrier_by_bucket", "pareto"):
        png = tmp_path / f"{name}.png"
        assert png.exists() or f"skipped {png}" in out
