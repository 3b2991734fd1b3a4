"""Kernel K12 (the grouped expert matmul) held against its plain PyTorch
version on a CUDA card: every row at or past an expert's count zero,
int8 bit-exact, bf16 and e4m3 each row within 2^-6 of its max-abs.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the plain version is held against the JAX package in
tests/test_torch_grouped_matmul.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import grouped_matmul as TG
from dlnetbench_tpu_torch.ops import quantized_matmul as TQ


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the Hopper kernel K12 runs only there "
                    "(its plain version is tested against JAX in "
                    "tests/test_torch_grouped_matmul.py)")
    return torch.device("cuda")


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def run_case(dev, fmt, dtype, c, k, n, counts):
    e = len(counts)
    x = torch.from_numpy(arr(5, (e, c, k))).to(dev, dtype)
    w = torch.from_numpy(arr(6, (e, k, n), k ** -0.5)).to(dev, dtype)
    sx = sw = None
    if fmt:
        w, sw = TG.quantize_experts(w, fmt)
        sx = TQ.scale_from_amax(TG.expert_amax(x), fmt)
    counts = torch.tensor(counts, dtype=torch.int32, device=dev)
    before = TG.grouped_launches
    got = TG.grouped_matmul(x, w, counts=counts, sx=sx, sw=sw, fmt=fmt)
    torch.cuda.synchronize()
    assert TG.grouped_launches == before + 1
    ref = TG.plain_grouped_matmul(x, w, counts, sx, sw, fmt)
    for i, cnt in enumerate(counts.tolist()):
        assert not got[i, cnt:].any()
    if fmt == "int8":
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().amax(-1)
        scale = ref.float().abs().amax(-1).clamp_min(1e-6)
        assert float((err / scale).max()) <= 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (None, torch.bfloat16, 200, 256, 512), (None, torch.float32, 37, 48, 40),
    ("int8", torch.bfloat16, 130, 128, 256),
    ("float8", torch.bfloat16, 130, 128, 256)])
def test_kernel_matches_plain_on_card(cuda_device, case):
    fmt, dtype, c, k, n = case
    run_case(cuda_device, fmt, dtype, c, k, n, [c, 0, 1, c // 2])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, "int8", "float8"])
def test_kernel_skewed_counts_on_card(cuda_device, fmt):
    """Eight experts of 300 slots under skewed counts (full, empty, a
    row tile's edge, ragged tails), several column tiles and a half
    last contraction stage: the persistent schedule visits every live
    tile once and writes zeros on every dead row."""
    run_case(cuda_device, fmt, torch.bfloat16, 300, 320, 768,
             [300, 0, 128, 17, 256, 129, 1, 255])


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros(2, 64, 100, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(2, 100, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of"):
        TG.grouped_matmul(x, w)
