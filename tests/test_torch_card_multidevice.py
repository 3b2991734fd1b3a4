"""Kernels K11 (int8 and e4m3) and K12 (bf16) launched on two cards in
one process: first on cuda:0, then on cuda:1, each held against its
plain PyTorch version at ``chip_smoke.py``'s bars (int8 bit-exact, the
rest every row within 2^-6 of its max-abs).  A kernel that raises its
dynamic shared-memory cap (or caches what it asks of a device) once a
process, not once a device, launches on the first card and fails on
the second.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``two_cards`` fixture, which skips where no card is visible
(through ``cuda_device``) and below two cards; the plain versions are
held against the JAX package in tests/test_torch_quantized_mlp.py and
tests/test_torch_grouped_matmul.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import grouped_matmul as TG
from dlnetbench_tpu_torch.ops import quantized_matmul as TQ

ROW_TOL = 2.0 ** -6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (their plain versions are tested against JAX "
                    "in tests/test_torch_quantized_mlp.py and "
                    "tests/test_torch_grouped_matmul.py)")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the case launches on cuda:0 and "
                    "then on cuda:1 in one process")
    return [cuda_device, torch.device("cuda", 1)]


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def check(fmt, y, ref):
    assert torch.isfinite(y.float()).all()
    if fmt == "int8":
        assert torch.equal(y, ref)
    else:
        err = (y.float() - ref.float()).abs().amax(dim=-1)
        scale = ref.float().abs().amax(dim=-1).clamp_min(1e-6)
        assert float((err / scale).max()) <= ROW_TOL


def k11(dev, fmt):
    # N / 256 = 4: the same cluster-of-4 instance on both cards
    x = torch.from_numpy(arr(31, (256, 320))).to(dev, torch.bfloat16)
    w = torch.from_numpy(arr(32, (320, 1024), 320 ** -0.5)).to(
        dev, torch.bfloat16)
    wq, sw = TQ.quantize_tensor(w, fmt)
    sx = TQ.scale_from_amax(TQ.amax_of(x), fmt)
    y, _ = TQ.kernel_fused_matmul(x, TQ.k_major(wq), sw, sx, fmt, False)
    torch.cuda.synchronize(dev)
    ref, _ = TQ.plain_fused_matmul(x, wq, sw, sx, fmt, False)
    check(fmt, y, ref)


def k12(dev, fmt):
    counts = [200, 0, 1, 100]
    x = torch.from_numpy(arr(33, (4, 200, 256))).to(dev, torch.bfloat16)
    w = torch.from_numpy(arr(34, (4, 256, 512), 256 ** -0.5)).to(
        dev, torch.bfloat16)
    counts = torch.tensor(counts, dtype=torch.int32, device=dev)
    before = TG.grouped_launches
    y = TG.grouped_matmul(x, w, counts=counts)
    torch.cuda.synchronize(dev)
    assert TG.grouped_launches == before + 1
    ref = TG.plain_grouped_matmul(x, w, counts, None, None, None)
    check(fmt, y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,fmt", [(k11, "int8"), (k11, "float8"),
                                        (k12, None)],
                         ids=["K11-int8", "K11-e4m3", "K12-bf16"])
def test_kernel_launches_on_a_second_card(two_cards, kernel, fmt):
    """The launch on cuda:1 after one on cuda:0 runs and agrees with the
    plain version as the first did."""
    for dev in two_cards:
        kernel(dev, fmt)
