"""Kernels K9 (SwiGLU backward dg, du) and K10 (dWd) held against their
plain PyTorch versions on a CUDA card.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the plain versions are held against the JAX package in
tests/test_torch_mlp_backward.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import mlp_backward as TMB


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (their plain versions are tested against JAX "
                    "in tests/test_torch_mlp_backward.py)")
    return torch.device("cuda")


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def operands(dev, t, d, f):
    bf = torch.bfloat16
    dy = torch.from_numpy(arr(5, (t, d), 0.1)).to(dev, bf)
    wd = torch.from_numpy(arr(6, (f, d), f ** -0.5)).to(dev, bf)
    g = torch.from_numpy(arr(7, (t, f))).to(dev, bf)
    u = torch.from_numpy(arr(8, (t, f))).to(dev, bf)
    return dy, wd, g, u


def assert_rows_close(got, want, tol):
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    assert (err <= tol * scale.clamp_min(1e-3 * scale.max())).all()


# (t, d, f): the first two shapes of the first kernels; an odd row-tile
# count of K9 (T 384: 3 tiles, the last paired with a zeroed one; K10's
# odd count, F 384, is in the T cases below); more units than the
# card's clusters (K9 16 x 16 units, K10 16 x 2 at a cluster of 4)
@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f", [(256, 256, 256), (384, 512, 512),
                                   (384, 256, 768), (4096, 2048, 4096)])
def test_kernels_match_plain_on_card(cuda_device, t, d, f):
    """K9: dg, du each row within 2^-6 of its max-abs (bf16 outputs);
    K10: dWd each row within 1e-3 of its max-abs (f32 sums in another
    order), as chip_smoke.py holds them at the train shape."""
    dy, wd, g, u = operands(cuda_device, t, d, f)
    got = (*TMB.kernel_dgdu(dy, wd, g, u), TMB.kernel_dwd(g, u, dy))
    torch.cuda.synchronize()
    want = (*TMB.plain_dgdu(dy, wd, g, u), TMB.plain_dwd(g, u, dy))
    for a, b, tol in zip(got, want, (2.0 ** -6, 2.0 ** -6, 1e-3)):
        assert_rows_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [32, 96, 160])
def test_dwd_takes_t_past_whole_stages(cuda_device, t):
    """K10's contract is T % 32: a last 64-row stage only partly inside T
    is zero-filled by TMA (zero g and u give zero h).  F 384 is an odd
    count of row tiles: the last pairs with a zeroed tile."""
    dy, _, g, u = operands(cuda_device, t, 256, 384)
    got = TMB.kernel_dwd(g, u, dy)
    torch.cuda.synchronize()
    assert_rows_close(got, TMB.plain_dwd(g, u, dy), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", TMB.DWD_CLUSTERS)
def test_dwd_under_each_cluster_size(cuda_device, cluster):
    """Each cluster size K10 is built for (blocks along D sharing one h
    stage): D 1024 is 4 column tiles, so every size runs as asked."""
    dy, _, g, u = operands(cuda_device, 320, 1024, 512)
    prev = TMB.set_dwd_cluster(cluster)
    try:
        got = TMB.kernel_dwd(g, u, dy)
        torch.cuda.synchronize()
    finally:
        TMB.set_dwd_cluster(prev)
    assert_rows_close(got, TMB.plain_dwd(g, u, dy), 1e-3)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_take(cuda_device):
    z = torch.zeros(200, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples"):
        TMB.kernel_dgdu(z, torch.zeros(256, 128, device=cuda_device,
                                       dtype=torch.bfloat16),
                        torch.zeros(200, 256, device=cuda_device,
                                    dtype=torch.bfloat16),
                        torch.zeros(200, 256, device=cuda_device,
                                    dtype=torch.bfloat16))
