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


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f", [(256, 256, 256), (384, 512, 512)])
def test_kernels_match_plain_on_card(cuda_device, t, d, f):
    """K9: dg, du each row within 2^-6 of its max-abs (bf16 outputs);
    K10: dWd each row within 1e-3 of its max-abs (f32 sums in another
    order), as chip_smoke.py holds them at the train shape."""
    dev, bf = cuda_device, torch.bfloat16
    dy = torch.from_numpy(arr(5, (t, d), 0.1)).to(dev, bf)
    wd = torch.from_numpy(arr(6, (f, d), f ** -0.5)).to(dev, bf)
    g = torch.from_numpy(arr(7, (t, f))).to(dev, bf)
    u = torch.from_numpy(arr(8, (t, f))).to(dev, bf)
    got = (*TMB.kernel_dgdu(dy, wd, g, u), TMB.kernel_dwd(g, u, dy))
    torch.cuda.synchronize()
    want = (*TMB.plain_dgdu(dy, wd, g, u), TMB.plain_dwd(g, u, dy))
    for a, b, tol in zip(got, want, (2.0 ** -6, 2.0 ** -6, 1e-3)):
        err = (a.float() - b.float()).abs().amax(dim=-1)
        scale = b.float().abs().amax(dim=-1)
        assert (err <= tol * scale.clamp_min(1e-3 * scale.max())).all()


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
