"""Kernels K3/K4/K5 (flash attention forward, dq, dk/dv) held against
their plain PyTorch versions on a CUDA card.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the plain versions are held against the JAX package in
tests/test_torch_flash_attention.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import flash_attention as TFA

CASES = [
    # b, s, hq, hkv, dh, causal (tests/test_flash_attention.py CASES)
    (1, 256, 2, 2, 128, True),    # MHA
    (2, 256, 4, 2, 128, True),    # GQA group 2
    (1, 256, 4, 1, 64, True),     # MQA, gpt2-style head dim 64
    (1, 256, 2, 2, 128, False),   # non-causal
    (1, 384, 2, 2, 128, True),    # seq that only 128 divides
    # S = 640: ten 64-row q tiles, five 128-key tiles (not a power of
    # two); GQA groups 1, 2 and 4 at Dh 128 and 64, and an odd group (3),
    # whose K4 block pairs two q heads of neighbouring q tiles
    (1, 640, 2, 2, 128, True),
    (1, 640, 4, 2, 128, True),
    (1, 640, 8, 2, 128, True),
    (1, 640, 2, 2, 64, True),
    (1, 640, 4, 2, 64, False),
    (1, 640, 8, 2, 64, True),
    (1, 640, 6, 2, 128, True),
    # S = 128: one pair of 64-row q tiles; GQA groups 1, 2 and 4 (K3's
    # block pairs the two q tiles of one head when the group is 1)
    (1, 128, 2, 2, 128, True),
    (2, 128, 4, 2, 128, True),
    (1, 128, 8, 2, 64, True),
    (1, 128, 4, 1, 128, False),
    (2, 128, 2, 2, 64, False),
]
# each row (Dh values) against its own max-abs, floored at 1e-3 of the
# tensor's, as chip_smoke.py holds it.  bf16: one output ulp.  f32: a
# dq row that cancels to ~0 (only its interval's first key) keeps the
# f32 rounding of its terms against that floor; an H100 80GB HBM3 read
# 2.3e-4 for K4 and 7.7e-4 for K7 (the splash dq, the same loop), so
# the bar is the f32 splash case's 4e-3
TOL_ROW = {torch.bfloat16: 2.0 ** -6, torch.float32: 4e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (their plain versions are tested against JAX "
                    "in tests/test_torch_flash_attention.py)")
    return torch.device("cuda")


def qkv(seed, b, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", CASES)
def test_kernels_match_plain_on_card(cuda_device, dtype, b, s, hq, hkv,
                                     dh, causal):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in qkv(9, b, s, hq, hkv, dh))
    do = torch.randn_like(q)
    out, lse = TFA.kernel_forward(q, k, v, causal)
    grads = TFA.kernel_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    p_out, p_lse = TFA.plain_forward(q, k, v, causal)
    p_grads = TFA.plain_backward(q, k, v, out, lse, do, causal)
    tol = TOL_ROW[dtype]
    assert float((lse - p_lse).abs().max()) < 1e-3
    for g, p in zip((out, *grads), (p_out, *p_grads)):
        err = (g.float() - p.float()).abs().amax(dim=-1)
        scale = p.float().abs().amax(dim=-1)
        assert (err <= tol * scale.clamp_min(1e-3 * scale.max())).all()


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take(cuda_device):
    q = torch.zeros(2, 256, 2, 128, device=cuda_device,
                    dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        TFA.kernel_forward(q.transpose(0, 1).contiguous().transpose(0, 1),
                           q, q, True)
    with pytest.raises(ValueError, match="dtype"):
        TFA.kernel_forward(q.half(), q.half(), q.half(), True)
    with pytest.raises(ValueError, match="unsupported shape"):
        TFA.kernel_forward(q[:, :200], q[:, :200], q[:, :200], True)
