"""Kernels K6/K7/K8 (splash attention: K3-K5 under a BlockMask) held
against their plain PyTorch versions on a CUDA card, and bitwise equal
to K3/K4/K5 under the plain causal mask.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the plain versions are held against the JAX package in
tests/test_torch_splash_attention.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import attention_mask as TM
from dlnetbench_tpu_torch.ops import flash_attention as TFA

# tests/test_flash_attention.py MASK_SPECS: (causal, window, seg_avg,
# seg_seed)
MASK_SPECS = [(True, 40, 0, 0), (True, 0, 50, 3), (False, 0, 64, 1),
              (True, 32, 80, 5)]
# b, s, hq, hkv, dh: the JAX splash tests' shape, GQA group 4 with
# Dh=64, and one that only 128 divides
SHAPES = [(2, 256, 4, 2, 128), (1, 256, 4, 1, 64), (1, 384, 2, 2, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (their plain versions are tested against JAX "
                    "in tests/test_torch_splash_attention.py)")
    return torch.device("cuda")


def qkv(seed, b, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", MASK_SPECS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(cuda_device, dtype, spec, shape):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in qkv(9, *shape))
    do = torch.randn_like(q)
    t = TM.MaskSpec(*spec)
    out, lse = TFA.kernel_splash_forward(q, k, v, t)
    grads = TFA.kernel_splash_backward(q, k, v, out, lse, do, t)
    torch.cuda.synchronize()
    p_out, p_lse = TFA.plain_splash_forward(q, k, v, t)
    p_grads = TFA.plain_splash_backward(q, k, v, out, lse, do, t)
    # bf16: one output ulp; f32: a row of dq that cancels to ~0 (its
    # interval's first key only) keeps f32 rounding of its terms against
    # its 1e-3 floor (chip_smoke.py's f32 splash check reads up to 7.7e-4
    # on an H100, for K4 and K7 alike)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 4e-3
    assert float((lse - p_lse).abs().max()) < 1e-3
    for g, p in zip((out, *grads), (p_out, *p_grads)):
        err = (g.float() - p.float()).abs().amax(dim=-1)
        scale = p.float().abs().amax(dim=-1)
        assert (err <= tol * scale.clamp_min(1e-3 * scale.max())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_causal_kernels_equal_flash_kernels_on_card(cuda_device,
                                                          dtype):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in qkv(10, 2, 512, 4, 2, 128))
    do = torch.randn_like(q)
    spec = TM.MaskSpec(causal=True)
    out, lse = TFA.kernel_forward(q, k, v, True)
    s_out, s_lse = TFA.kernel_splash_forward(q, k, v, spec)
    assert torch.equal(out, s_out) and torch.equal(lse, s_lse)
    for a, b in zip(TFA.kernel_backward(q, k, v, out, lse, do, True),
                    TFA.kernel_splash_backward(q, k, v, out, lse, do,
                                               spec)):
        assert torch.equal(a, b)
