"""Kernel K11 (the fused-quantization matmul) held against its plain
PyTorch version on a CUDA card: int8 bit-exact, e4m3 each row within
2^-6 of its max-abs and 1e-2 relative Frobenius, amax exact.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the plain version is held against the JAX package in
tests/test_torch_quantized_mlp.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import quantized_matmul as TQ

FMTS = ["int8", "float8"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (their plain versions are tested against JAX "
                    "in tests/test_torch_quantized_mlp.py)")
    return torch.device("cuda")


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def rel_fro(got, want) -> float:
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-9))


def check(fmt, y, ref):
    if fmt == "int8":
        assert torch.equal(y, ref)
    else:
        err = (y.float() - ref.float()).abs().amax(dim=-1)
        assert (err <= 2.0 ** -6 * ref.float().abs().amax(dim=-1)).all()
        assert rel_fro(y, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("collect", [False, True])
def test_fused_kernel_matches_plain_on_card(cuda_device, fmt, dtype,
                                            collect):
    """K11 against its plain version: int8 bit-exact, e4m3 each row
    within 2^-6 of its max-abs and 1e-2 Frobenius, amax exact — as
    chip_smoke.py holds it at the train shape."""
    x = torch.from_numpy(arr(21, (256, 192))).to(cuda_device, dtype)
    w = torch.from_numpy(arr(22, (192, 512), 0.1)).to(cuda_device, dtype)
    wq, sw = TQ.quantize_tensor(w, fmt)
    sx = TQ.scale_from_amax(TQ.amax_of(x), fmt)
    y, am = TQ.kernel_fused_matmul(x, TQ.k_major(wq), sw, sx, fmt, collect)
    torch.cuda.synchronize()
    ref, ram = TQ.plain_fused_matmul(x, wq, sw, sx, fmt, collect)
    check(fmt, y, ref)
    if collect:
        assert torch.equal(am, ram)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(128, 64, 256), (384, 128, 768),
                                   (256, 1088, 512), (256, 320, 1024)])
def test_fused_kernel_tiles_on_card(cuda_device, fmt, dtype, m, k, n):
    """The smallest launch (one output tile, one contraction stage: the
    quantized A tile's shared-memory layout alone decides the result),
    N / 256 = 3, 2 and 4 (clusters of 1, 2 and 4 blocks), contractions
    whose last stage is half full; with amax."""
    x = torch.from_numpy(arr(23, (m, k))).to(cuda_device, dtype)
    w = torch.from_numpy(arr(24, (k, n), k ** -0.5)).to(cuda_device, dtype)
    wq, sw = TQ.quantize_tensor(w, fmt)
    sx = TQ.scale_from_amax(TQ.amax_of(x), fmt)
    y, am = TQ.kernel_fused_matmul(x, TQ.k_major(wq), sw, sx, fmt, True)
    torch.cuda.synchronize()
    ref, ram = TQ.plain_fused_matmul(x, wq, sw, sx, fmt, True)
    check(fmt, y, ref)
    assert torch.equal(am, ram)


@pytest.mark.cuda
def test_fused_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.zeros(200, 128, device=cuda_device, dtype=torch.bfloat16)
    wq, sw = TQ.quantize_tensor(torch.ones(128, 128, device=cuda_device),
                                "int8")
    sx = torch.ones((), device=cuda_device)
    with pytest.raises(ValueError, match="multiples"):
        TQ.kernel_fused_matmul(x, TQ.k_major(wq), sw, sx, "int8", False)
    with pytest.raises(ValueError, match="dtype"):
        TQ.kernel_fused_matmul(x[:128].half(), TQ.k_major(wq), sw, sx,
                               "int8", False)
