"""Kernels K1 (paged decode attention over bf16 / f32 pages) and K2 (over
int8 / e4m3 pages) held against their plain PyTorch versions on a CUDA
card.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the plain versions are held against the JAX package in
tests/test_torch_paged_attention.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import paged_attention as PA
from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ

FMT = {"int8": "int8", "fp8": "float8"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only "
                    "there (their plain versions are tested against JAX "
                    "in tests/test_torch_paged_attention.py)")
    return torch.device("cuda")


def decode_inputs(seed: int, *, b=2, hq=4, hkv=2, dh=8, pages=16,
                  psize=4, pmax=6, lengths=(5, 17)):
    """Seeded numpy decode-attention operands."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, dh), np.float32) * dh ** -0.5
    kp = rng.standard_normal((hkv, pages, psize, dh), np.float32)
    vp = rng.standard_normal((hkv, pages, psize, dh), np.float32)
    bt = rng.permutation(pages)[:b * pmax].reshape(b, pmax).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), bt


def quantize_pools(kp, vp, fmt):
    """Per-page, per-head symmetric quantization of f32 pools: int8
    rounds half to even, then clips; e4m3 clips, then converts."""
    out = []
    for p in (kp, vp):
        amax = np.abs(p).max(axis=(2, 3))
        scale = (np.maximum(amax, 1e-12) / (127.0 if fmt == "int8"
                                            else 448.0)).astype(np.float32)
        x = p / scale[:, :, None, None]
        if fmt == "int8":
            q = torch.from_numpy(np.clip(np.round(x), -127, 127).astype(
                np.int8))
        else:
            q = torch.from_numpy(np.clip(x, -448, 448).astype(
                np.float32)).to(torch.float8_e4m3fn)
        out += [q, torch.from_numpy(scale)]
    return out   # kq, ks, vq, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_plain_on_card(cuda_device, dtype):
    q, kp, vp, ln, bt = decode_inputs(6, b=4, hq=8, hkv=2, dh=64,
                                      pages=64, psize=16, pmax=8,
                                      lengths=(1, 17, 100, 128))
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (q, kp, vp)]
    args += [torch.from_numpy(ln).to(cuda_device),
             torch.from_numpy(bt).to(cuda_device)]
    before = PA.launches
    got = PA.paged_attention(*args)
    torch.cuda.synchronize()
    assert PA.launches == before + 1
    ref = PA.gather_attention(*args)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
def test_k2_kernel_matches_plain_on_card(cuda_device, cache_dtype):
    q, kp, vp, ln, bt = decode_inputs(7, b=4, hq=8, hkv=2, dh=64,
                                      pages=64, psize=16, pmax=8,
                                      lengths=(1, 17, 100, 128))
    kq, ks, vq, vs = quantize_pools(kp, vp, cache_dtype)
    args = [a.to(cuda_device) for a in (
        torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(ln),
        torch.from_numpy(bt))]
    before = PAQ.launches
    got = PAQ.quant_paged_attention(*args, fmt=FMT[cache_dtype])
    torch.cuda.synchronize()
    assert PAQ.launches == before + 1
    ref = PAQ.dequant_gather_attention(*args)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take(cuda_device):
    q, kp, vp, ln, bt = (torch.from_numpy(a).to(cuda_device)
                         for a in decode_inputs(8, dh=32))
    with pytest.raises(ValueError, match="int32"):
        PA.paged_attention(q, kp, vp, ln.long(), bt)
    with pytest.raises(ValueError, match="page dtype"):
        PA.paged_attention(q, kp.bfloat16(), vp.bfloat16(), ln, bt)
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_attention(q, kp.transpose(1, 2), vp.transpose(1, 2), ln,
                           bt)
