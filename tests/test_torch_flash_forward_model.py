"""A numpy model of kernel K3's tile loop (``fwd_bf16`` in
``dlnetbench_tpu_torch/ops/csrc/flash_attention.cu``; K6 is its splash
mode), held against the port's plain versions and against the JAX
package's Pallas forward kernel.

The model walks what one consumer warpgroup walks: a 64-row q tile of
one q head, the 128-key tiles of its visit range in order (the causal
triangle, all of them, or the BlockMask's range at ``FWD_TILES``), with
the kernel's rounding points: q * scale * log2(e) rounded to the input
type once, s = q k^T in f32, the causal mask on a tile the diagonal
crosses or the row intervals on a tile the mask marks partial, the
base-2 online softmax with f32 m, l and O, p rounded to the input type
before p . v, and O / l rounded at the end, lse = (m + log2 l) ln 2.

* bf16 inputs: against ``plain_forward`` / ``plain_splash_forward``
  (whole-row softmax, p rounded against the row's final max) at the
  card's bars, every O row within 2^-6 of its max-abs and lse within
  1e-3; under the plain-causal mask the splash model is the causal one
  bitwise, as K6 is K3.
* f32 inputs (the rounding points are then exact): against JAX's
  ``_fwd`` (``_fwd_kernel`` through ``pallas_call``, in interpret mode
  on the CPU as the JAX package's own tests run it) at the 2e-5 of
  tests/test_torch_flash_attention.py.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import attention_mask as TM
from dlnetbench_tpu_torch.ops import flash_attention as TFA

JFA = importlib.import_module("dlnetbench_tpu.ops.flash_attention")
BQ, BK = TFA.FWD_TILES

CASES = [
    # b, s, hq, hkv, dh, causal (tests/test_flash_attention.py CASES)
    (1, 256, 2, 2, 128, True),
    (2, 256, 4, 2, 128, True),
    (1, 256, 4, 1, 64, True),
    (1, 256, 2, 2, 128, False),
    (1, 384, 2, 2, 128, True),
]
SPECS = [TM.MaskSpec(window=40), TM.MaskSpec(seg_avg=50, seg_seed=3),
         TM.MaskSpec(causal=False, seg_avg=64, seg_seed=1),
         TM.MaskSpec(window=32, seg_avg=80, seg_seed=5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(seed, b, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))]


def bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def model_forward(q, k, v, mask, rounded: bool):
    """``(O, lse)`` by K3's tile loop; ``mask`` is True (causal), False
    (dense) or a MaskSpec.  ``rounded``: bf16 rounding points (the bf16
    kernel), else exact (the f32 rounding points are no-ops)."""
    rnd = bf16 if rounded else (lambda x: np.asarray(x, np.float32))
    b, s, hq, dh = q.shape
    g = hq // k.shape[2]
    nq = s // BQ
    if isinstance(mask, TM.MaskSpec):
        bm = TM.block_mask(mask, s, BQ, BK)
        ranges = [(int(bm.q_first_k[t]), int(bm.q_last_k[t]) + 1)
                  for t in range(nq)]
    elif mask:
        ranges = [(0, (t * BQ + BQ - 1) // BK + 1) for t in range(nq)]
    else:
        ranges = [(0, s // BK)] * nq
    out = np.zeros_like(q)
    lse = np.zeros((b, hq, s), np.float32)
    mul = np.float32(dh ** -0.5 * TFA.LOG2E)
    for bi, h, t in np.ndindex(b, hq, nq):
        q0 = t * BQ
        rows = np.arange(q0, q0 + BQ)
        qs = rnd(q[bi, q0:q0 + BQ, h] * mul)
        m = np.full(BQ, TFA.NEG_INF, np.float32)
        l = np.zeros(BQ, np.float32)
        acc = np.zeros((BQ, dh), np.float32)
        for j in range(*ranges[t]):
            c0 = j * BK
            cols = np.arange(c0, c0 + BK)
            kt = k[bi, c0:c0 + BK, h // g]
            sc = (qs @ kt.T).astype(np.float32)
            if isinstance(mask, TM.MaskSpec):
                if not (bm.blk_lo_max[t] <= c0
                        and bm.blk_hi_min[t] >= c0 + BK - 1):
                    keep = ((cols[None, :] >= bm.lo[rows, None])
                            & (cols[None, :] <= bm.hi[rows, None]))
                    sc = np.where(keep, sc, np.float32(TFA.NEG_INF))
            elif mask and c0 + BK - 1 > q0:
                sc = np.where(cols[None, :] > rows[:, None],
                              np.float32(TFA.NEG_INF), sc)
            m_new = np.maximum(m, sc.max(axis=1))
            alpha = np.exp2(m - m_new)
            p = np.exp2(sc - m_new[:, None])
            l = l * alpha + p.sum(axis=1)
            acc = acc * alpha[:, None] + rnd(p) @ v[bi, c0:c0 + BK, h // g]
            m = m_new
        out[bi, q0:q0 + BQ, h] = rnd(acc / l[:, None])
        lse[bi, h, q0:q0 + BQ] = (m + np.log2(l)) / TFA.LOG2E
    return out, lse


def row_err(a, r) -> float:
    """Worst row's max abs error over the row's max-abs (floored at 1e-3
    of the tensor's), as chip_smoke.py holds the kernels."""
    err = np.abs(a - r).max(axis=-1)
    scale = np.abs(r).max(axis=-1)
    return float((err / np.maximum(scale, 1e-3 * scale.max())).max())


def as_bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", CASES)
def test_model_matches_plain_forward_in_bf16(b, s, hq, hkv, dh, causal):
    q, k, v = (bf16(x) for x in qkv(0, b, s, hq, hkv, dh))
    got, got_lse = model_forward(q, k, v, causal, rounded=True)
    want, want_lse = TFA.plain_forward(*as_bf16(q, k, v), causal)
    assert row_err(got, want.float().numpy()) <= 2.0 ** -6
    assert np.abs(got_lse - want_lse.numpy()).max() <= 1e-3


@pytest.mark.parametrize("spec", SPECS, ids=lambda t: t.label())
def test_model_matches_plain_splash_forward_in_bf16(spec):
    q, k, v = (bf16(x) for x in qkv(1, 2, 384, 4, 2, 128))
    got, got_lse = model_forward(q, k, v, spec, rounded=True)
    want, want_lse = TFA.plain_splash_forward(*as_bf16(q, k, v), spec)
    assert row_err(got, want.float().numpy()) <= 2.0 ** -6
    assert np.abs(got_lse - want_lse.numpy()).max() <= 1e-3


def test_model_splash_under_plain_causal_is_the_causal_model_bitwise():
    q, k, v = (bf16(x) for x in qkv(2, 1, 384, 3, 1, 64))
    a = model_forward(q, k, v, True, rounded=True)
    c = model_forward(q, k, v, TM.MaskSpec(causal=True), rounded=True)
    assert all(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", CASES)
def test_model_matches_jax_forward_kernel_in_f32(b, s, hq, hkv, dh,
                                                 causal):
    q, k, v = qkv(3, b, s, hq, hkv, dh)
    got, got_lse = model_forward(q, k, v, causal, rounded=False)
    want, want_lse = JFA._fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, block_q=128,
                              block_k=128)
    assert np.abs(got - np.asarray(want)).max() < 2e-5
    # JAX stores lse replicated over 8 sublanes: [B, H, 8, S]
    assert np.abs(got_lse - np.asarray(want_lse)[:, :, 0]).max() < 2e-5
