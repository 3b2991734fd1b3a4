"""The torch port's splash attention (kernels K6/K7/K8) held against the
JAX package's Pallas splash kernels on the same numpy inputs.

On the CPU the port's op runs its plain versions (K3-K5's formulas with
the row-interval mask, in q chunks over each chunk's key range); JAX
runs ``_splash_fwd`` / ``splash_attention(q, k, v, spec, 64, 64)`` in
interpret mode, as tests/test_flash_attention.py does, over its
MASK_SPECS — among them a segment mask whose documents (avg 50) are
shorter than a 64-row tile, so rows meet a fully masked first tile, and
the non-causal segment mask.  Bars: 2e-5 on the forward and lse, 5e-4 on
the gradients (tests/test_torch_flash_attention.py's), and JAX's own
1e-5 / 1e-4 against the dense-masked reference.  The cases that need a
card live in tests/test_torch_card_splash_attention.py, which imports no
jax and runs on the card with ``pytest --noconftest -m cuda``."""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.ops import attention_mask as JM
from dlnetbench_tpu_torch import ops as tops
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.ops import attention_mask as TM
from dlnetbench_tpu_torch.ops import flash_attention as TFA

JFA = importlib.import_module("dlnetbench_tpu.ops.flash_attention")

# tests/test_flash_attention.py MASK_SPECS: (causal, window, seg_avg,
# seg_seed)
MASK_SPECS = [(True, 40, 0, 0), (True, 0, 50, 3), (False, 0, 64, 1),
              (True, 32, 80, 5)]
# b, s, hq, hkv, dh: the JAX splash tests' shape, GQA group 4 with
# Dh=64 (test_splash_gqa_and_padded_head_dim), and one that only 128
# divides
SHAPES = [(2, 256, 4, 2, 128), (1, 256, 4, 1, 64), (1, 384, 2, 2, 128)]


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


def maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def tensors(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("spec", MASK_SPECS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_lse_match_jax_splash(spec, shape):
    q, k, v = qkv(0, *shape)
    t, j = TM.MaskSpec(*spec), JM.MaskSpec(*spec)
    want, want_lse = JFA._splash_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), j, block_q=64,
                                     block_k=64)
    got, lse = TFA.splash_forward(*tensors(q, k, v), t)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert maxdiff(got, want) < 2e-5
    # JAX stores lse replicated over 8 sublanes: [B, H, 8, S]
    assert maxdiff(lse, np.asarray(want_lse)[:, :, 0]) < 2e-5
    op = TFA.splash_attention(*tensors(q, k, v), t)
    assert torch.equal(op, got)


@pytest.mark.parametrize("spec", MASK_SPECS)
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_gradients_match_jax_splash(spec, shape):
    q, k, v = qkv(1, *shape)
    cot = np.random.default_rng(2).standard_normal(q.shape,
                                                   dtype=np.float32)
    t, j = TM.MaskSpec(*spec), JM.MaskSpec(*spec)
    _, vjp = jax.vjp(lambda *xs: JFA.splash_attention(*xs, j, 64, 64),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(cot))
    ts = tensors(q, k, v, grad=True)
    (TFA.splash_attention(*ts, t) * torch.from_numpy(cot)).sum().backward()
    for w, g in zip(want, ts):
        assert g.grad.shape == w.shape
        assert maxdiff(g.grad, w) < 5e-4


@pytest.mark.parametrize("spec", MASK_SPECS)
def test_matches_the_dense_masked_reference(spec):
    """The port's splash op against the port's dense-masked
    ``layers.attention`` at JAX's own bars (1e-5 forward, 1e-4 grads)."""
    q, k, v = qkv(8, 2, 256, 4, 2, 128)
    t = TM.MaskSpec(*spec)
    dense = torch.from_numpy(TM.dense_mask(t, 256))
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        q.shape, dtype=np.float32))
    a, b = tensors(q, k, v, grad=True), tensors(q, k, v, grad=True)
    want = TL.attention(*a, causal=t.causal, dense_mask=dense)
    got = TFA.splash_attention(*b, t)
    assert maxdiff(got.detach(), want.detach()) < 1e-5
    (want * cot).sum().backward()
    (got * cot).sum().backward()
    for x, y in zip(a, b):
        assert maxdiff(x.grad, y.grad) < 1e-4


def test_dense_masked_reference_matches_jax_layers():
    from dlnetbench_tpu.models import layers as JL
    q, k, v = qkv(6, 2, 64, 4, 2, 32)
    for spec in MASK_SPECS:
        j = JM.MaskSpec(*spec)
        m = JM.dense_mask(j, 64)
        want = JL.attention(*map(jnp.asarray, (q, k, v)), causal=j.causal,
                            dense_mask=jnp.asarray(m))
        got = TL.attention(*tensors(q, k, v), j.causal,
                           dense_mask=torch.from_numpy(m))
        assert maxdiff(got, want) < 2e-6


def test_plain_causal_spec_is_the_flash_op_bitwise():
    q, k, v = qkv(3, 2, 256, 4, 2, 128)
    spec = TM.MaskSpec(causal=True)
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        q.shape, dtype=np.float32))
    a, b = tensors(q, k, v, grad=True), tensors(q, k, v, grad=True)
    fa = TFA.flash_attention(*a, True)
    sp = TFA.splash_attention(*b, spec)
    assert torch.equal(fa, sp)
    (fa * cot).sum().backward()
    (sp * cot).sum().backward()
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("chunk", [64, 128, 384])
def test_chunking_changes_nothing_but_order(monkeypatch, chunk):
    """The plain versions walk q in chunks over each chunk's key range:
    a different chunk gives the same result within summation order, and
    ``plain_splash_rows`` of a q tile equals that tile of the whole."""
    q, k, v = tensors(*qkv(5, 1, 384, 2, 1, 64))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    spec = TM.MaskSpec(causal=True, window=40, seg_avg=50, seg_seed=3)
    o1, l1 = TFA.plain_splash_forward(q, k, v, spec)
    g1 = TFA.plain_splash_backward(q, k, v, o1, l1, do, spec)
    monkeypatch.setattr(TFA, "SPLASH_CHUNK", chunk)
    o2, l2 = TFA.plain_splash_forward(q, k, v, spec)
    g2 = TFA.plain_splash_backward(q, k, v, o1, l1, do, spec)
    assert maxdiff(o1, o2) < 1e-6 and maxdiff(l1, l2) < 1e-6
    for a, b in zip(g1, g2):
        assert maxdiff(a, b) < 1e-5
    ro, rl = TFA.plain_splash_rows(q, k, v, spec, 128, 192)
    assert maxdiff(ro, o1[:, 128:192]) < 1e-6
    assert maxdiff(rl, l1[:, :, 128:192]) < 1e-6


def test_plain_backward_reads_the_saved_lse():
    """The backward recomputes p from the saved lse (K7/K8's formulas),
    not autograd through a forward: a shifted lse scales dv."""
    q, k, v = tensors(*qkv(3, 1, 128, 2, 1, 64))
    spec = TM.MaskSpec(causal=True, window=16)
    out, lse = TFA.plain_splash_forward(q, k, v, spec)
    do = torch.ones_like(out)
    base = TFA.plain_splash_backward(q, k, v, out, lse, do, spec)
    shifted = TFA.plain_splash_backward(q, k, v, out, lse + np.log(2.0),
                                        do, spec)
    assert torch.allclose(shifted[2], base[2] / 2, atol=1e-6)


def test_dispatcher_routes_masks():
    """ops.attention (tests/test_flash_attention.py's dispatch case):
    auto runs splash and agrees with the dense-masked xla reference; the
    plain-causal spec is the mask=None path bitwise; a causal-flag
    mismatch raises; the CPU launches nothing."""
    q, k, v = tensors(*qkv(11, 1, 256, 2, 2, 128))
    spec = TM.MaskSpec(causal=True, window=32)
    before = (TFA.splash_fwd_launches, TFA.splash_dq_launches,
              TFA.splash_dkv_launches)
    a = tops.attention(q, k, v, causal=True, mask=spec)
    b = tops.attention(q, k, v, causal=True, impl="xla", mask=spec)
    assert maxdiff(a, b) < 1e-5
    assert torch.equal(a, TFA.splash_attention(q, k, v, spec))
    c = tops.attention(q, k, v, causal=True, mask=TM.MaskSpec(causal=True))
    assert torch.equal(c, tops.attention(q, k, v, causal=True))
    for impl in ("auto", "xla"):
        with pytest.raises(ValueError, match="causal"):
            tops.attention(q, k, v, causal=False, impl=impl, mask=spec)
    seg = TM.MaskSpec(causal=False, seg_avg=64, seg_seed=1)
    d = tops.attention(q, k, v, causal=False, mask=seg)
    e = tops.attention(q, k, v, causal=False, impl="xla", mask=seg)
    assert maxdiff(d, e) < 1e-5
    assert (TFA.splash_fwd_launches, TFA.splash_dq_launches,
            TFA.splash_dkv_launches) == before
    # a shape the kernels cannot take: the masked dense reference on the
    # CPU, as the unmasked path does
    q, k, v = tensors(*qkv(12, 1, 100, 2, 2, 64))
    got = tops.attention(q, k, v, causal=True, mask=spec)
    assert torch.equal(got, TL.attention(
        q, k, v, True, dense_mask=torch.from_numpy(TM.dense_mask(spec,
                                                                 100))))
    with pytest.raises(ValueError, match="unsupported shape"):
        TFA.splash_attention(q, k, v, spec)
    with pytest.raises(ValueError, match="MaskSpec"):
        TFA.splash_attention(q, k, v, None)


def test_auto_refuses_the_dense_fallback_at_64k_with_a_mask():
    s = 64 * 1024 + 1
    q = torch.zeros(1, s, 1, 8)
    with pytest.raises(ValueError, match="refuses the dense fallback"):
        tops.attention(q, q, q, causal=True,
                       mask=TM.MaskSpec(causal=True, window=64))


def test_kernel_wrappers_refuse_foreign_mask_arrays():
    """A packed BlockMask built for another S or another kernel's tiles
    is refused before a launch."""
    q, k, v = tensors(*qkv(13, 1, 256, 2, 2, 64))
    spec = TM.MaskSpec(causal=True, window=32)
    arr = TFA.splash_arrays(spec, 256, "dkv", q.device)
    with pytest.raises(ValueError, match="do not fit the fwd kernel"):
        TFA._arrays_for(q, spec, "fwd", arr)
    other = TFA.splash_arrays(spec, 128, "fwd", q.device)
    with pytest.raises(ValueError, match="do not fit"):
        TFA._arrays_for(q, spec, "fwd", other)
    assert TFA._arrays_for(q, spec, "dkv", arr) is arr
