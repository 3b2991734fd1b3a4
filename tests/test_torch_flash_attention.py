"""The torch port's flash attention (kernels K3/K4/K5) held against the
JAX package's Pallas flash kernels on the same numpy inputs.

On the CPU the port's op runs its plain versions (the forward's base-2
softmax and the backward's recomputation formulas); JAX runs
``flash_attention(q, k, v, causal, 128, 128)`` in interpret mode, as
tests/test_flash_attention.py does.  The bars are that file's: 2e-5 on
the forward (and here on lse), 5e-4 on the gradients.  The cases that
need a card live in tests/test_torch_card_flash_attention.py, which
imports no jax and runs on the card with ``pytest --noconftest -m
cuda``."""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch import ops as tops
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.ops import flash_attention as TFA

JFA = importlib.import_module("dlnetbench_tpu.ops.flash_attention")

CASES = [
    # b, s, hq, hkv, dh, causal (tests/test_flash_attention.py CASES)
    (1, 256, 2, 2, 128, True),    # MHA
    (2, 256, 4, 2, 128, True),    # GQA group 2
    (1, 256, 4, 1, 64, True),     # MQA, gpt2-style head dim 64
    (1, 256, 2, 2, 128, False),   # non-causal
    (1, 384, 2, 2, 128, True),    # seq that only 128 divides
]


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


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", CASES)
def test_forward_and_lse_match_jax_flash(b, s, hq, hkv, dh, causal):
    q, k, v = qkv(0, b, s, hq, hkv, dh)
    want, want_lse = JFA._fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, block_q=128,
                              block_k=128)
    got, lse = TFA.forward(*map(torch.from_numpy, (q, k, v)), causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert maxdiff(got, want) < 2e-5
    # JAX stores lse replicated over 8 sublanes: [B, H, 8, S]
    assert maxdiff(lse, np.asarray(want_lse)[:, :, 0]) < 2e-5
    op = TFA.flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    assert maxdiff(op, JFA.flash_attention(q, k, v, causal, 128, 128)) \
        < 2e-5


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", CASES)
def test_gradients_match_jax_flash(b, s, hq, hkv, dh, causal):
    q, k, v = qkv(1, b, s, hq, hkv, dh)
    cot = np.random.default_rng(2).standard_normal(q.shape,
                                                   dtype=np.float32)

    def loss(q, k, v):
        return jnp.sum(JFA.flash_attention(q, k, v, causal, 128, 128)
                       * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (TFA.flash_attention(*ts, causal) * torch.from_numpy(cot)).sum() \
        .backward()
    for w, t in zip(want, ts):
        assert t.grad.shape == w.shape
        assert maxdiff(t.grad, w) < 5e-4


def test_plain_backward_is_the_recomputation_not_autograd():
    """The backward runs plain_backward's formulas (p from the saved
    lse, D from dO and O): feeding it a shifted lse shifts p, which
    autograd through a forward would not see."""
    q, k, v = map(torch.from_numpy, qkv(3, 1, 128, 2, 1, 64))
    out, lse = TFA.plain_forward(q, k, v, True)
    do = torch.ones_like(out)
    base = TFA.plain_backward(q, k, v, out, lse, do, True)
    shifted = TFA.plain_backward(q, k, v, out, lse + np.log(2.0), do, True)
    assert torch.allclose(shifted[2], base[2] / 2, atol=1e-6)


def test_bf16_forward_close_to_reference():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in qkv(5, 1, 256, 2, 2, 128))
    want = TL.attention(q, k, v, causal=True).float()
    got = TFA.flash_attention(q, k, v, True).float()
    assert float((got - want).abs().max()) < 3e-2


def test_reference_attention_matches_jax_layers():
    from dlnetbench_tpu.models import layers as JL
    q, k, v = qkv(6, 2, 64, 4, 2, 32)
    for causal in (True, False):
        want = JL.attention(jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), causal=causal)
        got = TL.attention(*map(torch.from_numpy, (q, k, v)), causal)
        assert maxdiff(got, want) < 2e-6


def test_dispatcher():
    q, k, v = map(torch.from_numpy, qkv(7, 1, 256, 2, 2, 128))
    ref = tops.attention(q, k, v, causal=True, impl="xla")
    assert torch.equal(ref, TL.attention(q, k, v, causal=True))
    before = (TFA.fwd_launches, TFA.dq_launches, TFA.dkv_launches)
    out = tops.attention(q, k, v, causal=True, impl="auto")
    assert torch.equal(out, TFA.plain_forward(q, k, v, True)[0])
    assert float((out - ref).abs().max()) < 2e-5
    # the CPU path launches nothing
    assert (TFA.fwd_launches, TFA.dq_launches, TFA.dkv_launches) == before
    for impl in ("nope", "flash"):     # the card's one path is "auto"
        with pytest.raises(ValueError, match="unknown attention impl"):
            tops.attention(q, k, v, causal=True, impl=impl)


def test_xla_refuses_a_cuda_tensor(monkeypatch):
    """The einsum reference is for CPU tensors only: on the card every
    impl the dispatcher accepts runs the kernels."""
    q, k, v = map(torch.from_numpy, qkv(7, 1, 128, 2, 2, 64))
    monkeypatch.setattr(tops, "on_card", lambda t: True)
    with pytest.raises(ValueError, match="impl='xla' is the CPU reference"):
        tops.attention(q, k, v, causal=True, impl="xla")


def test_unsupported_shapes():
    q, k, v = map(torch.from_numpy, qkv(8, 1, 100, 2, 2, 64))
    assert not TFA.flash_supported(q, k, v)
    # auto on the CPU falls back to the reference, as JAX's does
    out = tops.attention(q, k, v, causal=True, impl="auto")
    assert torch.equal(out, TL.attention(q, k, v, causal=True))
    with pytest.raises(ValueError, match="unsupported shape"):
        TFA.flash_attention(q, k, v, True)
    q, k, v = map(torch.from_numpy, qkv(8, 1, 128, 2, 2, 96))
    assert not TFA.flash_supported(q, k, v)


def test_auto_refuses_the_dense_fallback_at_64k():
    s = 64 * 1024 + 1
    q = torch.zeros(1, s, 1, 8)
    with pytest.raises(ValueError, match="refuses the dense fallback"):
        tops.attention(q, q, q, causal=True, impl="auto")
