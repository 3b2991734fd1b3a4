"""The torch port's grouped expert matmul (kernel K12's plain version, the
per-expert quantization, the grouped expert SwiGLU and its backward) held
against the JAX package on the same numpy inputs.

On the CPU the port's ``grouped_matmul`` runs its plain version; JAX
runs its Pallas kernel in interpret mode, as tests/test_moe.py does.
Bars (tests/test_moe.py's): products within 1e-5 on the live rows, and
zero wherever JAX zeroes (the port zeroes every row at or past a count,
JAX whole blocks past it, so the rows between are compared only where
the dispatch contract makes them zero in both); the int8 product
bit-equal; e4m3 finite and within 1e-2 relative (Frobenius); the grouped
SwiGLU's gradients within 1e-5.  The cases that need a card live in
tests/test_torch_card_grouped_matmul.py, which imports no jax and runs
on the card with ``pytest --noconftest -m cuda``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.ops import grouped_matmul as JG
from dlnetbench_tpu.ops import quantized_matmul as JQ
from dlnetbench_tpu_torch.ops import grouped_matmul as TG
from dlnetbench_tpu_torch.ops import quantized_matmul as TQ

SMALL = dict(block_c=8, block_n=16, block_k=16)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a: np.ndarray, dtype: str = "float32"):
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def gm_case(e=4, c=16, d=32, h=48, dtype="float32"):
    """x [E, C, d], w_gate/w_up [E, d, h], w_down [E, h, d] for both."""
    return (both(arr(0, (e, c, d)), dtype),
            both(arr(1, (e, d, h), 0.05), dtype),
            both(arr(2, (e, d, h), 0.05), dtype),
            both(arr(3, (e, h, d), 0.05), dtype))


def test_default_blocks_equal_jax():
    assert TG.DEFAULT_BLOCKS == JG.DEFAULT_BLOCKS


def test_plain_grouped_matmul_matches_jax_kernel():
    (jx, tx), (jw, tw), _, _ = gm_case()
    want = JG.grouped_matmul(jx, jw, **SMALL)
    got = TG.grouped_matmul(tx, tw, **SMALL)
    assert got.shape == (4, 16, 48) and got.dtype == torch.float32
    assert float(np.abs(f32(got) - f32(want)).max()) < 1e-5


@pytest.mark.parametrize("block_c", [4, 8])
def test_counts_zero_rows_where_jax_zeroes_and_live_rows_match(block_c):
    """Live rows within 1e-5; every row at or past a count is zero in the
    port, which covers every row the TPU kernel zeroes (whole blocks past
    the count) — counts of 0 and of the full buffer included."""
    (jx, tx), (jw, tw), _, _ = gm_case()
    counts = np.array([16, 5, 0, 9], np.int32)
    want = f32(JG.grouped_matmul(jx, jw, counts=jnp.asarray(counts),
                                 block_c=block_c, block_n=16, block_k=16))
    got = f32(TG.grouped_matmul(tx, tw, counts=torch.from_numpy(counts)))
    for e, n in enumerate(counts):
        jax_zero_from = min(-(-n // block_c) * block_c, 16)
        assert np.abs(got[e, :n] - want[e, :n]).max(initial=0) < 1e-5
        assert not got[e, n:].any()
        assert not want[e, jax_zero_from:].any()


@pytest.mark.parametrize("fmt", ["int8", "float8"])
def test_quantize_experts_and_amax_equal_jax(fmt):
    (jx, tx), (jw, tw), _, _ = gm_case(dtype="bfloat16")
    jq, js = JG.quantize_experts(jw, fmt)
    tq, ts = TG.quantize_experts(tw, fmt)
    assert tq.dtype == TQ.FORMATS[fmt][0]
    assert np.array_equal(f32(tq), f32(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(TG.expert_amax(tx).numpy(),
                          np.asarray(JG.expert_amax(jx)))


def _quant_pair(fmt, counts=None):
    (jx, tx), (jw, tw), _, _ = gm_case(dtype="bfloat16")
    jq, jsw = JG.quantize_experts(jw, fmt)
    tq, tsw = TG.quantize_experts(tw, fmt)
    jsx = JQ.scale_from_amax(JG.expert_amax(jx), fmt)
    tsx = TQ.scale_from_amax(TG.expert_amax(tx), fmt)
    jc = None if counts is None else jnp.asarray(counts)
    tc = None if counts is None else torch.from_numpy(counts)
    want = JG.grouped_matmul(jx, jq, sx=jsx, sw=jsw, fmt=fmt, counts=jc,
                             **SMALL)
    got = TG.grouped_matmul(tx, tq, sx=tsx, sw=tsw, fmt=fmt, counts=tc)
    return got, want


def test_int8_grouped_bit_equal_to_jax():
    """int32 sums are exact and the scale spelling is shared: the plain
    int8 grouped product equals the Pallas kernel's bit for bit, on every
    row without counts and on the live rows with them."""
    got, want = _quant_pair("int8")
    assert got.dtype == torch.bfloat16
    assert np.array_equal(f32(got), f32(want))
    counts = np.array([16, 8, 0, 3], np.int32)
    got, want = _quant_pair("int8", counts)
    g, w = f32(got), f32(want)
    for e, n in enumerate(counts):
        assert np.array_equal(g[e, :n], w[e, :n])
        assert not g[e, n:].any()


def test_e4m3_grouped_finite_and_close_to_jax():
    got, want = _quant_pair("float8")
    g, w = f32(got), f32(want)
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-2


def test_grouped_ffn_grads_match_jax():
    """Output and the four gradients of sum(y^2) within 1e-5 of the JAX
    package's grouped_ffn (its Pallas forward in interpret mode, its
    custom-VJP backward) — f32, the CPU path follows JAX's formulas."""
    pairs = gm_case()
    jargs = [p[0] for p in pairs]
    targs = [p[1].clone().requires_grad_(True) for p in pairs]

    def jloss(*a):
        return jnp.sum(JG.grouped_ffn(*a, **SMALL) ** 2)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    y = TG.grouped_ffn(*targs, **SMALL)
    tval = y.square().sum()
    tgrads = torch.autograd.grad(tval, targs)
    assert abs(tval.item() - float(jval)) <= 1e-5 * abs(float(jval))
    for g, w in zip(tgrads, jgrads):
        assert float(np.abs(f32(g) - f32(w)).max()) < 1e-5


def test_grouped_ffn_counts_carry_no_gradient_and_skip_rows():
    pairs = gm_case()
    targs = [p[1].clone().requires_grad_(True) for p in pairs]
    counts = torch.tensor([16, 4, 0, 7], dtype=torch.int32)
    y = TG.grouped_ffn(*targs, counts=counts)
    for e, n in enumerate(counts.tolist()):
        assert not y[e, n:].any()
    grads = torch.autograd.grad(y.sum(), targs)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("fmt", ["int8", "float8"])
def test_grouped_ffn_quantized_runs_finite_and_near_jax(fmt):
    """The fused-quantization expert SwiGLU: finite, within 1e-2
    (Frobenius) of JAX's — the hidden activation's rounding to bf16 may
    differ by an ulp between the packages' silu, which can move a code —
    with the straight-through backward."""
    pairs = gm_case(dtype="bfloat16")
    want = f32(JG.grouped_ffn(*[p[0] for p in pairs], fmt=fmt, **SMALL))
    targs = [p[1].clone().requires_grad_(True) for p in pairs]
    y = TG.grouped_ffn(*targs, fmt=fmt)
    got = f32(y)
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
    grads = torch.autograd.grad(y.float().sum(), targs)
    assert all(torch.isfinite(g.float()).all() for g in grads)


def _message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("kwargs", [
    dict(block_c=-4, block_n=16, block_k=16), dict(block_k=2.5),
    dict(fmt="int4"), dict(fmt="int8")])
def test_validation_messages_equal_jax(kwargs):
    (jx, tx), (jw, tw), _, _ = gm_case()
    assert _message(lambda: TG.grouped_matmul(tx, tw, **kwargs)) \
        == _message(lambda: JG.grouped_matmul(jx, jw, **kwargs))


def test_shape_and_ffn_fmt_messages_equal_jax():
    (jx, tx), (jw, tw), (ju, tu), (jd, td) = gm_case()
    assert _message(lambda: TG.grouped_matmul(tx, td)) \
        == _message(lambda: JG.grouped_matmul(jx, jd))
    assert _message(lambda: TG.grouped_ffn(tx, tw, tu, td, fmt="fp4")) \
        == _message(lambda: JG.grouped_ffn(jx, jw, ju, jd, fmt="fp4"))
