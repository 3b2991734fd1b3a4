"""The torch port's paged decode attention (kernels K1 and K2) and its
quantized cache writes, held against the JAX package on the same
numpy inputs.

On the CPU the port's wrappers run their plain versions; those are what
these tests compare with the JAX package (K1's with the gather fallback
at the 1e-5 bar of tests/test_serving.py, K2's with the Pallas quantized
kernel in interpret mode at the 1e-5 bar of tests/test_kv_density.py).
The cases that need a card live in
tests/test_torch_card_paged_attention.py, which imports no jax and runs
on the card with ``pytest --noconftest -m cuda``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.ops.paged_attention_quant import \
    quant_paged_attention as jax_quant_attention
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu_torch.ops import paged_attention as PA
from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
from dlnetbench_tpu_torch.ops import quantized_matmul as TQM
from dlnetbench_tpu_torch.ops.common import fit_block, on_card
from dlnetbench_tpu_torch.serving import kv_cache as TKV

FMT = {"int8": "int8", "fp8": "float8"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is enough, and the suite's
    parallel workers (and its timing-sensitive tests) keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(a) -> torch.Tensor:
    """A numpy/jax array -> a CPU tensor holding the same bytes (e4m3
    arrays travel as uint8 and are viewed back)."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def raw_bits(a) -> np.ndarray:
    """JAX array -> numpy array of its bytes (e4m3 as uint8)."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


def decode_inputs(seed: int, *, b=2, hq=4, hkv=2, dh=8, pages=16,
                  psize=4, pmax=6, lengths=(5, 17)):
    """Seeded numpy decode-attention operands; B == Hkv by default (the
    shape where a transposed scatter would broadcast silently)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, dh), np.float32) * dh ** -0.5
    kp = rng.standard_normal((hkv, pages, psize, dh), np.float32)
    vp = rng.standard_normal((hkv, pages, psize, dh), np.float32)
    bt = rng.permutation(pages)[:b * pmax].reshape(b, pmax).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), bt


def quantize_pools(kp, vp, fmt):
    """Per-page, per-head symmetric quantization of f32 pools, done once
    in numpy so both packages read identical bytes."""
    out = []
    for p in (kp, vp):
        amax = np.abs(p).max(axis=(2, 3))
        scale = (np.maximum(amax, 1e-12) / (127.0 if fmt == "int8"
                                            else 448.0)).astype(np.float32)
        x = p / scale[:, :, None, None]
        if fmt == "int8":
            q = np.clip(np.round(x), -127, 127).astype(np.int8)
        else:
            q = np.asarray(jnp.asarray(np.clip(x, -448, 448)).astype(
                jnp.float8_e4m3fn))
        out += [q, scale]
    return out   # kq, ks, vq, vs


# ---------------------------------------------------------------------
# the device split


def test_on_card_splits_by_device_and_fit_block():
    assert on_card(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="unsupported device"):
        on_card(torch.zeros(1, device="meta"))
    assert fit_block(24, 16) == 8
    assert fit_block(96, 64) == 32
    with pytest.raises(ValueError, match="non-positive"):
        fit_block(0, 8)


# ---------------------------------------------------------------------
# K1: plain version vs the JAX gather fallback


@pytest.mark.parametrize("lengths", [(5, 17), (1, 24), (4, 13)])
def test_k1_plain_matches_jax_gather(lengths):
    q, kp, vp, ln, bt = decode_inputs(0, lengths=lengths)
    ref = JKV.paged_attention_decode(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(ln),
                                     jnp.asarray(bt), impl="gather")
    got = PA.paged_attention(to_torch(q), to_torch(kp), to_torch(vp),
                             to_torch(ln), to_torch(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_k1_plain_gqa_groups_and_batch():
    """A wider batch than KV heads and a group of 4 (llama3_8b's)."""
    q, kp, vp, ln, bt = decode_inputs(1, b=3, hq=8, hkv=2, pmax=5,
                                      lengths=(20, 3, 9))
    ref = JKV.paged_attention_decode(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(ln),
                                     jnp.asarray(bt), impl="gather")
    got = PA.paged_attention(to_torch(q), to_torch(kp), to_torch(vp),
                             to_torch(ln), to_torch(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------
# K2: plain version vs the JAX quantized Pallas kernel (interpret mode)


@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
def test_k2_plain_matches_jax_quant_kernel(cache_dtype):
    q, kp, vp, ln, bt = decode_inputs(2)
    kq, ks, vq, vs = quantize_pools(kp, vp, cache_dtype)
    fmt = FMT[cache_dtype]
    ref = jax_quant_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(ln),
        jnp.asarray(bt), fmt=fmt, pages_per_compute_block=2)
    got = PAQ.quant_paged_attention(
        to_torch(q), to_torch(kq), to_torch(vq), to_torch(ks),
        to_torch(vs), to_torch(ln), to_torch(bt), fmt=fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # and through the cache's dispatch, which picks K2 for scales
    via = TKV.paged_attention_decode(
        to_torch(q), to_torch(kq), to_torch(vq), to_torch(ln),
        to_torch(bt), k_scale=to_torch(ks), v_scale=to_torch(vs), fmt=fmt)
    assert torch.equal(via, got)


@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
def test_k2_stays_within_the_decode_parity_bar(cache_dtype):
    """Attention over the quantized pools against the unquantized ones:
    within the JAX package's stated bar (QUANT_DECODE_TOL)."""
    q, kp, vp, ln, bt = decode_inputs(9, lengths=(11, 24))
    kq, ks, vq, vs = quantize_pools(kp, vp, cache_dtype)
    dense = PA.paged_attention(to_torch(q), to_torch(kp), to_torch(vp),
                               to_torch(ln), to_torch(bt))
    quant = TKV.paged_attention_decode(
        to_torch(q), to_torch(kq), to_torch(vq), to_torch(ln),
        to_torch(bt), k_scale=to_torch(ks), v_scale=to_torch(vs),
        fmt=FMT[cache_dtype])
    err = float((quant - dense).abs().max())
    assert 0 < err <= TKV.QUANT_DECODE_TOL[cache_dtype], err


def test_k2_refuses_a_mismatched_format():
    q, kp, vp, ln, bt = decode_inputs(3)
    kq, ks, vq, vs = quantize_pools(kp, vp, "int8")
    args = (to_torch(q), to_torch(kq), to_torch(vq), to_torch(ks),
            to_torch(vs), to_torch(ln), to_torch(bt))
    with pytest.raises(ValueError, match="unknown fmt"):
        PAQ.quant_paged_attention(*args, fmt="int4")
    with pytest.raises(ValueError, match="fmt 'float8' but pages"):
        PAQ.quant_paged_attention(*args, fmt="float8")
    with pytest.raises(ValueError, match="need fmt"):
        TKV.paged_attention_decode(args[0], args[1], args[2], args[5],
                                   args[6], k_scale=args[3],
                                   v_scale=args[4])


# ---------------------------------------------------------------------
# the quantization recipe and quantized cache writes: bit-exact


@pytest.mark.parametrize("fmt", ["int8", "float8"])
def test_scale_and_cast_match_jax_bit_exact(fmt):
    from dlnetbench_tpu.ops.quantized_matmul import (_cast_q,
                                                     scale_from_amax)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 447.9]     # round-half-even and edges
    amax = np.abs(x).max(axis=1)
    js = scale_from_amax(jnp.asarray(amax), fmt)
    ts = TQM.scale_from_amax(torch.from_numpy(amax), fmt)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq = _cast_q(jnp.asarray(x) / js[:, None], fmt)
    tq = TQM.cast_q(torch.from_numpy(x) / ts[:, None], fmt)
    np.testing.assert_array_equal(to_np(tq), raw_bits(jq))
    # the saturating clip: out-of-range scaled values clamp, never wrap
    big = torch.tensor([1e6, -1e6])
    np.testing.assert_array_equal(TQM.cast_q(big, fmt).float().numpy(),
                                  [TQM.FORMATS[fmt][1],
                                   -TQM.FORMATS[fmt][1]])


def _jax_pools(cc):
    return [np.asarray(a) for a in JKV.device_buffers(cc)]


@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
def test_quant_write_span_matches_jax_bit_exact(cache_dtype):
    """A sequence of decode-shaped (K=1) and prefill-shaped (K=5)
    writes, some switched off, over B == Hkv slots: pages and scales
    must equal the JAX package's byte for byte."""
    fmt = FMT[cache_dtype]
    cc = JKV.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=8,
                         num_pages=10, page_size=4, max_seqs=2,
                         max_pages_per_seq=4, cache_dtype=cache_dtype)
    jk, _, js, _ = JKV.device_buffers(cc)
    tk, _, ts, _ = TKV.device_buffers(TKV.CacheConfig(**vars(cc)), "cpu")
    bt = np.asarray([[3, 0, 7, 1], [2, 5, 9, 4]], np.int32)
    rng = np.random.default_rng(5)
    writes = [  # (layer, positions, write_ok [B, K])
        (0, [0, 0], [[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]]),
        (1, [0, 3], [[1, 1, 1, 1, 1], [1, 1, 1, 1, 1]]),
        (0, [5, 3], [[1], [1]]),
        (0, [6, 4], [[1], [0]]),            # slot 1 inactive
        (1, [5, 8], [[0], [0]]),            # nobody writes
        (0, [6, 4], [[1], [1]]),
        (1, [5, 8], [[1], [1]]),
    ]
    for li, pos, ok in writes:
        ok = np.asarray(ok, bool)
        new = rng.standard_normal((2, ok.shape[1], 2, 8)).astype(
            np.float32) * rng.uniform(0.1, 4.0)
        jk, js = JKV.quant_write_span(
            jk, js, li, jnp.asarray(new), jnp.asarray(pos, jnp.int32),
            jnp.asarray(ok), jnp.asarray(bt), fmt=fmt, page_size=4,
            num_pages=10)
        TKV.quant_write_span(
            tk, ts, li, torch.from_numpy(new),
            torch.tensor(pos, dtype=torch.int32), torch.from_numpy(ok),
            torch.from_numpy(bt), fmt=fmt, page_size=4, num_pages=10)
        np.testing.assert_array_equal(to_np(tk), raw_bits(jk))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_write_rows_gates_disabled_rows():
    """The unquantized write: enabled rows land, disabled rows change
    nothing even when they point at an enabled row's page (page 0 is a
    real page and block-table padding points at it)."""
    pages = torch.zeros((1, 2, 4, 4, 8))
    new = torch.arange(3 * 2 * 8, dtype=torch.float32).reshape(3, 2, 8)
    page_ids = torch.tensor([0, 0, 2])
    rows = torch.tensor([1, 1, 3])
    gate = TKV.write_gate((page_ids, rows),
                          torch.tensor([False, True, False]))
    TKV.write_rows(pages, 0, new, gate)
    assert torch.equal(pages[0, :, 0, 1], new[1])
    assert int((pages != 0).sum()) == 16          # one row, both heads
    TKV.write_rows(pages, 0, new, TKV.write_gate(
        (page_ids, rows), torch.tensor([False, False, False])))
    assert torch.equal(pages[0, :, 0, 1], new[1])
    assert int((pages != 0).sum()) == 16
