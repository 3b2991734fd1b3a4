"""The torch port's mask layer (``ops/attention_mask.py``) held against
the JAX package's on the same specs and lengths: every integer array,
verdict table and stat is exactly equal.  The grid is the JAX splash
tests' MASK_SPECS (tests/test_flash_attention.py) plus the plain-causal
spec and the chip check's masks, at a few lengths, at the JAX kernels'
blocks and at the port's kernel tiles (forward and dq 64 x 64, dk/dv
64 x 128)."""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dlnetbench_tpu.ops import attention_mask as JM
from dlnetbench_tpu_torch.ops import attention_mask as TM
from dlnetbench_tpu_torch.ops import flash_attention as TFA

REPO = Path(__file__).resolve().parent.parent

# (causal, window, seg_avg, seg_seed)
SPECS = [
    (True, 40, 0, 0),             # tests/test_flash_attention.py MASK_SPECS
    (True, 0, 50, 3),
    (False, 0, 64, 1),
    (True, 32, 80, 5),
    (True, 0, 0, 0),              # plain causal
    (True, 1024, 0, 0),           # the chip check's masks
    (True, 0, 768, 0),
    (True, 1024, 768, 0),
    (False, 0, 768, 0),
]
LENGTHS = [256, 384, 1024]
TILES = [(64, 64), (64, 128), (128, 128), (128, 64)]


def specs(t):
    return (TM.MaskSpec(*t), JM.MaskSpec(*t))


@pytest.mark.parametrize("seed,avg,s", [(0, 50, 256), (3, 50, 1000),
                                        (1, 64, 384), (0, 768, 6144),
                                        (7, 1, 40), (0, 8192, 65536)])
def test_segment_ids_equal(seed, avg, s):
    got = TM.segment_ids(seed, avg, s)
    want = JM.segment_ids(seed, avg, s)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("s", LENGTHS)
def test_row_intervals_and_dense_mask_equal(spec, s):
    t, j = specs(spec)
    for a, b in zip(TM.row_intervals(t, s), JM.row_intervals(j, s)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TM.dense_mask(t, s), JM.dense_mask(j, s))
    assert TM.sparsity_fraction(t, s) == JM.sparsity_fraction(j, s)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("tiles", TILES)
def test_block_mask_arrays_verdicts_and_stats_equal(spec, s, tiles):
    t, j = specs(spec)
    if s % tiles[0] or s % tiles[1]:
        with pytest.raises(ValueError, match="do not divide"):
            TM.block_mask(t, s, *tiles)
        return
    got, want = TM.block_mask(t, s, *tiles), JM.block_mask(j, s, *tiles)
    for name in ("q_first_k", "q_last_k", "kv_first_q", "kv_last_q",
                 "blk_lo_max", "blk_hi_min", "lo", "hi"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.nq, got.nk) == (want.nq, want.nk)
    np.testing.assert_array_equal(got.verdicts(), want.verdicts())
    assert got.stats() == want.stats()


@pytest.mark.parametrize("spec", SPECS)
def test_record_globals_and_ring_hops_equal(spec):
    t, j = specs(spec)
    s = 1024
    assert TM.record_globals(t, s) == JM.record_globals(j, s)
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(TM.ring_hop_work(t, s, n),
                                      JM.ring_hop_work(j, s, n))
        assert TM.record_globals(t, s, n_shards=n) \
            == JM.record_globals(j, s, n_shards=n)
        assert TM.ring_skipped_hop_fraction(t, s, n) \
            == JM.ring_skipped_hop_fraction(j, s, n)
    np.testing.assert_array_equal(TM.ring_hop_work(None, s, 4),
                                  JM.ring_hop_work(None, s, 4))


@pytest.mark.parametrize("spec", SPECS)
def test_allowed_equals_dense_mask_and_jax(spec):
    import jax.numpy as jnp
    t, j = specs(spec)
    s = 256
    qp = torch.arange(s)[:, None]
    kp = torch.arange(s)[None, :]
    ids = (TM.segment_ids(t.seg_seed, t.seg_avg, s) if t.seg_avg
           else None)
    got = TM.allowed(t, qp, kp, ids)
    assert got.dtype == torch.bool and got.shape == (s, s)
    np.testing.assert_array_equal(got.numpy(), TM.dense_mask(t, s))
    want = JM.allowed(j, jnp.arange(s)[:, None], jnp.arange(s)[None, :],
                      ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if t.seg_avg:
        with pytest.raises(ValueError, match="seg_ids"):
            TM.allowed(t, qp, kp)


def test_mask_spec_validation_labels_and_knobs():
    bad = [dict(window=-1), dict(seg_avg=-2), dict(causal=False, window=8),
           dict(causal=False)]
    for kw in bad:
        with pytest.raises(ValueError) as te:
            TM.MaskSpec(**kw)
        with pytest.raises(ValueError) as je:
            JM.MaskSpec(**kw)
        assert str(te.value) == str(je.value)
    for spec in SPECS:
        t, j = specs(spec)
        assert t.label() == j.label() and t.to_dict() == j.to_dict()
        assert TM.MaskSpec.from_dict(t.to_dict()) == t
        assert t.is_plain_causal == j.is_plain_causal
        assert hash(t) == hash(TM.MaskSpec(*spec))
    for knobs in ((0, 0, 0), (64, 0, 0), (0, 50, 3), (32, 80, 5)):
        got, want = TM.MaskSpec.from_knobs(*knobs), \
            JM.MaskSpec.from_knobs(*knobs)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError, match="seg_avg"):
        TM.segment_ids(0, 0, 16)


def test_kernel_tiles_match_the_cuda_source():
    """The wrapper's tile constants are the CUDA source's: each splash
    kernel's BlockMask is built at the tiles the kernel walks."""
    src = (REPO / "dlnetbench_tpu_torch/ops/csrc/flash_attention.cu") \
        .read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    bq, bk = const("kBQ"), const("kBK")
    # the forward's 128-key stages; dk/dv: two consumer warpgroups of 64
    # keys each
    bkf = const("kBKf")
    bkd = const("kConsumers") * 64
    assert re.search(r"kBKd = kConsumers \* 64", src)
    assert TFA.FWD_TILES == (bq, bkf)
    assert TFA.DQ_TILES == (bq, bk)
    assert TFA.DKV_TILES == (bq, bkd)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_packed_arrays_follow_the_kernels_layout(kind):
    """``pack_block_mask``: [first | last | lo_max | hi_min] each padded
    to 4 entries, then lo and hi; the transposed visit ranges for dk/dv;
    cached per (spec, S, kind, device)."""
    spec = TM.MaskSpec(causal=True, window=40, seg_avg=50, seg_seed=3)
    s = 384
    arr = TFA.splash_arrays(spec, s, kind, torch.device("cpu"))
    assert arr is TFA.splash_arrays(spec, s, kind, torch.device("cpu"))
    bm = TM.block_mask(spec, s, *TFA._KIND_TILES[kind])
    first, last = ((bm.kv_first_q, bm.kv_last_q) if kind == "dkv"
                   else (bm.q_first_k, bm.q_last_k))
    n4, nq4 = -(-len(first) // 4) * 4, -(-bm.nq // 4) * 4
    got = arr.packed.numpy()
    assert arr.packed.dtype == torch.int32
    assert len(got) == 2 * n4 + 2 * nq4 + 2 * s
    off = 0
    for a, width in ((first, n4), (last, n4), (bm.blk_lo_max, nq4),
                     (bm.blk_hi_min, nq4), (bm.lo, s), (bm.hi, s)):
        np.testing.assert_array_equal(got[off:off + len(a)], a)
        assert not got[off + len(a):off + width].any()
        off += width
    assert off % 4 == 2 * s % 4 == 0
