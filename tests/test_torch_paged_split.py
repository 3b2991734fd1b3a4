"""The split paged decode attention of kernels K1 and K2
(``dlnetbench_tpu_torch/ops/csrc/paged_attention.cu``), checked where a
CPU can check it.

* The split and tile constants, read from the CUDA source, are the
  wrapper's (``split_pages``, ``workspace_floats``), and every shape
  ``check_operands`` accepts (Dh a multiple of 32 up to 256, a GQA
  group up to 32, f32 / bf16 / 8-bit pages) fits the shared memory a
  block may use.
* A numpy model of the kernel's algorithm — each slot's block-table row
  cut into splits of whole pages, each split walked in tiles with an
  online f32 softmax (scores times the page's K scale, probabilities
  times its V scale), the partials (m, l, acc) combined in split order —
  against the plain version ``gather_attention`` over lengths at the
  page's and the split's edges, an empty slot and the table's full
  width, GQA groups 1, 4 and 8, and f32, int8 and e4m3 pages.

The kernel itself runs only on a card (tests/test_torch_card_paged_
attention.py and chip_smoke.py)."""
from __future__ import annotations

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.ops import paged_attention as PA

SRC = (Path(__file__).resolve().parent.parent / "dlnetbench_tpu_torch" /
       "ops" / "csrc" / "paged_attention.cu").read_text()
SMEM_LIMIT = 227 * 1024          # the kernel's kMaxSmem
PAGE, PMAX = 16, 10              # splits of 4 pages: 4, 4, 2
ELT = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}


def const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"constexpr int {name} not found in paged_attention.cu"
    return int(m.group(1))


C = {n: const(n) for n in ("kSplitTokens", "kMaxSplits", "kTileTokens",
                           "kWideTileTokens")}


def tile_tokens(dh: int, elt: int) -> int:
    return C["kTileTokens"] if dh * elt <= 512 else C["kWideTileTokens"]


def smem(group: int, dh: int, elt: int, pps: int) -> int:
    """Bytes of a block's shared memory, as the kernel's ``Smem``: two
    stages of K and V tiles, the split's pages and scales, the group's
    queries and each warp's p row, the combine's flag."""
    tile = tile_tokens(dh, elt)
    pages = -(-3 * pps * 4 // 16) * 16
    return (4 * tile * dh * elt + pages + group * dh * 4
            + group * tile * 4 + 16)


def test_the_wrapper_sizes_the_split_as_the_kernel():
    assert PA.SPLIT_TOKENS == C["kSplitTokens"]
    assert PA.MAX_SPLITS == C["kMaxSplits"] == 65535
    # the source's formulas, mirrored by split_pages and workspace_floats
    assert ("int pps = (kSplitTokens + page_size - 1) / page_size;\n"
            "  pps = std::max(pps, (pmax + kMaxSplits - 1) / kMaxSplits);\n"
            "  return std::min(pps, pmax);") in SRC
    assert "const int n_split = (pmax + pps - 1) / pps;" in SRC
    assert "dim3(hkv, batch, n_split)" in SRC
    assert "ws + n_acc + static_cast<size_t>(bh) * n_split * group * 2" \
        in SRC
    for page, pmax in itertools.product((1, 3, 15, 16, 17, 64, 100, 256),
                                        (1, 2, 7, 32, 100, 70000)):
        pps = PA.split_pages(page, pmax)
        n = PA.num_splits(page, pmax)
        assert 1 <= pps <= pmax and n <= C["kMaxSplits"]
        assert (n - 1) * pps < pmax <= n * pps
        # whole pages holding at least kSplitTokens tokens, or the row
        assert pps * page >= min(C["kSplitTokens"], pmax * page)
        if pmax <= C["kMaxSplits"]:
            assert (pps - 1) * page < C["kSplitTokens"] or pps == 1
    assert PA.workspace_floats(8, 32, 8, 128, 16, 32) == 8 * 8 * 8 * 4 * 130


@pytest.mark.parametrize("pages", sorted(ELT))
def test_every_accepted_shape_fits_shared_memory(pages):
    """Every head dim and group the wrapper accepts, at each page type's
    tile: the block's shared memory fits; a tile is at most two tokens a
    lane; p . V's lanes cover a row's 16-byte chunks (at most two a
    lane); the combine's lanes hold at most two float4s of a head."""
    elt = ELT[pages]
    pps = PA.split_pages(1, 4096)            # page size 1: the most pages
    assert pps == C["kSplitTokens"]
    assert "float acc[kCpl * NE] = {};" in SRC and "float4 o[2] = {};" in SRC
    for dh, group in itertools.product(range(32, 257, 32), range(1, 33)):
        assert smem(group, dh, elt, pps) <= SMEM_LIMIT, (dh, group)
        assert 32 * group <= 1024 and tile_tokens(dh, elt) <= 64
        rc = dh * elt // 16
        cpl = 2 if elt == 4 else 1                  # kCpl
        assert min(32, rc) * cpl >= rc
        assert dh // 4 <= 2 * 32                    # the combine's float4s


# ----------------------------------------------------- the numpy model

def pools(seed: int, pages: str, *, b, hq, hkv, dh, n_pages, pmax):
    """f32 q, pages as the kernel reads them (8-bit ones dequantized
    exactly to f32), their scales (None for f32 pages) and a table."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, dh), np.float32) * dh ** -0.5
    kv = [rng.standard_normal((hkv, n_pages, PAGE, dh), np.float32)
          for _ in range(2)]
    bt = rng.permutation(n_pages)[:b * pmax].reshape(b, pmax)
    if pages == "f32":
        return q, kv, None, bt.astype(np.int32)
    qs, scales = [], []
    for p in kv:
        amax = np.abs(p).max(axis=(2, 3))
        sc = (amax / (127.0 if pages == "int8" else 448.0)).astype(
            np.float32)
        x = p / sc[:, :, None, None]
        if pages == "int8":
            x = np.clip(np.round(x), -127, 127)
        else:
            x = torch.from_numpy(np.clip(x, -448, 448).astype(np.float32)) \
                .to(torch.float8_e4m3fn).float().numpy()
        qs.append(x.astype(np.float32))
        scales.append(sc)
    return q, qs, scales, bt.astype(np.int32)


def split_model(q, kp, vp, lengths, bt, scales=None, *, elt):
    """The kernel's algorithm in f32: per (slot, KV head), splits of
    ``split_pages`` pages, each in tiles of ``tile_tokens`` tokens with
    an online softmax; one live split writes its output, more are
    combined in split order; an empty slot gets zeros."""
    b, hq, dh = q.shape
    hkv, n_pages, page, _ = kp.shape
    g, pmax = hq // hkv, bt.shape[1]
    split_tok = PA.split_pages(page, pmax) * page
    tile = tile_tokens(dh, elt)
    out = np.zeros_like(q)
    for bi, h in itertools.product(range(b), range(hkv)):
        ln = min(int(lengths[bi]), pmax * page)
        if ln <= 0:
            continue
        qg = q[bi, h * g:(h + 1) * g]
        parts = []
        for t0 in range(0, ln, split_tok):
            m = np.full(g, PA.MASK_VALUE, np.float32)
            l = np.zeros(g, np.float32)
            acc = np.zeros((g, dh), np.float32)
            for tt in range(t0, min(ln, t0 + split_tok), tile):
                toks = np.arange(tt, min(ln, t0 + split_tok, tt + tile))
                pg = np.clip(bt[bi, toks // page], 0, n_pages - 1)
                k = kp[h, pg, toks % page]
                v = vp[h, pg, toks % page]
                s = qg @ k.T
                if scales is not None:
                    s = s * scales[0][h, pg][None, :]
                m_new = np.maximum(m, s.max(axis=1))
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new[:, None])
                l = l * alpha + p.sum(axis=1)
                if scales is not None:
                    p = p * scales[1][h, pg][None, :]
                acc = acc * alpha[:, None] + p @ v
                m = m_new
            parts.append((m, l, acc))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[bi, h * g:(h + 1) * g] = acc / l[:, None]
            continue
        mx = np.max([p[0] for p in parts], axis=0)
        big_l = sum(pl * np.exp(pm - mx) for pm, pl, _ in parts)
        o = np.zeros((g, dh), np.float32)
        for pm, _, pa in parts:             # split order
            o = o + pa * np.exp(pm - mx)[:, None]
        out[bi, h * g:(h + 1) * g] = o / big_l[:, None]
    return out


# the page's edges (15, 16, 17), a split exactly (64 tokens = 4 pages),
# the table's full width (160), one token, an empty slot
LENGTHS = (0, 1, 15, 16, 17, 64, 65, PMAX * PAGE)


@pytest.mark.parametrize("pages", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_split_model_matches_gather_attention(pages, group):
    hkv = 2
    q, (kp, vp), scales, bt = pools(3, pages, b=len(LENGTHS),
                                    hq=hkv * group, hkv=hkv, dh=64,
                                    n_pages=len(LENGTHS) * PMAX + 2,
                                    pmax=PMAX)
    lengths = np.asarray(LENGTHS, np.int32)
    got = split_model(q, kp, vp, lengths, bt, scales, elt=ELT[pages])
    t = [torch.from_numpy(a) for a in (q, kp, vp, lengths, bt)]
    sc = [torch.from_numpy(s) for s in scales] if scales else [None, None]
    want = PA.gather_attention(*t, *sc).numpy()
    assert PA.num_splits(PAGE, PMAX) == 3
    # the empty slot gets zeros; the plain version's all-masked softmax
    # averages V there (the kernels' convention differs by design)
    assert not got[0].any()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [1, 4, 8])
def test_split_combine_in_split_order_is_the_unsplit_result(group):
    """Splitting a row changes only the f32 summation order: the
    combined splits agree with one split over the whole row within f32
    rounding, and the combine reads the partials in split order, so the
    result is the same whichever block arrives last."""
    hkv = 2
    q, (kp, vp), _, bt = pools(4, "f32", b=2, hq=hkv * group, hkv=hkv,
                               dh=128, n_pages=2 * PMAX + 2, pmax=PMAX)
    lengths = np.asarray([PMAX * PAGE, 150], np.int32)
    split = split_model(q, kp, vp, lengths, bt, elt=4)
    saved = PA.SPLIT_TOKENS
    try:
        PA.SPLIT_TOKENS = PMAX * PAGE        # one split a row
        whole = split_model(q, kp, vp, lengths, bt, elt=4)
    finally:
        PA.SPLIT_TOKENS = saved
    np.testing.assert_allclose(split, whole, rtol=2e-6, atol=2e-6)
    assert "for (int z0 = 0; z0 < n_live; z0 += 8) {" in SRC
    assert "const float wz = __shfl_sync(0xffffffffu, w, z);" in SRC
    assert "atomicAdd(counters + bh, 1) == n_live - 1" in SRC
    assert "if (tid == 0) counters[bh] = 0;" in SRC
