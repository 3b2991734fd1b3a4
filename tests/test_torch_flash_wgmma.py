"""The wgmma/TMA flash kernels, K3 (forward), K4 (dq) and K5 (dk/dv) and
their splash mode K6/K7/K8
(``dlnetbench_tpu_torch/ops/csrc/flash_attention.cu``, ``fwd_bf16``,
``dq_bf16`` and ``dkv_bf16``, on the helpers of ``csrc/hopper.cuh``),
checked where a CPU can check it.

* The tile, ring and register constants, read from the CUDA source:
  every instantiation (Dh 64 / 128, dense, causal and splash) fits the
  232,448 bytes of shared memory a block may use on Hopper, and the
  setmaxnreg split fits the 65,536 registers of an SM.
* One numpy image of TMA's 128-byte swizzle of a tile, read through the
  kernels' K-major and N-major wgmma descriptors: each product reads
  the elements its formula names (S = Q K^T, dP = dO V^T, dQ += dS K;
  S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q).
* The accumulator-to-register-A packing (``pack_a``) is the wgmma A
  fragment, over a numpy model of both layouts.
* The visit ranges at the kernels' tiles: K3's and K4's pairs of (q
  head, q tile) items cover every item once, and with K5's key tiles
  every live tile is computed exactly once, and every allowed (query,
  key) pair of the mask lies in a computed tile; K3's and K4's K/V rings
  never wait on a stage a consumer holds.

A numpy model of K3's tile loop at its rounding points is held against
the plain versions and JAX's forward kernel in
tests/test_torch_flash_forward_model.py.

The kernels themselves run only on a card (tests/test_torch_card_*.py
and chip_smoke.py)."""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from dlnetbench_tpu_torch.ops import attention_mask as TM
from dlnetbench_tpu_torch.ops import flash_attention as TFA

CSRC = Path(__file__).resolve().parent.parent / "dlnetbench_tpu_torch" / \
    "ops" / "csrc"
SRC = (CSRC / "flash_attention.cu").read_text()
HDR = (CSRC / "hopper.cuh").read_text()
SMEM_LIMIT = 232448          # dynamic shared memory a block may use
REGS_PER_SM = 65536
HEAD_DIMS = (64, 128)
MODES = ("dense", "causal", "splash")


def const(name: str) -> int:
    """A ``constexpr int name = <int>;`` of the CUDA source (also the
    second of ``constexpr int a = 1, name = 2;``)."""
    m = re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)[,;]", SRC)
    assert m, f"constexpr int {name} not found in flash_attention.cu"
    return int(m.group(1))


C = {n: const(n) for n in (
    "kBQ", "kBK", "kConsumers", "kWsThreads", "kHelperWarps",
    "kBKf", "kFwdKStages", "kFwdVStages", "kFwdQSlots", "kDqStages", "kDkvStages", "kWsExtra", "kRowsBytes", "kPanel",
    "kRegProducer", "kRegConsumer")}
BKD = C["kConsumers"] * 64


def body(name: str) -> str:
    """The source of kernel ``name`` (template head to the next one)."""
    i = SRC.index(f"    {name}(const __grid_constant__")
    j = SRC.find("template <int DH", i)
    return SRC[i:j if j > 0 else len(SRC)]


def tile_bytes(dh: int) -> int:
    return 64 * dh * 2


def fwd_smem(dh: int) -> int:
    """kFwdQSlots slots of the two items' q tiles, then the K and V rings
    of 128-key tiles (2 tile_bytes each)."""
    return C["kWsExtra"] + (2 * C["kFwdQSlots"] + 2 * (
        C["kFwdKStages"] + C["kFwdVStages"])) * tile_bytes(dh)


def dq_smem(dh: int) -> int:
    return C["kWsExtra"] + (4 + 2 * C["kDqStages"]) * tile_bytes(dh)


def dkv_stage(dh: int) -> int:
    return 3 * tile_bytes(dh) + C["kRowsBytes"]


def dkv_smem(dh: int) -> int:
    return (C["kWsExtra"] + 4 * tile_bytes(dh)
            + C["kDkvStages"] * dkv_stage(dh))


def test_the_source_states_the_formulas_this_test_mirrors():
    assert "kConsumers = 2, kBKd = kConsumers * 64;" in SRC
    assert ("return kWsExtra + static_cast<size_t>(4 + 2 * kDqStages) *\n"
            "                         tile_bytes<DH>();") in SRC
    assert "return 3 * tile_bytes<DH>() + kRowsBytes;" in SRC
    assert ("return kWsExtra + 4 * static_cast<size_t>(tile_bytes<DH>()) "
            "+\n         static_cast<size_t>(kDkvStages) * "
            "dkv_stage_bytes<DH>();") in SRC
    assert "return 64 * DH * 2;" in SRC
    # the descriptors the consumers build
    assert ("return sw128_desc(addr + (ks / 4) * panel + (ks % 4) * 32, 16, "
            "1024);") in SRC
    assert "return sw128_desc(addr + kk * 16 * 128, panel, 1024);" in SRC
    assert "int panel = kPanel) {" in SRC
    assert "const int e = 4 * (2 * kk + r / 2) + 2 * (r % 2);" in HDR
    # the grids and K4's pairing
    assert "const int pair = G * nq / 2 - 1 - y;     // longest first" in SRC
    assert "pair_items<MODE, kBK>(mv, hk, G, nq, blockIdx.y);" in SRC
    assert "dim3(B * Hkv, Hq / Hkv * (S / kBQ) / 2)" in SRC
    assert "dim3(B * Hkv, S / kBKd)" in SRC
    # the PTX helpers live once, in hopper.cuh, included by both sources
    mlp = (CSRC / "mlp_matmul.cu").read_text()
    for src in (SRC, mlp):
        assert '#include "hopper.cuh"' in src
        for helper in ("void mbar_wait(", "void tma_load(",
                       "uint64_t sw128_desc(", "EncodeTiled encode_fn(",
                       "void reg_claim(", "struct Ring"):
            assert helper not in src, helper
    for helper in ("void mbar_wait(", "void tma_load(", "void bulk_load(",
                   "uint64_t sw128_desc(", "void wgmma_ss_n64(",
                   "void wgmma_rs_n64(", "void wgmma_rs_n128(",
                   "EncodeTiled encode_fn(", "void reg_claim(",
                   "void pack_a("):
        assert helper in HDR, helper


@pytest.mark.parametrize("kernel", ["dq_bf16", "dkv_bf16"])
def test_the_backward_kernels_are_wgmma_and_tma_only(kernel):
    """No mma.sync, ldmatrix or cp.async remains in K4/K5: TMA loads, a
    producer warp, wgmma consumer warpgroups."""
    src = body(kernel)
    for old in ("mma(", "mma_abt", "mma_xb", "ldsm4", "load_tile",
                "cp_async", "scale_tile", "__syncthreads();\n    "):
        assert old not in src, old
    for new in ("tma_load(", "wgmma_ss_n64(", "wgmma_rs<DH>(",
                "reg_release<kRegProducer>()",
                "reg_claim<kRegConsumer>()", "mbar_wait(&empty[r.slot]"):
        assert new in src, new


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_every_instantiation_fits_shared_memory(dh, mode):
    """K4 holds the two items' q and dO tiles and a K/V ring; K5 the
    128-key K and V tiles and a ring of q, dO, q * scale tiles with their
    rows (lse, D and, splash, lo / hi: room for all four in every mode)."""
    del mode                    # the layout is the same in every mode
    assert C["kDqStages"] >= 2 and C["kDkvStages"] >= 2
    assert dq_smem(dh) <= SMEM_LIMIT and dkv_smem(dh) <= SMEM_LIMIT
    # every tile and stage 1024-byte aligned (the swizzle's phase)
    assert tile_bytes(dh) % 1024 == 0 and dkv_stage(dh) % 1024 == 0
    assert C["kRowsBytes"] == 4 * C["kBQ"] * 4 and C["kRowsBytes"] % 1024 == 0
    # the extra: 1024 for alignment, then the barriers and K4's D rows
    barriers = 8 * (1 + 3 * C["kDkvStages"])
    assert barriers <= 512 and 8 * (1 + 2 * C["kDqStages"]) <= 512
    assert 512 + 2 * 64 * 4 <= 1024 == C["kWsExtra"] - 1024
    # TMA boxes: 64 columns (128 bytes, the swizzle span) x 1 head x at
    # most 256 rows; a panel is 64 rows x 128 bytes
    assert C["kPanel"] == 64 * 128
    assert max(C["kBQ"], C["kBK"], BKD) <= 256


def test_register_split_fits_the_sm():
    threads = C["kWsThreads"]
    assert threads == 3 * 128
    cap = REGS_PER_SM // threads // 8 * 8           # 168 at launch
    prod, cons = C["kRegProducer"], C["kRegConsumer"]
    assert all(24 <= r <= 256 and r % 8 == 0 for r in (prod, cons))
    # setmaxnreg moves registers within the block's pool at launch; an
    # inc past it waits for ever
    assert 128 * (prod + 2 * cons) <= threads * cap
    # K5's consumer holds dK and dV (64 x Dh f32 each: 64 + 64 registers
    # a thread at Dh 128) and S^T, dP^T (64 x 64: 32 + 32)
    assert cons - (64 + 64 + 32 + 32) >= 32
    # WG 0's helper warps (K5) and the producer warp
    assert C["kHelperWarps"] == 3 and C["kConsumers"] == 2


# --------------------------------------------- the swizzle, the descriptors

def swizzle(addr: int) -> int:
    """TMA's 128-byte swizzle on a 1024-byte aligned region, as wgmma
    applies it to a descriptor's addresses (CUTLASS's Swizzle<3,4,3>)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_image(tile: np.ndarray) -> dict:
    """Where TMA puts a [rows, dh] tile loaded as dh / 64 boxes of 64
    columns x rows: byte address -> (row, column)."""
    rows, dh = tile.shape
    img = {}
    for p in range(dh // 64):
        for r in range(rows):
            for c in range(64):
                img[p * rows * 128 + swizzle(r * 128 + 2 * c)] = \
                    tile[r, 64 * p + c]
    return img


def kmajor_read(img, start: int, n_rows: int, sbo: int = 1024):
    """A K-major operand of one K step (16 bf16) through a 128-byte
    swizzle descriptor at ``start``: [n_rows, 16]."""
    return np.array([[img[swizzle(start + (m // 8) * sbo + (m % 8) * 128
                                  + 2 * k)] for k in range(16)]
                     for m in range(n_rows)])


def nmajor_read(img, start: int, n: int, lbo: int, sbo: int = 1024):
    """An N-major (MN-major) operand of one K step: [16, n]."""
    return np.array([[img[swizzle(start + (j // 64) * lbo + (k // 8) * sbo
                                  + (k % 8) * 128 + 2 * (j % 64))]
                      for j in range(n)] for k in range(16)])


def ids(rows: int, dh: int, tag: int) -> np.ndarray:
    """Distinct element ids of a [rows, dh] tile."""
    return tag * 10**6 + np.arange(rows * dh).reshape(rows, dh)


def kmajor(addr: int, ks: int, panel: int) -> int:
    return addr + (ks // 4) * panel + (ks % 4) * 32       # kmajor()


def nmajor(addr: int, kk: int) -> int:
    return addr + kk * 16 * 128        # nmajor(); the panel is the LBO


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_k4_reads_one_stage_two_ways(dh):
    """S = Q K^T reads Q and K K-major; dQ += dS K reads the same K
    stage N-major (Dh is N, the stage's 64 keys the contraction)."""
    q, k = ids(64, dh, 1), ids(C["kBK"], dh, 2)
    qi, ki = tma_image(q), tma_image(k)
    for ks in range(dh // 16):
        a = kmajor_read(qi, kmajor(0, ks, C["kPanel"]), 64)
        b = kmajor_read(ki, kmajor(0, ks, C["kPanel"]), 64)
        assert (a == q[:, 16 * ks:16 * ks + 16]).all()
        assert (b == k[:, 16 * ks:16 * ks + 16]).all()
    for kk in range(C["kBK"] // 16):
        b = nmajor_read(ki, nmajor(0, kk), dh, C["kPanel"])
        assert (b == k[16 * kk:16 * kk + 16, :]).all()


@pytest.mark.parametrize("ci", range(2))
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_k5_reads_the_key_tile_and_the_q_stage(dh, ci):
    """S^T = K (q * scale)^T: A is consumer ci's 64 keys of the 128-key
    tile (panels of 128 rows), B the q * scale tile, both K-major; dV +=
    P^T dO and dK += dS^T q read the dO and q tiles N-major."""
    kt, qs = ids(BKD, dh, 3), ids(64, dh, 4)
    kimg, qimg = tma_image(kt), tma_image(qs)
    kp = 2 * C["kPanel"]
    for ks in range(dh // 16):
        a = kmajor_read(kimg, kmajor(ci * C["kPanel"], ks, kp), 64)
        assert (a == kt[64 * ci:64 * ci + 64, 16 * ks:16 * ks + 16]).all()
        b = kmajor_read(qimg, kmajor(0, ks, C["kPanel"]), 64)
        assert (b == qs[:, 16 * ks:16 * ks + 16]).all()
    for kk in range(C["kBQ"] // 16):
        b = nmajor_read(qimg, nmajor(0, kk), dh, C["kPanel"])
        assert (b == qs[16 * kk:16 * kk + 16, :]).all()


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_scaling_in_place_keeps_every_element_in_its_slot(dh):
    """q * scale is written at the q tile's byte offsets (16-byte pieces,
    whole under the swizzle): each 16-byte piece holds 8 columns of one
    row, so the elementwise pass maps every element onto itself."""
    q = ids(64, dh, 5)
    img = tma_image(q)
    for piece in range(0, tile_bytes(dh), 16):
        vals = [img[piece + 2 * i] for i in range(8)]
        rows = {v // dh % 64 for v in (x - 5 * 10**6 for x in vals)}
        cols = [(x - 5 * 10**6) % dh for x in vals]
        assert len(rows) == 1 and cols == list(range(cols[0], cols[0] + 8))


# ----------------------------------------- accumulator -> register A

def acc_pos(warp: int, lane: int, e: int) -> tuple:
    """Element e of a thread's m64nN f32 accumulator (PTX's wgmma D
    fragment): row 16 warp + lane / 4 + 8 ((e % 4) / 2), column
    8 (e / 4) + 2 (lane % 4) + e % 2."""
    return (16 * warp + lane // 4 + 8 * ((e % 4) // 2),
            8 * (e // 4) + 2 * (lane % 4) + e % 2)


def a_frag_pos(warp: int, lane: int, reg: int, half: int) -> tuple:
    """Half ``half`` of register ``reg`` of the wgmma register-A fragment
    (m64k16 bf16; each warp's 16 rows as mma.m16n8k16's A): row 16 warp +
    lane / 4 + 8 (reg % 2), column 8 (reg / 2) + 2 (lane % 4) + half."""
    return (16 * warp + lane // 4 + 8 * (reg % 2),
            8 * (reg // 2) + 2 * (lane % 4) + half)


def pack_a_index(kk: int, reg: int) -> int:
    return 4 * (2 * kk + reg // 2) + 2 * (reg % 2)       # hopper.cuh


@pytest.mark.parametrize("n", [64])
def test_pack_a_is_the_register_a_fragment(n):
    """For every K step kk of a 64 x n accumulator (S or dS: n = 64 keys
    in K4, 64 queries in K5), register r of thread (warp, lane) packs
    accumulator elements pack_a_index(kk, r) + {0, 1}: the same row and
    columns 16 kk + the fragment's column, so no shuffle is needed; over
    the warpgroup every element of the step appears once."""
    for kk in range(n // 16):
        seen = set()
        for warp in range(4):
            for lane in range(32):
                for reg in range(4):
                    e = pack_a_index(kk, reg)
                    for half in range(2):
                        row, col = acc_pos(warp, lane, e + half)
                        frow, fcol = a_frag_pos(warp, lane, reg, half)
                        assert (row, col) == (frow, 16 * kk + fcol)
                        seen.add((row, col))
        assert seen == {(r, 16 * kk + c) for r in range(64)
                        for c in range(16)}


def test_the_accumulator_covers_the_tile_once():
    for nr in (32, 64):                   # m64n64 and m64n128
        pos = [acc_pos(w, lane, e) for w in range(4) for lane in range(32)
               for e in range(nr)]
        assert len(set(pos)) == len(pos) == 64 * 2 * nr


# ------------------------------------------------------- visit ranges

SPECS = [None, "causal", TM.MaskSpec(window=40),
         TM.MaskSpec(seg_avg=50, seg_seed=3),
         TM.MaskSpec(causal=False, seg_avg=64, seg_seed=1),
         TM.MaskSpec(window=32, seg_avg=80, seg_seed=5),
         TM.MaskSpec(seg_avg=96, seg_seed=2), TM.MaskSpec(causal=True)]


def intervals(spec, s: int):
    if spec is None:
        return np.zeros(s, int), np.full(s, s - 1)
    if spec == "causal":
        return np.zeros(s, int), np.arange(s)
    return TM.row_intervals(spec, s)


def dq_ranges(spec, s: int) -> list:
    """K4's visit range [j0, j1) of kv tiles per q tile."""
    nq = s // C["kBQ"]
    if spec is None:
        return [(0, s // C["kBK"])] * nq
    if spec == "causal":
        return [(0, (qt * C["kBQ"] + C["kBQ"] - 1) // C["kBK"] + 1)
                for qt in range(nq)]
    bm = TM.block_mask(spec, s, *TFA.DQ_TILES)
    return [(int(bm.q_first_k[qt]), int(bm.q_last_k[qt]) + 1)
            for qt in range(nq)]


def dkv_ranges(spec, s: int) -> list:
    """K5's visit range [first, last] of q tiles per 128-key tile."""
    nq = s // C["kBQ"]
    if spec is None:
        return [(0, nq - 1)] * (s // BKD)
    if spec == "causal":
        return [(kt * BKD // C["kBQ"], nq - 1) for kt in range(s // BKD)]
    bm = TM.block_mask(spec, s, *TFA.DKV_TILES)
    return [(int(bm.kv_first_q[kt]), int(bm.kv_last_q[kt]))
            for kt in range(s // BKD)]


def live_tiles(spec, s: int, bq: int, bk: int) -> set:
    lo, hi = intervals(spec, s)
    live = set()
    for r in range(s):
        for j in range(lo[r] // bk, hi[r] // bk + 1):
            live.add((r // bq, j))
    return live


def pairs_cover_every_item_and_live_tile_once(spec, s, group, ranges,
                                              bk):
    """Block (KV head, y) takes items 2p, 2p + 1 (p = pairs - 1 - y) of
    the KV head's group x nq items in (q tile, q head) order; its ring
    runs over the union of their ranges; a consumer computes the stages
    of its own range.  Every item is taken once, every live (q tile, kv
    tile) of each q head computed once, every allowed pair inside."""
    nq = s // C["kBQ"]
    assert (group * nq) % 2 == 0
    items, computed = [], []
    for y in range(group * nq // 2):
        pair = group * nq // 2 - 1 - y
        own = []
        for c in range(2):
            i = 2 * pair + c
            qt, g = i // group, i % group
            items.append((g, qt))
            own.append((g, qt, *ranges[qt]))
        j_lo = min(o[2] for o in own)
        j_hi = max(o[3] for o in own)
        for j in range(j_lo, j_hi):
            for g, qt, j0, j1 in own:
                if j0 <= j < j1:
                    computed.append((g, qt, j))
    assert sorted(items) == [(g, qt) for g in range(group)
                             for qt in range(nq)]
    assert len(computed) == len(set(computed))
    live = live_tiles(spec, s, C["kBQ"], bk)
    got = {(qt, j) for g, qt, j in computed if g == 0}
    assert live <= got
    for g in range(group):
        assert {(qt, j) for gg, qt, j in computed if gg == g} == got
    # the longest first: the first blocks take the last q tiles
    if spec == "causal":
        assert max(qt for _, qt in items[:2]) == nq - 1


@pytest.mark.parametrize("spec", SPECS, ids=lambda t: getattr(
    t, "label", lambda: str(t))())
@pytest.mark.parametrize("s,group", [(256, 1), (256, 2), (640, 3),
                                     (640, 4), (384, 1)])
def test_k4_pairs_cover_every_item_and_live_tile_once(spec, s, group):
    pairs_cover_every_item_and_live_tile_once(spec, s, group,
                                              dq_ranges(spec, s), C["kBK"])


def k4_ring_runs_to_the_end(own: list, stages: int,
                            free_on_skip: bool = True) -> bool:
    """K4's K/V ring between its producer and two consumers, step by
    step: the producer fills stage k once both consumers have freed
    stage k - stages; a consumer takes stage k once it is filled.  On a
    stage of its own range it frees the stage it held (whose dQ product
    was in flight) and holds this one; on a stage outside its range it
    frees the held stage (``free_on_skip``) and this one; at the end it
    frees the held stage.  False if the ring stops short (a hang)."""
    live = [r for r in own if r[1] > r[0]]
    if not live:
        return True
    j_lo, j_hi = min(r[0] for r in live), max(r[1] for r in live)
    freed = {c: set() for c in range(2)}
    filled = j_lo
    pos = [j_lo, j_lo]
    held = [None, None]
    moved = True
    while moved:
        moved = False
        while filled < j_hi and (filled - j_lo < stages or all(
                filled - stages in freed[c] for c in range(2))):
            filled += 1
            moved = True
        for c in range(2):
            k = pos[c]
            if k == j_hi:
                if held[c] is not None:
                    freed[c].add(held[c])
                    held[c] = None
                continue
            if k >= filled:
                continue
            if own[c][0] <= k < own[c][1]:
                if held[c] is not None:
                    freed[c].add(held[c])
                held[c] = k
            else:
                if free_on_skip and held[c] is not None:
                    freed[c].add(held[c])
                    held[c] = None
                freed[c].add(k)
            pos[c] += 1
            moved = True
    return pos == [j_hi, j_hi] and held == [None, None]


# non-causal documents longer than a few tiles: neighbouring q tiles'
# ranges can end many kv tiles apart
LONG_DOCS = [TM.MaskSpec(causal=False, seg_avg=300, seg_seed=seed)
             for seed in range(4)]


@pytest.mark.parametrize("spec", SPECS + LONG_DOCS, ids=lambda t: getattr(
    t, "label", lambda: str(t))())
@pytest.mark.parametrize("s,group", [(256, 1), (640, 1), (640, 3),
                                     (640, 4)])
def test_k4_ring_never_waits_on_a_held_stage(spec, s, group):
    """A consumer holds its last stage until the next stage's S and dP
    retire; over a run of stages outside its range it frees it first, so
    the producer is never left waiting on a stage its consumer holds
    while that consumer waits on the producer."""
    assert "if (held >= 0) {\n        wgmma_wait<0>();" in body("dq_bf16")
    ranges = dq_ranges(spec, s)
    nq = s // C["kBQ"]
    for pair in range(group * nq // 2):
        own = [ranges[(2 * pair + c) // group] for c in range(2)]
        assert k4_ring_runs_to_the_end(own, C["kDqStages"])


def test_the_ring_model_finds_the_hang_it_guards_against():
    """Holding the last stage across skipped stages hangs once the other
    item's range runs on for a ring's depth of stages."""
    own = [(0, 2), (0, 2 + C["kDqStages"])]
    assert k4_ring_runs_to_the_end(own, C["kDqStages"])
    assert not k4_ring_runs_to_the_end(own, C["kDqStages"],
                                       free_on_skip=False)


@pytest.mark.parametrize("spec", SPECS, ids=lambda t: getattr(
    t, "label", lambda: str(t))())
@pytest.mark.parametrize("s", [256, 640, 384])
def test_k5_key_tiles_cover_every_live_tile_once(spec, s):
    """Block (KV head, key tile kt) walks the group's q heads, each over
    q tiles [first, last] of the transposed BlockMask at DKV_TILES: every
    live (q tile, 128-key tile) once per q head, every allowed pair in a
    visited stage; the first key tiles are the longest under causal."""
    ranges = dkv_ranges(spec, s)
    live = live_tiles(spec, s, C["kBQ"], BKD)
    visited = [(qt, kt) for kt, (f, last) in enumerate(ranges)
               for qt in range(f, last + 1)]
    assert len(visited) == len(set(visited))
    assert live <= set(visited)
    if spec == "causal":
        counts = [last + 1 - f for f, last in ranges]
        assert counts == sorted(counts, reverse=True)


def test_wrapper_tiles_are_the_kernels_tiles():
    assert TFA.FWD_TILES == (C["kBQ"], C["kBKf"])
    assert TFA.DQ_TILES == (C["kBQ"], C["kBK"])
    assert TFA.DKV_TILES == (C["kBQ"], BKD)


# ------------------------------------------------------------ K3 forward

def fwd_ranges(spec, s: int) -> list:
    """K3's visit range [j0, j1) of 128-key tiles per q tile (the
    BlockMask at FWD_TILES under a mask)."""
    nq, bkf = s // C["kBQ"], C["kBKf"]
    if spec is None:
        return [(0, s // bkf)] * nq
    if spec == "causal":
        return [(0, (qt * C["kBQ"] + C["kBQ"] - 1) // bkf + 1)
                for qt in range(nq)]
    bm = TM.block_mask(spec, s, *TFA.FWD_TILES)
    return [(int(bm.q_first_k[qt]), int(bm.q_last_k[qt]) + 1)
            for qt in range(s // C["kBQ"])]


def test_the_forward_source_states_the_formulas_this_test_mirrors():
    assert ("static_cast<size_t>(2 * kFwdQSlots +\n"
            "                             2 * (kFwdKStages + kFwdVStages)) *\n"
            "             tile_bytes<DH>();") in SRC
    src = body("fwd_bf16")
    # K4's pairing over persistent units (longest pairs first), the q
    # tiles loaded by TMA into a slot freed when the unit's S retired
    assert src.count("const Items it = pair_items<MODE, kBKf>(mv, hk, G, "
                     "nq, u / nbh);") == 2
    assert src.count("for (int u = blockIdx.x; u < units; u += gridDim.x)"
                     ) == 2
    assert "const int units = B * Hkv * (Hq / Hkv * (S / kBQ) / 2);" in SRC
    assert "kernel<<<units < sms ? units : sms, kWsThreads, smem, stream>>>" \
        in SRC
    assert "mbar_expect_tx(&full_q[rq.slot], 2 * TB);" in src
    assert src.index("if (lane == 0) mbar_arrive(&empty_q[rq.slot]);") > \
        src.rindex("retire_pv<DH>(")
    # separate K and V rings: V j - 1 is loaded after K j
    assert "mbar_expect_tx(&full_k[rk.slot], KT);" in src
    assert "mbar_expect_tx(&full_v[rv.slot], KT);" in src
    assert "b * S + (j - 1) * kBKf);" in src
    assert SRC.count("dim3(B * Hkv, Hq / Hkv * (S / kBQ) / 2)") == 1
    # q rounded in place to bf16(q * scale * log2 e), S from Q and K
    # K-major, p V from register A and V N-major
    assert "scale_bytes(sq, sq, TB, q_mul, tid, 128);" in src
    assert ("wgmma_ss_n128(s, kmajor(qa, ks, kPanel), kmajor(ka, ks, KP),\n"
            "                        ks > 0);") in src
    assert "wgmma_rs<DH>(acc, a[kk], nmajor(va, kk, 2 * kPanel), 1);" in SRC
    assert "const float q_mul = scale * kLog2e;" in SRC


def test_no_mma_sync_is_left_in_the_flash_kernels():
    """K3/K6 left mma.sync, ldmatrix and cp.async with their first
    design: the bf16 forward is the warp-specialised wgmma/TMA template
    too."""
    code = re.sub(r"//[^\n]*", "", SRC)
    for old in ("mma.sync", "ldmatrix", "cp.async", "load_tile", "mma_abt",
                "mma_xb"):
        assert old not in code, old
    src = body("fwd_bf16")
    for new in ("tma_load(", "wgmma_ss_n128(", "reg_release<kRegProducer>()",
                "reg_claim<kRegConsumer>()", "mbar_wait(&empty_k[rk.slot]",
                "mbar_wait(&empty_v[rv.slot]"):
        assert new in src, new
    assert "static_assert(fwd_smem<DH>() <= 232448" in SRC


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_the_forward_fits_shared_memory(dh, mode):
    """K3 holds two slots of the two items' q tiles (the next unit's
    loads while this one finishes) and rings of 128-key K and V tiles."""
    del mode                    # the layout is the same in every mode
    assert C["kFwdKStages"] >= 2 and C["kFwdVStages"] >= 2
    assert C["kFwdQSlots"] == 2
    assert fwd_smem(dh) <= SMEM_LIMIT
    # barriers: full and empty per q slot and per stage of the K ring and
    # the V ring, under the 512 bytes before the tiles
    assert 16 * (C["kFwdQSlots"] + C["kFwdKStages"] + C["kFwdVStages"]) \
        <= 512
    assert tile_bytes(dh) % 1024 == 0


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_the_forward_consumer_fits_its_registers(dh):
    """A K3 consumer holds O (64 x Dh f32), S (64 x 128 f32) and the
    packed p of the stage whose p V is on the tensor cores (8 K steps x 4
    registers) while S is in its softmax, with room left for addresses,
    m, l and the row bounds."""
    o, s, frags = dh // 2, 64, 8 * 4
    assert o + s + frags + 32 <= C["kRegConsumer"]


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_k3_reads_q_and_k_kmajor_and_v_nmajor(dh):
    """S = Q K^T reads the q tile and the 128-key K stage K-major (N =
    128 rows, panels of 128 rows); O += p V reads the V stage N-major (Dh
    is N, the stage's 128 keys the contraction, 8 K steps)."""
    bkf, kp = C["kBKf"], 2 * C["kPanel"]
    q, k, v = ids(64, dh, 6), ids(bkf, dh, 7), ids(bkf, dh, 8)
    qi, ki, vi = tma_image(q), tma_image(k), tma_image(v)
    for ks in range(dh // 16):
        a = kmajor_read(qi, kmajor(0, ks, C["kPanel"]), 64)
        b = kmajor_read(ki, kmajor(0, ks, kp), bkf)
        assert (a == q[:, 16 * ks:16 * ks + 16]).all()
        assert (b == k[:, 16 * ks:16 * ks + 16]).all()
    for kk in range(bkf // 16):
        b = nmajor_read(vi, nmajor(0, kk), dh, kp)
        assert (b == v[16 * kk:16 * kk + 16, :]).all()


@pytest.mark.parametrize("spec", SPECS, ids=lambda t: getattr(
    t, "label", lambda: str(t))())
@pytest.mark.parametrize("s,group", [(128, 1), (256, 2), (640, 3),
                                     (640, 4), (384, 1)])
def test_k3_pairs_cover_every_item_and_live_tile_once(spec, s, group):
    """K3 pairs items as K4 does, over its 128-key tiles (FWD_TILES)."""
    pairs_cover_every_item_and_live_tile_once(spec, s, group,
                                              fwd_ranges(spec, s),
                                              C["kBKf"])


@pytest.mark.parametrize("spec", SPECS + LONG_DOCS, ids=lambda t: getattr(
    t, "label", lambda: str(t))())
@pytest.mark.parametrize("s,group", [(256, 1), (640, 1), (640, 3),
                                     (1024, 3)])
def test_k3_ring_never_waits_on_a_held_stage(spec, s, group):
    """A K3 consumer frees a stage's K once its S retires, and holds the
    V of the stage whose p V is pending until its next stage's S
    retires; over a stage outside its range it retires that p V and
    frees the pending V first, then the stage's K and V, so the V ring
    (modelled) runs to its end."""
    src = body("fwd_bf16")
    skip = src.index("// outside this item's range")
    assert src.index("retire_pv<DH>(acc, a,", skip) < src.index(
        "mbar_arrive(&empty_v[rv.slot]);", skip)
    assert src.index("if (lane == 0) mbar_arrive(&empty_k[rk.slot]);") < \
        src.index("ex2(m[hh] - m_new)")
    ranges = fwd_ranges(spec, s)
    nq = s // C["kBQ"]
    for pair in range(group * nq // 2):
        own = [ranges[(2 * pair + c) // group] for c in range(2)]
        assert k4_ring_runs_to_the_end(own, C["kFwdVStages"])


@pytest.mark.parametrize("units,sms", [(3072, 132), (16, 132), (133, 132),
                                       (1, 132)])
def test_k3_persistent_blocks_take_every_unit_once(units, sms):
    """min(units, SMs) blocks, block k taking units k, k + grid, ...: every
    (pair, KV head) unit once, the longest pairs (the first units) spread
    one a block."""
    grid = min(units, sms)
    taken = [u for k in range(grid) for u in range(k, units, grid)]
    assert sorted(taken) == list(range(units))
    assert all(k < units for k in range(grid))
