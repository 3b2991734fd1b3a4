"""The shared wgmma skeleton of kernels K11 and K12
(``dlnetbench_tpu_torch/ops/csrc/mlp_matmul.cu``, ``wg_gemm_kernel``),
checked where a CPU can check it.

* Its tile, stage, ring, cluster and register constants, read from the
  CUDA source: the wrappers' shape contract matches them, every
  instantiation's shared memory (the f32-master ring included) fits the
  232,448 bytes a block may use on Hopper, and the setmaxnreg split fits
  the 65,536 registers of an SM.
* The quantizer's hand-built 128-byte swizzle of the 8-bit A tile is the
  layout TMA's ``CU_TENSOR_MAP_SWIZZLE_128B`` writes and ``wgmma``
  reads (byte bits 4-6 XOR bits 7-9), and a permutation of the tile.
* ``grouped_matmul.tile_schedule``, the plain-Python model of the
  persistent schedule (units of a pair of row tiles times the cluster's
  column tiles): every live (expert, row tile, column tile) computed
  once, every other tile zeroed once, over GMM_SKEW-like counts.

The kernel itself runs only on a card (tests/test_torch_card_*.py and
chip_smoke.py)."""
from __future__ import annotations

import re
from pathlib import Path

import pytest

from dlnetbench_tpu_torch.ops import grouped_matmul as TG
from dlnetbench_tpu_torch.ops import quantized_matmul as TQ

SRC = (Path(__file__).resolve().parent.parent / "dlnetbench_tpu_torch" /
       "ops" / "csrc" / "mlp_matmul.cu").read_text()
SMEM_LIMIT = 232448          # dynamic shared memory a block may use
REGS_PER_SM = 65536
# chip_smoke.py's skewed counts: a full expert, an empty one, ragged tails
GMM_SKEW = [1280, 1000, 0, 17, 640, 1280, 129, 1]


def const(name: str) -> int:
    """A ``constexpr int name = <int>;`` of the CUDA source (also the
    second of ``constexpr int a = 1, name = 2;``)."""
    m = re.search(rf"constexpr int (?:\w+ = \d+, )?{name} = (\d+)[,;]", SRC)
    assert m, f"constexpr int {name} not found in mlp_matmul.cu"
    return int(m.group(1))


C = {n: const(n) for n in (
    "kBM", "kBN", "kRowBytes", "kQ8K", "kBf16K", "kStageA", "kStageW",
    "kMaxWStages", "kSmemBudget", "kSmemExtra", "kWgThreads",
    "kQuantWarps", "kRegLoader", "kRegConsumer", "kRegLoaderE4M3",
    "kRegConsumerE4M3", "kRegProducer", "kRegConsumerBf16")}


def ring(name: str) -> dict:
    """The depths ``x_stages<CL>()`` / ``a_stages<CL>()`` return, by CL."""
    body = re.search(rf"constexpr int {name}\(\) {{\s*return ([^;]+);", SRC)
    assert body, name
    expr = body.group(1)
    m = re.fullmatch(r"CL == 1 \? (\d+) : CL == 2 \? (\d+) : (\d+)", expr)
    if m:
        return dict(zip((1, 2, 4), map(int, m.groups())))
    m = re.fullmatch(r"CL == 1 \? (\d+) : (\d+)", expr)
    assert m, expr
    return {1: int(m.group(1)), 2: int(m.group(2)), 4: int(m.group(2))}


X_STAGES, A_STAGES = ring("x_stages"), ring("a_stages")


def x_stage(elt: int, cl: int) -> int:
    return C["kBM"] // cl * C["kQ8K"] * elt


def w_stages_q8(elt: int, cl: int) -> int:
    free = (C["kSmemBudget"] - X_STAGES[cl] * x_stage(elt, cl)
            - A_STAGES[cl] * C["kStageA"])
    return min(C["kMaxWStages"], free // C["kStageW"])


def smem_q8(elt: int, cl: int) -> int:
    return (C["kSmemExtra"] + w_stages_q8(elt, cl) * C["kStageW"]
            + A_STAGES[cl] * C["kStageA"]
            + X_STAGES[cl] * x_stage(elt, cl))


def test_the_source_states_the_formulas_this_test_mirrors():
    assert "kSmemBudget - x_stages<CL>() * x_stage_bytes<TX, CL>() -" in SRC
    assert "a_stages<CL>() * kStageA) / kStageW" in SRC
    assert "kBM / CL * kQ8K * static_cast<int>(sizeof(TX))" in SRC
    assert "kSmemBudget / (kStageA + kStageW)" in SRC
    assert re.search(r"int g_cluster = (\d+);", SRC)
    assert "mma.sync" not in SRC[SRC.index("K11 / K12: the wgmma skeleton"):
                                 SRC.index("K9 dg/du")]


def test_contract_matches_the_tiles():
    assert (TQ.TILE_M, TQ.TILE_N) == (C["kBM"], C["kBN"])
    assert (TG.TILE_N, TG.TILE_K) == (C["kBN"], TQ.TILE_K)
    # a stage row is 128 bytes of contraction: 128 8-bit or 64 bf16
    # values; the 8-bit contract (K % 64) leaves at most a half stage,
    # the bf16 one whole stages
    assert C["kRowBytes"] == 128 == C["kQ8K"] == 2 * C["kBf16K"]
    assert TQ.TILE_K == C["kQ8K"] // 2 == C["kBf16K"]
    assert C["kStageA"] == C["kBM"] * C["kRowBytes"]
    assert C["kStageW"] == C["kBN"] * C["kRowBytes"] \
        == C["kBf16K"] * C["kBN"] * 2
    # the default cluster is one of the built sizes
    assert int(re.search(r"int g_cluster = (\d+);", SRC).group(1)) \
        in TQ.CLUSTERS


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16_master", "f32_master"])
@pytest.mark.parametrize("cl", TQ.CLUSTERS)
def test_every_8bit_instantiation_fits_shared_memory(elt, cl):
    stages = w_stages_q8(elt, cl)
    assert stages >= 2, "the weight ring needs two stages to overlap"
    assert X_STAGES[cl] >= 2 and A_STAGES[cl] >= 2
    assert smem_q8(elt, cl) <= SMEM_LIMIT
    # the quantizer's eight-value passes tile its 128 / cl rows exactly
    assert (C["kBM"] // cl) % 8 == 0
    # TMA boxes: at most 256 elements a dimension; the 1024-byte
    # alignment of every stage holds
    assert C["kQ8K"] <= 256 and C["kBM"] // cl <= 256
    assert x_stage(elt, cl) % 1024 == 0
    assert C["kStageA"] % 1024 == 0 and C["kStageW"] % 1024 == 0


def test_the_f32_master_ring_fits():
    """The f32 x stage is twice the bf16 one: it leaves two or three
    weight stages where the bf16 master leaves three or four."""
    assert [w_stages_q8(4, cl) for cl in (1, 2, 4)] == [2, 2, 3]
    assert [w_stages_q8(2, cl) for cl in (1, 2, 4)] == [4, 3, 4]
    assert max(smem_q8(4, cl) for cl in (1, 2, 4)) <= SMEM_LIMIT


def test_the_bf16_instantiation_fits_shared_memory():
    stages = C["kSmemBudget"] // (C["kStageA"] + C["kStageW"])
    assert stages == 4
    assert C["kSmemExtra"] + stages * (C["kStageA"] + C["kStageW"]) \
        <= SMEM_LIMIT


def test_register_split_fits_the_sm():
    regs = [C[k] for k in ("kRegLoader", "kRegConsumer", "kRegLoaderE4M3",
                           "kRegConsumerE4M3", "kRegProducer",
                           "kRegConsumerBf16")]
    assert all(24 <= r <= 256 and r % 8 == 0 for r in regs)
    # three warpgroups: WG 0 (the producer warp and, 8-bit, the quantizer
    # warps) and two consumers
    assert C["kWgThreads"] == 3 * 128 and C["kQuantWarps"] == 3
    # ptxas compiles the kernel under 65536 / threads registers a thread
    # (rounded down to 8); a wgmma with a 64 x 256 accumulator (128
    # registers a thread) asked for 154 or more when a 512-thread build
    # (128 a thread) was refused on an H100 80GB HBM3
    cap = REGS_PER_SM // C["kWgThreads"] // 8 * 8
    assert cap >= 154
    # setmaxnreg moves registers within the block's pool at launch; an
    # inc past it waits for ever (the first 8-bit build, 80 + 2 x 216,
    # hung on the card)
    pool = C["kWgThreads"] * cap
    assert 128 * (C["kRegLoader"] + 2 * C["kRegConsumer"]) <= pool
    assert 128 * (C["kRegLoaderE4M3"] + 2 * C["kRegConsumerE4M3"]) <= pool
    assert 128 * (C["kRegProducer"] + 2 * C["kRegConsumerBf16"]) <= pool
    assert min(C["kRegConsumer"], C["kRegConsumerE4M3"],
               C["kRegConsumerBf16"]) >= 154


def quantizer_offset(row: int, g: int) -> int:
    """The quantizer's byte offset of values 8 (g % 2) .. of 16-byte
    chunk g // 2 in row `row` of the A stage (mlp_matmul.cu)."""
    return row * 128 + ((((g >> 1) ^ row) & 7) << 4) + (g & 1) * 8


def tma_swizzle_128b(byte: int) -> int:
    """Where TMA's 128-byte swizzle puts logical byte `byte` of a tile
    with 128-byte rows, 1024-byte aligned (CUTLASS's Swizzle<3,4,3>)."""
    return byte ^ (((byte >> 7) & 7) << 4)


def test_quantizer_writes_the_tma_swizzle():
    seen = set()
    for row in range(C["kBM"]):
        for g in range(16):
            off = quantizer_offset(row, g)
            assert off == tma_swizzle_128b(row * 128 + g * 8)
            seen.add(off)
    assert seen == set(range(0, C["kStageA"], 8))


def test_quantizer_stores_are_bank_conflict_free():
    """The quantizer's warps take 32 consecutive items f (a warp starts
    at a multiple of 32); a half warp (16 lanes, 8 bytes each) stores one
    row's 128 bytes: 32 distinct banks."""
    for f0 in range(0, C["kBM"] * 16, 16):
        banks = set()
        for f in range(f0, f0 + 16):
            off = quantizer_offset(f >> 4, f & 15)
            banks |= {(off // 4) % 32, (off // 4 + 1) % 32}
        assert len(banks) == 32


def check_schedule(counts, m, n, cluster, clusters):
    computed, dead = TG.tile_schedule(counts, m, n, cluster, clusters)
    mt, nt = -(-m // 128), n // 256
    cnt = counts if counts is not None else [m]
    live_rows = [min(max(c, 0), m) for c in cnt]
    want_live = {(e, tm, tn) for e, c in enumerate(live_rows)
                 for tm in range(-(-c // 128)) for tn in range(nt)}
    every = {(e, tm, tn) for e in range(len(cnt)) for tm in range(mt)
             for tn in range(nt)}
    got = [t for c in computed for t in c]
    got_dead = [t for b in dead for t in b]
    # each tile computed at most once, every live tile among them
    assert len(got) == len(set(got)) and want_live <= set(got)
    # a computed tile that is not live is the second of a pair: its rows
    # lie wholly past the count (zeros) or past the buffer (not written)
    for e, tm, _ in set(got) - want_live:
        assert tm % 2 == 1 and (e, tm - 1, 0) in want_live
        assert tm * 128 >= live_rows[e]
    # every other tile of the buffer is zeroed, once, by one block
    assert len(got_dead) == len(set(got_dead))
    assert set(got_dead) == every - set(got)
    for e, tm, _ in got_dead:
        assert tm * 128 >= live_rows[e]
    # a cluster's blocks take a pair of row tiles times `cluster`
    # neighbouring column tiles
    for c in computed:
        for i in range(0, len(c), 2 * cluster):
            group = c[i:i + 2 * cluster]
            (e0, tm0, tn0) = group[0]
            assert tm0 % 2 == 0 and tn0 % cluster == 0
            assert group == [(e0, tm0 + r, tn0 + x) for r in range(2)
                             for x in range(cluster)]
    return computed, dead


@pytest.mark.parametrize("cluster", TQ.CLUSTERS)
@pytest.mark.parametrize("clusters", [1, 7, 16, 33, 66])
def test_schedule_visits_each_live_tile_once_under_skew(cluster, clusters):
    # the moe_ab gate/up shape: 8 experts x 1280 slots, N = 7168
    check_schedule(GMM_SKEW, 1280, 7168, cluster, clusters)


@pytest.mark.parametrize("counts", [
    [300, 0, 128, 17, 256, 129, 1, 255], [0, 0, 0], [5], [-3, 400, 129]])
def test_schedule_ragged_counts_and_buffers(counts):
    """Counts past the buffer (clipped), negative (none), a buffer that
    128 does not divide, an odd number of row tiles."""
    for cluster in (1, 2):
        check_schedule(counts, 300, 512, cluster, 3)


def test_schedule_of_k11_is_every_tile_in_raster_groups():
    """K11 (one expert, every row live) at the up projection: 96 x 56
    tiles; a wave of 33 clusters of 2 x 2 covers 16 row tiles over 10
    columns, so its operands are few panels of x and w."""
    computed, dead = check_schedule(None, 12288, 14336, 2, 33)
    assert not any(dead)
    assert sum(len(c) for c in computed) == 96 * 56
    wave = [t for c in computed for t in c[:4]]
    assert {tm for _, tm, _ in wave} == set(range(16))
    assert len({tn for _, _, tn in wave}) <= 10


def test_an_empty_expert_gets_only_zeros():
    computed, dead = check_schedule([0, 256], 256, 512, 1, 4)
    assert all(e == 1 for c in computed for e, _, _ in c)
    assert sorted(t for b in dead for t in b) == [(0, 0, 0), (0, 0, 1),
                                                  (0, 1, 0), (0, 1, 1)]


def test_an_odd_tail_pairs_with_a_zeroed_tile():
    """129 live rows: row tiles 0 and 1 live, 2 and 3 (one pair) dead;
    17 live rows: tile 0 live, tile 1 computed with it (zeros)."""
    computed, dead = check_schedule([129, 17], 512, 256, 1, 2)
    got = {t for c in computed for t in c}
    assert got == {(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)}
    assert sorted(t for b in dead for t in b) == [(0, 2, 0), (0, 3, 0),
                                                  (1, 2, 0), (1, 3, 0)]
