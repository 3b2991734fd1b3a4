"""The port's spine against the JAX package's: the stats files and their
generator, the roofline counts, the schedule algebra, and the small
pure helpers the proxies share.  Everything here is host math, held
exactly (same exception type for every invariant error)."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from dlnetbench_tpu import stats_gen as J_gen
from dlnetbench_tpu.core import hardware as J_hw
from dlnetbench_tpu.core import model_card as J_card
from dlnetbench_tpu.core import model_stats as J_stats
from dlnetbench_tpu.core import roofline as J_roof
from dlnetbench_tpu.core import schedule as J_sched
from dlnetbench_tpu.metrics import stats as J_mstats
from dlnetbench_tpu.parallel import buffers as J_buf
from dlnetbench_tpu.proxies import base as J_base
from dlnetbench_tpu_torch import stats_gen as T_gen
from dlnetbench_tpu_torch.core import hardware as T_hw
from dlnetbench_tpu_torch.core import model_card as T_card
from dlnetbench_tpu_torch.core import model_stats as T_stats
from dlnetbench_tpu_torch.core import roofline as T_roof
from dlnetbench_tpu_torch.core import schedule as T_sched
from dlnetbench_tpu_torch.metrics import stats as T_mstats
from dlnetbench_tpu_torch.parallel import buffers as T_buf
from dlnetbench_tpu_torch.proxies import base as T_base

REPO = Path(__file__).resolve().parent.parent
JAX_STATS = sorted((REPO / "dlnetbench_tpu" / "data" / "model_stats")
                   .glob("*.txt"))
PORT_STATS = REPO / "dlnetbench_tpu_torch" / "data" / "model_stats"
CARDS = T_card.list_model_cards()
GRID = [(c, b, dt) for c in CARDS for b in T_gen.BATCH_GRID
        for dt in T_gen.DTYPE_GRID]


def same(a, b) -> bool:
    """Two dataclasses of the two packages hold equal fields."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def both(fn_j, fn_t, *args, **kwargs):
    """Both packages' results, or both exceptions' types."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(fn(*args, **kwargs))
        except Exception as e:          # compared by type below
            out.append(type(e))
    return out


# ------------------------------------------------------------ stats files
def test_the_grids_cover_every_file():
    assert len(JAX_STATS) == 72
    assert sorted(p.name for p in PORT_STATS.glob("*.txt")) == sorted(
        f"{c}_{b}_{dt}.txt" for c, b, dt in GRID)
    assert len(GRID) == 72


@pytest.mark.parametrize("path", JAX_STATS, ids=lambda p: p.stem)
def test_jax_stats_file_parses_alike_and_round_trips(path):
    text = path.read_text()
    j = J_stats.parse_stats_text(path.stem, text)
    t = T_stats.parse_stats_text(path.stem, text)
    assert same(j, t)
    assert t.model_bytes == j.model_bytes
    assert t.to_text() == j.to_text()
    again = T_stats.parse_stats_text(path.stem, t.to_text())
    assert again.to_text() == t.to_text() and same(again, t)


@pytest.mark.parametrize("card,batch,dtype", GRID)
def test_port_stats_file_is_the_generator_output(card, batch, dtype):
    name = f"{card}_{batch}_{dtype}"
    text = (PORT_STATS / f"{name}.txt").read_text()
    gen = T_gen.generate_stats(T_card.load_model_card(card), batch, dtype)
    assert gen.device == "NVIDIA H100 SXM"
    assert text == gen.to_text()                 # byte for byte
    assert same(T_stats.load_model_stats(name),
                T_stats.parse_stats_text(name, gen.to_text()))


def test_llama3_8b_h100_times_are_its_roofline():
    s = T_stats.load_model_stats("llama3_8b_16_bfloat16")
    assert s.forward_flops == 2392537302040576
    assert s.model_size == 8030261248
    # compute-bound at the H100's bf16 peak
    assert s.fwd_us == pytest.approx(s.forward_flops / 989e12 * 1e6,
                                     abs=0.01)
    assert s.bwd_us == pytest.approx(2 * s.fwd_us, abs=0.01)


def test_stats_parse_errors_alike():
    for text in ("Forward_Flops 12", "Forward_Flops:1\n"):
        j, t = both(J_stats.parse_stats_text, T_stats.parse_stats_text,
                    "x", text)
        assert j is t is ValueError
    j, t = both(J_stats.load_model_stats, T_stats.load_model_stats,
                "no_such_model_16_bfloat16")
    assert j is t is FileNotFoundError


# ------------------------------------------------------------ roofline
@pytest.mark.parametrize("card", CARDS)
def test_flop_and_byte_counts_are_jax_integers(card):
    jc, tc = J_card.load_model_card(card), T_card.load_model_card(card)
    assert tc.num_params() == jc.num_params()
    assert tc.non_expert_params() == jc.non_expert_params()
    for b in (1, 2, 16, 32, 64, 128):
        for fn in ("attention_flops", "mlp_flops", "model_flops"):
            assert getattr(T_roof, fn)(tc, b) == getattr(J_roof, fn)(jc, b)
        for dt in ("bfloat16", "float8", "float32", "int8"):
            assert T_roof.model_bytes(tc, b, dt) == \
                J_roof.model_bytes(jc, b, dt)
            assert T_roof.train_step_bytes(tc, b, dt) == \
                J_roof.train_step_bytes(jc, b, dt)


@pytest.mark.parametrize("card", CARDS)
def test_times_equal_the_jax_generator_on_the_h100_spec(card, monkeypatch):
    spec = T_hw.HARDWARE["h100_sxm"]
    monkeypatch.setitem(J_hw.HARDWARE, "h100_sxm", J_hw.HardwareSpec(
        name=spec.name, peak_flops=dict(spec.peak_flops),
        hbm_bandwidth=spec.hbm_bandwidth, hbm_capacity=spec.hbm_capacity))
    jc, tc = J_card.load_model_card(card), T_card.load_model_card(card)
    assert T_roof.BWD_FWD_RATIO == J_roof.BWD_FWD_RATIO
    for b in T_gen.BATCH_GRID:
        for dt in T_gen.DTYPE_GRID:
            for fn in ("forward_time_s", "ffn_forward_time_s",
                       "train_step_time_s"):
                assert getattr(T_roof, fn)(tc, b, dt, "h100_sxm") == \
                    getattr(J_roof, fn)(jc, b, dt, "h100_sxm")
            j = J_gen.generate_stats(jc, b, dt, "h100_sxm")
            t = T_gen.generate_stats(tc, b, dt, "h100_sxm")
            assert same(j, t) and j.to_text() == t.to_text()


def test_card_listing_and_arch_names():
    assert T_card.list_model_cards() == J_card.list_model_cards()
    rng = np.random.default_rng(0)
    words = ["llama3", "8b", "16", "bfloat16", "x", "", "mixtral", "8x7b"]
    names = ["_".join(rng.choice(words, size=rng.integers(0, 6)))
             for _ in range(300)]
    names += [p.stem for p in JAX_STATS] + ["a_b", "ab", ""]
    for n in names:
        j, t = both(J_card.arch_name_from_stats_name,
                    T_card.arch_name_from_stats_name, n)
        assert j == t, n


# ------------------------------------------------------------ schedules
def _stats_pair(name):
    """The JAX file parsed by each package: the same numbers on both
    sides."""
    js = J_stats.load_model_stats(name)
    return js, T_stats.parse_stats_text(name, js.to_text())


def _cards_pair(stats_name):
    arch = T_card.arch_name_from_stats_name(stats_name)
    return J_card.load_model_card(arch), T_card.load_model_card(arch)


SCHED_MODELS = ["gpt2_l_16_bfloat16", "llama3_8b_32_float8",
                "llama3_70b_128_bfloat16", "mixtral_8x7b_16_bfloat16",
                "vit_b_64_float8"]


@pytest.mark.parametrize("name", SCHED_MODELS)
def test_dp_and_fsdp_schedules_are_jax(name):
    js, ts = _stats_pair(name)
    for n in (0, 1, 3, 8, 13, -2):
        j, t = both(lambda: J_sched.dp_schedule(js, n),
                    lambda: T_sched.dp_schedule(ts, n))
        if isinstance(j, type):
            assert j is t
        else:
            assert same(j, t) and j.bucket_bytes == t.bucket_bytes
    for units in (1, 4, 8, 7):
        for world, sf in ((1, None), (4, None), (4, 2), (8, 2), (8, 8),
                          (6, 4), (4, 3), (2, 1)):
            j, t = both(lambda: J_sched.fsdp_schedule(js, units, world, sf),
                        lambda: T_sched.fsdp_schedule(ts, units, world, sf))
            if isinstance(j, type):
                assert j is t
            else:
                assert same(j, t)
                assert j.padded_unit_size == t.padded_unit_size


@pytest.mark.parametrize("name", SCHED_MODELS)
def test_pipeline_moe_and_sequence_schedules_are_jax(name):
    js, ts = _stats_pair(name)
    jc, tc = _cards_pair(name)
    for stages in (1, 2, 3, 4, 5):
        for mbs in (1, 2, 3, 4, 8):
            for dp, tp in ((1, 1), (2, 1), (1, 2), (2, 4)):
                j, t = both(
                    lambda: J_sched.pipeline_schedule(
                        js, jc, num_stages=stages, num_microbatches=mbs,
                        dp=dp, tp=tp),
                    lambda: T_sched.pipeline_schedule(
                        ts, tc, num_stages=stages, num_microbatches=mbs,
                        dp=dp, tp=tp))
                if isinstance(j, type):
                    assert j is t
                else:
                    assert same(j, t) and j.num_stages == t.num_stages
            for ep in (1, 2, 3, 8):
                j, t = both(
                    lambda: J_sched.moe_schedule(
                        js, jc, num_stages=stages, num_microbatches=mbs,
                        num_expert_shards=ep, dp=2),
                    lambda: T_sched.moe_schedule(
                        ts, tc, num_stages=stages, num_microbatches=mbs,
                        num_expert_shards=ep, dp=2))
                if isinstance(j, type):
                    assert j is t
                else:
                    assert same(j, t) and same(j.grid, t.grid)
    for sp in (1, 2, 3, 4, 7, 8):
        for batch in (None, 1, 5):
            j, t = both(lambda: J_sched.sequence_schedule(js, jc, sp, batch),
                        lambda: T_sched.sequence_schedule(ts, tc, sp, batch))
            if isinstance(j, type):
                assert j is t
            else:
                assert same(j, t)


def test_zb_tables_and_grids_are_jax():
    for s in range(0, 7):
        for m in range(0, 10):
            j, t = both(J_sched.zb_tables, T_sched.zb_tables, s, m)
            if isinstance(j, type):
                assert j is t
                continue
            assert same(j, t) and j.ticks == t.ticks
            assert j.f_senders(s) == t.f_senders(s)
            assert j.b_senders() == t.b_senders()
            for units in (1.0, 2.0, 3.0):
                assert J_sched.zb_unit_ticks(j, units) == \
                    T_sched.zb_unit_ticks(t, units)
    for dp, pp, tp in ((1, 1, 1), (2, 3, 4), (4, 2, 1), (1, 4, 2)):
        jg, tg = J_sched.Grid3D(dp, pp, tp), T_sched.Grid3D(dp, pp, tp)
        assert jg.world_size == tg.world_size
        for r in range(jg.world_size):
            assert jg.coords(r) == tg.coords(r)
            assert jg.rank(*jg.coords(r)) == tg.rank(*tg.coords(r)) == r
            for c in ("dp_color", "pp_color", "tp_color"):
                assert getattr(jg, c)(r) == getattr(tg, c)(r)
    for total in (0, 1, 7, 8030261248):
        for n in (1, 3, 8, 0, -1):
            j, t = both(J_sched.split_buckets, T_sched.split_buckets,
                        total, n)
            assert j == t


# ------------------------------------------------------------ helpers
def test_overlap_fraction_is_jax_on_random_samples():
    rng = np.random.default_rng(1)
    for _ in range(200):
        n = int(rng.integers(0, 6))
        full, comp, comm = (list(rng.uniform(-1, 5, n)) for _ in range(3))
        if rng.random() < 0.3:
            comm = [c * 1e-5 for c in comm]          # degenerate leg
        assert T_mstats.overlap_fraction(full, comp, comm) == \
            J_mstats.overlap_fraction(full, comp, comm)


def test_run_estimation_and_chains_are_jax():
    rng = np.random.default_rng(2)
    for _ in range(300):
        w = list(rng.uniform(0, 0.5, int(rng.integers(1, 7))))
        if rng.random() < 0.2:
            w = [0.0] * len(w)
        m = float(rng.uniform(0, 10))
        skip = int(rng.integers(0, 4))
        assert T_base.estimate_runs(w, m, skip) == \
            J_base.estimate_runs(w, m, skip)
        runs, k = int(rng.integers(0, 40)), int(rng.integers(-1, 9))
        assert T_base._chain_sizes(runs, k) == J_base._chain_sizes(runs, k)


def test_median_us_is_jax():
    from dlnetbench_tpu.utils import timing as J_timing
    from dlnetbench_tpu_torch.utils import timing as T_timing
    rng = np.random.default_rng(4)
    for n in range(1, 40):
        x = list(rng.uniform(0, 1, n))
        assert T_timing.median_us(x) == J_timing.median_us(x)


def test_scaled_elems_is_jax():
    rng = np.random.default_rng(3)
    for _ in range(500):
        elems = int(rng.integers(0, 10 ** 10))
        scale = float(rng.choice([1.0, 2.0, 1e-5, 0.5, rng.uniform(0, 1)]))
        minimum = int(rng.choice([128, 1, 0]))
        assert T_buf.scaled_elems(elems, scale, minimum) == \
            J_buf.scaled_elems(elems, scale, minimum)
