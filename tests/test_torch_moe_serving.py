"""MoE decode in the torch port's serving tier, held against the JAX
package on the CPU (the port's counterpart of tests/test_moe_serving.py):
``moe_mlp_rounds`` against JAX's (output within 1e-5 of max-abs, f32;
``load`` and ``rounds`` exact; inactive slots masked; lossless against
the unbatched gated sum), ``skew_bias`` bit-equal, the engine's greedy
streams equal to the JAX engine's at N=1 and N=4 and over an int8
cache, the seeded skew raising rounds and imbalance, speculation
refused with JAX's message, ``moe_skew`` validation, the flight ring's
MoE fields, and the record's ``moe`` block equal to JAX's and read by
the port's parser and ``serving_summary`` as JAX's record is.  Tiny f32
models, weights handed over through numpy."""
from __future__ import annotations

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import moe_decode as JMD
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu.serving.scheduler import Engine as JEngine
from dlnetbench_tpu.serving.scheduler import ServingConfig as JServing
from dlnetbench_tpu.serving.scheduler import run_serving as j_run_serving
from dlnetbench_tpu_torch.metrics import telemetry as TT
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import decode as TD
from dlnetbench_tpu_torch.serving import moe_decode as TMD
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan

import scripted_clock

# tests/test_moe_serving.py's model and engine
MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=32, num_experts=4, top_k=2,
             moe_capacity_factor=1.0)
SERVING = dict(slots=4, page_size=4, num_pages=64, max_seq_len=32,
               warmup_requests=0)
PLAN = dict(kind="poisson", rate_rps=200.0, num_requests=6, seed=0,
            prompt_len=[4, 8], output_len=[4, 6])
# every arrival at t=0: the decode batches, so the rounds, are fixed by
# the admission order alone
T0_PLAN = dict(kind="replay", seed=0, prompt_len=[4, 8], output_len=[4, 6],
               trace=[{"t": 0.0}] * 6)
# the round outputs: f32 sums in another order than XLA's einsums
Y_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(**over):
    return jtfm.TransformerConfig(**{**MODEL, **over}, gated=True,
                                  max_positions=0, dtype="float32")


def torch_model(**over):
    return ttfm.TransformerConfig(**{**MODEL, **over}, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jp = jtfm.init_params(jax.random.key(0), jax_model())
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def jax_engine_runs(weights):
    """The JAX engine per config override, built and run once per
    module: ``(token_streams, moe_block)``."""
    memo: dict = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in memo:
            eng = JEngine(jax_model(), JServing(**{**SERVING, **kw}),
                          params=weights[0])
            done, _ = scripted_clock.run(eng,
                                         JPlan.from_dict(PLAN).sample())
            assert len(done) == PLAN["num_requests"]
            memo[key] = (dict(eng.token_streams), eng.moe_block())
        return memo[key]
    return get


def port_engine(tp, model=None, **kw):
    return TS.Engine(model or torch_model(),
                     TS.ServingConfig(**{**SERVING, **kw}), params=tp,
                     device="cpu")


def port_run(tp, plan=PLAN, **kw):
    eng = port_engine(tp, **kw)
    reqs = TPlan.from_dict(plan).sample()
    done, _ = scripted_clock.run(eng, reqs)
    assert len(done) == len(reqs)
    assert eng.cache.pages_in_use == 0
    return dict(eng.token_streams), eng


# ---------------------------------------------------------------------
# the MLP itself


def _mlp_inputs(seed, b=8, d=16, e=4, h=24):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            rng.randn(d, e).astype(np.float32),
            (rng.randn(e, d, h) * 0.1).astype(np.float32),
            (rng.randn(e, d, h) * 0.1).astype(np.float32),
            (rng.randn(e, h, d) * 0.1).astype(np.float32))


def _both(arrs, *, top_k, capacity, bias=None, active=None):
    jy, jl, jr = JMD.moe_mlp_rounds(
        *map(jnp.asarray, arrs), top_k=top_k, capacity=capacity,
        bias=None if bias is None else jnp.asarray(bias),
        active=None if active is None else jnp.asarray(active))
    ty, tl, tr = TMD.moe_mlp_rounds(
        *map(torch.from_numpy, arrs), top_k=top_k, capacity=capacity,
        bias=None if bias is None else torch.from_numpy(bias),
        active=None if active is None else torch.from_numpy(active))
    return (np.asarray(jy), np.asarray(jl), int(jr)), \
        (ty.numpy(), tl.numpy(), tr)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("top_k,capacity", [(2, 1), (2, 3), (1, 2),
                                            (2, 16)])
def test_moe_mlp_rounds_matches_jax(seed, top_k, capacity):
    """Output within Y_TOL of max-abs, the per-expert load and the round
    count exact, at capacities forcing one round to many, with a seeded
    skew bias and a slot mask."""
    arrs = _mlp_inputs(seed)
    bias = np.array(JMD.skew_bias(4, 3.0, seed))
    active = np.random.RandomState(seed + 9).rand(8) < 0.7
    for kw in ({}, {"bias": bias, "active": active}):
        (jy, jl, jr), (ty, tl, tr) = _both(arrs, top_k=top_k,
                                           capacity=capacity, **kw)
        np.testing.assert_array_equal(tl, jl)
        assert tr == jr
        assert np.abs(ty - jy).max() <= Y_TOL * max(np.abs(jy).max(), 1.0)
        assert tl.dtype == np.int32


def test_moe_mlp_rounds_lossless_vs_unbatched_sum():
    """At capacity 1 (several rounds) the result is the top-k gated sum
    computed token by token, and every routed pair counted once."""
    x, wr, wg, wu, wd = _mlp_inputs(0)
    y, load, rounds = TMD.moe_mlp_rounds(
        *map(torch.from_numpy, (x, wr, wg, wu, wd)), top_k=2, capacity=1)
    assert rounds >= 2 and int(load.sum()) == 8 * 2
    logits = x @ wr
    ref = np.zeros_like(x)
    for t in range(8):
        top = np.argsort(-logits[t], kind="stable")[:2]
        w = np.exp(logits[t, top] - logits[t, top].max())
        w /= w.sum()
        for j, e in enumerate(top):
            g = x[t] @ wg[e]
            hh = g / (1.0 + np.exp(-g)) * (x[t] @ wu[e])
            ref[t] += w[j] * (hh @ wd[e])
    assert np.abs(y.numpy() - ref).max() < 1e-4


def test_moe_mlp_rounds_masks_inactive_slots():
    """Inactive rows occupy no capacity, report no load and get zeros;
    no active row runs no round (JAX: the loop never trips)."""
    x, wr, wg, wu, wd = _mlp_inputs(0, b=4)
    ts = [torch.from_numpy(a) for a in (x, wr, wg, wu, wd)]
    active = torch.tensor([True, False, True, False])
    before = TMD.host_reads
    y, load, rounds = TMD.moe_mlp_rounds(*ts, top_k=1, capacity=4,
                                         active=active)
    assert int(load.sum()) == 2
    assert float(y[1].abs().max()) == 0.0 == float(y[3].abs().max())
    _, load0, rounds0 = TMD.moe_mlp_rounds(
        *ts, top_k=1, capacity=4, active=torch.zeros(4, dtype=torch.bool))
    assert rounds0 == 0 and int(load0.sum()) == 0
    assert TMD.host_reads - before == 2        # one round count a call


def test_skew_bias_bit_equal_to_jax_and_off_at_zero():
    assert TMD.skew_bias(4, 0.0, 3) is None and JMD.skew_bias(4, 0.0, 3) \
        is None
    for e, skew, seed in ((4, 10.0, 3), (8, 50.0, 1), (8, 0.37, 12)):
        t = TMD.skew_bias(e, skew, seed)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(JMD.skew_bias(e, skew,
                                                               seed)))
    assert not torch.equal(TMD.skew_bias(4, 10.0, 3),
                           TMD.skew_bias(4, 10.0, 4))


def test_decode_capacity_matches_jax():
    for args in ((4, 2, 4, 1.0), (8, 2, 8, 1.0), (64, 2, 8, 1.0),
                 (3, 1, 8, 1.25), (16, 2, 8, 0.5)):
        assert TMD.decode_capacity(*args) == JMD.decode_capacity(*args)


# ---------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("n", [1, 4])
def test_moe_streams_equal_jax(weights, jax_engine_runs, n):
    """Greedy MoE streams equal the JAX engine's (N=1) at N=1 and N=4;
    the fused loop's accumulated stats reach the host (every routed
    pair counted: top_k per active slot per step)."""
    _, tp = weights
    want, _ = jax_engine_runs()
    got, eng = port_run(tp, multi_step_n=n)
    assert got == want
    blk = eng.moe_block()
    assert blk["dispatches"] > 0 and blk["rounds_mean"] > 0
    assert len(blk["expert_load"]) == 4
    assert abs(sum(blk["expert_load"]) - 1.0) < 1e-5


def test_moe_fused_stats_equal_one_step_and_jax(weights, jax_engine_runs):
    """The JAX fused engine (N=4) against the port's on the same plan:
    equal streams and equal ``moe`` blocks, measured on the same
    dispatch windows."""
    _, tp = weights
    want, jblk = jax_engine_runs(multi_step_n=4)
    got, eng = port_run(tp, multi_step_n=4)
    assert got == want
    tblk = eng.moe_block()
    for key in ("expert_load", "load_imbalance", "num_experts", "top_k",
                "capacity_factor", "prefill_dispatches",
                "prefill_rounds_mean"):
        assert tblk[key] == jblk[key], key


def test_moe_quantized_cache_composes(weights, jax_engine_runs):
    """MoE decode over an int8 cache: streams equal the JAX int8 MoE
    engine's, at N=1 and N=4."""
    _, tp = weights
    want, _ = jax_engine_runs(cache_dtype="int8")
    for n in (1, 4):
        got, _ = port_run(tp, cache_dtype="int8", multi_step_n=n)
        assert got == want


def test_moe_skew_raises_rounds_and_imbalance():
    """The seeded skew concentrates routing (imbalance up) and
    overflows the per-round capacity (rounds up) on the same plan; at
    top-1 with full concentration every token lands on one expert."""
    mc = torch_model(num_experts=8, top_k=1, seq_len=64)
    tp = ttfm.init_params(mc, seed=0, device="cpu")
    plan = dict(kind="poisson", rate_rps=400.0, num_requests=10, seed=0,
                prompt_len=[4, 8], output_len=[6, 10])
    blocks = {}
    for skew in (0.0, 50.0):
        eng = port_engine(tp, model=mc, slots=8, num_pages=160,
                          moe_skew=skew, moe_skew_seed=1)
        scripted_clock.run(eng, TPlan.from_dict(plan).sample())
        blocks[skew] = eng.moe_block()
    b, s = blocks[0.0], blocks[50.0]
    assert s["load_imbalance"] > b["load_imbalance"]
    assert s["rounds_mean"] > b["rounds_mean"]
    assert s["load_imbalance"] == pytest.approx(8.0)


def test_moe_speculative_refused_with_jax_message(weights):
    _, tp = weights
    with pytest.raises(ValueError) as te:
        port_engine(tp, speculative=True, multi_step_n=2)
    with pytest.raises(ValueError) as je:
        JEngine(jax_model(), JServing(**{**SERVING, "speculative": True,
                                         "multi_step_n": 2}))
    assert str(te.value) == str(je.value)
    assert "dense models only" in str(te.value)


def test_moe_skew_validation_matches_jax():
    for bad in (-1.0, -1e-9):
        with pytest.raises(ValueError) as te:
            TS.ServingConfig(**SERVING, moe_skew=bad).validate()
        with pytest.raises(ValueError) as je:
            JServing(**SERVING, moe_skew=bad).validate()
        assert str(te.value) == str(je.value)


def test_moe_telemetry_fields(weights):
    """With the flight recorder on, engine-step samples carry the last
    dispatch's ``moe_rounds`` and ``moe_imbalance``."""
    _, tp = weights
    rec = TT.enable(capacity=256)
    try:
        port_run(tp, plan=dict(PLAN, num_requests=3))
    finally:
        TT.disable()
    samples = [s for s in rec.samples() if "moe_rounds" in s]
    assert samples
    assert all(s["moe_imbalance"] >= 1.0 and s["moe_rounds"] >= 0
               for s in samples)


def test_moe_record_block_and_pathway_equal_jax(weights):
    """``run_serving`` on the t=0 plan with a skew: the record's ``moe``
    block and the skew knobs in ``serving_config`` equal JAX's; the
    port's parser hoists the same ``moe_*`` columns from the port's
    record as from JAX's, and ``serving_summary`` reads skew, imbalance
    and rounds from both alike."""
    pytest.importorskip("pandas")
    from dlnetbench_tpu_torch.analysis.bandwidth import serving_summary
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.metrics.emit import \
        result_to_record as t_to_record
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe
    from dlnetbench_tpu.metrics.emit import result_to_record as j_to_record
    jp, tp = weights
    cfg = dict(SERVING, moe_skew=10.0, moe_skew_seed=2)
    jres = j_run_serving(jax_model(), JServing(**cfg),
                         JPlan.from_dict(T0_PLAN), params=jp)
    tres = TS.run_serving(torch_model(), TS.ServingConfig(**cfg),
                          TPlan.from_dict(T0_PLAN), params=tp,
                          device="cpu")
    jg, tg = jres.global_meta, tres.global_meta
    assert tg["moe"] == jg["moe"]
    assert tg["moe"]["dispatches"] > 0 and tg["moe"]["skew"] == 10.0
    for key in ("moe_experts", "moe_top_k", "moe_capacity_factor",
                "moe_skew", "moe_skew_seed"):
        assert tg["serving_config"][key] == jg["serving_config"][key]
    trec = emit_result(tres, stream=io.StringIO())
    jrec = j_to_record(jres)
    assert t_to_record(tres)["global"]["moe"] == trec["global"]["moe"]
    tdf, jdf = records_to_dataframe([trec]), records_to_dataframe([jrec])
    cols = sorted(c for c in tdf.columns if c.startswith("moe_"))
    assert "moe_load_imbalance" in cols and "moe_expert_load_max" in cols
    assert cols == sorted(c for c in jdf.columns if c.startswith("moe_"))
    for c in cols:
        assert tdf[c].iloc[0] == jdf[c].iloc[0], c
    ts, js = serving_summary([trec]), serving_summary([jrec])
    for c in ("moe_skew", "expert_imbalance", "moe_rounds_mean"):
        assert float(ts[c].iloc[0]) == float(js[c].iloc[0]), c
    assert float(ts["moe_rounds_mean"].iloc[0]) > 0


def test_dense_engine_has_no_moe_block_and_decode_reads_nothing(weights):
    """A dense engine stamps no ``moe`` block and its decode programs
    read no round count back; a MoE decode step reads one a layer."""
    dense = ttfm.TransformerConfig(**{k: v for k, v in MODEL.items()
                                      if not k.startswith(("num_e",
                                                           "top_k",
                                                           "moe_"))},
                                   dtype="float32")
    dp = ttfm.init_params(dense, seed=0, device="cpu")
    before = TMD.host_reads
    eng = port_engine(dp, model=dense, multi_step_n=4)
    eng.run(TPlan.from_dict(PLAN).sample())
    assert eng.moe_block() is None and TMD.host_reads == before
    res = TS.run_serving(dense, TS.ServingConfig(**SERVING),
                         TPlan.from_dict(dict(PLAN, num_requests=2)),
                         params=dp, device="cpu")
    assert "moe" not in res.global_meta
    assert "moe_skew" not in res.global_meta["serving_config"]
    _, tp = weights
    mc = torch_model()
    cc = eng.cache_cfg
    step = TD.make_decode_step(mc, cc)
    from dlnetbench_tpu_torch.serving.kv_cache import device_buffers
    pools = device_buffers(cc, "cpu")
    b = cc.max_seqs
    before = TMD.host_reads
    out = step(tp, *pools, torch.zeros(b, dtype=torch.int32),
               torch.zeros(b, dtype=torch.int32),
               torch.zeros((b, cc.max_pages_per_seq), dtype=torch.int32),
               torch.ones(b, dtype=torch.bool))
    assert TMD.host_reads - before == MODEL["num_layers"]
    load, rounds = out[-2:]
    assert int(load.sum()) == b * MODEL["top_k"] * MODEL["num_layers"]
    assert rounds >= MODEL["num_layers"]


@pytest.mark.parametrize("argv,message", [
    (["--num_experts", "4", "--top_k", "2", "--speculative",
      "--multi_step_n", "2"], "dense models only"),
    (["--moe_skew", "-1"], "moe_skew must be >= 0"),
    (["--world", "3"], "slots must divide evenly across world ranks"),
    (["--kv_shard", "3"], "kv_shard 3 must divide num_kv_heads 2"),
    (["--disaggregate"], "world 1 must equal prefill_ranks 1"),
    (["--fault", '{"events":[{"kind":"meteor"}]}'], "unknown kind"),
])
def test_cli_serve_refusals(capsys, argv, message):
    """``cli serve`` refuses MoE + speculation (JAX's message), a
    negative skew, and bad ``--world``, ``--kv_shard``,
    ``--disaggregate`` and ``--fault`` settings as usage errors."""
    from dlnetbench_tpu_torch import cli as tcli
    plan = ('{"kind":"poisson","rate_rps":100,"num_requests":2,"seed":0,'
            '"prompt_len":[3,4],"output_len":[2,3]}')
    with pytest.raises(SystemExit) as e:
        tcli.main(["serve", "--platform", "cpu", "--arrival", plan,
                   "--embed", "32", "--heads", "4", "--kv_heads", "2",
                   "--ff", "64", "--layers", "2", "--vocab", "64", *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_serve_moe_flags_reach_the_record(tmp_path):
    """The MoE flags with JAX's meanings: the record's ``moe`` block and
    ``serving_config`` carry the experts, top-k, capacity factor and
    skew given on the command line."""
    from dlnetbench_tpu_torch import cli as tcli
    out = tmp_path / "s.jsonl"
    plan = ('{"kind":"poisson","rate_rps":100,"num_requests":3,"seed":0,'
            '"prompt_len":[3,6],"output_len":[2,4]}')
    assert tcli.main(["serve", "--platform", "cpu", "--arrival", plan,
                      "--embed", "32", "--heads", "4", "--kv_heads", "2",
                      "--ff", "64", "--layers", "2", "--vocab", "64",
                      "--num_experts", "4", "--top_k", "2",
                      "--moe_capacity_factor", "1.5", "--moe_skew", "3",
                      "--moe_skew_seed", "5", "--out", str(out)]) == 0
    g = json.loads(out.read_text().splitlines()[-1])["global"]
    sc = g["serving_config"]
    assert (sc["moe_experts"], sc["moe_top_k"], sc["moe_capacity_factor"],
            sc["moe_skew"], sc["moe_skew_seed"]) == (4, 2, 1.5, 3.0, 5)
    assert (g["moe"]["num_experts"], g["moe"]["top_k"]) == (4, 2)
    assert g["moe"]["capacity_factor"] == 1.5 and g["moe"]["skew"] == 3.0
