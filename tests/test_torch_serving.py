"""The torch port's serving slice held against the JAX package: arrival
plans, the page allocator, the model layers, the prefill/decode
programs over every cache dtype, the engine's greedy token streams, and
the record the port's ``cli serve`` writes, read by the JAX package's
parser.  Everything runs on the CPU at the bench's tiny serving shape
(embed 64, 4/2 heads, ff 128, 2 layers, vocab 256, f32), with the JAX
package's weights handed to the port through numpy."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.models import layers as JL
from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import decode as JD
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu.serving import metrics as JM
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu_torch import cli as tcli
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import decode as TD
from dlnetbench_tpu_torch.serving import kv_cache as TKV
from dlnetbench_tpu_torch.serving import metrics as TM
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan
from dlnetbench_tpu_torch.serving.arrivals import splitmix64

DATA = Path(__file__).parent / "data"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is enough, and the suite's
    parallel workers (and its timing-sensitive tests) keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# bench.py's serving model
MODEL = dict(vocab_size=256, embed_dim=64, num_heads=4, num_kv_heads=2,
             ff_dim=128, num_layers=2, seq_len=64)


def jax_model():
    return jtfm.TransformerConfig(**MODEL, gated=True, max_positions=0,
                                  dtype="float32")


def torch_model():
    return ttfm.TransformerConfig(**MODEL, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the same weights as port params on the CPU)."""
    jp = jtfm.init_params(jax.random.key(0), jax_model())
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def raw_bits(a) -> np.ndarray:
    """An array's bytes as numpy (e4m3 as uint8; int8 as is), copied."""
    a = np.array(a)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


# ---------------------------------------------------------------------
# arrival plans and prompts


@pytest.mark.parametrize("fixture", ["arrival_poisson.json",
                                     "arrival_diurnal.json",
                                     "arrival_prefix.json"])
def test_arrival_plans_sample_the_same_streams(fixture):
    spec = f"@{DATA / fixture}"
    jp, tp = JPlan.loads(spec), TPlan.loads(spec)
    assert tp.to_dict() == jp.to_dict()
    assert [dataclasses.astuple(r) for r in tp.sample()] \
        == [dataclasses.astuple(r) for r in jp.sample()]
    assert tp.offered_rps() == jp.offered_rps()
    for r in tp.sample()[:4]:
        np.testing.assert_array_equal(TD.prompt_tokens_for(r, 256),
                                      JD.prompt_tokens_for(r, 256))


def test_splitmix64_golden_values():
    v1, s = splitmix64(0)
    v2, _ = splitmix64(s)
    assert v1 == 0xE220A8397B1DCDAF
    assert v2 == 0x6E789E6AA1B965F4


def test_arrival_plan_validation_matches():
    for bad in ({"kind": "lunar"},
                {"kind": "poisson", "rate_rps": 0.0, "num_requests": 3},
                {"kind": "replay", "trace": []}):
        with pytest.raises(ValueError):
            TPlan.from_dict(bad)
        with pytest.raises(ValueError):
            JPlan.from_dict(bad)


# ---------------------------------------------------------------------
# the page allocator


def test_allocator_block_tables_match_jax():
    kw = dict(num_layers=1, num_kv_heads=2, head_dim=8, num_pages=12,
              page_size=4, max_seqs=3, max_pages_per_seq=5)
    jc = JKV.PagedKVCache(JKV.CacheConfig(**kw))
    tc = TKV.PagedKVCache(TKV.CacheConfig(**kw))
    script = [("allocate", 0, 6), ("allocate", 1, 17), ("append", 0, 5),
              ("append", 1, 9), ("free", 0), ("allocate", 2, 11),
              ("append", 2, 11), ("allocate", 0, 3), ("append", 1, 1),
              ("free", 1), ("allocate", 1, 20), ("append", 0, 2)]
    for op, *args in script:
        getattr(jc, op)(*args)
        getattr(tc, op)(*args)
        np.testing.assert_array_equal(tc.block_tables, jc.block_tables)
        np.testing.assert_array_equal(tc.lengths, jc.lengths)
        assert tc.stats() == jc.stats()
    assert tc.can_fit(1) == jc.can_fit(1)
    with pytest.raises(ValueError, match="already allocated"):
        tc.allocate(2, 4)
    tight = TKV.PagedKVCache(TKV.CacheConfig(**{**kw, "num_pages": 6}))
    tight.allocate(0, 20)
    with pytest.raises(TKV.CacheOOM, match="free"):
        tight.allocate(1, 8)
    with pytest.raises(TKV.CacheOOM, match="reservation"):
        tc.append(0, 10)
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        TKV.PagedKVCache(TKV.CacheConfig(**kw)).allocate(0, 21)


def test_cache_config_accounting_matches_jax():
    for cd in TKV.CACHE_DTYPES:
        kw = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_pages=10,
                  page_size=4, max_seqs=2, max_pages_per_seq=4,
                  cache_dtype=cd)
        assert TKV.CacheConfig(**kw).pool_bytes \
            == JKV.CacheConfig(**kw).pool_bytes
    with pytest.raises(ValueError, match="cannot hold"):
        TKV.CacheConfig(**{**kw, "num_pages": 3}).validate()


# ---------------------------------------------------------------------
# layers and weights


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((5, 3, 2, 16)).astype(np.float32)
    pos = np.arange(7, 10)
    jq, jk = JL.rope(jnp.asarray(x), jnp.asarray(k), jnp.asarray(pos))
    tq, tk = TL.rope(torch.from_numpy(x), torch.from_numpy(k),
                     torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    # the per-slot decode rope
    qd, kd, pd = x[:, 0], k[:, 0], np.asarray([0, 3, 17, 40, 63])
    jq, jk = JD._rope_decode(jnp.asarray(qd), jnp.asarray(kd),
                             jnp.asarray(pd))
    tq, tk = TL.rope(torch.from_numpy(qd), torch.from_numpy(kd),
                     torch.from_numpy(pd))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    y = rng.standard_normal((6, 16)).astype(np.float32)
    sc = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(y), torch.from_numpy(sc)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(y), jnp.asarray(sc))),
        rtol=1e-5, atol=1e-6)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TL.swiglu(*map(torch.from_numpy, (y, wg, wu, wd))).numpy(),
        np.asarray(JL.swiglu(*map(jnp.asarray, (y, wg, wu, wd)))),
        rtol=1e-5, atol=1e-5)


def test_init_params_tree_matches_jax_and_seeds(weights):
    jp, _ = weights
    tp = ttfm.init_params(torch_model(), seed=3, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({n: tuple(w.shape) for n, w in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tp.items()}
    assert tshapes == jshapes
    again = ttfm.init_params(torch_model(), seed=3, device="cpu")
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])
    bf = ttfm.params_from_numpy(
        {"w": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}, "cpu")
    assert bf["w"].dtype == torch.bfloat16
    assert bf["w"].tolist() == [1.5, -2.25]


def test_config_refuses_knobs_outside_the_slice():
    with pytest.raises(ValueError):
        ttfm.TransformerConfig(**{**MODEL, "dtype": "float16"})
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.serving import decode as D
    # the GPT-2 family trains in the port (slice 20); serving refuses it
    # as the JAX package's check_config does (no decode path)
    for over in ({"gated": False}, {"max_positions": 64},
                 {"gated": False, "max_positions": 64}):
        with pytest.raises(ValueError, match="gated"):
            D.check_config(ttfm.TransformerConfig(**{**MODEL, **over}))
    # attention masks train in the port (slice 5); serving refuses them
    # as the JAX package's check_config does (a window in decode, a
    # segment mask always)
    with pytest.raises(ValueError, match="no sliding-window path"):
        D.check_config(ttfm.TransformerConfig(**{**MODEL,
                                                 "attention_window": 8}))
    with pytest.raises(ValueError, match="document-segment masks"):
        D.check_config(ttfm.TransformerConfig(**{**MODEL,
                                                 "attention_seg_avg": 8}))
    cfg = ttfm.TransformerConfig.from_card(load_model_card("llama3_8b"),
                                           num_layers=4, vocab_size=32768)
    assert (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.ff_dim,
            cfg.head_dim) == (4096, 32, 8, 14336, 128)
    # MoE models train in the port (slice 4) and serve since the
    # serving-breadth slice (tests/test_torch_moe_serving.py)
    moe = ttfm.TransformerConfig.from_card(load_model_card("mixtral_8x7b"))
    assert D.check_config(moe) is moe
    small = ttfm.TransformerConfig(**{**MODEL, "num_experts": 4})
    assert D.check_config(small) is small


def test_check_config_refuses_masks_with_the_jax_messages():
    """A window and a segment mask are refused in serving with the JAX
    package's decode-time messages."""
    from dlnetbench_tpu.models import transformer as JT
    from dlnetbench_tpu.serving import decode as JD
    from dlnetbench_tpu_torch.serving import decode as D
    for over in ({"attention_window": 8}, {"attention_seg_avg": 8},
                 {"attention_window": 8, "attention_seg_avg": 16}):
        with pytest.raises(ValueError) as te:
            D.check_config(ttfm.TransformerConfig(**{**MODEL, **over}))
        with pytest.raises(ValueError) as je:
            JD.check_config(JT.TransformerConfig(
                gated=True, max_positions=0, **MODEL, **over), decode=True)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------
# the prefill and decode programs


def _dequant(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return pages.float() * scales[..., None, None]


def _quant_step(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One quantization step at each page value: the scale for int8; for
    e4m3 the spacing of the value's binade (3 mantissa bits), and of the
    subnormals (2**-9) near zero, times the scale."""
    if pages.dtype == torch.int8:
        return scales[..., None, None].expand(pages.shape)
    mag = pages.float().abs().clamp_min(2.0 ** -6)
    return 2.0 ** (torch.floor(torch.log2(mag)) - 3) \
        * scales[..., None, None]


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_prefill_and_decode_match_jax(weights, cache_dtype):
    """Uneven prefill chunks for two slots, then decode steps with one
    slot switched off for a step: the pools agree to 1e-5 (a quantized
    page value may sit one quantization step apart where its f32 input
    lay within rounding error of a boundary) and the tokens are equal."""
    jp, tp = weights
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=16, num_pages=12,
              page_size=4, max_seqs=2, max_pages_per_seq=5,
              cache_dtype=cache_dtype)
    jcc, tcc = JKV.CacheConfig(**kw), TKV.CacheConfig(**kw)
    jpools = list(JKV.device_buffers(jcc))
    tpools = list(TKV.device_buffers(tcc, "cpu"))
    jpre = jax.jit(JD.make_prefill_chunk(jax_model(), jcc, 3))
    tpre = TD.make_prefill_chunk(torch_model(), tcc, 3)
    jdec = jax.jit(JD.make_decode_step(jax_model(), jcc))
    tdec = TD.make_decode_step(torch_model(), tcc)
    cache = TKV.PagedKVCache(tcc)
    prompts = [np.asarray([5, 9, 3, 11, 7, 200, 17], np.int32),
               np.asarray([1, 2, 250, 4, 8], np.int32)]
    last = []
    for slot, prompt in enumerate(prompts):
        cache.allocate(slot, len(prompt) + 6)
        row = cache.block_tables[slot].copy()
        pos = 0
        while pos < len(prompt):
            n = min(3, len(prompt) - pos)
            ch = np.zeros(3, np.int32)
            ch[:n] = prompt[pos:pos + n]
            *jpools, jn = jpre(jp, *jpools, jnp.asarray(ch),
                               jnp.int32(pos), jnp.int32(n),
                               jnp.asarray(row))
            *tpools, tn = tpre(tp, *tpools, torch.from_numpy(ch), pos, n,
                               torch.from_numpy(row))
            pos += n
            cache.append(slot, n)
        assert int(tn) == int(jn)
        last.append(int(tn))
    for step in range(5):
        active = np.asarray([True, step != 2])
        toks = np.asarray(last, np.int32)
        posn = cache.lengths.copy()
        bt = cache.block_tables.copy()
        *jpools, jn = jdec(jp, *jpools, jnp.asarray(toks),
                           jnp.asarray(posn), jnp.asarray(bt),
                           jnp.asarray(active))
        *tpools, tn = tdec(tp, *tpools, torch.from_numpy(toks),
                           torch.from_numpy(posn), torch.from_numpy(bt),
                           torch.from_numpy(active))
        jn = np.asarray(jn)
        for slot in range(2):
            if active[slot]:
                assert int(tn[slot]) == int(jn[slot]), (step, slot)
                cache.append(slot)
                last[slot] = int(tn[slot])
    if cache_dtype == "bf16":
        for t, j in zip(tpools, jpools):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=1e-5, atol=1e-5)
        return
    for pages, scales, jpages, jscales in ((tpools[0], tpools[2],
                                            jpools[0], jpools[2]),
                                           (tpools[1], tpools[3],
                                            jpools[1], jpools[3])):
        jpages = torch.from_numpy(raw_bits(jpages)).view(pages.dtype)
        jscales = torch.from_numpy(np.array(jscales))
        torch.testing.assert_close(scales, jscales, rtol=1e-5, atol=1e-7)
        diff = (_dequant(pages, scales) - _dequant(jpages, jscales)).abs()
        assert bool((diff <= 1e-5 + _quant_step(pages, scales)).all())
        # a value on a rounding boundary is rare: nearly every byte equal
        same = float((to_np(pages) == to_np(jpages)).mean())
        assert same > 0.99, same


# ---------------------------------------------------------------------
# the engine


def _serving_kw(**over):
    kw = dict(slots=4, page_size=4, num_pages=48, max_seq_len=32,
              prefill_chunk=4, slo_ttft_ms=200.0, slo_tpot_ms=100.0,
              warmup_requests=0)
    kw.update(over)
    return kw


PLAN = {"kind": "poisson", "rate_rps": 200.0, "num_requests": 6,
        "seed": 11, "prompt_len": [4, 12], "output_len": [3, 6]}


@pytest.mark.parametrize("cache_dtype,prefill", [("bf16", "separate"),
                                                 ("bf16", "inline"),
                                                 ("int8", "separate"),
                                                 ("fp8", "inline")])
def test_run_serving_streams_equal_jax_engine(weights, cache_dtype,
                                              prefill):
    from dlnetbench_tpu.serving.scheduler import Engine as JEngine
    from dlnetbench_tpu.serving.scheduler import \
        ServingConfig as JServing
    jp, tp = weights
    kw = _serving_kw(cache_dtype=cache_dtype, prefill=prefill)
    plan = TPlan.from_dict(PLAN)
    jeng = JEngine(jax_model(), JServing(**kw), params=jp)
    jdone, _ = jeng.run(JPlan.from_dict(PLAN).sample())
    tcfg = TS.ServingConfig(**kw)
    teng = TS.Engine(torch_model(), tcfg, params=tp, device="cpu")
    res = TS.run_serving(torch_model(), tcfg, plan, engine=teng)
    assert teng.token_streams == jeng.token_streams
    assert res.num_runs == len(jdone) == PLAN["num_requests"]
    srv = res.global_meta["serving"]
    assert srv["completed"] == PLAN["num_requests"]
    assert srv["kv_cache"]["pages_in_use"] == 0
    assert srv["decode_loop"]["dispatches"] == teng._dispatches > 0
    assert all(len(s) == r.output_len for r in plan.sample()
               for s in [teng.token_streams[r.rid]])


def test_serving_block_and_result_match_jax():
    plan = JPlan.from_dict(PLAN)
    rows = [(0, 0.0, 0.01, 0.02, 0.09, 5, 4), (1, 0.01, 0.02, 0.05, 0.3, 7, 1),
            (2, 0.02, 0.2, 0.6, 0.9, 4, 3)]
    jdone = [JM.Completed(*r) for r in rows]
    tdone = [TM.Completed(*r) for r in rows]
    kw = dict(slo_ttft_ms=100.0, slo_tpot_ms=50.0, wall_s=1.0,
              engine_steps=9, queue_depth_max=2, batch_occupancy_mean=1.5,
              admitted_peak=3)
    assert TM.serving_block(tdone, TPlan.from_dict(PLAN), **kw) \
        == JM.serving_block(jdone, plan, **kw)
    tres = TM.build_result(tdone, TPlan.from_dict(PLAN), {"x": 1})
    jres = JM.build_result(jdone, plan, {"x": 1})
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)


def test_serving_config_refuses_knobs_outside_the_slice():
    # every knob of the JAX package's config is the port's: capacity
    # ranks, KV sharding and disaggregation since the serving-at-scale
    # slice (tests/test_torch_serving_scale.py), the fused loop,
    # speculation, sampling and grammars since the decode-loop slice,
    # prefix sharing and the MoE skew since the serving-breadth slice
    for over in ({"world": 2}, {"kv_shard": 2},
                 {"disaggregate": True, "world": 2},
                 {"multi_step_n": 4}, {"speculative": True},
                 {"temperature": 0.7}, {"grammar": "json"},
                 {"prefix_sharing": True}, {"moe_skew": 2.0}):
        TS.ServingConfig(**_serving_kw(**over)).validate()
    # a disaggregated config is refused by the one-engine path, with
    # the JAX package's message
    with pytest.raises(ValueError, match="run_disagg"):
        TS.Engine(torch_model(), TS.ServingConfig(**_serving_kw(
            disaggregate=True, world=2)), devices=["cpu", "cpu"])
    # a MoE model with speculation: refused at the engine build, with
    # the JAX package's message
    from dlnetbench_tpu.serving.scheduler import Engine as JEngine
    from dlnetbench_tpu.serving.scheduler import ServingConfig as JServing
    moe = dict(MODEL, num_experts=4, top_k=2)
    with pytest.raises(ValueError) as te:
        TS.Engine(ttfm.TransformerConfig(**moe, dtype="float32"),
                  TS.ServingConfig(**_serving_kw(speculative=True,
                                                 multi_step_n=2)),
                  device="cpu")
    with pytest.raises(ValueError) as je:
        JEngine(jtfm.TransformerConfig(**moe, gated=True, max_positions=0,
                                       dtype="float32"),
                JServing(**_serving_kw(speculative=True, multi_step_n=2)))
    assert str(te.value) == str(je.value)
    assert "speculative decode covers dense models only" in str(te.value)
    with pytest.raises(ValueError, match="prefill"):
        TS.ServingConfig(**_serving_kw(prefill="lazy")).validate()
    with pytest.raises(ValueError, match="multiple"):
        TS.ServingConfig(**_serving_kw(max_seq_len=30)).validate()
    # a fault plan is checked before the measured run
    from dlnetbench_tpu_torch.faults.plan import FaultEvent, FaultPlan
    with pytest.raises(ValueError, match="unknown kind"):
        TS.run_serving(torch_model(), TS.ServingConfig(**_serving_kw(
            warmup_requests=0)), TPlan.from_dict(PLAN), device="cpu",
            fault_plan=FaultPlan(events=[FaultEvent(kind="meteor")]))


def test_engine_rejects_oversized_request(weights):
    _, tp = weights
    eng = TS.Engine(torch_model(), TS.ServingConfig(**_serving_kw()),
                    params=tp, device="cpu")
    plan = TPlan(kind="replay", trace=[{"t": 0.0, "prompt_len": 30,
                                        "output_len": 10}])
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.run(plan.sample())


def test_engine_and_cli_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.Engine(torch_model(), TS.ServingConfig(**_serving_kw()))
    with pytest.raises(SystemExit):
        tcli.main(["serve", "--arrival", json.dumps(PLAN)])


# ---------------------------------------------------------------------
# the record


def test_cli_record_loads_through_jax_parser(tmp_path, capsys):
    from dlnetbench_tpu.metrics.parser import (load_records,
                                               records_to_dataframe)
    out = tmp_path / "rec.jsonl"
    rc = tcli.main(["serve", "--platform", "cpu", "--out", str(out),
                    "--arrival", json.dumps(PLAN), "--slots", "4",
                    "--page_size", "4", "--num_pages", "48",
                    "--max_seq_len", "32", "--prefill_chunk", "4",
                    "--cache_dtype", "int8", "--tag", "lane=cpu"])
    assert rc == 0
    assert "serving: 6 requests" in capsys.readouterr().err
    recs = load_records(out)
    assert len(recs) == 1 and recs[0]["version"] == 2
    g = recs[0]["global"]
    assert g["kv_cache_dtype"] == "int8" and g["framework"] == "torch"
    assert g["variables"] == {"lane": "cpu"}
    df = records_to_dataframe(recs)
    assert len(df) == PLAN["num_requests"]
    assert {"ttft", "tpot", "e2e", "output_len"} <= set(df.columns)
    assert recs[0]["mesh"]["platform"] == "cpu"
