"""The port's speculative decode held against the JAX package's on the
CPU: greedy speculative streams (ngram and truncated drafters) against
JAX's and the 1-step streams with JAX's acceptance counts, the sampled
speculative stream against JAX's, the verify pass against iterated
single steps and JAX's verify pass (tokens, logits, the gated K+1-row
write), one spec-loop call against JAX's loop on the same state (idle
rounds included), the ngram drafter's helpers, the refusals' messages,
and the chi-square losslessness of rejection-sampling acceptance.  JAX's
tiny serving model, its weights handed to the port through numpy."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import decode as JD
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu.serving import sampling as JSMP
from dlnetbench_tpu.serving import speculative as JSP
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu.serving.scheduler import Engine as JEngine
from dlnetbench_tpu.serving.scheduler import ServingConfig as JServing
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import decode as TD
from dlnetbench_tpu_torch.serving import kv_cache as TKV
from dlnetbench_tpu_torch.serving import sampling as SMP
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving import speculative as SP
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan

MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=32)
SERVING = dict(slots=4, page_size=4, num_pages=32, max_seq_len=32,
               slo_ttft_ms=200.0, slo_tpot_ms=100.0, warmup_requests=0)
PLAN = dict(kind="poisson", rate_rps=200.0, num_requests=10, seed=7,
            prompt_len=[4, 9], output_len=[1, 7])
CACHE = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_pages=16,
             page_size=4, max_seqs=2, max_pages_per_seq=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model():
    return jtfm.TransformerConfig(**MODEL, gated=True, max_positions=0,
                                  dtype="float32")


def torch_model():
    return ttfm.TransformerConfig(**MODEL, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jp = jtfm.init_params(jax.random.key(1), jax_model())
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _engines(weights, plan=PLAN, **kw):
    """(port engine, JAX engine) after one run of ``plan`` each."""
    jp, tp = weights
    teng = TS.Engine(torch_model(), TS.ServingConfig(**SERVING, **kw),
                     params=tp, device="cpu")
    teng.run(TPlan.from_dict(plan).sample())
    jeng = JEngine(jax_model(), JServing(**SERVING, **kw), params=jp)
    jeng.run(JPlan.from_dict(plan).sample())
    return teng, jeng


@pytest.fixture(scope="module")
def one_step(weights):
    _, tp = weights
    eng = TS.Engine(torch_model(), TS.ServingConfig(**SERVING), params=tp,
                    device="cpu")
    eng.run(TPlan.from_dict(PLAN).sample())
    return dict(eng.token_streams)


@pytest.mark.parametrize("drafter,extra", [
    ("ngram", {}), ("truncated", {"drafter_layers": 1})])
def test_speculative_streams_equal_jax_and_one_step(weights, one_step,
                                                    drafter, extra):
    """Greedy speculation is lossless: the stream equals the 1-step
    stream whatever the drafter proposes, and JAX's speculative stream;
    the raw acceptance counts (a per-slot quantity, free of timing) are
    JAX's."""
    teng, jeng = _engines(weights, multi_step_n=4, speculative=True,
                          spec_k=3, drafter=drafter, **extra)
    assert dict(teng.token_streams) == one_step
    assert dict(teng.token_streams) == dict(jeng.token_streams)
    spec = teng.decode_loop_block()["spec"]
    jspec = jeng.decode_loop_block()["spec"]
    assert spec["drafter"] == drafter and spec["drafted"] > 0
    for key in ("k", "drafted", "accepted", "acceptance_rate"):
        assert spec[key] == jspec[key], key


def test_spec_sampled_streams_equal_jax(weights):
    """Speculative sampling (truncated drafter, rejection acceptance):
    the port's sampled stream is JAX's token for token; the record
    carries the acceptance point."""
    kw = dict(multi_step_n=8, speculative=True, spec_k=3,
              drafter="truncated", drafter_layers=1, temperature=0.8,
              top_p=0.9, sample_seed=11)
    teng, jeng = _engines(weights, **kw)
    assert dict(teng.token_streams) == dict(jeng.token_streams)
    assert teng._accepted == jeng._accepted
    assert teng._drafted == jeng._drafted


def test_spec_engine_first_draw_matches_unfused(weights):
    """The statistically sound end-to-end half of losslessness for one
    seed: the speculative engine's FIRST emitted token per request is
    drawn by the prefill (LANE_TOKEN at the last prompt position), the
    same draw the non-speculative engine makes, so they agree."""
    _, tp = weights
    plan = dict(kind="poisson", rate_rps=500.0, num_requests=24, seed=9,
                prompt_len=[4, 6], output_len=[8, 12])
    base = dict(**SERVING, temperature=0.8, sample_seed=11,
                multi_step_n=8)
    streams = []
    for over in ({}, dict(speculative=True, spec_k=3, drafter="truncated",
                          drafter_layers=1)):
        eng = TS.Engine(torch_model(), TS.ServingConfig(**base, **over),
                        params=tp, device="cpu")
        eng.run(TPlan.from_dict(plan).sample())
        streams.append(dict(eng.token_streams))
    ns, sp = streams
    assert sorted(ns) == sorted(sp) and len(ns) == 24
    assert all(ns[r][0] == sp[r][0] for r in ns)
    assert all(0 <= t < MODEL["vocab_size"]
               for toks in sp.values() for t in toks)


# ---------------------------------------------------------------------
# the verify pass and the loop at op level


@pytest.fixture(scope="module")
def prefilled(weights):
    """Both packages' pools after prefilling [1, 8, 2, 60] into slot 0,
    the block tables and the first generated token."""
    jp, tp = weights
    tcc, jcc = TKV.CacheConfig(**CACHE), JKV.CacheConfig(**CACHE)
    cache = TKV.PagedKVCache(tcc)
    cache.allocate(0, 20)
    cache.allocate(1, 12)
    k, v = TKV.device_buffers(tcc, "cpu")
    prompt = np.array([1, 8, 2, 60], np.int32)
    row = torch.from_numpy(cache.block_tables[0].copy())
    k, v, nxt = TD.make_prefill_chunk(torch_model(), tcc, 4)(
        tp, k, v, torch.from_numpy(prompt), 0, 4, row)
    jk, jv = JKV.device_buffers(jcc)
    jk, jv, jn = jax.jit(JD.make_prefill_chunk(jax_model(), jcc, 4))(
        jp, jk, jv, jnp.asarray(prompt), jnp.int32(0), jnp.int32(4),
        jnp.asarray(cache.block_tables[0]))
    assert int(jn) == int(nxt)
    return (k, v), (jk, jv), cache.block_tables.copy(), int(nxt)


def test_verify_pass_matches_iterated_decode_and_jax(weights, prefilled):
    """At every fed position the verify pass computes the single-step
    program's greedy continuation; tokens equal JAX's verify pass,
    logits within 1e-5, and the gated K+1-row write leaves a switched-off
    slot's pages untouched and writes the rest as JAX does."""
    jp, tp = weights
    (k, v), (jk, jv), bt_np, first = prefilled
    bt = torch.from_numpy(bt_np)
    fed = [first, 17, 42, 3]
    step = TD.make_decode_step(torch_model(), TKV.CacheConfig(**CACHE))
    k1, v1, ref = k.clone(), v.clone(), []
    for j, tok in enumerate(fed):
        k1, v1, nx = step(tp, k1, v1, torch.tensor([tok, 0],
                                                   dtype=torch.int32),
                          torch.tensor([4 + j, 0], dtype=torch.int32), bt,
                          torch.tensor([True, False]))
        ref.append(int(nx[0]))
    tokens = np.array([fed, [5, 6, 7, 8]], np.int32)
    write_ok = np.array([[True] * 4, [False] * 4])
    positions = np.array([4, 0], np.int32)
    k2, v2 = k.clone(), v.clone()
    _, _, out, logits = SP._verify_tokens(
        torch_model(), TKV.CacheConfig(**CACHE), tp, k2, v2,
        torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(write_ok), bt, return_logits=True)
    assert out[0].tolist() == ref
    jverify = jax.jit(lambda *a: JSP._verify_tokens(
        jax_model(), JKV.CacheConfig(**CACHE), *a, return_logits=True))
    jk2, jv2, jout, jlog = jverify(
        jp, jk, jv, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(write_ok), jnp.asarray(bt_np))
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               rtol=1e-5, atol=1e-5)
    # slot 1 wrote nothing (its pages are as before); slot 0's rows are
    # JAX's within rounding and the iterated steps' exactly where the
    # same math wrote them
    for got, before, want in ((k2, k, jk2), (v2, v, jv2)):
        pages1 = bt[1].long()
        assert torch.equal(got[:, :, pages1], before[:, :, pages1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("drafter,sampled", [("ngram", False),
                                             ("truncated", False),
                                             ("truncated", True)])
def test_spec_loop_call_equals_jax(weights, prefilled, drafter, sampled):
    """One loop call on the same start state and ngram table as JAX's
    loop: tokens, counts, state, table, rounds_run and the raw
    acceptance stats equal; rounds past the budget change nothing
    (rounds_run stops where JAX's loop exits)."""
    jp, tp = weights
    (k, v), (jk, jv), bt_np, first = prefilled
    sampler = jsampler = None
    if sampled:
        scfg = dict(temperature=0.9, top_k=0, top_p=1.0, sample_seed=3,
                    grammar="")
        sampler = SMP.DeviceSampler(SMP.check_sampling_config(**scfg), 64)
        jsampler = JSMP.DeviceSampler(
            JSMP.check_sampling_config(**scfg), 64)
    state = np.zeros((TD.STATE_ROWS, 2), np.int32)
    state[:, 0] = [first, 4, 7, 20, 5, 0]
    table = np.zeros((2, 64), np.int32)
    table[0, [1, 8, 2, 60]] = [8, 2, 60, first]
    kw = dict(spec_k=3, drafter=drafter, drafter_layers=1)
    loop = SP.make_spec_decode_loop(torch_model(),
                                    TKV.CacheConfig(**CACHE), 8,
                                    sampler=sampler, **kw)
    jloop = jax.jit(JSP.make_spec_decode_loop(
        jax_model(), JKV.CacheConfig(**CACHE), 8, sampler=jsampler, **kw))
    got = loop(tp, k.clone(), v.clone(), torch.from_numpy(state),
               torch.from_numpy(table), torch.from_numpy(bt_np), 8)
    want = jloop(jp, jk, jv, jnp.asarray(state), jnp.asarray(table),
                 jnp.asarray(bt_np), jnp.int32(8))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert 1 <= int(got[6]) < 8          # rounds_run: idle rounds ran


def test_spec_loop_with_no_active_slot_changes_nothing(weights,
                                                       prefilled):
    _, tp = weights
    (k, v), _, bt_np, first = prefilled
    loop = SP.make_spec_decode_loop(torch_model(),
                                    TKV.CacheConfig(**CACHE), 4, spec_k=2,
                                    drafter="truncated")
    state = torch.zeros((TD.STATE_ROWS, 2), dtype=torch.int32)
    state[TD.STATE_LAST, 0], state[TD.STATE_POS, 0] = first, 4
    state[TD.STATE_LIMIT, 0] = 20
    k2, v2 = k.clone(), v.clone()
    out = loop(tp, k2, v2, state, torch.zeros((2, 64), dtype=torch.int32),
               torch.from_numpy(bt_np), 4)
    assert torch.equal(k2, k) and torch.equal(v2, v)
    assert torch.equal(out[2], state)
    assert int(out[5].sum()) == 0 and int(out[6]) == 0
    assert int(out[7]) == 0 and int(out[8]) == 0


def test_ngram_helpers_match_jax():
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, 64, size=23).astype(np.int32)
    row = SP.seed_ngram_row(prompt, 9, 64)
    np.testing.assert_array_equal(row, JSP.seed_ngram_row(prompt, 9, 64))
    table = rng.randint(0, 64, size=(3, 64)).astype(np.int32)
    last = np.array([5, 0, 63], np.int32)
    got = SP._draft_ngram(torch.from_numpy(table), torch.from_numpy(last),
                          4)
    want = JSP._draft_ngram(jnp.asarray(table), jnp.asarray(last), 4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_spec_refusals_match_jax():
    """The JAX builder's refusals, word for word: a quantized cache,
    sampling with a drafter that has no distribution, a full-depth
    truncated drafter, and the shape checks."""
    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    scfg = dict(temperature=0.8, top_k=0, top_p=1.0, sample_seed=0,
                grammar="")
    cases = [
        (dict(cache_dtype="int8"), dict(spec_k=2, drafter="ngram"), False),
        ({}, dict(spec_k=2, drafter="ngram"), True),
        ({}, dict(spec_k=2, drafter="truncated", drafter_layers=2), False),
        ({}, dict(spec_k=0, drafter="ngram"), False),
        ({}, dict(spec_k=2, drafter="oracle"), False)]
    for cc, kw, sampled in cases:
        t_s = (SMP.DeviceSampler(SMP.SamplingConfig(**scfg), 64)
               if sampled else None)
        j_s = (JSMP.DeviceSampler(JSMP.SamplingConfig(**scfg), 64)
               if sampled else None)
        got = msg(lambda: SP.make_spec_decode_loop(
            torch_model(), TKV.CacheConfig(**CACHE, **cc), 4, sampler=t_s,
            **kw))
        want = msg(lambda: JSP.make_spec_decode_loop(
            jax_model(), JKV.CacheConfig(**CACHE, **cc), 4, sampler=j_s,
            **kw))
        assert got == want, kw


# ---------------------------------------------------------------------
# rejection sampling: the losslessness lock


def _chi_ok(counts, probs):
    stat, df = SMP.chi_square(counts, probs)
    return stat < SMP.chi_square_critical(df), (stat, df)


def test_spec_rejection_sampling_is_lossless():
    """The rejection-sampling rule as the loop computes it — draft from
    q, accept iff u*q(d) < p(d), resample the residual on reject — emits
    tokens distributed as the target p for a drafter q that visibly
    disagrees (chi-square at p ~= 0.001), and q itself fails the same
    test.  At T=0 the rule is exact-match greedy."""
    s = SMP.DeviceSampler(SMP.check_sampling_config(
        temperature=0.8, top_k=0, top_p=1.0, sample_seed=5, grammar=""),
        16)
    rng = np.random.RandomState(2)
    tlog = rng.randn(16).astype(np.float32)
    dlog = rng.randn(16).astype(np.float32)
    n = 4096
    p = s.probs(torch.from_numpy(np.tile(tlog, (n, 1))))
    q = s.probs(torch.from_numpy(np.tile(dlog, (n, 1))))
    uids = torch.arange(n, dtype=torch.int32)
    pos = torch.full((n,), 7, dtype=torch.int32)
    rows = torch.arange(n)
    d = s.draw_from_probs(q, s.u01(uids, pos, SMP.LANE_DRAFT))
    accept = (s.u01(uids, pos, SMP.LANE_ACCEPT) * q[rows, d.long()]
              < p[rows, d.long()])
    resid = torch.clamp(p - q, min=0.0)
    z = resid.sum(dim=-1, keepdim=True)
    rdist = torch.where(z > 0, resid / torch.clamp(z, min=1e-30), p)
    r = s.draw_from_probs(rdist, s.u01(uids, pos, SMP.LANE_RESID))
    emitted = torch.where(accept, d, r).numpy()
    counts = np.bincount(emitted, minlength=16)
    ok, info = _chi_ok(counts, p[0].numpy())
    assert ok, info
    assert not _chi_ok(counts, q[0].numpy())[0]
    s0 = SMP.DeviceSampler(SMP.SamplingConfig(temperature=0.0), 16)
    p0 = s0.probs(torch.from_numpy(np.tile(tlog, (4, 1))))
    q0 = s0.probs(torch.from_numpy(np.tile(dlog, (4, 1))))
    d0 = torch.full((4,), int(np.argmax(dlog)), dtype=torch.long)
    u0 = s0.u01(torch.arange(4, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32), SMP.LANE_ACCEPT)
    r4 = torch.arange(4)
    assert not bool((u0 * q0[r4, d0] < p0[r4, d0]).any())
