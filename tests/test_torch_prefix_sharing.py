"""Cross-request prefix sharing in the torch port, held against the JAX
package on the CPU: the prefix trie and the refcounting allocator over
seeded admission/free sequences (every plan, copy-on-write destination,
block table, refcount and ``stats()["prefix"]`` equal), the read-only
``prefix_match_len`` probe, the page copy of a copy-on-write, the
engine's greedy and sampled streams with sharing (equal to the JAX
engine's and to the unshared run's, at N=1 and N=4), sharing over an
int8 cache at the JAX package's bar (equal streams), and the record's
sharing globals (equal to JAX's on a plan whose arrivals all land at
t=0, so residency at admission does not depend on either engine's
speed).  Tiny f32 models (the JAX density tests' shape), weights handed
over through numpy; every comparison is exact."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu.serving.scheduler import Engine as JEngine
from dlnetbench_tpu.serving.scheduler import ServingConfig as JServing
from dlnetbench_tpu.serving.scheduler import run_serving as j_run_serving
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import kv_cache as TKV
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan

import scripted_clock

DATA = Path(__file__).parent / "data"
PREFIX_PLAN = f"@{DATA / 'arrival_prefix.json'}"
# the JAX density tests' tiny model and engine (tests/test_kv_density.py)
MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=64)
SERVING = dict(slots=3, page_size=4, num_pages=40, max_seq_len=32,
               prefill_chunk=4, slo_ttft_ms=200.0, slo_tpot_ms=100.0,
               warmup_requests=0)
# arrival_prefix.json with a 9-token prefix over 4-token pages: the
# divergence page is shared copy-on-write
COW_PLAN = dict(kind="poisson", rate_rps=500.0, num_requests=8, seed=3,
                prompt_len=[10, 14], output_len=[3, 5],
                shared_prefix_len=9, prefix_pool=1)
# every arrival at t=0: which prompt is resident at each admission is
# fixed by the admission order alone
T0_PLAN = dict(kind="replay", seed=3, prompt_len=[10, 14],
               output_len=[3, 5], shared_prefix_len=9, prefix_pool=2,
               trace=[{"t": 0.0}] * 8)
SAMPLED = dict(temperature=0.8, top_p=0.9, sample_seed=7)


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
    jp = jtfm.init_params(jax.random.key(0), jax_model())
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _plan(spec):
    return ((JPlan.loads(spec), TPlan.loads(spec)) if isinstance(spec, str)
            else (JPlan.from_dict(spec), TPlan.from_dict(spec)))


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's streams per (plan, config override), each
    engine built once per module."""
    memo: dict = {}

    def get(spec, **kw):
        key = (str(spec), tuple(sorted(kw.items())))
        if key not in memo:
            eng = JEngine(jax_model(), JServing(**{**SERVING, **kw}),
                          params=weights[0])
            done, _ = scripted_clock.run(eng, _plan(spec)[0].sample())
            assert len(done) == len(_plan(spec)[0].sample())
            memo[key] = dict(eng.token_streams)
        return memo[key]
    return get


def port_run(tp, spec, **kw):
    eng = TS.Engine(torch_model(), TS.ServingConfig(**{**SERVING, **kw}),
                    params=tp, device="cpu")
    reqs = _plan(spec)[1].sample()
    done, _ = scripted_clock.run(eng, reqs)
    assert len(done) == len(reqs)
    assert eng.cache.pages_in_use == 0
    assert not eng.cache.trie._node_of_page
    return dict(eng.token_streams), eng


# ---------------------------------------------------------------------
# the trie and the allocator


def _cache_cfgs(**over):
    kw = dict(num_layers=1, num_kv_heads=2, head_dim=8, num_pages=24,
              page_size=4, max_seqs=4, max_pages_per_seq=4)
    kw.update(over)
    return JKV.CacheConfig(**kw), TKV.CacheConfig(**kw)


def _same_state(j, t, step):
    assert t._free == j._free, step
    np.testing.assert_array_equal(t._ref, np.asarray(j._ref))
    np.testing.assert_array_equal(t.block_tables, j.block_tables)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    assert t._pages_of == j._pages_of, step
    assert t.stats() == j.stats(), step
    assert sorted(t.trie._node_of_page) == sorted(j.trie._node_of_page)


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_allocator_and_trie_equal_jax_over_seeded_sequences(seed):
    """The JAX property test's operation mix (admit with and without a
    shared system prompt, prefill + publish, decode appends past the
    divergence, evictions) on both allocators: every match, plan,
    copy-on-write destination and refusal equal, and after every step
    the free list, refcounts, block tables and stats equal; the port's
    block tables never alias a written page, and the pool comes back
    whole."""
    rng = np.random.RandomState(seed)
    jc, tc = _cache_cfgs(max_pages_per_seq=6)
    j, t = JKV.PagedKVCache(jc), TKV.PagedKVCache(tc)
    prompts = {}
    # system prompts of 10 tokens over 4-token pages: a sharer matches two
    # full pages and two rows of a boundary page (copy-on-write)
    pool = [rng.randint(0, 50, size=10).astype(np.int32) for _ in range(2)]
    hits = cows = 0
    for step in range(300):
        op = rng.randint(0, 3)
        free_slots = [i for i in range(tc.max_seqs) if not t._pages_of[i]]
        busy = [i for i in range(tc.max_seqs) if t._pages_of[i]]
        if op == 0 and free_slots:
            slot = free_slots[0]
            pre = pool[rng.randint(0, len(pool))]
            tail = rng.randint(50, 64, size=rng.randint(2, 7)).astype(
                np.int32)
            prompt = (np.concatenate([pre, tail]) if rng.rand() < 0.7
                      else tail)
            total = len(prompt) + rng.randint(1, 5)
            if total > tc.max_pages_per_seq * tc.page_size:
                continue
            share = prompt if rng.rand() < 0.8 else None
            assert t.trie.match(prompt) == j.trie.match(prompt)
            jp, tp = j.plan_admission(total, share), \
                t.plan_admission(total, share)
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp), step
            if tp.need_pages > t.free_pages:
                continue
            dst = t.admit(slot, tp)
            assert dst == j.admit(slot, jp), step
            hits += tp.shared_tokens > 0
            cows += dst is not None
            prompts[slot] = prompt
            n = len(prompt) - int(tp.shared_tokens)
            t.append(slot, n)
            j.append(slot, n)
            t.publish(slot, prompt)
            j.publish(slot, prompt)
        elif op == 1 and busy:
            slot = busy[rng.randint(0, len(busy))]
            room = (len(t._pages_of[slot]) * tc.page_size
                    - int(t.lengths[slot]))
            if room > 0:
                t.append(slot)
                j.append(slot)
        elif op == 2 and busy:
            slot = busy[rng.randint(0, len(busy))]
            t.free(slot)
            j.free(slot)
            prompts.pop(slot, None)
        _same_state(j, t, step)
        refs = np.zeros(tc.num_pages, np.int64)
        for i in range(tc.max_seqs):
            for p in t._pages_of[i]:
                refs[p] += 1
        np.testing.assert_array_equal(refs, t._ref)
        for i, prompt in prompts.items():
            for col, p in enumerate(t._pages_of[i]):
                if refs[p] > 1:
                    assert col < len(prompt) // tc.page_size, (step, i)
    assert hits > 0 and cows > 0
    for i in range(tc.max_seqs):
        if t._pages_of[i]:
            t.free(i)
            j.free(i)
    _same_state(j, t, "drained")
    assert t.free_pages == tc.num_pages and not t.trie._node_of_page


def test_shared_page_writes_and_negative_refcounts_refused():
    """A write into a page with refcount > 1 raises, as JAX's does; the
    copy-on-write page takes writes; the last reader frees a page and
    drops its trie node; a refcount pushed negative raises."""
    _, tc = _cache_cfgs(num_pages=8, max_seqs=3)
    cache = TKV.PagedKVCache(tc)
    prompt = np.arange(9, dtype=np.int32)
    cache.admit(0, cache.plan_admission(12, prompt))
    cache.append(0, 9)
    cache.publish(0, prompt)
    plan = cache.plan_admission(12, np.r_[prompt[:9], 60, 61])
    assert (plan.shared_tokens, len(plan.shared_pages), plan.cow_rows) \
        == (9, 2, 1)
    dst = cache.admit(1, plan)
    assert dst is not None and cache.refcount(dst) == 1
    assert cache.lengths[1] == 9
    cache.append(1, 3)                       # into the private copy
    cache.lengths[1] = 7                     # force a write into page 1
    with pytest.raises(RuntimeError, match="shared page"):
        cache.append(1, 2)
    shared = plan.shared_pages
    cache.free(0)
    assert [cache.refcount(p) for p in shared] == [1, 1]
    cache.free(1)
    assert [cache.refcount(p) for p in shared] == [0, 0]
    assert cache.plan_admission(12, prompt).shared_tokens == 0
    cache._pages_of[2] = [5]
    with pytest.raises(RuntimeError, match="negative"):
        cache.free(2)


def test_prefix_match_len_probe_is_readonly_as_jax():
    """The probe (JAX ``tests/test_fleet.py``'s case) on both caches:
    resident tokens capped at prompt_len - 1, foreign prompts 0, and no
    lookup or hit counted."""
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=16, num_pages=16,
              page_size=4, max_seqs=2, max_pages_per_seq=4)
    caches = [JKV.PagedKVCache(JKV.CacheConfig(**kw).validate()),
              TKV.PagedKVCache(TKV.CacheConfig(**kw).validate())]
    toks = np.arange(8)
    for cache in caches:
        cache.allocate(0, 8)
        cache.publish(0, toks)
        before = cache.prefix_lookups
        got = [cache.prefix_match_len(p)
               for p in (toks, np.arange(50, 58), None, toks[:1],
                         np.r_[toks[:6], 40, 41])]
        assert got == [7, 0, 0, 0, 6]
        assert cache.prefix_lookups == before and cache.prefix_hits == 0
        assert "prefix" not in cache.stats()


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_copy_page_moves_one_page_of_every_pool(cache_dtype):
    """``copy_page`` copies page src into dst along axis 2 of both pools
    and, quantized, both scale arrays, bytes exact; no other page
    changes (the JAX engine's ``_cow_copy``)."""
    _, tc = _cache_cfgs(num_layers=2, num_pages=6,
                        cache_dtype=cache_dtype)
    pools = TKV.device_buffers(tc, "cpu")
    gen = torch.Generator().manual_seed(1)
    for t in pools:
        bits = TKV._bits(t)
        bits.copy_(torch.randint(0, 100, bits.shape, generator=gen)
                   .to(bits.dtype))
    before = [TKV._bits(t).clone() for t in pools]
    TKV.copy_page(pools, 4, 1)
    for t, b in zip(pools, before):
        after = TKV._bits(t)
        assert torch.equal(after[:, :, 1], b[:, :, 4])
        keep = [p for p in range(6) if p != 1]
        assert torch.equal(after[:, :, keep], b[:, :, keep])
    assert len(pools) == (2 if cache_dtype == "bf16" else 4)


# ---------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("spec,n", [(PREFIX_PLAN, 1), (PREFIX_PLAN, 4),
                                    (COW_PLAN, 1), (COW_PLAN, 4)])
def test_sharing_streams_equal_jax_and_the_unshared_run(weights,
                                                        jax_streams,
                                                        spec, n):
    """Greedy streams with sharing equal the JAX engine's (with sharing,
    at N=1) and the port's unshared run, exactly, at N=1 and N=4 (the
    fused path: block tables uploaded at the admission boundary); the
    prefix was shared, with copy-on-write copies on the 9-token plan."""
    _, tp = weights
    want = jax_streams(spec, prefix_sharing=True)
    off, _ = port_run(tp, spec, multi_step_n=n)
    on, eng = port_run(tp, spec, multi_step_n=n, prefix_sharing=True)
    assert on == off == want
    st = eng.cache.stats()["prefix"]
    assert st["hits"] > 0 and st["bytes_saved"] > 0
    assert 0 < st["hit_rate"] <= 1
    if spec is COW_PLAN:
        assert st["cow_copies"] > 0


@pytest.mark.parametrize("n", [1, 4])
def test_sampled_sharing_streams_equal_jax(weights, jax_streams, n):
    """Seeded sampling with sharing: equal to the JAX engine's sampled
    streams with sharing and to the port's sampled run without it."""
    _, tp = weights
    want = jax_streams(COW_PLAN, prefix_sharing=True, **SAMPLED)
    off, _ = port_run(tp, COW_PLAN, multi_step_n=n, **SAMPLED)
    on, eng = port_run(tp, COW_PLAN, multi_step_n=n, prefix_sharing=True,
                       **SAMPLED)
    assert on == off == want
    assert eng.cache.stats()["prefix"]["hits"] > 0


def test_grammar_and_inline_prefill_compose_with_sharing(weights):
    """The JSON grammar over the fused path, and inline prefill (one
    chunk a step, resuming at the shared length), with sharing: streams
    equal the unshared runs'."""
    _, tp = weights
    for kw in (dict(multi_step_n=4, temperature=0.8, sample_seed=3,
                    grammar="json"),
               dict(prefill="inline")):
        off, _ = port_run(tp, COW_PLAN, **kw)
        on, eng = port_run(tp, COW_PLAN, prefix_sharing=True, **kw)
        assert on == off
        assert eng.cache.stats()["prefix"]["hits"] > 0


def test_sharing_composes_with_int8_cache(weights, jax_streams):
    """Sharing over an int8 cache, at the JAX package's bar
    (``tests/test_kv_density.py``): the streams equal the unshared int8
    run's, and the JAX int8 engine's with sharing."""
    _, tp = weights
    want = jax_streams(PREFIX_PLAN, cache_dtype="int8",
                       prefix_sharing=True)
    off, _ = port_run(tp, PREFIX_PLAN, cache_dtype="int8")
    on, eng = port_run(tp, PREFIX_PLAN, cache_dtype="int8",
                       prefix_sharing=True)
    assert on == off == want
    assert eng.cache.stats()["prefix"]["hits"] > 0


def test_record_sharing_globals_equal_jax(weights):
    """``run_serving`` with sharing on the t=0 plan: the record's
    ``prefix_hit_rate``, ``prefix_bytes_saved``, the cache's prefix
    block and ``serving_config.prefix_sharing`` equal JAX's; the
    unshared record stamps no sharing globals."""
    jp, tp = weights
    cfg = dict(SERVING, prefix_sharing=True)
    jplan, tplan = _plan(T0_PLAN)
    jres = j_run_serving(jax_model(), JServing(**cfg), jplan, params=jp)
    tres = TS.run_serving(torch_model(), TS.ServingConfig(**cfg), tplan,
                          params=tp, device="cpu")
    jg, tg = jres.global_meta, tres.global_meta
    for key in ("prefix_hit_rate", "prefix_bytes_saved"):
        assert tg[key] == jg[key]
    assert tg["prefix_hit_rate"] > 0 and tg["prefix_bytes_saved"] > 0
    assert tg["serving"]["kv_cache"]["prefix"] \
        == jg["serving"]["kv_cache"]["prefix"]
    assert tg["serving_config"]["prefix_sharing"] is True
    tsc, jsc = tg["serving_config"], jg["serving_config"]
    shared = set(tsc) & set(jsc)
    assert {k: tsc[k] for k in shared} == {k: jsc[k] for k in shared}
    assert "prefix_sharing" in shared
    off = TS.run_serving(torch_model(), TS.ServingConfig(**SERVING), tplan,
                         params=tp, device="cpu").global_meta
    assert "prefix_hit_rate" not in off
    assert off["serving_config"]["prefix_sharing"] is False
    assert "prefix" not in off["serving"]["kv_cache"]
