"""The port's fused decode loop held against the JAX package's on the CPU:
N-step token streams against JAX's and the port's own 1-step streams
over every cache dtype and both prefill modes, the loop program against
iterated single steps and JAX's loop, the device-state sync contract,
adaptive N, the config guards' messages, the record's decode_loop block,
``attn_impl``, ``pages_for_pool_bytes``, and the serving_decode and
kv_density_ab line assemblers against the JAX bench's.  The model is
JAX's tiny serving model (vocab 64, embed 32, heads 4/2, ff 64, 2
layers, f32), its weights handed to the port through numpy."""
from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JBENCH
from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import decode as JD
from dlnetbench_tpu.serving import kv_cache as JKV
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu.serving.device_state import \
    DeviceDecodeState as JDeviceState
from dlnetbench_tpu.serving.scheduler import Engine as JEngine
from dlnetbench_tpu.serving.scheduler import ServingConfig as JServing
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import decode as TD
from dlnetbench_tpu_torch.serving import kv_cache as TKV
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan
from dlnetbench_tpu_torch.serving.arrivals import Request, _Rng
from dlnetbench_tpu_torch.serving.device_state import (DeviceDecodeState,
                                                       SyncContractError)

MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=32)
SERVING = dict(slots=4, page_size=4, num_pages=32, max_seq_len=32,
               slo_ttft_ms=200.0, slo_tpot_ms=100.0, warmup_requests=0)
PLAN = dict(kind="poisson", rate_rps=200.0, num_requests=10, seed=7,
            prompt_len=[4, 9], output_len=[1, 7])


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
def jax_streams(weights):
    """Memoized JAX engine streams per config override."""
    memo: dict = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in memo:
            eng = JEngine(jax_model(), JServing(**{**SERVING, **kw}),
                          params=weights[0])
            done, _ = eng.run(JPlan.from_dict(PLAN).sample())
            assert len(done) == PLAN["num_requests"]
            memo[key] = dict(eng.token_streams)
        return memo[key]
    return get


def port_run(tp, **kw):
    eng = TS.Engine(torch_model(), TS.ServingConfig(**{**SERVING, **kw}),
                    params=tp, device="cpu")
    done, _ = eng.run(TPlan.from_dict(PLAN).sample())
    assert len(done) == PLAN["num_requests"]
    assert eng.cache.pages_in_use == 0
    return dict(eng.token_streams), eng


# ---------------------------------------------------------------------
# token parity


CASES = [("bf16", "separate"), ("bf16", "inline"), ("int8", "separate"),
         ("fp8", "inline")]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("cache_dtype,prefill", CASES)
def test_multi_step_streams_equal_jax_and_one_step(weights, jax_streams,
                                                   cache_dtype, prefill, n):
    """N-step greedy == the port's 1-step == JAX's 1-step, exactly (and
    == JAX's own fused N=4 engine on the dense cache); the fused path
    really fused."""
    _, tp = weights
    kw = dict(cache_dtype=cache_dtype, prefill=prefill)
    if prefill == "inline":
        kw["prefill_chunk"] = 4
    one, _ = port_run(tp, **kw)
    assert one == jax_streams(**kw)
    got, eng = port_run(tp, multi_step_n=n, **kw)
    assert got == one
    if n == 4 and (cache_dtype, prefill) == CASES[0]:
        assert got == jax_streams(multi_step_n=4, **kw)
    blk = eng.decode_loop_block()
    assert blk["multi_step_n"] == n and blk["device_steps"] > 0
    assert blk["steps_per_dispatch"] >= 1.0
    assert blk["sync_h2d_us"]["n"] >= 1


def test_multi_step_n1_is_classic_engine(weights, jax_streams):
    """multi_step_n=1 builds no loop and no device state, and its
    streams and block are the classic engine's."""
    _, tp = weights
    eng = TS.Engine(torch_model(), TS.ServingConfig(**SERVING,
                                                    multi_step_n=1),
                    params=tp, device="cpu")
    assert eng._loop is None and eng._decode is not None
    assert eng.dstate is None
    eng.run(TPlan.from_dict(PLAN).sample())
    assert dict(eng.token_streams) == jax_streams()
    blk = eng.decode_loop_block()
    assert blk["steps_per_dispatch"] == 1.0
    assert blk["host_dispatch_us"]["n"] > 0
    assert "sync_h2d_us" not in blk


def test_fused_dispatch_issues_no_trip_past_the_budget(weights):
    """The host knows every budget: a fused dispatch issues exactly the
    trips the JAX loop would run, so the launched device steps equal
    the steps the loop found an active slot in."""
    _, tp = weights
    d0, s0 = TS.decode_dispatches, TS.decode_device_steps
    _, eng = port_run(tp, multi_step_n=8, adaptive_n=False)
    assert TS.decode_dispatches - d0 == eng._dispatches
    assert TS.decode_device_steps - s0 == eng._device_steps
    assert eng._device_steps > eng._dispatches


def test_multi_step_loop_matches_iterated_single_steps_and_jax(weights):
    """Op level: the loop's token block over N trips equals N iterated
    single steps on the same starting state, and JAX's loop on the same
    inputs (tokens, counts, state, steps_run, early exit)."""
    jp, tp = weights
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_pages=16,
              page_size=4, max_seqs=2, max_pages_per_seq=6)
    jcc, tcc = JKV.CacheConfig(**kw), TKV.CacheConfig(**kw)
    cache = TKV.PagedKVCache(tcc)
    k, v = TKV.device_buffers(tcc, "cpu")
    prompt = np.array([5, 9, 3, 11, 7], np.int32)
    cache.allocate(0, len(prompt) + 8)
    row = torch.from_numpy(cache.block_tables[0].copy())
    k, v, nxt = TD.make_prefill_chunk(torch_model(), tcc, 5)(
        tp, k, v, torch.from_numpy(prompt), 0, 5, row)
    cache.append(0, 5)
    first = int(nxt)
    bt = torch.from_numpy(cache.block_tables.copy())
    step = TD.make_decode_step(torch_model(), tcc)
    k1, v1 = k.clone(), v.clone()
    last, pos, ref = first, 5, []
    for _ in range(4):
        k1, v1, nx = step(tp, k1, v1, torch.tensor([last, 0],
                                                   dtype=torch.int32),
                          torch.tensor([pos, 0], dtype=torch.int32), bt,
                          torch.tensor([True, False]))
        last = int(nx[0])
        pos += 1
        ref.append(last)
    state = np.zeros((TD.STATE_ROWS, 2), np.int32)
    state[TD.STATE_LAST, 0] = first
    state[TD.STATE_POS, 0] = 5
    state[TD.STATE_REM, 0] = 4
    state[TD.STATE_LIMIT, 0] = 13
    loop = TD.make_multi_step_decode(torch_model(), tcc, n_max=8)
    jloop = jax.jit(JD.make_multi_step_decode(jax_model(), jcc, n_max=8))
    jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
    for n_steps in (4, 8):          # 8: the loop finds no active slot
        k2, v2 = k.clone(), v.clone()
        tstate = torch.from_numpy(state)
        _, _, st, out, cnt, steps = loop(tp, k2, v2, tstate, bt, n_steps)
        assert np.array_equal(tstate.numpy(), state)   # input untouched
        assert int(steps) == 4 and int(cnt[0]) == 4 and int(cnt[1]) == 0
        assert out[0, :4].tolist() == ref
        assert st[TD.STATE_POS, 0] == 9 and st[TD.STATE_REM, 0] == 0
        torch.testing.assert_close(k2, k1, rtol=0, atol=0)
        _, _, jst, jout, jcnt, jsteps = jloop(
            jp, jk, jv, jnp.asarray(state), jnp.asarray(bt.numpy()),
            jnp.int32(n_steps))
        assert int(jsteps) == int(steps)
        np.testing.assert_array_equal(np.asarray(jout), out.numpy())
        np.testing.assert_array_equal(np.asarray(jcnt), cnt.numpy())
        np.testing.assert_array_equal(np.asarray(jst), st.numpy())


def test_multi_step_loop_refuses_bad_arguments():
    tcc = TKV.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=8,
                          num_pages=16, page_size=4, max_seqs=2,
                          max_pages_per_seq=6)
    with pytest.raises(ValueError, match="n_max"):
        TD.make_multi_step_decode(torch_model(), tcc, n_max=0)
    with pytest.raises(ValueError, match="attn_impl"):
        TD.make_multi_step_decode(torch_model(), tcc, n_max=2,
                                  attn_impl="flash")
    loop = TD.make_multi_step_decode(torch_model(), tcc, n_max=2)
    with pytest.raises(TypeError, match="state, block_tables"):
        loop({}, None, None, None)


# ---------------------------------------------------------------------
# the host/device state split


def test_device_state_roundtrip_property():
    """Any interleaving of admit / evict / device advance / flush / pull
    round-trips losslessly: after a final pull the port's host mirrors
    equal a pure-host model of the same operations and JAX's
    DeviceDecodeState driven alongside."""
    slots, pmax, vocab = 4, 6, 32
    ds = DeviceDecodeState(slots, pmax, vocab=vocab)
    jds = JDeviceState(slots, pmax, vocab=vocab)
    ref = {"state": np.zeros((TD.STATE_ROWS, slots), np.int32),
           "bt": np.zeros((slots, pmax), np.int32),
           "tab": np.zeros((slots, vocab), np.int32)}

    def advance(state, table):
        state, table = state.clone(), table.clone()
        last, pos = state[TD.STATE_LAST].clone(), state[TD.STATE_POS]
        act = state[TD.STATE_REM] > 0
        nxt = (last * 7 + pos) % vocab
        rows = torch.arange(state.shape[1])
        col = torch.where(act, last, 0).long()
        table[rows, col] = torch.where(act, nxt, table[rows, col])
        state[TD.STATE_LAST] = torch.where(act, nxt, last)
        state[TD.STATE_POS] += act.to(torch.int32)
        state[TD.STATE_REM] -= act.to(torch.int32)
        return state, table

    def jadvance(state, table):
        st, tab = advance(torch.from_numpy(np.array(state)),
                          torch.from_numpy(np.array(table)))
        return jnp.asarray(st.numpy()), jnp.asarray(tab.numpy())

    def ref_advance():
        st, tab = ref["state"], ref["tab"]
        for s in range(slots):
            if st[TD.STATE_REM, s] > 0:
                last, pos = st[TD.STATE_LAST, s], st[TD.STATE_POS, s]
                nxt = (last * 7 + pos) % vocab
                tab[s, last] = nxt
                st[TD.STATE_LAST, s] = nxt
                st[TD.STATE_POS, s] += 1
                st[TD.STATE_REM, s] -= 1

    rng = _Rng(123)
    for _ in range(120):
        op = rng.uniform_int(0, 3)
        if op == 0:
            for d in (ds, jds):
                d.pull()
            s = rng.uniform_int(0, slots - 1)
            row = np.asarray([rng.uniform_int(0, 15)
                              for _ in range(pmax)], np.int32)
            tab_row = np.asarray([rng.uniform_int(0, vocab - 1)
                                  for _ in range(vocab)], np.int32)
            kw = dict(last_token=rng.uniform_int(0, vocab - 1),
                      position=rng.uniform_int(0, 10),
                      remaining=rng.uniform_int(1, 6), seq_limit=16,
                      uid=rng.uniform_int(0, 20) - 5,
                      grammar_state=rng.uniform_int(0, 9))
            for d in (ds, jds):
                d.admit(s, block_row=row, ngram_row=tab_row, **kw)
            ref["state"][:, s] = [kw["last_token"], kw["position"],
                                  kw["remaining"], kw["seq_limit"],
                                  kw["uid"], kw["grammar_state"]]
            ref["bt"][s] = row
            ref["tab"][s] = tab_row
            # a mirror mutated after admit must not reach the device
            row[:] = -1
        elif op == 1:
            s = rng.uniform_int(0, slots - 1)
            for d in (ds, jds):
                d.pull()
                d.evict(s)
            ref["state"][TD.STATE_REM, s] = 0
        elif op == 2:
            ds.rebind(advance(*ds.carries()))
            jds.rebind(jadvance(*jds.carries()))
            ref_advance()
        else:
            for d in (ds, jds):
                d.pull()
    for d in (ds, jds):
        d.pull()
    view, jview = ds.host_view(), jds.host_view()
    assert view.keys() == jview.keys()
    for key in view:
        np.testing.assert_array_equal(view[key], jview[key])
    np.testing.assert_array_equal(view["block_tables"], ref["bt"])
    np.testing.assert_array_equal(view["ngram_table"], ref["tab"])
    for key, r in (("last_tokens", TD.STATE_LAST),
                   ("positions", TD.STATE_POS),
                   ("remaining", TD.STATE_REM), ("uids", TD.STATE_UID),
                   ("grammar_states", TD.STATE_GRAMMAR)):
        np.testing.assert_array_equal(view[key], ref["state"][r])
    assert ds.sync_h2d_us and ds.sync_d2h_us
    assert set(ds.sync_stats()) == set(jds.sync_stats())


def test_device_state_stale_mutation_refused():
    """Mutating a stale mirror raises JAX's SyncContractError message;
    after a pull the mirror is writable again."""
    from dlnetbench_tpu.serving.device_state import \
        SyncContractError as JSyncError
    msgs = []
    for cls, err in ((DeviceDecodeState, SyncContractError),
                     (JDeviceState, JSyncError)):
        ds = cls(2, 4)
        ds.admit(0, last_token=3, position=2, remaining=4, seq_limit=8,
                 block_row=np.zeros(4, np.int32))
        ds.rebind(ds.carries())
        with pytest.raises(err, match="STALE") as e1:
            ds.admit(1, last_token=1, position=0, remaining=2,
                     seq_limit=8, block_row=np.zeros(4, np.int32))
        with pytest.raises(err, match="STALE") as e2:
            ds.evict(0)
        ds.pull()
        ds.evict(0)
        assert ds.host_view()["remaining"][0] == 0
        with pytest.raises(ValueError, match="rebind got 2"):
            ds.rebind((1, 2))
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------
# adaptive N


def test_pick_n_steps_policy_matches_jax(weights):
    """The scripted policy, on the port's engine and JAX's side by
    side: nothing waiting runs N, pending work caps at the shortest
    remaining output, an arrival due in ~2 measured steps caps at 2, a
    prefilling slot pins 1, adaptive off runs N."""
    from dlnetbench_tpu.serving.arrivals import Request as JRequest
    from dlnetbench_tpu.serving.scheduler import _SlotState as JSlot
    jp, tp = weights
    teng = TS.Engine(torch_model(), TS.ServingConfig(**SERVING,
                                                     multi_step_n=8),
                     params=tp, device="cpu")
    jeng = JEngine(jax_model(), JServing(**SERVING, multi_step_n=8),
                   params=jp)
    picks = []
    for eng, slot_cls, req_cls in ((teng, TS._SlotState, Request),
                                   (jeng, JSlot, JRequest)):
        eng._reset_state()
        eng._t0 = time.monotonic()

        def slot(prompt, out, generated):
            st = slot_cls(req_cls(rid=0, arrival_s=0.0,
                                  prompt_len=prompt, output_len=out),
                          admitted_s=0.0)
            st.prefill_done = prompt
            st.generated = generated
            return st

        got = []
        eng.slots[0] = slot(4, 6, 1)
        eng.slots[1] = slot(4, 4, 1)
        got.append(eng._pick_n_steps([0, 1]))
        eng.pending.append(req_cls(rid=9, arrival_s=0.0, prompt_len=4,
                                   output_len=2))
        got.append(eng._pick_n_steps([0, 1]))
        eng.pending.clear()
        eng._step_ewma_s = 1.0
        eng.queue.append(req_cls(rid=10, arrival_s=1.5, prompt_len=4,
                                 output_len=2))
        got.append(eng._pick_n_steps([0, 1]))
        eng.queue.clear()
        eng.slots[2] = slot(4, 4, 0)
        eng.slots[2].prefill_done = 2
        got.append(eng._pick_n_steps([0, 1]))
        eng.cfg = dataclasses.replace(eng.cfg, adaptive_n=False)
        got.append(eng._pick_n_steps([0, 1]))
        picks.append(got)
    assert picks[0] == picks[1] == [8, 3, 2, 1, 8]


# ---------------------------------------------------------------------
# config guards


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("over", [
    {"multi_step_n": 0}, {"speculative": True, "spec_k": 0},
    {"speculative": True, "drafter": "oracle"}, {"top_p": 0.9},
    {"temperature": 0.8, "top_p": 1.5}, {"temperature": -1.0},
    {"speculative": True, "temperature": 0.8, "drafter": "ngram"},
    {"speculative": True, "cache_dtype": "int8"},
    {"grammar": "yaml"}, {"temperature": 0.0, "top_k": 3}])
def test_serving_config_validation_messages_match_jax(over):
    assert _message(lambda: TS.ServingConfig(**SERVING,
                                             **over).validate()) \
        == _message(lambda: JServing(**SERVING, **over).validate())


def test_engine_refuses_full_depth_drafter_like_jax(weights):
    jp, tp = weights
    kw = dict(speculative=True, drafter="truncated", drafter_layers=2)
    got = _message(lambda: TS.Engine(torch_model(),
                                     TS.ServingConfig(**SERVING, **kw),
                                     params=tp, device="cpu"))
    want = _message(lambda: JEngine(jax_model(), JServing(**SERVING, **kw),
                                    params=jp))
    assert got == want and "drafter_layers" in got
    with pytest.raises(ValueError, match="attn_impl"):
        TS.ServingConfig(**SERVING, attn_impl="flash").validate()


# ---------------------------------------------------------------------
# attn_impl and pages_for_pool_bytes


def test_attn_impl_names_and_refusals():
    """``auto`` on a CPU tensor is the plain gather (bitwise), ``gather``
    is the plain version by name, equal to JAX's gather math; an
    unknown name is refused."""
    rng = np.random.RandomState(0)
    k = torch.from_numpy(rng.randn(2, 8, 4, 32).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 8, 4, 32).astype(np.float32))
    q = torch.from_numpy(rng.randn(3, 4, 32).astype(np.float32))
    lengths = torch.tensor([5, 1, 12], dtype=torch.int32)
    bt = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7], [7, 6, 5, 4]],
                      dtype=torch.int32)
    auto = TKV.paged_attention_decode(q, k, v, lengths, bt)
    gather = TKV.paged_attention_decode(q, k, v, lengths, bt,
                                        impl="gather")
    assert torch.equal(auto, gather)
    want = JKV.paged_attention_decode(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(lengths.numpy()),
        jnp.asarray(bt.numpy()), impl="gather")
    np.testing.assert_allclose(gather.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown impl"):
        TKV.paged_attention_decode(q, k, v, lengths, bt, impl="flash")


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "fp8"])
def test_pages_for_pool_bytes_matches_jax(cache_dtype):
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=16, num_pages=1,
              page_size=8, max_seqs=24, max_pages_per_seq=5,
              cache_dtype=cache_dtype)
    for budget in (1, 1000, 102400, 10 ** 9):
        assert TKV.pages_for_pool_bytes(budget, TKV.CacheConfig(**kw)) \
            == JKV.pages_for_pool_bytes(budget, JKV.CacheConfig(**kw))
    with pytest.raises(ValueError, match="budget"):
        TKV.pages_for_pool_bytes(0, TKV.CacheConfig(**kw))


# ---------------------------------------------------------------------
# the record


def test_serving_record_carries_decode_loop_and_attribution(weights):
    """run_serving -> record: the serving block's decode_loop (syncs,
    spec), the serving_config's loop knobs and ``attn_impl``, the
    serving_dispatch attribution, and JAX's parser hoisting the
    columns."""
    from dlnetbench_tpu.metrics.parser import (records_to_dataframe,
                                               validate_record)
    from dlnetbench_tpu_torch.metrics.emit import result_to_record
    _, tp = weights
    sc = TS.ServingConfig(**{**SERVING, "warmup_requests": 2},
                          multi_step_n=4, speculative=True, spec_k=2)
    plan = TPlan(kind="poisson", rate_rps=200.0, num_requests=6, seed=1,
                 prompt_len=[4, 8], output_len=[2, 5])
    rec = result_to_record(TS.run_serving(torch_model(), sc, plan,
                                          params=tp, device="cpu"))
    validate_record(rec)
    dl = rec["global"]["serving"]["decode_loop"]
    assert dl["multi_step_n"] == 4 and dl["speculative"]
    assert dl["dispatches"] >= 1 and dl["host_dispatch_us"]["n"] >= 1
    assert dl["sync_h2d_us"]["n"] >= 1
    assert dl["spec"]["k"] == 2 and dl["spec"]["rounds_idle"] >= 0
    sc_rec = rec["global"]["serving_config"]
    assert sc_rec["multi_step_n"] == 4 and sc_rec["spec_k"] == 2
    assert sc_rec["attn_impl"] == "auto"
    assert "sampling" not in rec["global"]
    attr = rec["global"]["attribution"]
    assert attr["inputs"]["source"] == "serving_dispatch"
    assert attr["inputs"]["steps_per_dispatch"] == \
        dl["steps_per_dispatch"]
    assert attr["bound"] == "host"
    assert abs(sum(attr["fractions"].values()) - 1.0) < 1e-3
    df = records_to_dataframe([rec])
    for col in ("serving_steps_per_dispatch", "serving_tokens_per_sync",
                "serving_host_dispatch_us_p50",
                "serving_spec_acceptance"):
        assert col in df.columns, col


def test_dispatch_decomposition_matches_jax():
    from dlnetbench_tpu.analysis import attribution as JA
    from dlnetbench_tpu_torch.analysis import attribution as TA
    one = {"device_us": {"total": 50 * 500.0 + 9999.0},
           "decode_device_us": {"total": 50 * 500.0},
           "device_steps": 50, "steps_per_dispatch": 1.0,
           "dispatches": 50, "host_dispatch_us": {"total": 7.0}}
    multi = {"device_us": {"total": 48 * 100.0 + 6 * 400.0 + 9999.0},
             "decode_device_us": {"total": 48 * 100.0 + 6 * 400.0},
             "device_steps": 48, "steps_per_dispatch": 8.0,
             "dispatches": 6, "sync_h2d_us": {"total": 3.0}}
    dec = TA.dispatch_decomposition(one, multi)
    assert dec == JA.dispatch_decomposition(one, multi)
    assert abs(dec["dispatch_us"] - 400.0) < 1.0
    for blk in (one, multi):
        assert TA.serving_host_us(blk, dec["dispatch_us"]) \
            == JA.serving_host_us(blk, dec["dispatch_us"])
    assert TA.dispatch_decomposition(one, one) is None


# ---------------------------------------------------------------------
# the serving_decode and kv_density_ab line assemblers


def _ab_round(p99, tps, *, n=1, spd=1.0, dev_us=0.0, steps=50, disp=50,
              host_us=100.0, spec=None):
    dl = {"multi_step_n": n, "dispatches": disp, "device_steps": steps,
          "steps_per_dispatch": spd, "tokens_per_sync": spd,
          "device_us": {"total": dev_us},
          "host_dispatch_us": {"total": host_us}}
    if spec:
        dl["spec"] = spec
    return {"e2e_ms": {"p99": p99}, "ttft_ms": {"p50": 2.0},
            "tpot_ms": {"p50": 1.0}, "tokens_per_s": tps,
            "goodput_frac": 1.0, "completed": 8, "offered_rps": 80.0,
            "wall_s": 0.1, "decode_loop": dl}


@pytest.mark.parametrize("variant", ["base", "ab", "ab_no_spec"])
def test_serving_decode_line_equals_bench_py(variant):
    one = [_ab_round(30.0 + i, 4000.0 - 10 * i, dev_us=50 * 1000.0)
           for i in range(3)]
    multi = [_ab_round(15.0, 8000.0 + i, n=8, spd=8.0,
                       dev_us=48 * 500.0 + 6 * 500.0, steps=48, disp=6,
                       host_us=120.0) for i in range(3)]
    spec = [_ab_round(14.0, 9000.0, n=8, spd=9.0, dev_us=30000.0,
                      steps=45, disp=5, host_us=110.0,
                      spec={"k": 4, "drafter": "ngram",
                            "acceptance_rate": 0.4 + 0.01 * i})
            for i in range(3)]
    kw = {"base": {},
          "ab": dict(multi_rounds=multi, spec_rounds=spec,
                     token_parity=True),
          "ab_no_spec": dict(multi_rounds=multi, token_parity=False)}[
              variant]
    got = TBENCH.serving_decode_line(one, ", test", **kw)
    assert got == JBENCH._serving_decode_line(one, ", test", **kw)
    if variant == "ab":
        assert got["token_parity"] is True
        assert got["attribution_flip"]["band_disjoint_drop"] is True


@pytest.mark.parametrize("int8_err", [0.011, 0.2])
def test_kv_density_line_equals_bench_py(int8_err):
    def srv(p99, adm, tps, grps):
        return {"e2e_ms": {"p99": p99}, "tokens_per_s": tps,
                "goodput_frac": 1.0, "goodput_rps": grps,
                "admitted_concurrency_peak": adm,
                "kv_cache": {"num_pages": 25 if adm < 10 else 96,
                             "pool_bytes": 102400}}
    rounds = {
        "bf16": [srv(90.0, 7, 3000.0, 200.0), srv(95.0, 7, 2900.0, 195.0),
                 srv(92.0, 7, 3100.0, 205.0)],
        "int8": [srv(55.0, 20, 5000.0, 350.0),
                 srv(58.0, 20, 5200.0, 360.0),
                 srv(56.0, 20, 5100.0, 355.0)],
        "fp8": [srv(100.0, 20, 2900.0, 190.0),
                srv(105.0, 20, 2800.0, 185.0),
                srv(102.0, 20, 2850.0, 188.0)]}
    parity = {"int8": [0.01, int8_err, 0.011], "fp8": [0.07, 0.08, 0.075]}
    got = TBENCH.kv_density_line(rounds, parity, 102400, suffix=", t")
    assert got == JBENCH._kv_density_line(rounds, parity, 102400,
                                          suffix=", t")
    assert got["variants"]["int8"]["parity_ok"] is (int8_err < 0.05)


@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
def test_kv_parity_probe_within_the_bar_and_near_jax(cache_dtype):
    """The density line's parity probe: within the stated bar, and
    within 1e-5 of JAX's probe on the same seeded stream (both write
    through their own quantized write path)."""
    got = TBENCH.kv_parity_err(cache_dtype, 1, torch.device("cpu"))
    want = JBENCH._kv_parity_err(cache_dtype, 1)
    assert got <= TKV.QUANT_DECODE_TOL[cache_dtype]
    assert got == pytest.approx(want, abs=1e-5)
