"""The port's seeded sampling and grammar-constrained decode held against
the JAX package's on the CPU: the key derivation's golden values and the
device twin over a grid against the host twin and JAX's, the filter
pipeline and the inverse-CDF draw against JAX's on the same inputs, the
grammar tables and automaton, the validators' messages, sampled and
grammar streams (1-step and fused) against JAX's engines, the replay
property, the chi-square draw distribution, the sampling_ab assembler
against the JAX bench's, and the CLI's flags and record.  JAX's tiny
serving model, its weights handed to the port through numpy."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JBENCH
from dlnetbench_tpu.models import transformer as jtfm
from dlnetbench_tpu.serving import sampling as JSMP
from dlnetbench_tpu.serving.arrivals import ArrivalPlan as JPlan
from dlnetbench_tpu.serving.scheduler import Engine as JEngine
from dlnetbench_tpu.serving.scheduler import ServingConfig as JServing
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch import cli as tcli
from dlnetbench_tpu_torch.models import transformer as ttfm
from dlnetbench_tpu_torch.serving import sampling as SMP
from dlnetbench_tpu_torch.serving import scheduler as TS
from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan as TPlan

import scripted_clock

MODEL = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=64)
SAMPLED = dict(slots=2, page_size=4, num_pages=64, max_seq_len=64,
               prefill_chunk=8, attn_impl="gather", warmup_requests=0,
               temperature=0.8, top_p=0.9, sample_seed=11)
PLAN = dict(kind="poisson", rate_rps=100.0, num_requests=8, seed=3,
            prompt_len=[4, 8], output_len=[4, 10])
LANES = (SMP.LANE_TOKEN, SMP.LANE_ACCEPT, SMP.LANE_RESID, SMP.LANE_DRAFT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jc = jtfm.TransformerConfig(**MODEL, gated=True, max_positions=0,
                                dtype="float32")
    jp = jtfm.init_params(jax.random.key(0), jc)
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tp


def port_streams(tp, **kw) -> dict:
    eng = TS.Engine(ttfm.TransformerConfig(**MODEL, dtype="float32"),
                    TS.ServingConfig(**{**SAMPLED, **kw}), params=tp,
                    device="cpu")
    done, _ = scripted_clock.run(eng, TPlan.from_dict(PLAN).sample())
    assert len(done) == PLAN["num_requests"]
    return dict(eng.token_streams)


def jax_streams(jc, jp, **kw) -> dict:
    eng = JEngine(jc, JServing(**{**SAMPLED, **kw}), params=jp)
    scripted_clock.run(eng, JPlan.from_dict(PLAN).sample())
    return dict(eng.token_streams)


def pair(temperature=1.0, top_k=0, top_p=1.0, seed=0, grammar="",
         vocab=8):
    """The port's and JAX's samplers on the same knobs."""
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              sample_seed=seed, grammar=grammar)
    return (SMP.DeviceSampler(SMP.check_sampling_config(**kw), vocab),
            JSMP.DeviceSampler(JSMP.check_sampling_config(**kw), vocab))


# ---------------------------------------------------------------------
# key derivation


def test_key_bits_golden_values():
    assert SMP.key_bits(0, 0, 0, 0) == 0x37DD7702
    assert SMP.key_bits(7, 3, 11, 1) == 0xE540F20C
    assert SMP.key_bits(2**31, -2, 5, 3) == 0x74B4D306
    assert SMP.key_u01(7, 3, 11, 1) == (0xE540F20C >> 8) / float(1 << 24)


def test_key_u01_range_lane_independence_and_jax_host_twin():
    keys = [(s, u, c, lane) for s in (0, 7, 2**31) for u in (-3, 0, 5)
            for c in (0, 1, 9) for lane in range(4)]
    assert all(0.0 <= SMP.key_u01(*k) < 1.0 for k in keys)
    assert [SMP.key_bits(*k) for k in keys] \
        == [JSMP.key_bits(*k) for k in keys]
    assert len({SMP.key_bits(7, 1, 4, lane) for lane in range(4)}) == 4


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_device_u01_equals_host_twin_and_jax_over_a_grid(seed):
    """The int64 16-bit-halves twin is bit-exact with the host chain and
    JAX's uint32 twin over (uid, counter) extremes and random values,
    every lane."""
    s, js = pair(seed=seed, vocab=16)
    rng = np.random.RandomState(seed % 1000)
    edge = np.array([0, 1, -1, 2**31 - 1, -2**31, 0x7FFF, 0x8000,
                     0xFFFF, 0x10000], np.int64)
    uids = np.concatenate([edge, rng.randint(-2**31, 2**31 - 1, 200)])
    ctrs = np.concatenate([edge[::-1],
                           rng.randint(-2**31, 2**31 - 1, 200)])
    uids, ctrs = uids.astype(np.int32), ctrs.astype(np.int32)
    for lane in LANES:
        dev = s.u01(torch.from_numpy(uids), torch.from_numpy(ctrs),
                    lane).numpy()
        jdev = np.asarray(js.u01(jnp.asarray(uids), jnp.asarray(ctrs),
                                 lane))
        host = np.float32([SMP.key_u01(seed, int(u), int(c), lane)
                           for u, c in zip(uids, ctrs)])
        np.testing.assert_array_equal(dev, host)
        np.testing.assert_array_equal(dev, jdev)


# ---------------------------------------------------------------------
# the filter pipeline and the inverse CDF


def test_filter_temperature_zero_is_onehot():
    s = SMP.DeviceSampler(SMP.SamplingConfig(temperature=0.0), 8)
    p = s.probs(torch.tensor([[0.1, 2.0, -1.0, 0.0, 0.5, 0.2, 0.3, 0.4]]))
    assert p[0, 1] == 1.0 and p[0].sum() == 1.0


def test_filter_top_k_keeps_ties_like_jax():
    s, js = pair(top_k=2)
    x = np.array([[0.0, 1.0, 1.0, 3.0, -2.0, 0.0, 0.0, 0.0]], np.float32)
    p = s.probs(torch.from_numpy(x)).numpy()[0]
    assert p[3] > p[1] == p[2] > 0
    assert (p[[0, 4, 5, 6, 7]] == 0.0).all()
    np.testing.assert_allclose(p, np.asarray(js.probs(jnp.asarray(x)))[0],
                               rtol=1e-6, atol=1e-7)


def test_filter_top_p_keeps_top1_and_cuts_tail_like_jax():
    s, js = pair(top_p=0.5)
    for row in ([10.0] + [0.0] * 7, [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4,
                                     0.3]):
        x = np.array([row], np.float32)
        p = s.probs(torch.from_numpy(x)).numpy()[0]
        assert p[0] > 0 and p[7] == 0.0 and abs(p.sum() - 1.0) < 1e-6
        np.testing.assert_array_equal(
            p > 0, np.asarray(js.probs(jnp.asarray(x)))[0] > 0)


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.8, top_p=0.9), dict(temperature=1.3, top_k=5),
    dict(temperature=0.7, top_k=9, top_p=0.8),
    dict(temperature=0.5, top_p=0.95, grammar="json")])
def test_filtered_distribution_and_draws_equal_jax(knobs):
    """On the same logits (ties included) the filters keep the same
    tokens — stable top-p order — the probabilities agree to an ulp, the
    draw from identical probabilities is exact and the keyed token draws
    are JAX's."""
    s, js = pair(vocab=64, seed=7, **knobs)
    rng = np.random.RandomState(1)
    x = (rng.randn(128, 64) * 3).astype(np.float32)
    x[:16, :8] = 1.0                          # ties across the cutoff
    g = rng.randint(0, 10, 128).astype(np.int32)
    gt, gj = ((torch.from_numpy(g), jnp.asarray(g)) if knobs.get("grammar")
              else (None, None))
    p = s.probs(torch.from_numpy(x), gt).numpy()
    jp = np.array(js.probs(jnp.asarray(x), gj))
    np.testing.assert_array_equal(p > 0, jp > 0)
    np.testing.assert_allclose(p, jp, rtol=1e-6, atol=1e-7)
    u = rng.rand(128).astype(np.float32)
    np.testing.assert_array_equal(
        s.draw_from_probs(torch.from_numpy(jp), torch.from_numpy(u)),
        np.asarray(js.draw_from_probs(jnp.asarray(jp), jnp.asarray(u))))
    ids = np.arange(128, dtype=np.int32)
    np.testing.assert_array_equal(
        s.draw_tokens(torch.from_numpy(x), torch.from_numpy(ids),
                      torch.from_numpy(ids * 3), gt).numpy(),
        np.asarray(js.draw_tokens(jnp.asarray(x), jnp.asarray(ids),
                                  jnp.asarray(ids * 3), gj)))


def test_inverse_cdf_never_draws_zero_prob():
    s, _ = pair()
    p = torch.tensor([[0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    for u in (0.0, 0.3, 0.999999):
        assert int(s.draw_from_probs(p, torch.tensor([u]))) == 1


def test_draw_from_probs_matches_cdf_partition():
    s, js = pair()
    p = np.array([[0.25, 0.0, 0.5, 0.25, 0.0, 0.0, 0.0, 0.0]], np.float32)
    picks, jpicks = [], []
    for u in (0.0, 0.2, 0.26, 0.74, 0.76, 0.999):
        uu = np.array([u], np.float32)
        picks.append(int(s.draw_from_probs(torch.from_numpy(p),
                                           torch.from_numpy(uu))))
        jpicks.append(int(np.asarray(js.draw_from_probs(
            jnp.asarray(p), jnp.asarray(uu)))[0]))
    assert picks == jpicks == [0, 0, 2, 2, 3, 3]


# ---------------------------------------------------------------------
# the grammar automaton


def test_grammar_tables_equal_jax_and_never_empty():
    g, jg = SMP.compile_grammar("json", 64), JSMP.compile_grammar("json",
                                                                  64)
    assert g.num_states == 3 * SMP.JSON_MAX_DEPTH + 1 and g.start == jg.start
    np.testing.assert_array_equal(g.mask, jg.mask)
    np.testing.assert_array_equal(g.trans, jg.trans)
    assert g.mask.any(axis=1).all()
    for name, vocab, needle in (("yaml", 64, "grammar"),
                                ("json", 3, "vocab")):
        with pytest.raises(ValueError, match=needle) as e:
            SMP.compile_grammar(name, vocab)
        with pytest.raises(ValueError) as je:
            JSMP.compile_grammar(name, vocab)
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("stream,ok", [
    ([2, 6, 10], True), ([0, 2, 1], True), ([0, 2, 3, 2, 1], True),
    ([0, 4, 6, 1, 1], True), ([1], False), ([0, 3], False),
    ([0, 2, 2], False), ([0, 2], True)])
def test_grammar_validate_stream(stream, ok):
    g = SMP.compile_grammar("json", 64)
    assert SMP.validate_stream(g, stream) is ok
    assert JSMP.validate_stream(JSMP.compile_grammar("json", 64),
                                stream) is ok


def test_grammar_host_device_transitions_agree():
    s, _ = pair(temperature=0.8, grammar="json", vocab=64)
    g = s.grammar
    rng = np.random.RandomState(0)
    state, toks, states = g.start, [], [g.start]
    for _ in range(40):
        tok = int(rng.choice(np.nonzero(g.mask[state])[0]))
        toks.append(tok)
        state = int(g.trans[state, tok])
        states.append(state)
    dev = torch.full((1,), g.start, dtype=torch.int32)
    st = g.start
    for tok, want in zip(toks, states[1:]):
        dev = s.advance(dev, torch.tensor([tok], dtype=torch.int32))
        st = s.host_advance(st, tok)
        assert int(dev[0]) == st == want


def test_grammar_mask_zeroes_probs():
    s, _ = pair(grammar="json")
    p = s.probs(torch.zeros((1, 8)), torch.zeros(1, dtype=torch.int32))
    p = p.numpy()[0]
    assert p[1] == p[3] == p[5] == p[7] == 0.0
    assert p[0] > 0 and p[2] > 0 and abs(p.sum() - 1.0) < 1e-6


# ---------------------------------------------------------------------
# the validator


@pytest.mark.parametrize("kw", [
    dict(temperature=-0.1), dict(temperature=0.8, top_k=-1),
    dict(temperature=0.8, top_p=0.0), dict(temperature=0.8, top_p=-0.5),
    dict(temperature=0.8, top_p=1.5), dict(temperature=0.8,
                                           grammar="yaml"),
    dict(top_k=4), dict(top_p=0.9),
    dict(temperature=0.8, speculative=True, drafter="ngram"),
    dict(grammar="json", speculative=True, drafter="ngram")])
def test_check_sampling_config_messages_match_jax(kw):
    full = dict(temperature=0.0, top_k=0, top_p=1.0, sample_seed=0,
                grammar="")
    full.update(kw)
    with pytest.raises(ValueError) as e:
        SMP.check_sampling_config(**full)
    with pytest.raises(ValueError) as je:
        JSMP.check_sampling_config(**full)
    assert str(e.value) == str(je.value)


def test_check_sampling_config_accepts_what_jax_accepts():
    for kw in (dict(temperature=0.8, top_k=4, top_p=0.9, grammar="json"),
               dict(grammar="json", speculative=True,
                    drafter="truncated"), {}):
        full = dict(temperature=0.0, top_k=0, top_p=1.0, sample_seed=1,
                    grammar="")
        full.update(kw)
        got = SMP.check_sampling_config(**full)
        want = JSMP.check_sampling_config(**full)
        assert got.enabled == want.enabled
        assert {f: getattr(got, f) for f in ("temperature", "top_k",
                                             "top_p", "grammar")} \
            == {f: getattr(want, f) for f in ("temperature", "top_k",
                                              "top_p", "grammar")}


# ---------------------------------------------------------------------
# the engines: bit identity and replay


@pytest.fixture(scope="module")
def sampled_one_step(weights):
    _, _, tp = weights
    return port_streams(tp, multi_step_n=1)


def test_nstep_bit_identical_to_1step_and_jax(weights, sampled_one_step):
    """Sampled fused N-step == sampled 1-step == JAX's engine, token for
    token; the same under the grammar (the device grammar row against
    the host transitions), which changes the streams."""
    jc, jp, tp = weights
    s1 = sampled_one_step
    assert s1 == jax_streams(jc, jp, multi_step_n=1)
    assert port_streams(tp, multi_step_n=8) == s1
    assert port_streams(tp, multi_step_n=3) == s1
    g1 = port_streams(tp, top_p=1.0, grammar="json")
    g8 = port_streams(tp, top_p=1.0, grammar="json", multi_step_n=8)
    assert g1 == g8 == jax_streams(jc, jp, top_p=1.0, grammar="json",
                                   multi_step_n=8)
    assert g1 != s1


def test_replay_is_slot_shape_invariant(weights, sampled_one_step):
    """Draws key by (seed, uid, position), never by slot or geometry: a
    request replays its stream in an engine of another shape; another
    seed is another run."""
    _, _, tp = weights
    assert port_streams(tp, slots=4) == sampled_one_step
    assert port_streams(tp, slots=2, sample_seed=12) != sampled_one_step


@pytest.mark.parametrize("kw", [
    dict(multi_step_n=1), dict(multi_step_n=8),
    dict(multi_step_n=8, speculative=True, spec_k=3, drafter="truncated",
         drafter_layers=1)])
def test_grammar_streams_validate(weights, kw):
    _, _, tp = weights
    g = SMP.compile_grammar("json", MODEL["vocab_size"])
    ss = port_streams(tp, top_p=1.0, grammar="json", **kw)
    for rid, toks in ss.items():
        assert SMP.validate_stream(g, toks), (kw, rid)


# ---------------------------------------------------------------------
# distribution equality


def test_chi_square_helpers_equal_jax():
    for counts, probs in (([50, 48, 2, 0], [0.49, 0.49, 0.01, 0.01]),
                          ([38, 41, 11, 10], [0.4, 0.4, 0.1, 0.1])):
        assert SMP.chi_square(counts, probs) \
            == JSMP.chi_square(counts, probs)
    assert SMP.chi_square([50, 48, 2, 0], [0.49, 0.49, 0.01, 0.01])[1] == 1
    for df in (1, 3, 10, 20):
        assert SMP.chi_square_critical(df) == JSMP.chi_square_critical(df)
    assert abs(SMP.chi_square_critical(10) - 29.59) < 0.7
    with pytest.raises(ValueError, match="no samples"):
        SMP.chi_square([0, 0], [0.5, 0.5])


def test_sampler_draws_match_filtered_distribution():
    """Tokens drawn over many uids follow the filtered distribution
    (chi-square at p ~= 0.001); filtered tokens are never drawn."""
    s, _ = pair(temperature=0.8, top_p=0.9, seed=5, vocab=16)
    row = np.random.RandomState(1).randn(16).astype(np.float32)
    n = 4096
    toks = s.draw_tokens(torch.from_numpy(np.tile(row, (n, 1))),
                         torch.arange(n, dtype=torch.int32),
                         torch.full((n,), 9, dtype=torch.int32)).numpy()
    p = s.probs(torch.from_numpy(row[None])).numpy()[0]
    counts = np.bincount(toks, minlength=16)
    assert counts[p == 0.0].sum() == 0
    stat, df = SMP.chi_square(counts, p)
    assert stat < SMP.chi_square_critical(df), (stat, df)


# ---------------------------------------------------------------------
# the sampling_ab line and the CLI


def _round(p99, tps, *, acc=None):
    r = {"e2e_ms": {"p99": p99}, "tpot_ms": {"p50": 1.0},
         "tokens_per_s": tps}
    if acc is not None:
        r["decode_loop"] = {"spec": {"acceptance_rate": acc}}
    return r


@pytest.mark.parametrize("spec_tps,identity", [
    ((150.0, 145.0, 148.0), True), ((99.0, 101.0, 100.0), None)])
def test_sampling_ab_line_equals_bench_py(spec_tps, identity):
    sampled = [_round(50.0, 100.0), _round(52.0, 95.0),
               _round(51.0, 98.0)]
    spec = [_round(30.0 + i, t, acc=0.5 + 0.01 * i)
            for i, t in enumerate(spec_tps)]
    kw = {} if identity is None else {"token_identity": identity}
    got = TBENCH.sampling_ab_line(sampled, spec, ", test", **kw)
    assert got == JBENCH._sampling_ab_line(sampled, spec, ", test", **kw)
    assert got["tokens_per_s_band_disjoint_gain"] is (spec_tps[0] > 120)


def _serve_argv(*extra):
    return ["serve", "--platform", "cpu", "--arrival",
            '{"kind": "poisson", "rate_rps": 100, "num_requests": 2, '
            '"seed": 0, "prompt_len": [4, 8], "output_len": [2, 4]}',
            *extra]


@pytest.mark.parametrize("argv,needle", [
    (("--top_p", "1.5", "--temperature", "0.8"), "top_p"),
    (("--sample_top_k", "4"), "temperature"),
    (("--temperature", "-1"), "temperature"),
    (("--temperature", "0.8", "--speculative", "--drafter", "ngram",
      "--multi_step_n", "8"), "drafter probs"),
    (("--grammar", "yaml"), "invalid choice"),
    (("--multi_step_n", "0"), "multi_step_n"),
    (("--speculative", "--drafter", "truncated", "--drafter_layers", "2"),
     "drafter_layers"),
    (("--attn_impl", "flash"), "invalid choice")])
def test_cli_sampling_flag_validation(capsys, argv, needle):
    with pytest.raises(SystemExit) as exc:
        tcli.main(_serve_argv(*argv))
    assert exc.value.code == 2
    assert needle in capsys.readouterr().err


def test_cli_run_with_grammar_and_spec(tmp_path, capsys):
    """The composition parses and runs: grammar + speculative sampling
    at N=8; the record carries the sampling identity, the acceptance
    point, the loop knobs, and loads through JAX's parser."""
    from dlnetbench_tpu.metrics.parser import (load_records,
                                               records_to_dataframe)
    out = tmp_path / "rec.jsonl"
    rc = tcli.main(_serve_argv(
        "--temperature", "0.8", "--sample_seed", "3", "--grammar", "json",
        "--speculative", "--drafter", "truncated", "--multi_step_n", "8",
        "--slots", "2", "--page_size", "4", "--num_pages", "32",
        "--max_seq_len", "32", "--vocab", "64", "--embed", "32", "--ff",
        "64", "--attn_impl", "gather", "--out", str(out)))
    assert rc == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    g = rec["global"]
    assert g["sampling"] == {"temperature": 0.8, "top_k": 0, "top_p": 1.0,
                             "sample_seed": 3, "grammar": "json"}
    assert g["spec_acceptance_by_temp"][0]["temperature"] == 0.8
    assert g["serving_config"]["attn_impl"] == "gather"
    assert g["serving_config"]["drafter"] == "truncated"
    assert g["serving"]["decode_loop"]["spec"]["drafter_layers"] == 1
    assert len(records_to_dataframe(load_records(out))) == 2
    assert "serving: 2 requests" in capsys.readouterr().err


def test_sampled_records_merge_by_identity(tmp_path):
    """The port's merge holds ``sampling`` as run identity: two
    processes' records of one sampled run merge, a different seed
    refuses."""
    import copy

    from dlnetbench_tpu.serving.metrics import \
        acceptance_by_temp as j_acc
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    from dlnetbench_tpu_torch.serving.metrics import acceptance_by_temp
    pts = [(1.2, 0.3), (0.8, 1.4), (0.0, -0.1)]
    assert acceptance_by_temp(pts) == j_acc(pts)
    out = tmp_path / "rec.jsonl"
    assert tcli.main(_serve_argv("--temperature", "0.8", "--out",
                                 str(out))) == 0
    base = json.loads(out.read_text())
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    for r in (a, b):
        r["global"]["num_processes"] = r["global"]["world_size"] = 2
    b["process"] = 1
    b["ranks"] = [dict(r, process_index=1, rank=1) for r in b["ranks"]]
    assert merge_records([a, b])["global"]["sampling"]["temperature"] \
        == 0.8
    c = copy.deepcopy(b)
    c["global"]["sampling"] = dict(c["global"]["sampling"], sample_seed=8)
    with pytest.raises(ValueError, match="sampling"):
        merge_records([a, c])
