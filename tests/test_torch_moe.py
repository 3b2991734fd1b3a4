"""The torch port's MoE held against the JAX package on the same numpy
inputs: routing (the router, the seeded token priority, the capacity
dispatch with and without seeds and groups, the drop closed form, the
routing stats), the dense / sparse / grouped expert layers, the MoE
transformer's loss, gradients and two SGD steps, the config knobs, and
the bench's ``moe_ab`` line.

Bars: the expert choices, the dispatch buffers and one-hots, the drop
counts and the token priorities are equal.  The gates are the softmax of
the top-k f32 router logits, which XLA and torch sum in another order
and exponentiate with other ``exp`` implementations: they are held within
1e-6 absolute (a weight is in [0, 1]; the logits differ in their last
bits, so about one weight in ten differs, by up to a few 1e-7).  The MoE
layers within 1e-5 (tests/test_moe.py); the tiny transformer's loss 1e-5
relative, each gradient leaf within 1e-3 of its max-abs and the two
steps' updates by the bar of tests/test_torch_training.py.  JAX runs the
grouped layer's Pallas kernel in interpret mode."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JBENCH
from dlnetbench_tpu.core.model_card import load_model_card as jax_card
from dlnetbench_tpu.models import bench_step as JB
from dlnetbench_tpu.models import layers as JL
from dlnetbench_tpu.models import moe as JM
from dlnetbench_tpu.models import transformer as JT
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch.core.model_card import load_model_card as torch_card
from dlnetbench_tpu_torch.metrics import stats as TS
from dlnetbench_tpu_torch.models import bench_step as TB
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import moe as TM
from dlnetbench_tpu_torch.models import transformer as TT

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def routing_case(t=64, d=16, e=4, seed=0):
    x, wr = arr(seed, (t, d)), arr(seed + 100, (d, e), 0.3)
    return (jnp.asarray(x), jnp.asarray(wr)), (torch.from_numpy(x),
                                               torch.from_numpy(wr))


def experts(e=4, d=16, h=24, seed=0):
    ws = [arr(seed + 1, (e, d, h), 0.05), arr(seed + 2, (e, d, h), 0.05),
          arr(seed + 3, (e, h, d), 0.05)]
    return [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]


# ------------------------------------------------------------ routing

def test_router_choices_equal_and_weights_within_ulps():
    (jx, jw), (tx, tw) = routing_case(t=256, d=64, e=8)
    jwt, jidx = JL.moe_router(jx, jw, 2)
    twt, tidx = TL.moe_router(tx, tw, 2)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(twt.numpy(), np.asarray(jwt), rtol=0,
                               atol=1e-6)


def tied_routing_case(t=32, d=16, e=8):
    """Exact ties: every fourth token row is zero (all logits 0) and
    router columns 1, 5 and 6 repeat columns 0, 2 and 3."""
    x, wr = arr(3, (t, d)), arr(103, (d, e), 0.3)
    x[::4] = 0.0
    wr[:, 1], wr[:, 5], wr[:, 6] = wr[:, 0], wr[:, 2], wr[:, 3]
    return (jnp.asarray(x), jnp.asarray(wr)), (torch.from_numpy(x),
                                               torch.from_numpy(wr))


def test_router_and_dispatch_break_ties_as_jax():
    """``jax.lax.top_k`` puts the lower index first among equal logits;
    the router and the seeded grouped dispatch follow it exactly."""
    (jx, jw), (tx, tw) = tied_routing_case()
    jwt, jidx = JL.moe_router(jx, jw, 2)
    twt, tidx = TL.moe_router(tx, tw, 2)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.array_equal(tidx[0].numpy(), [0, 1])      # an all-zero row
    np.testing.assert_allclose(twt.numpy(), np.asarray(jwt), rtol=0,
                               atol=1e-6)
    kw = {"drop_seed": 3, "group_tokens": 16, "with_stats": True}
    j = JM.dispatch(jx, jw, 8, 2, 1.0, **kw)
    t = TM.dispatch(tx, tw, 8, 2, 1.0, **kw)
    assert np.array_equal(t[0].numpy(), np.asarray(j[0]))       # xe
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))       # slots
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=0,
                               atol=1e-6)                       # gates
    for key in ("routed", "kept", "dropped"):
        assert np.array_equal(t[3][key].numpy(), np.asarray(j[3][key])), key
    assert float(t[3]["dropped"]) > 0          # the ties move real drops


@pytest.mark.parametrize("seed", [0, 7, 123456789, -3])
def test_token_priority_bits_equal(seed):
    gids = np.concatenate([np.arange(300), [2**31 - 1, -1, -2**31]]).astype(
        np.int32)
    want = np.asarray(JM.token_priority(seed, jnp.asarray(gids)))
    got = TM.token_priority(seed, torch.from_numpy(gids))
    assert want.dtype == np.uint32
    assert np.array_equal(got.numpy(), want.astype(np.int64))


DISPATCH_CASES = {
    "legacy": {},
    "seeded": {"drop_seed": 7},
    "grouped": {"group_tokens": 16},
    "seeded_grouped": {"drop_seed": 11, "group_tokens": 16},
}


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_equals_jax(case, cf):
    (jx, jw), (tx, tw) = routing_case()
    kw = DISPATCH_CASES[case]
    j = JM.dispatch(jx, jw, 4, 2, cf, with_stats=True, **kw)
    t = TM.dispatch(tx, tw, 4, 2, cf, with_stats=True, **kw)
    assert np.array_equal(t[0].numpy(), np.asarray(j[0]))       # xe
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))       # disp
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=0,
                               atol=1e-6)                       # gate
    for key in ("routed", "kept", "dropped", "expected_dropped"):
        assert np.array_equal(t[3][key].numpy(), np.asarray(j[3][key])), key
    # without stats: the same three arrays (the legacy case delegates)
    t3 = TM.dispatch(tx, tw, 4, 2, cf, **kw)
    assert len(t3) == 3 and torch.equal(t3[1], t[1])


def test_dispatch_with_global_token_ids_equals_jax():
    """A shard's routing with its global token ids (the SPMD use)."""
    (jx, jw), (tx, tw) = routing_case()
    for s in range(2):
        sl = slice(32 * s, 32 * (s + 1))
        gids = np.arange(32 * s, 32 * (s + 1), dtype=np.int32)
        j = JM.dispatch(jx[sl], jw, 4, 2, 1.0, drop_seed=11,
                        group_tokens=16, gids=jnp.asarray(gids))
        t = TM.dispatch(tx[sl], tw, 4, 2, 1.0, drop_seed=11,
                        group_tokens=16, gids=torch.from_numpy(gids))
        assert np.array_equal(t[1].numpy(), np.asarray(j[1]))
        assert np.array_equal(t[0].numpy(), np.asarray(j[0]))


def test_legacy_dispatch_is_layers_moe_dispatch():
    (_, _), (tx, tw) = routing_case()
    a = TM.dispatch(tx, tw, 4, 2, 1.25)
    b = TL.moe_dispatch(tx, tw, 4, 2, 1.25)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 4.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_drops_equal_closed_form_and_jax(cf, seed):
    (jx, jw), (tx, tw) = routing_case(seed=seed)
    t = TM.dispatch(tx, tw, 4, 2, cf, drop_seed=seed, group_tokens=16,
                    with_stats=True)[3]
    j = JM.dispatch(jx, jw, 4, 2, cf, drop_seed=seed, group_tokens=16,
                    with_stats=True)[3]
    assert float(t["dropped"]) == float(t["expected_dropped"])
    assert float(t["dropped"]) == float(j["dropped"])
    assert TM.group_capacity(16, 2, 4, cf) == JM.group_capacity(16, 2, 4, cf)


def test_group_divisibility_message_equal_jax():
    (jx, jw), (tx, tw) = routing_case(t=60)
    msgs = []
    for fn, x, w in ((JM.dispatch, jx, jw), (TM.dispatch, tx, tw)):
        with pytest.raises(ValueError) as exc:
            fn(x, w, 4, 2, 1.0, group_tokens=16)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [{}, {"drop_seed": 1, "group_tokens": 16}])
def test_stats_globals_equal_jax(kw):
    (jx, jw), (tx, tw) = routing_case()
    js = JM.dispatch(jx, jw, 4, 2, 1.0, with_stats=True, **kw)[3]
    ts = TM.dispatch(tx, tw, 4, 2, 1.0, with_stats=True, **kw)[3]
    opts = dict(num_experts=4, top_k=2, capacity_factor=1.0,
                drop_seed=kw.get("drop_seed"),
                group_tokens=kw.get("group_tokens", 0))
    assert TM.stats_globals(ts, **opts) == JM.stats_globals(
        jax.device_get(js), **opts)


def test_a2a_elems_per_rank_equal_jax():
    for args in ((4096, 2, 4096, 8), (1000, 1, 512, 4)):
        assert TM.a2a_elems_per_rank(*args) == JM.a2a_elems_per_rank(*args)


# ------------------------------------------------------------- layers

LAYERS = {
    "dense": (JL.moe_dense, TL.moe_dense, {}),
    "sparse": (JL.moe_sparse, TL.moe_sparse, {"capacity_factor": 1.25}),
    "sparse_lossless": (JL.moe_sparse, TL.moe_sparse,
                        {"capacity_factor": 2.0}),
    "grouped": (JM.moe_grouped, TM.moe_grouped, {"capacity_factor": 1.25}),
    "grouped_seeded": (JM.moe_grouped, TM.moe_grouped,
                       {"capacity_factor": 1.0, "drop_seed": 5}),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_moe_layers_match_jax(name):
    jfn, tfn, kw = LAYERS[name]
    (jx, jw), (tx, tw) = routing_case(t=32, d=16)
    jws, tws = experts()
    want = np.asarray(jfn(jx, jw, *jws, 2, **kw))
    got = tfn(tx, tw, *tws, 2, **kw)
    assert got.shape == (32, 16) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) < 1e-5


def test_moe_grouped_equals_sparse_when_lossless():
    (_, _), (tx, tw) = routing_case(t=32, d=16)
    _, tws = experts()
    ys = TL.moe_sparse(tx, tw, *tws, 2, capacity_factor=2.0)
    yg = TM.moe_grouped(tx, tw, *tws, 2, capacity_factor=2.0)
    yd = TL.moe_dense(tx, tw, *tws, 2)
    assert float((ys - yg).abs().max()) < 1e-5
    assert float((ys - yd).abs().max()) < 1e-5


def test_expert_ffn_refusals():
    _, tws = experts()
    xe = torch.zeros(4, 8, 16)
    # mlp_int8 is taken since the SPMD tier (ops/int8.int8_dot_batched;
    # held against JAX in tests/test_torch_spmd_ops.py)
    y = TM.expert_ffn(xe, *tws, mlp_int8=True)
    assert tuple(y.shape) == (4, 8, 16) and y.dtype == torch.float32
    msgs = []
    for fn, ws, x in ((JM.expert_ffn, experts()[0], jnp.zeros((4, 8, 16))),
                      (TM.expert_ffn, tws, xe)):
        with pytest.raises(ValueError) as exc:
            fn(x, *ws, impl="ragged")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_dot_f32_card_path_is_differentiable():
    """The card's bf16 x bf16 -> f32 product (``mm``/``bmm`` with
    ``out_dtype``) has no derivative in the library; ``dot_f32`` wraps it
    in an autograd Function.  Run on the meta device (shapes only), where
    the library op exists: its gradient raises, the port's does not."""
    for shape_a, shape_b in (((6, 4), (4, 5)), ((3, 6, 4), (3, 4, 5))):
        a = torch.empty(shape_a, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        b = torch.empty(shape_b, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        op = torch.mm if a.dim() == 2 else torch.bmm
        with pytest.raises(RuntimeError, match="not implemented"):
            torch.autograd.grad(op(a, b, out_dtype=torch.float32).sum(),
                                (a, b))
        y = TL._ProductF32.apply(a, b)
        ga, gb = torch.autograd.grad(y.sum(), (a, b))
        assert y.dtype == torch.float32
        assert ga.shape == a.shape and ga.dtype == torch.bfloat16
        assert gb.shape == b.shape and gb.dtype == torch.bfloat16


# ------------------------------------------------------- config knobs

TINY = dict(vocab_size=128, embed_dim=64, num_heads=2, num_kv_heads=1,
            ff_dim=64, num_layers=2, seq_len=32, dtype="float32",
            num_experts=4, top_k=2, moe_capacity_factor=1.25)


def _jcfg(**kw):
    return JT.TransformerConfig(gated=True, max_positions=0,
                                attention_impl="xla", scan_layers=False,
                                logits_f32=False, **{**TINY, **kw})


def _tcfg(**kw):
    return TT.TransformerConfig(logits_f32=False, **{**TINY, **kw})


@pytest.mark.parametrize("knobs", [
    {"moe_impl": "ragged"}, {"mlp_dtype": "int8"},
    {"mlp_backward": "pallas"}])
def test_moe_config_validation_mirrors_jax(knobs):
    msgs = []
    for make in (_jcfg, _tcfg):
        with pytest.raises(ValueError) as exc:
            make(**knobs)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_from_card_carries_the_experts():
    jc = JT.TransformerConfig.from_card(jax_card("mixtral_8x7b"),
                                        num_layers=2, seq_len=2048)
    tc = TT.TransformerConfig.from_card(torch_card("mixtral_8x7b"),
                                        num_layers=2, seq_len=2048)
    for f in ("vocab_size", "embed_dim", "num_heads", "num_kv_heads",
              "ff_dim", "num_layers", "seq_len", "num_experts", "top_k",
              "moe_impl", "moe_capacity_factor", "logits_f32"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert (tc.num_experts, tc.top_k) == (8, 2)


def test_init_params_moe_tree_equals_jax():
    jp = JT.init_params(jax.random.key(0), _jcfg())
    tp = TT.init_params(_tcfg(), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({n: tuple(w.shape) for n, w in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tp.items()}
    assert tshapes == jshapes


# ---------------------------------------------------- tiny transformer

def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


@pytest.fixture(scope="module")
def tiny_runs():
    """JAX's loss and gradients for each expert layer, and two chained
    SGD steps with ``moe_impl="grouped"``, on one set of weights."""
    jp = JT.init_params(jax.random.key(0), _jcfg())
    tokens = np.random.default_rng(4).integers(
        0, TINY["vocab_size"], (2, TINY["seq_len"] + 1)).astype(np.int32)
    jt = jnp.asarray(tokens)
    runs = {"np_params": jax.tree.map(np.asarray, jp), "tokens": tokens}
    for impl in ("dense", "sparse", "grouped"):
        cfg = _jcfg(moe_impl=impl)
        loss, grads = jax.value_and_grad(JT.loss_fn)(jp, jt, cfg)
        runs[impl] = {"loss": float(loss),
                      "grads": flat(jax.tree.map(np.asarray, grads))}
    p2, losses = jax.jit(JB.make_train_k(_jcfg(moe_impl="grouped"), 2))(
        jp, jt)
    runs["steps"] = {"p2": flat(jax.tree.map(np.asarray, p2)),
                     "losses": np.asarray(losses)}
    return runs


@pytest.mark.parametrize("impl", ["dense", "sparse", "grouped"])
def test_tiny_moe_model_loss_and_grads_match_jax(tiny_runs, impl):
    want = tiny_runs[impl]
    params = TT.params_from_numpy(tiny_runs["np_params"], "cpu")
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = TT.loss_fn(params, torch.from_numpy(tiny_runs["tokens"]),
                      _tcfg(moe_impl=impl))
    assert abs(loss.item() - want["loss"]) <= 1e-5 * abs(want["loss"])
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert sorted(grads) == sorted(want["grads"])
    for key, w in want["grads"].items():
        w = np.asarray(w, np.float32)
        assert float(np.abs(grads[key].numpy() - w).max()) \
            <= 1e-3 * float(np.abs(w).max()), key


def test_tiny_moe_model_two_grouped_steps_match_jax(tiny_runs):
    """Two SGD steps through ``make_train_k`` with ``moe_impl="grouped"``
    against JAX's: losses 1e-5 relative, each weight's update within two
    ulps of the weight plus 1e-3 of the leaf's largest update."""
    want = tiny_runs["steps"]
    params = TT.params_from_numpy(tiny_runs["np_params"], "cpu")
    params, losses = TB.make_train_k(_tcfg(moe_impl="grouped"), 2)(
        params, torch.from_numpy(tiny_runs["tokens"]))
    np.testing.assert_allclose(losses.numpy(), want["losses"], rtol=1e-5)
    got, p0 = flat(params), flat(tiny_runs["np_params"])
    for key, start in p0.items():
        start = np.asarray(start, np.float32)
        moved = got[key].numpy() - start
        ref = np.asarray(want["p2"][key], np.float32) - start
        assert float(np.abs(ref).max()) > 0, key
        bound = 2 * np.spacing(np.abs(start)) + 1e-3 * np.abs(ref).max()
        assert (np.abs(moved - ref) <= bound).all(), key


# ------------------------------------------------------- the bench line

_SUMMARIES = {
    "dense": {"value": 0.010, "best": 0.009, "band": [0.009, 0.011], "n": 3},
    "moe": {"value": 0.015, "best": 0.014, "band": [0.014, 0.016], "n": 3},
    "moe_grouped": {"value": 0.013, "best": 0.012, "band": [0.012, 0.014],
                    "n": 3},
}
_ROUNDS = {"dense": [0.009, 0.010, 0.011], "moe": [0.0135, 0.015, 0.0165],
           "moe_grouped": [0.0117, 0.013, 0.0143]}
_INFO = {"moe_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 1.25,
         "moe_drop_seed": None, "moe_group_tokens": 0,
         "moe": {"expert_load": [0.125] * 8, "load_imbalance": 1.0,
                 "drop_rate": 0.0, "router_entropy": 1.0}}
_ACTIVE = {"dense_ffn_params": 100, "moe_active_ffn_params": 100,
           "moe_total_ffn_params": 400, "router_params": 8}


@pytest.mark.parametrize("dense_band", [[0.009, 0.011], [0.014, 0.015]])
def test_moe_ab_line_equals_bench_py(dense_band):
    summaries = {**_SUMMARIES,
                 "dense": {**_SUMMARIES["dense"], "band": dense_band}}
    args = (summaries, _ROUNDS)
    kw = dict(metric="moe A/B: t", moe_info=_INFO, active_params=_ACTIVE)
    got = TBENCH.moe_ab_line(*args, **kw)
    assert got == JBENCH._moe_ab_line(*args, **kw)
    assert got["band_disjoint"] is (dense_band[1] < 0.014)


def test_bands_overlap_equals_jax():
    from dlnetbench_tpu.metrics import stats as JS
    for a, b in (([1, 2], [2, 3]), ([1, 2], [2.5, 3]), ([3, 4], [1, 2]),
                 (None, [1, 2]), ([1], [1, 2]), (["x", 1], [1, 2])):
        assert TS.bands_overlap(a, b) == JS.bands_overlap(a, b)


MOE_ENV = {"DLNB_BENCH_SEQ": "64", "DLNB_BENCH_LAYERS": "1",
           "DLNB_BENCH_VOCAB": "128", "DLNB_BENCH_EMBED": "64",
           "DLNB_BENCH_FF": "128", "DLNB_BENCH_HEADS": "2",
           "DLNB_BENCH_KV_HEADS": "1", "DLNB_BENCH_MOE_EXPERTS": "4",
           "DLNB_BENCH_MOE_LAYERS": "1", "DLNB_BENCH_MOE_K": "2",
           "DLNB_BENCH_MOE_FF": "64"}


def test_moe_ab_line_end_to_end_on_cpu():
    """``bench_moe_ab`` at a tiny ``DLNB_BENCH_*`` / ``DLNB_BENCH_MOE_*``
    shape: the JAX line's schema, three variants with bands, both ratio
    bands, the measured routing globals."""
    code = ("import json, torch\n"
            "from dlnetbench_tpu_torch import bench\n"
            "from dlnetbench_tpu_torch.models import bench_step as bs\n"
            "line = bench.bench_moe_ab(bs.bench_card(), None, 'cpu',\n"
            "                          torch.device('cpu'))\n")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(REPO), "HOME": str(Path.home()),
           "OMP_NUM_THREADS": "2", **MOE_ENV}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    want_keys = set(JBENCH._moe_ab_line(
        _SUMMARIES, _ROUNDS, metric="m", moe_info=_INFO,
        active_params=_ACTIVE)) - {"note"}
    assert want_keys <= set(line)
    for var in ("dense_ms", "moe_ms", "moe_grouped_ms"):
        assert set(line[var]) == {"value", "best", "band", "n"}
        assert line[var]["n"] == 3 and line[var]["value"] > 0
    assert line["ratio_moe_grouped_vs_dense"]["n"] == 3
    assert line["moe_experts"] == 4 and line["moe_top_k"] == 2
    assert len(line["moe"]["expert_load"]) == 4
    assert abs(sum(line["moe"]["expert_load"]) - 1.0) < 1e-3
    assert line["active_params"]["moe_total_ffn_params"] == 3 * 64 * 4 * 64
    assert "f_e=64" in line["metric"] and "1L B=2 S=64" in line["metric"]
