"""The torch port's quantized MLP (kernel K11's plain version, the int8
and e4m3 recipes, delayed scaling) held against the JAX package on the
same numpy inputs.

On the CPU the port's ``fused_matmul`` runs its plain version (the int8
product exactly, in float64; e4m3 in f32 from the dequantized values);
JAX runs its Pallas kernel in interpret mode, as
tests/test_quantized_matmul.py does.  Bars: quantization and int8
products exact (JAX's own exact bars), e4m3 within 1e-2 relative
(Frobenius, the JAX bar), the tiny model's loss 1e-5 relative and each
gradient leaf within 1e-3 of its max-abs (tests/test_torch_training.py),
widened only where stated below.  The cases that need a card live in
tests/test_torch_card_quantized_mlp.py, which imports no jax and runs on
the card with ``pytest --noconftest -m cuda``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JBENCH
from dlnetbench_tpu.models import bench_step as JB
from dlnetbench_tpu.models import transformer as JT
from dlnetbench_tpu.ops import fp8 as JF8
from dlnetbench_tpu.ops import int8 as JI8
from dlnetbench_tpu.ops import quantized_matmul as JQ
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch.models import bench_step as TB
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import transformer as TT
from dlnetbench_tpu_torch.ops import fp8 as TF8
from dlnetbench_tpu_torch.ops import int8 as TI8
from dlnetbench_tpu_torch.ops import quantized_matmul as TQ

FMTS = ["int8", "float8"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a: np.ndarray, dtype: str = "bfloat16"):
    """The same values for both packages: (jax array, torch tensor)."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_fro(got, want) -> float:
    g, w = f32(got), f32(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-9))


# ------------------------------------------------------- quantization


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_tensor_equals_jax(fmt, dtype):
    jx, tx = both(arr(1, (64, 48), 3.0), dtype)
    jq, js = JQ.quantize_tensor(jx, fmt)
    tq, ts = TQ.quantize_tensor(tx, fmt)
    assert tq.dtype == TQ.FORMATS[fmt][0]
    assert float(ts) == float(js)
    assert np.array_equal(f32(tq), f32(jq))


def test_cast_q_saturates_like_jax():
    vals = np.array([-1000, -127.5, -126.5, -0.5, 0.5, 1.5, 126.5, 127.5,
                     449, 1e6], np.float32)
    for fmt in FMTS:
        assert np.array_equal(f32(TQ.cast_q(torch.from_numpy(vals), fmt)),
                              f32(JQ._cast_q(jnp.asarray(vals), fmt)))


# ------------------------------------------------ K11's plain version

# shapes that exercise multi-block grids (tests/test_quantized_matmul.py)
SHAPES = [(128, 256, 64), (48, 32, 40), (8, 16, 8)]


def _fused_pair(t, k, n, fmt, collect, blocks=None):
    jx, tx = both(arr(2, (t, k)))
    jw, tw = both(arr(3, (k, n), 0.05))
    jwq, jsw = JQ.quantize_tensor(jw, fmt)
    twq, tsw = TQ.quantize_tensor(tw, fmt)
    jsx = JQ.scale_from_amax(jnp.max(jnp.abs(jx.astype(jnp.float32))), fmt)
    tsx = TQ.scale_from_amax(TQ.amax_of(tx), fmt)
    want = JQ.fused_matmul(jx, jwq, jsw, jsx, fmt=fmt,
                           collect_amax=collect, **(blocks or {}))
    got = TQ.fused_matmul(tx, twq, tsw, tsx, fmt=fmt, collect_amax=collect)
    return got, want


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("t,k,n", SHAPES)
def test_fused_matmul_plain_matches_jax_kernel(t, k, n, fmt):
    got, want = _fused_pair(t, k, n, fmt, collect=False)
    assert got.dtype == torch.bfloat16 and got.shape == (t, n)
    if fmt == "int8":
        assert np.array_equal(f32(got), f32(want))
    else:
        assert rel_fro(got, want) < 1e-2


@pytest.mark.parametrize("fmt", FMTS)
def test_fused_matmul_amax_and_small_blocks_match_jax(fmt):
    """JAX at small blocks (a multi-block grid on every axis, several
    contraction steps and amax tiles) against the port: the result as
    above, the collected amax exactly."""
    (got, gam), (want, wam) = _fused_pair(
        128, 256, 128, fmt, collect=True,
        blocks={"block_m": 32, "block_n": 64, "block_k": 64})
    assert float(gam) == float(wam)
    if fmt == "int8":
        assert np.array_equal(f32(got), f32(want))
    else:
        assert rel_fro(got, want) < 1e-2


def test_fused_matmul_validation():
    x = torch.zeros(16, 32, dtype=torch.bfloat16)
    wq, sw = TQ.quantize_tensor(torch.ones(32, 16), "int8")
    with pytest.raises(ValueError, match="unknown quantization format"):
        TQ.fused_matmul(x, wq, sw, 1.0, fmt="int4")
    with pytest.raises(ValueError, match="contraction mismatch"):
        TQ.fused_matmul(x[:, :8], wq, sw, 1.0, fmt="int8")


# ---------------------------------------------------- composed dots


def test_composed_dots_match_jax_and_fused_equals_composed():
    jx, tx = both(arr(4, (4, 8, 32)))
    jw, tw = both(arr(5, (32, 16), 0.1))
    t8, j8 = TI8.int8_dot(tx, tw), JI8.int8_dot(jx, jw)
    assert t8.shape == (4, 8, 16)
    assert np.array_equal(f32(t8), f32(j8))
    assert torch.equal(TQ.int8_dot_fused(tx, tw), t8)
    assert rel_fro(TF8.fp8_dot(tx, tw), JF8.fp8_dot(jx, jw)) < 1e-2
    assert rel_fro(TQ.fp8_dot_fused(tx, tw), TF8.fp8_dot(tx, tw)) < 1e-2


def test_straight_through_grads_match_jax():
    """Both backwards are the master-dtype products, f32 sums: equal to
    JAX's within bf16 rounding of the f32 result (one ulp)."""
    jx, tx = both(arr(6, (32, 16)))
    jw, tw = both(arr(7, (16, 24), 0.1))
    cot = arr(8, (32, 24))
    for tdot, jdot in ((TI8.int8_dot, JI8.int8_dot),
                       (TQ.int8_dot_fused, JQ.int8_dot_fused),
                       (TF8.fp8_dot, JF8.fp8_dot),
                       (TQ.fp8_dot_fused, JQ.fp8_dot_fused)):
        jg = jax.grad(lambda x, w: jnp.sum(
            jdot(x, w).astype(jnp.float32) * cot), argnums=(0, 1))(jx, jw)
        a, b = (t.clone().requires_grad_(True) for t in (tx, tw))
        (tdot(a, b).float() * torch.from_numpy(cot)).sum().backward()
        for got, want in ((a.grad, jg[0]), (b.grad, jg[1])):
            scale = float(np.abs(f32(want)).max())
            assert float(np.abs(f32(got) - f32(want)).max()) \
                <= 2.0 ** -8 * scale


def test_delayed_dot_state_contract():
    """tests/test_quantized_matmul.py:111 on the port: the true amax as
    state gives the fresh result exactly (int8); amax_out is the fresh
    amax; a stale state saturates (finite, still a fresh amax out); the
    carried state gets a zero gradient; fp8 within the e4m3 bar."""
    _, x = both(arr(11, (64, 32)))
    _, w = both(arr(12, (32, 48), 0.1))
    true_amax = TQ.amax_of(x)
    y, amax_out = TQ.int8_dot_fused_delayed(x, w, true_amax)
    assert torch.equal(y, TI8.int8_dot(x, w))
    assert torch.equal(amax_out, true_amax)
    y_stale, amax2 = TQ.int8_dot_fused_delayed(x, w, true_amax * 0.1)
    assert torch.isfinite(y_stale.float()).all()
    assert torch.equal(amax2, true_amax)
    assert not torch.equal(y_stale, y)
    xs, ws, am = (t.clone().requires_grad_(True)
                  for t in (x, w, true_amax))
    TQ.int8_dot_fused_delayed(xs, ws, am)[0].float().sum().backward()
    assert float(am.grad.abs().sum()) == 0.0
    xr, wr = (t.clone().requires_grad_(True) for t in (x, w))
    TI8.int8_dot(xr, wr).float().sum().backward()
    assert torch.equal(xs.grad, xr.grad) and torch.equal(ws.grad, wr.grad)
    yf, amf = TQ.fp8_dot_fused_delayed(x, w, true_amax)
    assert torch.equal(amf, true_amax)
    assert rel_fro(yf, TF8.fp8_dot(x, w)) < 1e-2


# --------------------------------------------------- SwiGLU recipes

def _swiglu_inputs():
    x = arr(13, (48, 32))
    ws = (arr(14, (32, 40), 0.1), arr(15, (32, 40), 0.1),
          arr(16, (40, 32), 0.1))
    return x, ws, arr(17, (48, 32))


RECIPES = {
    # name: (port fn, JAX fn, delayed)
    "int8": (TI8.swiglu_int8, JI8.swiglu_int8, False),
    "int8_fused": (TI8.swiglu_int8_fused, JI8.swiglu_int8_fused, False),
    "int8_fused_delayed": (TI8.swiglu_int8_fused_delayed,
                           JI8.swiglu_int8_fused_delayed, True),
    "int8_switchback": (TI8.swiglu_int8_sb, JI8.swiglu_int8_sb, False),
    "fp8": (TF8.swiglu_fp8, JF8.swiglu_fp8, False),
    "fp8_fused": (TF8.swiglu_fp8_fused, JF8.swiglu_fp8_fused, False),
    "fp8_fused_delayed": (TF8.swiglu_fp8_fused_delayed,
                          JF8.swiglu_fp8_fused_delayed, True),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_swiglu_recipe_output_and_grads_match_jax(name):
    """Output and the four gradients of each recipe against
    ``jax.grad`` on the same bf16 inputs.  The output is bit-for-bit
    JAX's for every recipe (the same quantization, exact int8 sums, the
    e4m3 sums of these small products exact in f32, h = g * sigmoid(g)
    * u rounding alike here).  Each gradient within 2^-8 of its tensor's
    max-abs: the backward's bf16 products are f32 sums in another order,
    each rounded to bf16 once (one ulp apart at most)."""
    tfn, jfn, delayed = RECIPES[name]
    x, ws, cot = _swiglu_inputs()
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, *ws)]
    qs = np.array([np.abs(x).max(), 0.7], np.float32)

    def jloss(*a):
        y = jfn(*a, jnp.asarray(qs)) if delayed else jfn(*a)
        y = y[0] if delayed else y
        return jnp.sum(y.astype(jnp.float32) * cot), y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(*jargs)
    targs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
             for a in (x, *ws)]
    ty = tfn(*targs, torch.from_numpy(qs)) if delayed else tfn(*targs)
    ty = ty[0] if delayed else ty
    (ty.float() * torch.from_numpy(cot)).sum().backward()
    for what, got, want in (("y", ty, jy), *zip(
            ("dx", "dwg", "dwu", "dwd"), (t.grad for t in targs), jg)):
        g, w = f32(got), f32(want)
        assert g.shape == w.shape, what
        if what == "y":
            assert np.array_equal(g, w), name
        assert float(np.abs(g - w).max()) <= 2.0 ** -8 * float(
            np.abs(w).max()), (name, what)


def test_swiglu_int8_fused_equals_composed_exactly():
    """quant_fusion is an implementation switch: the fused int8 SwiGLU's
    output and four gradients equal the composed one's bit for bit."""
    x, ws, cot = _swiglu_inputs()
    outs = []
    for fn in (TI8.swiglu_int8, TI8.swiglu_int8_fused):
        args = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                for a in (x, *ws)]
        y = fn(*args)
        (y.float() * torch.from_numpy(cot)).sum().backward()
        outs.append([y.detach(), *(a.grad for a in args)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_swiglu_delayed_state_and_zero_state_grad():
    """With the true amaxes as state the delayed SwiGLU equals the
    fresh fused one and emits the same state; the state's gradient is
    zero; a cold (ones) state is finite and emits the true amax_x."""
    x, ws, _ = _swiglu_inputs()
    tx, *tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, *ws))
    g = TI8.int8_dot(tx, tw[0])
    u = TI8.int8_dot(tx, tw[1])
    qs = torch.stack([TQ.amax_of(tx), TQ.amax_of(TQ.silu_hidden(g, u))])
    y, new_qs = TI8.swiglu_int8_fused_delayed(tx, *tw, qs)
    assert torch.equal(y, TI8.swiglu_int8_fused(tx, *tw))
    assert torch.equal(new_qs, qs)
    qs_leaf = qs.clone().requires_grad_(True)
    TI8.swiglu_int8_fused_delayed(tx, *tw, qs_leaf)[0].float().sum() \
        .backward()
    assert float(qs_leaf.grad.abs().sum()) == 0.0
    y2, qs2 = TI8.swiglu_int8_fused_delayed(tx, *tw, torch.ones(2))
    assert torch.isfinite(y2.float()).all() and float(qs2[0]) == float(qs[0])


def test_quantized_swiglu_dispatcher_guards_delayed_state():
    x = torch.zeros(8, 16, dtype=torch.bfloat16)
    w = torch.zeros(16, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="requires quant_fusion='fused'"):
        TL.quantized_swiglu(x, w, w, w.T, mlp_dtype="int8",
                            quant_fusion="composed",
                            amax_state=torch.ones(2))
    with pytest.raises(ValueError, match="not a quantized mlp_dtype"):
        TL.quantized_swiglu(x, w, w, w.T, mlp_dtype="bfloat16")


# --------------------------------------------------- config validation

_KNOBS = dict(vocab_size=128, embed_dim=64, num_heads=4, num_kv_heads=2,
              ff_dim=128, num_layers=2, seq_len=16)


@pytest.mark.parametrize("knobs", [
    {"mlp_dtype": "int4"},
    {"int8_backward": "sb"},
    {"int8_backward": "switchback"},
    {"mlp_dtype": "int8", "quant_fusion": "pallas"},
    {"mlp_dtype": "int8", "quant_fusion": "fused", "quant_scaling": "x"},
    {"quant_fusion": "fused"},
    {"mlp_dtype": "int8", "quant_scaling": "delayed"},
    {"mlp_dtype": "int8", "quant_fusion": "fused",
     "int8_backward": "switchback"},
    {"mlp_backward": "xla"},
    {"mlp_backward": "pallas", "mlp_dtype": "int8"},
])
def test_config_validation_mirrors_jax(knobs):
    with pytest.raises(ValueError) as jerr:
        JT.TransformerConfig(gated=True, max_positions=0, **_KNOBS, **knobs)
    with pytest.raises(ValueError) as terr:
        TT.TransformerConfig(**_KNOBS, **knobs)
    assert str(terr.value) == str(jerr.value)


def test_qstate_helpers_match_jax():
    knobs = dict(mlp_dtype="float8", quant_fusion="fused",
                 quant_scaling="delayed")
    jcfg = JT.TransformerConfig(gated=True, max_positions=0, **_KNOBS,
                                **knobs)
    tcfg = TT.TransformerConfig(**_KNOBS, **knobs)
    assert TT.needs_qstate(tcfg) == JT.needs_qstate(jcfg) is True
    assert np.array_equal(TT.init_qstate(tcfg, "cpu").numpy(),
                          np.asarray(JT.init_qstate(jcfg)))
    plain = TT.TransformerConfig(**_KNOBS)
    assert not TT.needs_qstate(plain)
    with pytest.raises(ValueError, match="delayed"):
        TT.init_qstate(plain, "cpu")
    params = TT.init_params(tcfg, device="cpu")
    with pytest.raises(ValueError, match="qstate"):
        TT.forward(params, torch.zeros(1, 16, dtype=torch.long), tcfg)


# ------------------------------------------- the tiny model, per recipe

TINY = dict(vocab_size=128, embed_dim=64, num_heads=4, num_kv_heads=2,
            ff_dim=128, num_layers=2, seq_len=16, dtype="float32")
MODEL_RECIPES = {
    "int8": {"mlp_dtype": "int8"},
    "int8_fused": {"mlp_dtype": "int8", "quant_fusion": "fused"},
    "int8_switchback": {"mlp_dtype": "int8",
                        "int8_backward": "switchback"},
    "e4m3_fused_delayed": {"mlp_dtype": "float8", "quant_fusion": "fused",
                           "quant_scaling": "delayed"},
}


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
    """JAX's loss, gradients and two chained SGD steps for each recipe on
    one set of weights and tokens (f32 master weights)."""
    base = JT.TransformerConfig(gated=True, max_positions=0,
                                attention_impl="xla", scan_layers=False,
                                logits_f32=False, **TINY)
    jp = JT.init_params(jax.random.key(0), base)
    tokens = np.random.default_rng(4).integers(
        0, TINY["vocab_size"], (2, TINY["seq_len"] + 1)).astype(np.int32)
    jt = jnp.asarray(tokens)
    runs = {"np_params": jax.tree.map(np.asarray, jp), "tokens": tokens}
    for name, knobs in MODEL_RECIPES.items():
        jcfg = dataclasses.replace(base, **knobs)
        if JT.needs_qstate(jcfg):
            qs = JT.init_qstate(jcfg)
            (loss, new_qs), grads = jax.value_and_grad(
                JT.loss_fn, has_aux=True)(jp, jt, jcfg, qs)
            (p2, qs2), losses = jax.jit(JB.make_train_k(jcfg, 2))((jp, qs),
                                                                  jt)
            extra = {"new_qs": np.asarray(new_qs), "qs2": np.asarray(qs2)}
        else:
            loss, grads = jax.value_and_grad(JT.loss_fn)(jp, jt, jcfg)
            p2, losses = jax.jit(JB.make_train_k(jcfg, 2))(jp, jt)
            extra = {}
        runs[name] = {"loss": float(loss),
                      "grads": flat(jax.tree.map(np.asarray, grads)),
                      "p2": flat(jax.tree.map(np.asarray, p2)),
                      "losses": np.asarray(losses), **extra}
    return runs


def _tcfg(name):
    return TT.TransformerConfig(logits_f32=False, **TINY,
                                **MODEL_RECIPES[name])


@pytest.mark.parametrize("name", sorted(MODEL_RECIPES))
def test_tiny_model_loss_and_grads_match_jax(tiny_runs, name):
    """Loss within 1e-5 relative and each gradient leaf within 1e-3 of
    its max-abs, the f32 bars of tests/test_torch_training.py: the
    int8/e4m3 quantization of the f32 activations lands on the same
    codes in both packages here (a code that flipped on an f32 ulp of
    difference upstream would move one element by one quantum)."""
    want = tiny_runs[name]
    cfg = _tcfg(name)
    params = TT.params_from_numpy(tiny_runs["np_params"], "cpu")
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    tok = torch.from_numpy(tiny_runs["tokens"])
    if TT.needs_qstate(cfg):
        loss, new_qs = TT.loss_fn(params, tok, cfg,
                                  TT.init_qstate(cfg, "cpu"))
        np.testing.assert_allclose(new_qs.numpy(), want["new_qs"],
                                   rtol=1e-6)
    else:
        loss = TT.loss_fn(params, tok, cfg)
    assert abs(loss.item() - want["loss"]) <= 1e-5 * abs(want["loss"])
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert sorted(grads) == sorted(want["grads"])
    for key, w in want["grads"].items():
        w = np.asarray(w, np.float32)
        assert float(np.abs(grads[key].numpy() - w).max()) \
            <= 1e-3 * float(np.abs(w).max()), key


@pytest.mark.parametrize("name", sorted(MODEL_RECIPES))
def test_tiny_model_two_chained_steps_match_jax(tiny_runs, name):
    """Two SGD steps through ``make_train_k`` (the ``(params, qstate)``
    carry under delayed scaling) against JAX's: losses 1e-5 relative,
    each weight's update within two ulps plus 1e-3 of the leaf's largest
    update (the bar of tests/test_torch_training.py), the carried state
    1e-6 relative."""
    want = tiny_runs[name]
    cfg = _tcfg(name)
    params = TT.params_from_numpy(tiny_runs["np_params"], "cpu")
    carry = ((params, TT.init_qstate(cfg, "cpu"))
             if TT.needs_qstate(cfg) else params)
    carry, losses = TB.make_train_k(cfg, 2)(
        carry, torch.from_numpy(tiny_runs["tokens"]))
    np.testing.assert_allclose(losses.numpy(), want["losses"], rtol=1e-5)
    if TT.needs_qstate(cfg):
        params, qs = carry
        np.testing.assert_allclose(qs.numpy(), want["qs2"], rtol=1e-6)
    got, p0 = flat(params), flat(tiny_runs["np_params"])
    for key, start in p0.items():
        start = np.asarray(start, np.float32)
        moved = got[key].numpy() - start
        ref = np.asarray(want["p2"][key], np.float32) - start
        bound = 2 * np.spacing(np.abs(start)) + 1e-3 * np.abs(ref).max()
        assert (np.abs(moved - ref) <= bound).all(), key


# ------------------------------------------------- bench aux assemblers

_SUMMARIES = {
    "composed": {"value": 2.0, "best": 1.9, "band": [1.9, 2.2], "n": 3},
    "fused": {"value": 1.0, "best": 0.9, "band": [0.9, 1.2], "n": 3},
    "fused_delayed": {"value": 0.8, "best": 0.7, "band": [0.7, 0.9],
                      "n": 3},
}
_ROUNDS = {"composed": [2.0, 1.9, 2.2], "fused": [1.0, 0.9, 1.2],
           "fused_delayed": [0.8, 0.7, 0.9]}


def test_ab_line_equals_bench_py():
    args = ("int8 fused-quant A/B (test)", _SUMMARIES, _ROUNDS, 10 ** 12)
    assert TBENCH.ab_line(*args, 0.5) == JBENCH._ab_line(*args, 0.5)
    # an above-peak reading is flagged by both
    hot_t = TBENCH.ab_line(*args, 1.5)
    hot_j = JBENCH._ab_line(*args, 1.5)
    assert "above-peak" in hot_t["note"] and "above-peak" in hot_j["note"]
    assert TBENCH.ab_line(*args, None)["vs_baseline"] is None


def test_recommended_step_equals_bench_py():
    bf16 = {"value": 0.5, "best": 0.49, "band": [0.49, 0.52], "n": 3}
    cands = [
        {"int8_master": {"value": 450.0, "best": 440.0,
                         "band": [440.0, 460.0], "n": 3, "loss": 10.5},
         "int8_switchback": {"value": 400.0, "best": 390.0,
                             "band": [390.0, 410.0], "n": 3,
                             "loss": 12.0}},
        {"int8_master": None, "int8_switchback": None},
        {"int8_master": {"value": 600.0, "loss": 10.4}},
    ]
    for c in cands:
        assert TBENCH.recommended_step(bf16, 10.42, c) == \
            JBENCH._recommended_step(bf16, 10.42, c)
