"""The torch port's model breadth held against the JAX package: the
GPT-2 family (GELU MLP, LayerNorm, learned positions, the head tied to
the embedding) and the remat knobs of ``models/transformer.py``.

A tiny f32 GPT-2 from the ``gpt2_l`` card (JAX's ``_tiny_cfg`` shape in
tests/test_models.py: embed 64, 4/2 heads of 16, ff 128, 2 layers,
vocab 64, ``max_positions`` 32, B 2, S 16) runs through both packages on
the same weights (``params_from_numpy``); at S 16 both run the einsum
reference attention.  Bars (f32 both sides; the gap is summation
order): logits 1e-5 absolute, loss 1e-6 relative, every gradient leaf
within 1e-5 of that leaf's max-abs, and two chained ``make_train_k``
steps' parameters within 1e-6 of each leaf's max-abs.  The remat knobs
are held on JAX's own tiny llama (tests/test_models.py
``test_remat_policies_agree``) at JAX's bar there (loss rtol 1e-6,
gradients rtol 1e-5 / atol 1e-6), and each port remat mode gives the
port's un-rematted loss and gradients bitwise on the CPU."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.core.model_card import load_model_card as jax_card
from dlnetbench_tpu.models import bench_step as JB
from dlnetbench_tpu.models import layers as JL
from dlnetbench_tpu.models import transformer as JT
from dlnetbench_tpu_torch.core.model_card import load_model_card as torch_card
from dlnetbench_tpu_torch.models import bench_step as TB
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import transformer as TT

TINY = dict(embed_dim=64, num_heads=4, num_kv_heads=2, ff_dim=128,
            dtype="float32")
SEQ = 16
# JAX's remat test model (tests/test_models.py test_remat_policies_agree)
LLAMA = dict(vocab_size=64, embed_dim=32, num_heads=4, num_kv_heads=2,
             ff_dim=64, num_layers=2, seq_len=16, gated=True,
             max_positions=0, dtype="float32")
REMAT = {"off": {}, "full": {"remat": True},
         "dots": {"remat": True, "remat_policy": "dots"},
         "mlp": {"remat": True, "remat_scope": "mlp"}}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat(val, name + "."))
        else:
            out[name] = val
    return out


def close_per_leaf(got: dict, want: dict, rel: float) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().float().numpy()
        assert g.shape == w.shape, name
        bound = rel * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, name


def tiny_cfgs(**kw):
    """JAX's ``_tiny_cfg("gpt2_l", max_positions=32)`` and the port's
    config from the port's copy of the card, with the same overrides."""
    jc = JT.TransformerConfig.from_card(jax_card("gpt2_l"), seq_len=32,
                                        num_layers=2, vocab_size=64)
    jc = dataclasses.replace(jc, max_positions=32, **TINY, **kw)
    tc = TT.TransformerConfig.from_card(torch_card("gpt2_l"), seq_len=32,
                                        num_layers=2, vocab_size=64)
    tc = dataclasses.replace(tc, max_positions=32, **TINY, **kw)
    return jc, tc


@pytest.fixture(scope="module")
def gpt2():
    jcfg, tcfg = tiny_cfgs()
    jp = JT.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, SEQ + 1)).astype(np.int32)
    loss, grads = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tokens),
                                                 jcfg)
    logits = JT.forward(jp, jnp.asarray(tokens[:, :-1]), jcfg)
    p2, losses = jax.jit(JB.make_train_k(jcfg, 2))(jp, jnp.asarray(tokens))
    return {"jcfg": jcfg, "tcfg": tcfg,
            "np_params": jax.tree.map(np.asarray, jp), "tokens": tokens,
            "loss": float(loss), "logits": np.asarray(logits),
            "grads": flat(jax.tree.map(np.asarray, grads)),
            "p2": flat(jax.tree.map(np.asarray, p2)),
            "losses": np.asarray(losses)}


def port_grads(np_params, tokens, cfg):
    params = TT.params_from_numpy(np_params, "cpu")
    leaves = flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = TT.loss_fn(params, torch.from_numpy(tokens), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# ------------------------------------------------------------ the cards

@pytest.mark.parametrize("name", ["gpt2_l", "gpt2_xl", "llama3_8b",
                                  "mixtral_8x7b"])
def test_from_card_matches_jax(name):
    j = JT.TransformerConfig.from_card(jax_card(name))
    t = TT.TransformerConfig.from_card(torch_card(name))
    for f in dataclasses.fields(t):
        if hasattr(j, f.name):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    if name.startswith("gpt2"):
        assert not t.gated and t.max_positions == 1024 and t.tied_embeddings


@pytest.mark.parametrize("card,kw", [
    ("gpt2_l", {"max_positions": 32}), ("llama3_8b", {}),
    ("mixtral_8x7b", {}), ("llama3_8b", {"tied_embeddings": True})])
def test_init_params_tree_matches_jax(card, kw):
    jc = JT.TransformerConfig.from_card(jax_card(card), seq_len=32,
                                        num_layers=2, vocab_size=64)
    jc = dataclasses.replace(jc, **TINY, **kw)
    tc = TT.TransformerConfig.from_card(torch_card(card), seq_len=32,
                                        num_layers=2, vocab_size=64)
    tc = dataclasses.replace(tc, **TINY, **kw)
    want = {k: tuple(v.shape) for k, v in
            flat(JT.init_params(jax.random.key(0), jc)).items()}
    got = {k: tuple(v.shape) for k, v in
           flat(TT.init_params(tc, device="cpu")).items()}
    assert got == want


# ------------------------------------------------------- GPT-2 vs JAX

def test_gpt2_logits_match_jax(gpt2):
    params = TT.params_from_numpy(gpt2["np_params"], "cpu")
    assert "pos_embed" in params and "head" not in params
    logits = TT.forward(params, torch.from_numpy(gpt2["tokens"][:, :-1]),
                        gpt2["tcfg"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), gpt2["logits"], rtol=0,
                               atol=1e-5)


def test_gpt2_loss_and_grads_match_jax(gpt2):
    loss, grads = port_grads(gpt2["np_params"], gpt2["tokens"],
                             gpt2["tcfg"])
    assert abs(float(loss) - gpt2["loss"]) <= 1e-6 * abs(gpt2["loss"])
    close_per_leaf(grads, gpt2["grads"], 1e-5)


def test_tied_embed_grad_matches_jax(gpt2):
    """The embedding's gradient sums its two uses, the lookup and the
    tied head: both packages agree, and it differs from the lookup's
    share alone."""
    _, grads = port_grads(gpt2["np_params"], gpt2["tokens"], gpt2["tcfg"])
    want = gpt2["grads"]["embed"]
    got = grads["embed"].numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())
    # tokens never looked up still get the head's share
    unseen = sorted(set(range(64)) - set(gpt2["tokens"][:, :-1].ravel()))
    assert unseen and float(np.abs(got[unseen]).max()) > 0


def test_gpt2_two_train_steps_match_jax(gpt2):
    params = TT.params_from_numpy(gpt2["np_params"], "cpu")
    p2, losses = TB.make_train_k(gpt2["tcfg"], 2)(
        params, torch.from_numpy(gpt2["tokens"]))
    np.testing.assert_allclose(losses.numpy(), gpt2["losses"], rtol=1e-6)
    close_per_leaf(flat(p2), gpt2["p2"], 1e-6)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_gpt2_block_remat_matches_jax(gpt2, mode):
    jcfg = dataclasses.replace(gpt2["jcfg"], **REMAT[mode])
    tcfg = dataclasses.replace(gpt2["tcfg"], **REMAT[mode])
    jp = jax.tree.map(jnp.asarray, gpt2["np_params"])
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(gpt2["tokens"]),
                                            jcfg)
    loss, grads = port_grads(gpt2["np_params"], gpt2["tokens"], tcfg)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    close_per_leaf(grads, flat(jax.tree.map(np.asarray, jg)), 1e-5)


def test_gpt2_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias)))
    got = TL.layernorm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    w_in = rng.standard_normal((64, 128)).astype(np.float32) / 8
    b_in = rng.standard_normal(128).astype(np.float32)
    w_out = rng.standard_normal((128, 64)).astype(np.float32) / 11
    b_out = rng.standard_normal(64).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    want = np.asarray(JL.gelu_mlp(*(jnp.asarray(a) for a in args)))
    got = TL.gelu_mlp(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_gelu_mlp_rounds_where_jax_rounds():
    """bf16: the pre-activation, GELU's output and the result are each
    rounded to bf16 (JAX's cast points, gelu in its tanh form)."""
    rng = np.random.default_rng(4)
    x, w_in, w_out = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in ((3, 8), (8, 16), (16, 8)))
    b_in = torch.zeros(16, dtype=torch.bfloat16)
    b_out = torch.zeros(8, dtype=torch.bfloat16)
    a = (x.float() @ w_in.float()).to(torch.bfloat16)
    h = torch.nn.functional.gelu(a.float(), approximate="tanh").to(
        torch.bfloat16)
    want = (h.float() @ w_out.float()).to(torch.bfloat16)
    got = TL.gelu_mlp(x, w_in, b_in, w_out, b_out)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_sequence_past_max_positions_is_refused():
    """JAX clamps the position index silently; the port refuses on the
    host, naming both lengths (on the card the gather would fault)."""
    _, tcfg = tiny_cfgs()
    params = TT.init_params(tcfg, device="cpu")
    tokens = torch.zeros((1, 33), dtype=torch.long)
    with pytest.raises(ValueError, match=r"sequence length 33 exceeds "
                                         r"max_positions 32"):
        TT.forward(params, tokens, tcfg)
    TT.forward(params, tokens[:, :32], tcfg)   # the table's length is fine


def test_attention_impl_goes_through():
    _, tcfg = tiny_cfgs()
    params = TT.init_params(tcfg, device="cpu")
    tokens = torch.randint(0, 64, (2, SEQ))
    auto = TT.forward(params, tokens, tcfg)
    xla = TT.forward(params, tokens,
                     dataclasses.replace(tcfg, attention_impl="xla"))
    assert torch.equal(auto, xla)
    with pytest.raises(ValueError, match="unsupported shape"):
        TT.forward(params, tokens,
                   dataclasses.replace(tcfg, attention_impl="flash"))
    with pytest.raises(ValueError, match="unknown attention impl"):
        TT.forward(params, tokens,
                   dataclasses.replace(tcfg, attention_impl="pallas"))


def test_scan_layers_changes_nothing():
    _, tcfg = tiny_cfgs()
    params = TT.init_params(tcfg, device="cpu")
    tokens = torch.randint(0, 64, (2, SEQ))
    a = TT.forward(params, tokens, tcfg)
    b = TT.forward(params, tokens,
                   dataclasses.replace(tcfg, scan_layers=False))
    assert torch.equal(a, b)


# ----------------------------------------------------- remat vs JAX

@pytest.fixture(scope="module")
def llama():
    jcfg = JT.TransformerConfig(**LLAMA)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tokens = np.array(jax.random.randint(jax.random.key(1), (2, 17), 0,
                                         64))
    out = {"np_params": jax.tree.map(np.asarray, jp), "tokens": tokens}
    for mode, kw in REMAT.items():
        loss, g = jax.value_and_grad(JT.loss_fn)(
            jp, jnp.asarray(tokens), JT.TransformerConfig(**LLAMA, **kw))
        out[mode] = (float(loss), flat(jax.tree.map(np.asarray, g)))
    out["port_off"] = port_grads(out["np_params"], tokens,
                                 TT.TransformerConfig(**LLAMA))
    return out


@pytest.mark.parametrize("mode", sorted(REMAT))
def test_remat_matches_jax(llama, mode):
    """Each mode's loss and gradients against JAX's same mode at JAX's
    remat bar (loss rtol 1e-6; gradients rtol 1e-5, atol 1e-6)."""
    loss, grads = port_grads(llama["np_params"], llama["tokens"],
                             TT.TransformerConfig(**LLAMA, **REMAT[mode]))
    jl, jg = llama[mode]
    np.testing.assert_allclose(float(loss), jl, rtol=1e-6)
    assert sorted(grads) == sorted(jg)
    for name, want in jg.items():
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["full", "dots", "mlp"])
def test_remat_is_bitwise_the_plain_step_on_cpu(llama, mode):
    """Recomputing on the CPU repeats the same operations: the loss and
    every gradient equal the un-rematted port's bit for bit."""
    loss, grads = port_grads(llama["np_params"], llama["tokens"],
                             TT.TransformerConfig(**LLAMA, **REMAT[mode]))
    l0, g0 = llama["port_off"]
    assert torch.equal(loss, l0)
    for name, g in g0.items():
        assert torch.equal(grads[name], g), name


def test_dots_policy_saves_the_plain_products():
    """``remat_policy="dots"`` saves mm/addmm/_int_mm/_scaled_mm outputs
    and recomputes the rest (bmm has a batch dim: recomputed)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten._int_mm.default,
               aten._scaled_mm.default):
        assert TT._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert TT._dots_policy(None, op) == \
            CheckpointPolicy.PREFER_RECOMPUTE


def test_remat_recomputes_in_backward():
    """Under ``remat`` the block's forward runs again in backward:
    counted through the layer norms' forwards."""
    calls = []
    real = TL.rmsnorm

    def counting(x, scale, eps=1e-6):
        calls.append(1)
        return real(x, scale, eps)

    for mode, per_layer in (("off", 2), ("full", 4), ("dots", 4),
                            ("mlp", 2)):
        cfg = TT.TransformerConfig(**LLAMA, **REMAT[mode])
        params = TT.init_params(cfg, device="cpu")
        for t in flat(params).values():
            t.requires_grad_(True)
        tokens = torch.randint(0, 64, (2, 17))
        TL.rmsnorm = counting
        try:
            calls.clear()
            loss = TT.loss_fn(params, tokens, cfg)
            loss.backward()
        finally:
            TL.rmsnorm = real
        # two norms a block and the final one
        assert len(calls) == per_layer * cfg.num_layers + 1, mode


# ----------------------------------------------------------- refusals

BAD_KNOBS = [
    {"remat_policy": "dot"},
    {"remat_scope": "layer"},
    {"remat_scope": "mlp", "gated": False},
    {"remat_scope": "mlp", "num_experts": 4, "top_k": 2},
    {"attention_window": -1},
    {"attention_seg_avg": -2},
    {"moe_impl": "scatter"},
    {"mlp_dtype": "float16"},
    {"int8_backward": "fast"},
    {"int8_backward": "switchback"},
    {"mlp_dtype": "int8", "num_experts": 4, "top_k": 2},
    {"mlp_dtype": "float8", "gated": False},
    {"quant_fusion": "partial", "mlp_dtype": "int8"},
    {"quant_scaling": "static", "mlp_dtype": "int8"},
    {"quant_fusion": "fused"},
    {"quant_scaling": "delayed", "mlp_dtype": "int8"},
    {"quant_fusion": "fused", "mlp_dtype": "int8",
     "int8_backward": "switchback"},
    {"mlp_backward": "auto"},
    {"mlp_backward": "pallas", "gated": False},
    {"mlp_backward": "split", "num_experts": 4, "top_k": 2},
]


def _message(cls, **kw):
    with pytest.raises(ValueError) as e:
        cls(**kw)
    return str(e.value)


@pytest.mark.parametrize("bad", BAD_KNOBS,
                         ids=["-".join(f"{k}={v}" for k, v in b.items())
                              for b in BAD_KNOBS])
def test_knob_refusals_match_jax(bad):
    kw = {**LLAMA, **bad}
    assert _message(TT.TransformerConfig, **kw) == \
        _message(JT.TransformerConfig, **kw)


def test_remat_knobs_are_fields_not_type_errors():
    cfg = TT.TransformerConfig(**LLAMA, remat=True, remat_policy="dots",
                               remat_scope="block", scan_layers=False,
                               attention_impl="flash")
    assert (cfg.remat, cfg.remat_policy, cfg.scan_layers,
            cfg.attention_impl) == (True, "dots", False, "flash")
