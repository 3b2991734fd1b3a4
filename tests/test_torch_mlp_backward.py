"""The torch port's fused SwiGLU backward (kernels K9/K10's plain
versions, ``swiglu_pallas_bwd``) and the split-product backward held
against the JAX package on the same numpy inputs.

On the CPU the port's ``dgdu`` and ``dwd`` run their plain versions; JAX
runs its Pallas kernels in interpret mode, as tests/test_mlp_backward.py
does, whose bars hold here: dg/du 1e-4 absolute (:52), dWd 2e-5 relative
plus 1e-4 absolute (:65), gradients 1e-5 of each tensor's max-abs (:37),
all in f32.  The tiny model with ``mlp_backward="pallas"`` and
``"split"`` takes the bars of tests/test_torch_training.py.  The cases
that need a card live in tests/test_torch_card_mlp_backward.py, which
imports no jax and runs on the card with ``pytest --noconftest -m
cuda``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.models import bench_step as JB
from dlnetbench_tpu.models import layers as JL
from dlnetbench_tpu.models import transformer as JT
from dlnetbench_tpu.ops import mlp_backward as JMB
from dlnetbench_tpu_torch.models import bench_step as TB
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import transformer as TT
from dlnetbench_tpu_torch.ops import mlp_backward as TMB


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def arr(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def mlp():
    """x [256, 128], Wg/Wu [128, 256], Wd [256, 128] and a cotangent
    (tests/test_mlp_backward.py's shapes), f32."""
    return (arr(0, (256, 128)), arr(1, (128, 256), 0.2),
            arr(2, (128, 256), 0.2), arr(3, (256, 128), 0.2),
            arr(4, (256, 128)))


def test_dgdu_plain_matches_jax_kernel(mlp):
    x, wg, wu, wd, dy = mlp
    g, u = x @ wg, x @ wu
    jdg, jdu = JMB.dgdu(*(jnp.asarray(a) for a in (dy, wd, g, u)))
    tdg, tdu = TMB.dgdu(*(torch.from_numpy(a) for a in (dy, wd, g, u)))
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), atol=1e-4)
    np.testing.assert_allclose(tdu.numpy(), np.asarray(jdu), atol=1e-4)


@pytest.mark.parametrize("block_k", [64, 1024])
def test_dwd_plain_matches_jax_kernel(mlp, block_k):
    """JAX's kernel at block_k 64 accumulates over four T steps."""
    x, wg, wu, _, dy = mlp
    g, u = x @ wg, x @ wu
    want = JMB.dwd(*(jnp.asarray(a) for a in (g, u, dy)), block_k=block_k)
    got = TMB.dwd(*(torch.from_numpy(a) for a in (g, u, dy)))
    assert got.dtype == torch.float32 and got.shape == (256, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas", "split"])
def test_swiglu_backward_variants_match_jax(mlp, impl):
    """The port's ``swiglu_pallas_bwd`` / ``swiglu_split_bwd`` against
    JAX's, and both against the port's autograd SwiGLU: loss of
    (swiglu ** 2).sum() 1e-5 relative, each gradient within 1e-5 of its
    tensor's max-abs."""
    x, wg, wu, wd, _ = mlp
    jfn = {"pallas": JMB.swiglu_pallas_bwd,
           "split": JL.swiglu_split_bwd}[impl]
    tfn = {"pallas": TMB.swiglu_pallas_bwd,
           "split": TMB.swiglu_split_bwd}[impl]
    jargs = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    jloss, jgrads = jax.value_and_grad(lambda *a: (jfn(*a) ** 2).sum(),
                                       argnums=(0, 1, 2, 3))(*jargs)
    results = []
    for fn in (tfn, TL.swiglu):
        targs = [torch.from_numpy(a).requires_grad_(True)
                 for a in (x, wg, wu, wd)]
        loss = (fn(*targs) ** 2).sum()
        loss.backward()
        results.append((loss.item(), [t.grad for t in targs]))
    for loss, grads in results:
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for name, got, want in zip(("dx", "dwg", "dwu", "dwd"), grads,
                                   jgrads):
            scale = float(jnp.max(jnp.abs(want))) + 1e-9
            np.testing.assert_allclose(got.numpy() / scale,
                                       np.asarray(want) / scale,
                                       atol=1e-5, err_msg=name)


TINY = dict(vocab_size=128, embed_dim=64, num_heads=4, num_kv_heads=2,
            ff_dim=128, num_layers=2, seq_len=16, dtype="float32")


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


@pytest.mark.parametrize("impl", ["pallas", "split"])
def test_tiny_model_with_mlp_backward_matches_jax(impl):
    """The tiny f32 model with ``mlp_backward=impl``: loss 1e-5 relative,
    every gradient leaf within 1e-3 of its max-abs, and two chained SGD
    steps (each weight's update within two ulps plus 1e-3 of the leaf's
    largest update) against JAX's — the bars of
    tests/test_torch_training.py."""
    jcfg = JT.TransformerConfig(gated=True, max_positions=0,
                                attention_impl="xla", scan_layers=False,
                                logits_f32=False, mlp_backward=impl, **TINY)
    tcfg = TT.TransformerConfig(logits_f32=False, mlp_backward=impl, **TINY)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(4).integers(
        0, TINY["vocab_size"], (2, TINY["seq_len"] + 1)).astype(np.int32)
    jt = jnp.asarray(tokens)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jp, jt, jcfg)
    jp2, jlosses = jax.jit(JB.make_train_k(jcfg, 2))(jp, jt)
    np_params = jax.tree.map(np.asarray, jp)

    params = TT.params_from_numpy(np_params, "cpu")
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    tok = torch.from_numpy(tokens)
    loss = TT.loss_fn(params, tok, tcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    for key, w in flat(jax.tree.map(np.asarray, jgrads)).items():
        w = np.asarray(w, np.float32)
        assert float(np.abs(grads[key].numpy() - w).max()) \
            <= 1e-3 * float(np.abs(w).max()), key

    params = TT.params_from_numpy(np_params, "cpu")
    params, losses = TB.make_train_k(tcfg, 2)(params, tok)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    got, p0 = flat(params), flat(np_params)
    want = flat(jax.tree.map(np.asarray, jp2))
    for key, start in p0.items():
        start = np.asarray(start, np.float32)
        moved = got[key].numpy() - start
        ref = np.asarray(want[key], np.float32) - start
        bound = 2 * np.spacing(np.abs(start)) + 1e-3 * np.abs(ref).max()
        assert (np.abs(moved - ref) <= bound).all(), key


def test_wrappers_take_the_plain_versions_on_the_cpu_only(mlp):
    """On a CPU tensor the wrappers run the plain versions and count no
    launch; a CUDA-only check refuses what the kernels cannot take."""
    x, wg, wu, wd, dy = mlp
    g, u = (torch.from_numpy(a) for a in (x @ wg, x @ wu))
    before = (TMB.dgdu_launches, TMB.dwd_launches)
    TMB.dgdu(torch.from_numpy(dy), torch.from_numpy(wd), g, u)
    TMB.dwd(g, u, torch.from_numpy(dy))
    assert (TMB.dgdu_launches, TMB.dwd_launches) == before
    with pytest.raises(ValueError, match="bfloat16"):
        TMB.kernel_dgdu(torch.from_numpy(dy), torch.from_numpy(wd), g, u)


def test_config_knob_reaches_the_dispatch():
    cfg = dataclasses.replace(TT.TransformerConfig(**TINY),
                              mlp_backward="pallas")
    assert cfg.mlp_backward == "pallas"
    with pytest.raises(ValueError, match="dense bf16 SwiGLU path only"):
        dataclasses.replace(cfg, mlp_dtype="int8")
