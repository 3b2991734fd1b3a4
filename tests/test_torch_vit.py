"""The torch port's ViT (``models/vit.py``) held against the JAX
package's: the cards, the parameter tree, ``patchify`` (exact), and the
tiny f32 model's logits, loss and gradients at JAX's test shape
(tests/test_models.py ``test_vit_forward_and_grad``: the vit_b card cut
to 2 layers, 32x32 images in 16-pixel patches, embed 64, 4 heads, ff
128, 10 classes, B 2) on the same weights and images.  The sequence is 5
tokens, so both packages run the einsum reference attention.  Bars (f32
both sides; summation order): logits 1e-5 absolute, loss 1e-6 relative,
every gradient leaf within 1e-5 of its max-abs."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.core.model_card import load_model_card as jax_card
from dlnetbench_tpu.models import layers as JL
from dlnetbench_tpu.models import transformer as JT
from dlnetbench_tpu.models import vit as JV
from dlnetbench_tpu_torch.core.model_card import load_model_card as torch_card
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import transformer as TT
from dlnetbench_tpu_torch.models import vit as TV

SMALL = dict(embed_dim=64, num_heads=4, ff_dim=128, num_classes=10,
             dtype="float32")


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat(val, name + "."))
        else:
            out[name] = val
    return out


def configs():
    jc = JV.ViTConfig.from_card(jax_card("vit_b"), num_layers=2,
                                image_size=32)
    jc = JV.ViTConfig(**{**jc.__dict__, **SMALL})
    tc = TV.ViTConfig.from_card(torch_card("vit_b"), num_layers=2,
                                image_size=32)
    tc = dataclasses.replace(tc, **SMALL)
    return jc, tc


@pytest.fixture(scope="module")
def tiny():
    jc, tc = configs()
    jp = JV.init_params(jax.random.key(0), jc)
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 3], dtype=np.int32)
    logits = JV.forward(jp, jnp.asarray(images), jc)
    loss, grads = jax.value_and_grad(JV.loss_fn)(
        jp, jnp.asarray(images), jnp.asarray(labels), jc)
    return {"jc": jc, "tc": tc, "np_params": jax.tree.map(np.asarray, jp),
            "images": images, "labels": labels,
            "logits": np.asarray(logits), "loss": float(loss),
            "grads": flat(jax.tree.map(np.asarray, grads))}


@pytest.mark.parametrize("name", ["vit_b", "vit_l", "vit_h"])
def test_from_card_matches_jax(name):
    j = JV.ViTConfig.from_card(jax_card(name))
    t = TV.ViTConfig.from_card(torch_card(name))
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.num_patches, t.head_dim) == (j.num_patches, j.head_dim)
    assert t.num_patches + 1 == torch_card(name).seq_len


def test_card_guards_match_jax():
    for build_j, build_t, card in (
            (JV.ViTConfig.from_card, TV.ViTConfig.from_card, "llama3_8b"),
            (JT.TransformerConfig.from_card, TT.TransformerConfig.from_card,
             "vit_b")):
        with pytest.raises(ValueError) as ej:
            build_j(jax_card(card))
        with pytest.raises(ValueError) as et:
            build_t(torch_card(card))
        assert str(et.value) == str(ej.value)
    assert str(et.value) == "vit_b is a ViT card; use models.vit"


def test_init_params_tree_matches_jax():
    jc, tc = configs()
    want = {k: tuple(v.shape) for k, v in
            flat(JV.init_params(jax.random.key(0), jc)).items()}
    got = {k: tuple(v.shape) for k, v in
           flat(TV.init_params(tc, device="cpu")).items()}
    assert got == want


@pytest.mark.parametrize("patch,size", [(16, 32), (4, 12), (14, 28)])
def test_patchify_is_exact(patch, size):
    jc, tc = configs()
    jc = dataclasses.replace(jc, patch_size=patch, image_size=size)
    tc = dataclasses.replace(tc, patch_size=patch, image_size=size)
    images = np.random.default_rng(patch).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(JV.patchify(jnp.asarray(images), jc))
    got = TV.patchify(torch.from_numpy(images), tc).numpy()
    assert got.shape == want.shape == (2, (size // patch) ** 2,
                                       patch * patch * 3)
    np.testing.assert_array_equal(got, want)


def test_params_from_numpy_carries_the_vit_tree(tiny):
    params = TT.params_from_numpy(tiny["np_params"], "cpu")
    got = flat(params)
    want = flat(tiny["np_params"])
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w)
    assert tuple(params["cls_token"].shape) == (1, 1, 64)


def test_logits_match_jax(tiny):
    params = TT.params_from_numpy(tiny["np_params"], "cpu")
    logits = TV.forward(params, torch.from_numpy(tiny["images"]),
                        tiny["tc"])
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    np.testing.assert_allclose(logits.numpy(), tiny["logits"], rtol=0,
                               atol=1e-5)


def test_loss_and_grads_match_jax(tiny):
    params = TT.params_from_numpy(tiny["np_params"], "cpu")
    leaves = flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = TV.loss_fn(params, torch.from_numpy(tiny["images"]),
                      torch.from_numpy(tiny["labels"]), tiny["tc"])
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert abs(float(loss.detach()) - tiny["loss"]) <= \
        1e-6 * abs(tiny["loss"])
    assert sorted(grads) == sorted(tiny["grads"])
    for name, want in tiny["grads"].items():
        got = grads[name].numpy()
        bound = 1e-5 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound, name
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_attention_impls_agree_on_cpu(tiny):
    params = TT.params_from_numpy(tiny["np_params"], "cpu")
    images = torch.from_numpy(tiny["images"])
    auto = TV.forward(params, images, tiny["tc"])
    xla = TV.forward(params, images,
                     dataclasses.replace(tiny["tc"], attention_impl="xla"))
    assert torch.equal(auto, xla)
    with pytest.raises(ValueError, match="unsupported shape"):
        TV.forward(params, images,
                   dataclasses.replace(tiny["tc"], attention_impl="flash"))


def test_cross_entropy_takes_class_logits():
    """``[B, C]`` logits with ``[B]`` labels, as ViT's loss calls it."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((5, 10)).astype(np.float32) * 4
    labels = rng.integers(0, 10, 5).astype(np.int32)
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(TL.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_bf16_forward_is_finite():
    jc, tc = configs()
    tc = dataclasses.replace(tc, dtype="bfloat16")
    params = TV.init_params(tc, seed=3, device="cpu")
    images = torch.randn((2, 32, 32, 3))
    logits = TV.forward(params, images, tc)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_bad_dtype_is_refused():
    _, tc = configs()
    with pytest.raises(ValueError, match="dtype"):
        dataclasses.replace(tc, dtype="float16")
