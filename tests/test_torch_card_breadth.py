"""Model breadth on a CUDA card: ``ops.attention``'s routes (a sequence
no 128-row tile divides takes the counted dense route; a tile-aligned
one launches K3 and never the dense route; a head dim the kernels lack
still raises at a tile-aligned length), the remat modes on a small
model, the tied head at an odd vocab, and tiny f32 GPT-2 and ViT models
on the card against the CPU.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU path is held against the JAX package in
tests/test_torch_model_breadth.py and tests/test_torch_vit.py.

Bars: bf16 outputs every row within 2^-6 of its max-abs (one output ulp
and the f32 sums' order, as ``chip_smoke.py`` holds the flash kernels);
f32 card against CPU (TF32 off) 1e-5 of each tensor's max-abs; the remat
modes' first loss bitwise the un-rematted one's."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from dlnetbench_tpu_torch import ops
from dlnetbench_tpu_torch.models import bench_step as TB
from dlnetbench_tpu_torch.models import transformer as TT
from dlnetbench_tpu_torch.models import vit as TV
from dlnetbench_tpu_torch.ops import flash_attention as FA

ROW_TOL = 2.0 ** -6
F32_TOL = 1e-5
GPT2 = dict(vocab_size=1001, embed_dim=128, num_heads=2, num_kv_heads=2,
            ff_dim=256, num_layers=2, seq_len=128, gated=False,
            max_positions=128, tied_embeddings=True)
LLAMA = dict(vocab_size=512, embed_dim=128, num_heads=2, num_kv_heads=1,
             ff_dim=256, num_layers=2, seq_len=128)
VIT = dict(image_size=32, patch_size=8, embed_dim=64, num_heads=4,
           ff_dim=128, num_layers=2, num_classes=10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels and the card's "
                    "dense route run only there (the CPU path is tested "
                    "against JAX in tests/test_torch_model_breadth.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def counts():
    return (FA.fwd_launches, FA.dq_launches, FA.dkv_launches,
            FA.dense_attention_calls)


def operands(b, s, hq, hkv, dh, dtype, device, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, dh), generator=gen).to(dtype)
               for h in (hq, hkv, hkv))
    return [t.to(device).requires_grad_(True) for t in (q, k, v)]


def rows_close(got, want, tol=ROW_TOL):
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(
        1e-3 * float(want.abs().max()))
    assert float(((got - want).abs() / scale).max()) <= tol


def leaves_close(got: dict, want: dict, tol: float):
    for name, w in want.items():
        g = got[name].float().cpu()
        w = w.float().cpu()
        bound = tol * float(w.abs().max())
        assert float((g - w).abs().max()) <= bound, name


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def to_device(tree, device):
    """A copy of a parameter tree on ``device``."""
    return {k: to_device(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def loss_and_grads(params, cfg, tokens):
    leaves = flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = TT.loss_fn(params, tokens, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,dh,causal", [
    (197, 12, 64, False),     # vit_b / vit_l's sequence
    (257, 4, 80, False),      # vit_h's sequence and head dim
    (130, 2, 64, True)])
def test_ragged_sequence_takes_the_counted_dense_route(cuda_device, s, hq,
                                                       dh, causal):
    q, k, v = operands(2, s, hq, hq, dh, torch.bfloat16, cuda_device)
    before = counts()
    out = ops.attention(q, k, v, causal=causal)
    out.float().square().sum().backward()
    after = counts()
    assert after[:3] == before[:3]               # no flash launch
    assert after[3] == before[3] + 1             # one dense call
    cq, ck, cv = (t.detach().cpu() for t in (q, k, v))
    rows_close(out.detach(), ops.attention(cq, ck, cv, causal=causal))
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tile_aligned_sequence_launches_k3(cuda_device, dtype):
    q, k, v = operands(1, 256, 4, 4, 64, dtype, cuda_device)
    before = counts()
    out = ops.attention(q, k, v, causal=True)
    out.float().sum().backward()
    after = counts()
    assert after[0] == before[0] + 1
    assert after[1] == before[1] + 1 and after[2] == before[2] + 1
    assert after[3] == before[3]


@pytest.mark.cuda
def test_tile_aligned_head_dim_96_still_raises(cuda_device):
    q, k, v = operands(1, 256, 2, 2, 96, torch.bfloat16, cuda_device)
    before = counts()
    with pytest.raises(ValueError, match="cannot take"):
        ops.attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="unsupported shape"):
        ops.attention(q, k, v, causal=True, impl="flash")
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("family,mode", [
    ("gpt2", {"remat": True}),
    ("gpt2", {"remat": True, "remat_policy": "dots"}),
    ("llama", {"remat": True, "remat_scope": "mlp"})])
def test_remat_modes_agree_on_card(cuda_device, family, mode):
    base = TT.TransformerConfig(**(GPT2 if family == "gpt2" else LLAMA))
    params = TT.init_params(base, seed=1, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    tokens = torch.randint(0, base.vocab_size, (2, 129), generator=gen,
                           device=cuda_device)
    l0, g0 = loss_and_grads(params, base, tokens)
    before = counts()
    l1, g1 = loss_and_grads(params, dataclasses.replace(base, **mode),
                            tokens)
    after = counts()
    assert torch.equal(l0, l1)
    leaves_close(g1, g0, ROW_TOL)
    fwd = after[0] - before[0]
    # the block's forward runs again in backward: K3 twice a layer
    # ("mlp" recomputes the MLP alone: once)
    want = base.num_layers * (1 if mode.get("remat_scope") == "mlp" else 2)
    assert fwd == want
    assert after[1] - before[1] == base.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tied_head_with_an_odd_vocab(cuda_device, dtype):
    cfg = TT.TransformerConfig(**GPT2, dtype=dtype)
    params = TT.init_params(cfg, seed=3, device=cuda_device)
    assert "head" not in params and cfg.vocab_size % 2 == 1
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen,
                           device=cuda_device)
    logits = TT.forward(params, tokens[:, :-1], cfg)
    assert logits.shape == (2, 128, 1001) and logits.dtype == torch.float32
    loss, grads = loss_and_grads(params, cfg, tokens)
    assert bool(torch.isfinite(loss))
    assert bool(torch.isfinite(grads["embed"]).all())
    # the head's share reaches rows no token looked up
    seen = torch.zeros(cfg.vocab_size, dtype=torch.bool)
    seen[tokens[:, :-1].reshape(-1).cpu()] = True
    assert float(grads["embed"][(~seen).to(cuda_device)].abs().max()) > 0


@pytest.mark.cuda
def test_tiny_gpt2_steps_on_card_match_cpu(cuda_device):
    cfg = TT.TransformerConfig(**GPT2, dtype="float32")
    cpu = TT.init_params(cfg, seed=5, device="cpu")
    card = to_device(cpu, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129),
                           generator=torch.Generator().manual_seed(6))
    before = counts()
    card, lc = TB.make_train_k(cfg, 2)(card, tokens.to(cuda_device))
    after = counts()
    cpu, lp = TB.make_train_k(cfg, 2)(cpu, tokens)
    assert float((lc.cpu() - lp).abs().max()) <= F32_TOL * float(
        lp.abs().max())
    leaves_close(flat(card), flat(cpu), F32_TOL)
    assert after[0] - before[0] == 2 * cfg.num_layers
    assert after[3] == before[3]


@pytest.mark.cuda
def test_tiny_vit_on_card_matches_cpu(cuda_device):
    cfg = TV.ViTConfig(**VIT, dtype="float32")
    cpu = TV.init_params(cfg, seed=7, device="cpu")
    card = to_device(cpu, cuda_device)
    images = torch.randn((2, 32, 32, 3),
                         generator=torch.Generator().manual_seed(8))
    labels = torch.tensor([3, 7])
    before = counts()
    got = TV.loss_fn(card, images.to(cuda_device), labels.to(cuda_device),
                     cfg)
    after = counts()
    want = TV.loss_fn(cpu, images, labels, cfg)
    assert abs(float(got) - float(want)) <= F32_TOL * abs(float(want))
    assert after[3] - before[3] == cfg.num_layers   # 17 tokens: dense
    assert after[:3] == before[:3]


@pytest.mark.cuda
def test_sequence_past_max_positions_refused_on_the_host(cuda_device):
    cfg = TT.TransformerConfig(**GPT2)
    params = TT.init_params(cfg, device=cuda_device)
    tokens = torch.zeros((1, 256), dtype=torch.long, device=cuda_device)
    before = counts()
    with pytest.raises(ValueError, match="exceeds max_positions 128"):
        TT.forward(params, tokens, cfg)
    assert counts() == before
