"""The SPMD tier on a CUDA card: ``int8_dot_batched`` (one exact
``torch._int_mm`` per expert) bit for bit against its CPU result, the
tiny f32 SPMD step on the card against the same step on the CPU (mesh
``(1, 1, 1)``, TF32 off, every sp_mode, the einsum and the grouped
expert FFN), and the decomposed ops at world 1 (a one-rank NCCL group)
against the plain products they decompose.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU path is held against the JAX package in
tests/test_torch_spmd*.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.models import moe as MoE
from dlnetbench_tpu_torch.models import spmd
from dlnetbench_tpu_torch.ops import collective_matmul as CM
from dlnetbench_tpu_torch.ops import moe_dispatch as MD
from dlnetbench_tpu_torch.ops.int8 import int8_dot_batched
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost

# the tiny card-legal SPMD shape: head_dim 64, S a multiple of 128
CARD_STEP = dict(vocab_size=512, embed_dim=256, num_heads=4,
                 num_kv_heads=4, ff_dim=512, seq_len=256, num_layers=2,
                 batch=4, num_microbatches=2)
STEP_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm, the flash kernels, "
                    "K12 and NCCL run only there (the CPU path is tested "
                    "against JAX in tests/test_torch_spmd*.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def world1(cuda_device):
    """A one-rank NCCL group for the case; its tp group is the world."""
    device = multihost.initialize("cuda")
    try:
        yield spmd.grid_mesh(1, 1, 1, device).groups["tp"]
    finally:
        multihost.shutdown()


def _randn(shape, seed, scale=1.0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n", [(4, 5, 12, 20), (2, 64, 256, 512),
                                     (4, 40, 64, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dot_batched_card_bitwise_cpu(cuda_device, e, c, k, n, dtype):
    """The forward bit for bit (exact int32 sums, the same scales; shapes
    _int_mm cannot take are zero-padded, which adds exact zeros), and the
    straight-through gradients within 1e-6 of their max-abs (f32 sums in
    another order)."""
    x = _randn((e, c, k), 1).to(dtype)
    w = _randn((e, k, n), 2, 0.1).to(dtype)
    dy = _randn((e, c, n), 3).to(dtype)
    outs = []
    for dev in ("cpu", cuda_device):
        xs = x.to(dev).detach().clone().requires_grad_(True)
        ws = w.to(dev).detach().clone().requires_grad_(True)
        y = int8_dot_batched(xs, ws)
        y.backward(dy.to(dev))
        outs.append([t.detach().cpu().float()
                     for t in (y, xs.grad, ws.grad)])
    (y_c, dx_c, dw_c), (y_g, dx_g, dw_g) = outs
    assert torch.equal(y_g, y_c)
    for got, want in ((dx_g, dx_c), (dw_g, dw_c)):
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        assert float((got - want).abs().max()) \
            <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ffn", ["einsum", "grouped"])
@pytest.mark.parametrize("sp_mode", ["megatron", "ring", "ulysses"])
def test_spmd_step_card_equals_cpu(cuda_device, sp_mode, ffn):
    """One f32 step on mesh (1, 1, 1): the card (K3/K4/K5, K12 f32 under
    ``grouped``) against the CPU (plain versions) from the same weights
    and tokens — the loss within 1e-5 relative, every updated leaf
    within 1e-5 of its max-abs."""
    cfg = spmd.SpmdConfig(**CARD_STEP, sp_mode=sp_mode, moe_ffn_impl=ffn)
    (l_card,), card = spmd.run_one_rank(cfg, "cuda")
    (l_cpu,), cpu = spmd.run_one_rank(cfg, "cpu")
    assert np.isfinite(l_card) and abs(l_card - l_cpu) <= STEP_TOL * abs(l_cpu)
    pairs = [(card[k], cpu[k]) for k in ("embed", "final_norm", "head")]
    pairs += [(card["layers"][k], cpu["layers"][k]) for k in spmd.LAYER_KEYS]
    for got, want in pairs:
        assert float(np.abs(got - want).max()) \
            <= STEP_TOL * float(np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2])
def test_collective_matmuls_at_world1_are_the_plain_product(world1, chunks):
    """At world 1 both decomposed ops are the plain product, forward and
    both gradients (the same library products in row chunks)."""
    x = _randn((2, 128, 64), 4).cuda().requires_grad_(True)
    w = _randn((64, 96), 5, 0.1).cuda().requires_grad_(True)
    dy = _randn((2, 128, 96), 6).cuda()
    for op in (CM.all_gather_matmul, CM.matmul_reduce_scatter):
        y = op(x, w, world1, chunks=chunks)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        ref = x @ w
        rdx, rdw = torch.autograd.grad(ref, (x, w), dy)
        for got, want in ((y, ref), (dx, rdx), (dw, rdw)):
            assert float((got - want).abs().max()) \
                <= 1e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["all_gather_matmul", "matmul_reduce_scatter"])
def test_bf16_product_with_f32_result_at_world1_is_dot_f32(world1, op):
    """bf16 operands with an f32 result (the vocab head's logits) at
    world 1: the forward is ``layers.dot_f32``'s, and the backward
    rounds the f32 cotangent to bf16 as ``dot_f32``'s does (tensor-core
    gradient products; both within 2^-8 of their max-abs)."""
    from dlnetbench_tpu_torch.models.layers import dot_f32
    x = _randn((2, 128, 256), 13).cuda().bfloat16().requires_grad_(True)
    w = _randn((256, 384), 14, 0.05).cuda().bfloat16().requires_grad_(True)
    dy = _randn((2, 128, 384), 15).cuda()
    y = getattr(CM, op)(x, w, world1, out_dtype=torch.float32)
    got = (y, *torch.autograd.grad(y, (x, w), dy))
    ref = dot_f32(x.reshape(-1, 256), w).reshape(2, 128, 384)
    want = (ref, *torch.autograd.grad(ref, (x, w), dy))
    assert y.dtype == torch.float32 and got[1].dtype == torch.bfloat16
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 2.0 ** -8 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ffn_impl", ["einsum", "grouped"])
def test_a2a_expert_ffn_at_world1_is_the_expert_ffn(world1, ffn_impl):
    """The decomposed MoE loop at world 1 is the expert FFN itself (the
    own block only), forward and gradients."""
    e, c, d, h = 4, 32, 64, 128
    xe = _randn((e, c, d), 7).cuda().requires_grad_(True)
    ws = [_randn(s, 8 + i, 0.1).cuda().requires_grad_(True)
          for i, s in enumerate(((e, d, h), (e, d, h), (e, h, d)))]
    dy = _randn((e, c, d), 11).cuda()
    y = MD.a2a_expert_ffn(xe, *ws, world1, ffn_impl=ffn_impl)
    got = torch.autograd.grad(y, (xe, *ws), dy)
    ref = MoE.expert_ffn(xe, *ws, impl=ffn_impl)
    want = torch.autograd.grad(ref, (xe, *ws), dy)
    assert torch.equal(y, ref)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.cuda
def test_differentiable_collectives_at_world1_are_identities(world1):
    """On a one-rank group every differentiable collective is the
    identity, and so is its backward."""
    x = _randn((2, 8, 16), 12).cuda().requires_grad_(True)
    ops = [lambda t: col.all_gather(t, world1, dim=1),
           lambda t: col.psum_scatter(t, world1, dim=1),
           lambda t: col.psum(t, world1),
           lambda t: col.all_to_all(t, world1, split=2, concat=1),
           lambda t: col.ppermute(t, world1, col.ring_perm(1, 1))]
    for op in ops:
        y = op(x)
        (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert torch.equal(y, x) and torch.equal(g, torch.ones_like(x))
