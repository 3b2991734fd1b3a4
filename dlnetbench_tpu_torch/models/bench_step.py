"""The headline bench train step (the JAX package's
``models/bench_step.py``): llama3_8b width, 4 layers, vocab 32768,
B=2, S=6144, bf16 logits, plain SGD with learning rate 1e-3.

The shape knobs are read once, at import, from the same ``DLNB_BENCH_*``
variables as the JAX package's, so a test can run the same pipeline at
a tiny size.  ``make_train_k(cfg, k)`` chains k optimizer steps in one
call: loss, backward (``torch.autograd.grad``), then the update
``p - 1e-3 * g`` applied to the parameter tensors IN PLACE under
``torch.no_grad()`` (the JAX package's step returns a new parameter
tree; updating in place is where the port saves a copy of the weights).
``build(k, device, **overrides)`` takes the JAX ``build``'s config
overrides (``mlp_dtype``, ``quant_fusion``, ``quant_scaling``,
``int8_backward``, ``mlp_backward``, and the mask knobs
``attention_window``, ``attention_seg_avg``, ``attention_seg_seed``,
which route the step's attention through the splash kernels K6/K7/K8);
with delayed scaling the carry is
``(params, qstate)``, the per-layer amax state riding the chain as it
would ride a training loop.
"""
from __future__ import annotations

import dataclasses
import os

import torch


def env_int(name: str, default: int) -> int:
    """Integer environment knob; a malformed value keeps the default."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


BATCH = env_int("DLNB_BENCH_BATCH", 2)
SEQ = env_int("DLNB_BENCH_SEQ", 6144)
LAYERS = env_int("DLNB_BENCH_LAYERS", 4)
VOCAB = env_int("DLNB_BENCH_VOCAB", 32768)
# 0 = the llama3_8b card's own dims
EMBED = env_int("DLNB_BENCH_EMBED", 0)
FF = env_int("DLNB_BENCH_FF", 0)
HEADS = env_int("DLNB_BENCH_HEADS", 0)
# kv heads default to HEADS when that is overridden
KV_HEADS = env_int("DLNB_BENCH_KV_HEADS", 0)

LEARNING_RATE = 1e-3


def bench_card():
    from dlnetbench_tpu_torch.core.model_card import (ModelCard,
                                                      load_model_card)
    base = load_model_card("llama3_8b")
    return ModelCard(name="llama3_8b_bench",
                     embed_dim=EMBED or base.embed_dim,
                     num_heads=HEADS or base.num_heads,
                     num_kv_heads=KV_HEADS or HEADS or base.num_kv_heads,
                     ff_dim=FF or base.ff_dim,
                     seq_len=SEQ, num_decoder_blocks=LAYERS,
                     vocab_size=VOCAB, gated_mlp=True)


def bench_cfg(card, **overrides):
    from dlnetbench_tpu_torch.models import transformer as tfm
    return dataclasses.replace(tfm.TransformerConfig.from_card(card),
                               logits_f32=False, **overrides)


def leaves(tree: dict) -> list:
    """The tensors of a parameter tree, in a fixed order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(leaves(val) if isinstance(val, dict) else [val])
    return out


def make_train_k(cfg, k: int):
    """``train_k(carry, tokens) -> (carry, losses)``: k SGD steps on the
    same token batch, chained; ``losses`` is a ``[k]`` f32 tensor on the
    parameters' device.  The carry is the parameter tree, updated in
    place and returned, or with delayed scaling ``(params, qstate)``,
    whose ``qstate`` is replaced by each step's emitted amaxes."""
    from dlnetbench_tpu_torch.models import transformer as tfm
    delayed = tfm.needs_qstate(cfg)

    def train_k(carry, tokens):
        params, qstate = carry if delayed else (carry, None)
        ps = leaves(params)
        losses = []
        for _ in range(k):
            for p in ps:
                p.requires_grad_(True)
            if delayed:
                loss, qstate = tfm.loss_fn(params, tokens, cfg, qstate)
            else:
                loss = tfm.loss_fn(params, tokens, cfg)
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                for p, g in zip(ps, grads):
                    p.sub_(g.to(p.dtype) * LEARNING_RATE)
            losses.append(loss.detach().to(torch.float32))
            del loss, grads
        for p in ps:
            p.requires_grad_(False)
        return ((params, qstate) if delayed else params), torch.stack(losses)
    return train_k


def build(k: int = 10, device="cuda", **cfg_overrides):
    """``(train_k_fn, carry, tokens, card, cfg)`` at the bench shape on
    ``device``: seeded random weights (the carry, or ``(params,
    qstate)`` when the config threads delayed-scaling state) and a
    seeded ``[B, S+1]`` token batch."""
    from dlnetbench_tpu_torch.models import transformer as tfm
    card = bench_card()
    cfg = bench_cfg(card, **cfg_overrides)
    device = torch.device(device)
    params = tfm.init_params(cfg, seed=0, device=device)
    if tfm.needs_qstate(cfg):
        params = (params, tfm.init_qstate(cfg, device))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, VOCAB, (BATCH, SEQ + 1), generator=gen,
                           device=device)
    return make_train_k(cfg, k), params, tokens, card, cfg
