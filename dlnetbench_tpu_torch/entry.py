"""Entry point of the flagship forward (the JAX package's
``__graft_entry__.entry``): llama3_8b width (4096 hidden, 32/8 heads,
ff 14336), cut to 4 layers, seq 1024 and vocab 32768, seeded random
weights, one batch of seeded tokens.

    fn, (params, tokens) = entry()
    logits = fn(params, tokens)       # [1, 1024, 32768] f32

Runs on the card unless the caller asks for ``platform="cpu"``.
"""
from __future__ import annotations

import torch


def flagship_cfg():
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.models.transformer import TransformerConfig
    card = load_model_card("llama3_8b")
    return TransformerConfig.from_card(card, seq_len=1024, num_layers=4,
                                       vocab_size=32768)


def entry(platform: str = "cuda"):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the forward
    (no gradient) of the flagship config."""
    from dlnetbench_tpu_torch.models import transformer as tfm
    from dlnetbench_tpu_torch.ops.common import resolve_device
    device = resolve_device(platform)
    cfg = flagship_cfg()
    params = tfm.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.seq_len),
                           generator=gen, device=device)

    def fn(params, tokens):
        with torch.no_grad():
            return tfm.forward(params, tokens, cfg)

    return fn, (params, tokens)
