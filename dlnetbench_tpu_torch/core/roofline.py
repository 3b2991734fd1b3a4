"""Analytic roofline model (the port's copy of the JAX package's
``core/roofline.py``; the formulas are the same, so both give the same
integers for the same card).

``t = flops / min(peak, AI * bandwidth)`` with closed-form attention and
MLP FLOP counts; SwiGLU MLPs cost 3 matmuls, GQA models project K/V into
the smaller KV dim, MoE models bill ``top_k`` experts per token, and the
backward costs ``BWD_FWD_RATIO`` forwards.
"""
from __future__ import annotations

from dlnetbench_tpu_torch.core.hardware import (BYTES_PER_ELEMENT,
                                                HARDWARE, HardwareSpec)
from dlnetbench_tpu_torch.core.model_card import ModelCard

BWD_FWD_RATIO = 2.0


def attention_flops(card: ModelCard, batch: int) -> int:
    """Forward FLOPs of all attention blocks: Q, K, V, O projections and
    the full (non-causal) QK^T and AV score products."""
    b, n, d, dkv, nl = (batch, card.seq_len, card.embed_dim, card.kv_dim,
                        card.num_layers)
    proj = 2 * b * n * d * (2 * d + 2 * dkv)
    scores = 4 * b * n * n * d
    return nl * (proj + scores)


def mlp_flops(card: ModelCard, batch: int) -> int:
    """Forward FLOPs of all MLP blocks (``top_k`` experts for MoE)."""
    b, n, d, h, nl = (batch, card.seq_len, card.embed_dim, card.ff_dim,
                      card.num_layers)
    n_mat = 3 if card.gated_mlp else 2
    return nl * n_mat * 2 * b * n * d * h * card.top_k


def model_flops(card: ModelCard, batch: int) -> int:
    return attention_flops(card, batch) + mlp_flops(card, batch)


def model_bytes(card: ModelCard, batch: int, dtype: str) -> int:
    """Device-memory traffic estimate: weights streamed once (active
    params only for MoE) plus ~8 d-sized activation tensors per token
    per layer."""
    bpe = BYTES_PER_ELEMENT[dtype]
    active_params = card.num_params()
    if card.is_moe:
        active_params -= card.num_layers * \
            (card.num_experts - card.top_k) * card.mlp_params_per_expert()
    weight_bytes = active_params * bpe
    act_bytes = (8 * batch * card.seq_len * card.embed_dim
                 * card.num_layers * bpe)
    return int(weight_bytes + act_bytes)


def roofline_time_s(flops: int, nbytes: int, hw: HardwareSpec,
                    dtype: str) -> float:
    """``t = flops / min(peak, AI * BW)``."""
    ai = flops / max(nbytes, 1)
    achievable = min(hw.peak(dtype), ai * hw.hbm_bandwidth)
    return flops / achievable


def train_step_bytes(card: ModelCard, batch: int, dtype: str) -> int:
    """Traffic of one train step counted pass by pass: 3 x the forward's
    (weights and working set once per pass) plus the saved-residual
    round trip — the gated MLP's two [B, N, ff] pre-activations and ~4
    d-sized attention saves per layer, written in the forward and read
    in the backward."""
    bpe = BYTES_PER_ELEMENT[dtype]
    base = 3 * model_bytes(card, batch, dtype)
    n_pre = 2 if card.gated_mlp else 1
    mlp_saved = n_pre * batch * card.seq_len * card.ff_dim * card.top_k
    attn_saved = 4 * batch * card.seq_len * card.embed_dim
    saved_round_trip = 2 * card.num_layers * (mlp_saved + attn_saved) * bpe
    return int(base + saved_round_trip)


def forward_time_s(card: ModelCard, batch: int, dtype: str,
                   device: str) -> float:
    hw = HARDWARE[device]
    return roofline_time_s(model_flops(card, batch),
                           model_bytes(card, batch, dtype), hw, dtype)


def train_step_time_s(card: ModelCard, batch: int, dtype: str,
                      device: str) -> float:
    """Roofline time of one train step: the step's FLOPs (forward plus
    ``BWD_FWD_RATIO`` forwards) over ``train_step_bytes``'s traffic."""
    hw = HARDWARE[device]
    flops = int(model_flops(card, batch) * (1.0 + BWD_FWD_RATIO))
    return roofline_time_s(flops, train_step_bytes(card, batch, dtype),
                           hw, dtype)


def ffn_forward_time_s(card: ModelCard, batch: int, dtype: str,
                       device: str) -> float:
    """Roofline time of the FFN blocks alone, their share of the
    forward's traffic in proportion to their FLOPs (the stats files'
    ``FFN_Average_Forward_Time``)."""
    hw = HARDWARE[device]
    fl = mlp_flops(card, batch)
    total_bytes = model_bytes(card, batch, dtype)
    frac = fl / max(model_flops(card, batch), 1)
    return roofline_time_s(fl, int(total_bytes * frac), hw, dtype)
