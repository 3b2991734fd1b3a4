"""The dense gated (SwiGLU + RMSNorm + RoPE) decoder: configuration and
weights, and the full-sequence forward and loss the training step
differentiates (the JAX package's ``models/transformer.py``, its dense
bf16 path).

``init_params`` builds the JAX package's parameter tree with the same
names and shapes — ``embed [V, D]``, ``layers.{wq, wk, wv, wo, norm1,
norm2, w_gate, w_up, w_down}`` stacked on a leading layer axis,
``final_norm [D]``, ``head [D, V]`` — from a seeded ``torch.Generator``
(the draws differ from ``jax.random``'s).  ``params_from_numpy`` turns
the JAX package's parameters, handed over as numpy arrays, into the
port's, which is how the tests run both packages on the same weights.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dlnetbench_tpu_torch import ops
from dlnetbench_tpu_torch.core.model_card import ModelCard
from dlnetbench_tpu_torch.models import layers as L
from dlnetbench_tpu_torch.models.layers import init_dense

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The dense gated subset of the JAX package's config.  Every knob
    outside it raises (see ROADMAP.md for where each lands)."""
    vocab_size: int
    embed_dim: int
    num_heads: int
    num_kv_heads: int
    ff_dim: int
    num_layers: int
    seq_len: int
    gated: bool = True
    max_positions: int = 0
    num_experts: int = 1
    tied_embeddings: bool = False
    dtype: str = "bfloat16"
    attention_window: int = 0
    attention_seg_avg: int = 0
    logits_f32: bool = True        # f32 logits, else the compute dtype

    def __post_init__(self):
        if not self.gated or self.max_positions:
            raise ValueError(
                "TransformerConfig: the port covers the gated (SwiGLU + "
                "RMSNorm + RoPE) family only; GELU / learned-position "
                "models are not ported yet (ROADMAP.md queue 1)")
        if self.num_experts > 1:
            raise ValueError(
                "TransformerConfig: num_experts > 1 (MoE) is not ported "
                "yet (ROADMAP.md queue 1)")
        if self.attention_window or self.attention_seg_avg:
            raise ValueError(
                "TransformerConfig: attention masks (window / segments) "
                "are not ported yet (ROADMAP.md queue 1)")
        if self.dtype not in DTYPES:
            raise ValueError(f"TransformerConfig: dtype {self.dtype!r} "
                             f"(one of {tuple(DTYPES)})")
        if self.embed_dim % self.num_heads \
                or self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"TransformerConfig: embed_dim {self.embed_dim}, heads "
                f"{self.num_heads}, kv_heads {self.num_kv_heads} do not "
                f"divide")

    @classmethod
    def from_card(cls, card: ModelCard, *, seq_len: int | None = None,
                  num_layers: int | None = None,
                  vocab_size: int | None = None,
                  dtype: str = "bfloat16") -> "TransformerConfig":
        """Build from an architecture card, optionally overriding size
        knobs (depth, vocab and sequence are cut to fit one card)."""
        if card.is_vit:
            raise ValueError(f"{card.name} is a ViT card; not ported yet")
        return cls(
            vocab_size=vocab_size or card.vocab_size or 32000,
            embed_dim=card.embed_dim,
            num_heads=card.num_heads,
            num_kv_heads=card.kv_heads,
            ff_dim=card.ff_dim,
            num_layers=num_layers or card.num_layers,
            seq_len=seq_len or card.seq_len,
            gated=card.gated_mlp,
            max_positions=card.max_position_embeddings,
            num_experts=card.num_experts,
            tied_embeddings=card.tied_embeddings,
            dtype=dtype,
        )

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device="cuda") -> dict:
    """Seeded random weights on ``device``, in the JAX package's tree."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, dh = cfg.embed_dim, cfg.head_dim
    dkv = cfg.num_kv_heads * dh
    h, nl, v = cfg.ff_dim, cfg.num_layers, cfg.vocab_size
    dt = cfg.torch_dtype
    s_d = 1.0 / math.sqrt(d)
    s_h = 1.0 / math.sqrt(h)

    def dense(shape, scale):
        return init_dense(gen, shape, scale, dt, device)

    layers = {
        "wq": dense((nl, d, d), s_d),
        "wk": dense((nl, d, dkv), s_d),
        "wv": dense((nl, d, dkv), s_d),
        "wo": dense((nl, d, d), s_d),
        "norm1": torch.ones((nl, d), dtype=dt, device=device),
        "norm2": torch.ones((nl, d), dtype=dt, device=device),
        "w_gate": dense((nl, d, h), s_d),
        "w_up": dense((nl, d, h), s_d),
        "w_down": dense((nl, h, d), s_h),
    }
    params = {
        "embed": dense((v, d), 1.0),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tied_embeddings:
        params["head"] = dense((d, v), s_d)
    return params


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of numpy arrays (e.g. the JAX package's
    parameters through ``np.asarray``) -> the same tree of tensors on
    ``device``.  bfloat16 arrays (numpy's ``ml_dtypes`` extension type)
    pass through f32, which holds every bf16 value exactly."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree)          # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def _block(cfg: TransformerConfig, x, lp: dict, tables):
    """One decoder block over a full sequence; x ``[B, S, D]``, ``lp``
    this layer's weights, ``tables`` the shared RoPE tables.  Each
    projection is a plain product rounded to the compute dtype (the JAX
    package's ``jnp.dot`` without ``preferred_element_type``)."""
    b, s, d = x.shape
    y = L.rmsnorm(x, lp["norm1"])
    q = (y @ lp["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (y @ lp["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (y @ lp["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
    att = ops.attention(q, k, v.contiguous(), causal=True).reshape(b, s, d)
    x = x + att @ lp["wo"]
    y = L.rmsnorm(x, lp["norm2"])
    return x + L.swiglu(y, lp["w_gate"], lp["w_up"], lp["w_down"])


def forward(params: dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, V]`` (f32 with
    ``cfg.logits_f32``, else the compute dtype).  The layer loop is a
    Python loop; the stacked weights are split with ``unbind``, whose
    backward stacks each weight's layer gradients once."""
    x = params["embed"][tokens.long()]
    s = tokens.shape[1]
    tables = L.rope_tables(torch.arange(s, device=tokens.device),
                           cfg.head_dim)
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.num_layers):
        x = _block(cfg, x, {n: w[li] for n, w in per_layer.items()},
                   tables)
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tied_embeddings else params["head"]
    if cfg.logits_f32:
        b, s, d = x.shape
        return L.dot_f32(x.reshape(b * s, d), head).reshape(b, s, -1)
    return x @ head


def loss_fn(params: dict, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy on a ``[B, S+1]`` token batch."""
    logits = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:])
