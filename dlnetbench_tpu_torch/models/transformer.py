"""The dense gated (SwiGLU + RMSNorm + RoPE) decoder: configuration and
weights, and the full-sequence forward and loss the training step
differentiates (the JAX package's ``models/transformer.py``, its dense
path with the MLP recipes: bf16, int8 and e4m3 quantized SwiGLU, and the
split and fused-kernel SwiGLU backwards).

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
    # the MLP recipes (the JAX package's knobs, same values and checks):
    mlp_dtype: str = "bfloat16"    # "int8" / "float8": quantized SwiGLU
                                   # forward, straight-through backward
    int8_backward: str = "master"  # "switchback": int8 dx-side backward
    quant_fusion: str = "composed"  # "fused": kernel K11
    quant_scaling: str = "dynamic"  # "delayed": amax carried as state
    mlp_backward: str = "fused"    # autograd; "split"; "pallas": K9/K10

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
        self._check_mlp_knobs()

    def _check_mlp_knobs(self):
        """The JAX package's validation of the MLP knobs, message for
        message (its ``__post_init__``)."""
        if self.mlp_dtype not in ("bfloat16", "float8", "int8"):
            raise ValueError(f"unknown mlp_dtype {self.mlp_dtype!r}; "
                             f"expected 'bfloat16', 'float8' or 'int8'")
        if self.int8_backward not in ("master", "switchback"):
            raise ValueError(
                f"unknown int8_backward {self.int8_backward!r}; "
                f"expected 'master' or 'switchback'")
        if self.int8_backward != "master" and self.mlp_dtype != "int8":
            raise ValueError(
                "int8_backward='switchback' requires mlp_dtype='int8'")
        if self.mlp_dtype != "bfloat16" and (self.num_experts > 1
                                             or not self.gated):
            raise ValueError(
                f"mlp_dtype={self.mlp_dtype!r} currently covers the "
                f"dense SwiGLU path only")
        if self.quant_fusion not in ("composed", "fused"):
            raise ValueError(f"unknown quant_fusion {self.quant_fusion!r}; "
                             f"expected 'composed' or 'fused'")
        if self.quant_scaling not in ("dynamic", "delayed"):
            raise ValueError(
                f"unknown quant_scaling {self.quant_scaling!r}; "
                f"expected 'dynamic' or 'delayed'")
        if self.quant_fusion == "fused" and self.mlp_dtype == "bfloat16":
            raise ValueError(
                "quant_fusion='fused' requires mlp_dtype='float8' or "
                "'int8' (there is nothing to quantize in bf16)")
        if self.quant_scaling == "delayed" and self.quant_fusion != "fused":
            raise ValueError(
                "quant_scaling='delayed' requires quant_fusion='fused' "
                "(the carried amax is a fused-kernel side output)")
        if self.quant_fusion == "fused" and self.int8_backward != "master":
            raise ValueError(
                "quant_fusion='fused' covers the master-dtype "
                "(straight-through) backward only; SwitchBack's "
                "quantized dx dots are a composed-path recipe")
        if self.mlp_backward not in ("split", "fused", "pallas"):
            raise ValueError(f"unknown mlp_backward {self.mlp_backward!r}; "
                             f"expected 'split', 'fused' or 'pallas'")
        if self.mlp_backward != "fused" and (self.num_experts > 1
                                             or self.mlp_dtype != "bfloat16"
                                             or not self.gated):
            raise ValueError(
                f"mlp_backward={self.mlp_backward!r} covers the dense "
                f"bf16 SwiGLU path only (MoE, float8/int8 and non-gated "
                f"MLPs dispatch elsewhere)")

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


def needs_qstate(cfg: TransformerConfig) -> bool:
    """True when the step threads delayed-scaling amax state
    (``init_qstate`` -> ``forward(..., qstate=...)`` -> ``(out,
    new_qstate)``)."""
    return cfg.quant_scaling == "delayed"


def init_qstate(cfg: TransformerConfig, device="cuda") -> torch.Tensor:
    """Initial delayed-scaling state: per layer ``[amax_x, amax_h]``
    (gate and up share the x amax, down uses the h amax), f32 ones — a
    guess, not a calibration: the first step quantizes against it
    (saturating where it is low) and emits the true amaxes."""
    if not needs_qstate(cfg):
        raise ValueError("init_qstate: cfg.quant_scaling != 'delayed'")
    return torch.ones((cfg.num_layers, 2), dtype=torch.float32,
                      device=device)


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


def _mlp(cfg: TransformerConfig, y, lp: dict, qs_row):
    """The block's SwiGLU by the config's recipe; ``(y2, new_qs_row)``,
    the row None unless delayed scaling carries state."""
    b, s, d = y.shape
    weights = (lp["w_gate"], lp["w_up"], lp["w_down"])
    if cfg.mlp_dtype in ("float8", "int8"):
        out = L.quantized_swiglu(y, *weights, mlp_dtype=cfg.mlp_dtype,
                                 quant_fusion=cfg.quant_fusion,
                                 int8_backward=cfg.int8_backward,
                                 amax_state=qs_row)
        return out if qs_row is not None else (out, None)
    if cfg.mlp_backward == "fused":
        return L.swiglu(y, *weights), None
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    fn = (MB.swiglu_pallas_bwd if cfg.mlp_backward == "pallas"
          else MB.swiglu_split_bwd)
    return fn(y.reshape(b * s, d), *weights).reshape(b, s, d), None


def _block(cfg: TransformerConfig, x, lp: dict, tables, qs_row=None):
    """One decoder block over a full sequence; x ``[B, S, D]``, ``lp``
    this layer's weights, ``tables`` the shared RoPE tables, ``qs_row``
    this layer's delayed-scaling state (delayed scaling only).  Returns
    ``(x, new_qs_row)``.  Each projection is a plain product rounded to
    the compute dtype (the JAX package's ``jnp.dot`` without
    ``preferred_element_type``)."""
    b, s, d = x.shape
    y = L.rmsnorm(x, lp["norm1"])
    q = (y @ lp["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (y @ lp["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (y @ lp["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q, k = L.apply_rope(q, tables), L.apply_rope(k, tables)
    att = ops.attention(q, k, v.contiguous(), causal=True).reshape(b, s, d)
    x = x + att @ lp["wo"]
    y2, new_qs_row = _mlp(cfg, L.rmsnorm(x, lp["norm2"]), lp, qs_row)
    return x + y2, new_qs_row


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            qstate: torch.Tensor | None = None):
    """tokens ``[B, S]`` -> logits ``[B, S, V]`` (f32 with
    ``cfg.logits_f32``, else the compute dtype).  With
    ``cfg.quant_scaling == "delayed"``, ``qstate`` (the ``[L, 2]``
    ``init_qstate`` carry) is required and the result is ``(logits,
    new_qstate)``.  The layer loop is a Python loop; the stacked weights
    are split with ``unbind``, whose backward stacks each weight's layer
    gradients once."""
    delayed = needs_qstate(cfg)
    if delayed and qstate is None:
        raise ValueError("cfg.quant_scaling='delayed' requires the "
                         "qstate carry (models.transformer.init_qstate)")
    x = params["embed"][tokens.long()]
    s = tokens.shape[1]
    tables = L.rope_tables(torch.arange(s, device=tokens.device),
                           cfg.head_dim)
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    rows = []
    for li in range(cfg.num_layers):
        x, row = _block(cfg, x, {n: w[li] for n, w in per_layer.items()},
                        tables, qstate[li] if delayed else None)
        rows.append(row)
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tied_embeddings else params["head"]
    if cfg.logits_f32:
        b, s, d = x.shape
        logits = L.dot_f32(x.reshape(b * s, d), head).reshape(b, s, -1)
    else:
        logits = x @ head
    return (logits, torch.stack(rows)) if delayed else logits


def loss_fn(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            qstate: torch.Tensor | None = None):
    """Next-token cross-entropy on a ``[B, S+1]`` token batch; with
    delayed scaling ``(loss, new_qstate)`` (the state is an output, not
    part of the loss)."""
    if needs_qstate(cfg):
        logits, new_qstate = forward(params, tokens[:, :-1], cfg, qstate)
        return L.cross_entropy(logits, tokens[:, 1:]), new_qstate
    logits = forward(params, tokens[:, :-1], cfg)
    return L.cross_entropy(logits, tokens[:, 1:])
