"""The Vision Transformer family (the vit_b / vit_l / vit_h cards; the
JAX package's ``models/vit.py``).

Encoder only: patchify -> [cls] + learned positions -> pre-norm encoder
blocks (LayerNorm, bidirectional attention, GELU MLP) -> the cls token's
classifier head, with f32 logits.  The layer loop is a Python loop over
the stacked weights (JAX scans them: the same numbers).

The cards' sequences (197 tokens for vit_b / vit_l, 257 for vit_h) are
not multiples of the flash kernels' 128-row tile, so on the card
``ops.attention`` takes its counted dense route there
(``flash_attention.dense_attention_calls``), as the JAX package runs
XLA's einsum where its kernel's blocks find no fit.  ``init_params``
builds the JAX package's tree (``patch_embed``, ``patch_bias``,
``cls_token``, ``pos_embed``, the stacked ``layers``, ``final_norm``,
``final_norm_b``, ``head_w``, ``head_b``) from a seeded
``torch.Generator``; ``transformer.params_from_numpy`` carries the JAX
package's weights over.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from dlnetbench_tpu_torch import ops
from dlnetbench_tpu_torch.core.model_card import ModelCard
from dlnetbench_tpu_torch.models import layers as L
from dlnetbench_tpu_torch.models.layers import init_dense
from dlnetbench_tpu_torch.models.transformer import DTYPES


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int
    patch_size: int
    embed_dim: int
    num_heads: int
    ff_dim: int
    num_layers: int
    num_classes: int
    dtype: str = "bfloat16"
    attention_impl: str = "auto"   # ops.attention: auto | flash | xla

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"ViTConfig: dtype {self.dtype!r} (one of "
                             f"{tuple(DTYPES)})")

    @classmethod
    def from_card(cls, card: ModelCard, *, num_layers: int | None = None,
                  image_size: int | None = None) -> "ViTConfig":
        if not card.is_vit:
            raise ValueError(f"{card.name} is not a ViT card")
        return cls(
            image_size=image_size or card.image_size,
            patch_size=card.patch_size,
            embed_dim=card.embed_dim,
            num_heads=card.num_heads,
            ff_dim=card.ff_dim,
            num_layers=num_layers or card.num_layers,
            num_classes=card.num_classes,
        )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def init_params(cfg: ViTConfig, *, seed: int = 0, device="cuda") -> dict:
    """Seeded random weights on ``device``, in the JAX package's tree."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, h, nl = cfg.embed_dim, cfg.ff_dim, cfg.num_layers
    p = cfg.patch_size
    dt = cfg.torch_dtype
    s_d = 1.0 / math.sqrt(d)

    def dense(shape, scale):
        return init_dense(gen, shape, scale, dt, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    return {
        "patch_embed": dense((p * p * 3, d), 1.0 / math.sqrt(p * p * 3)),
        "patch_bias": zeros(d),
        "cls_token": zeros(1, 1, d),
        "pos_embed": dense((cfg.num_patches + 1, d), 0.02),
        "layers": {
            "wq": dense((nl, d, d), s_d),
            "wk": dense((nl, d, d), s_d),
            "wv": dense((nl, d, d), s_d),
            "wo": dense((nl, d, d), s_d),
            "norm1": ones(nl, d),
            "norm1_b": zeros(nl, d),
            "norm2": ones(nl, d),
            "norm2_b": zeros(nl, d),
            "w_in": dense((nl, d, h), s_d),
            "b_in": zeros(nl, h),
            "w_out": dense((nl, h, d), 1.0 / math.sqrt(h)),
            "b_out": zeros(nl, d),
        },
        "final_norm": ones(d),
        "final_norm_b": zeros(d),
        "head_w": dense((d, cfg.num_classes), s_d),
        "head_b": zeros(cfg.num_classes),
    }


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """``[B, H, W, 3]`` (NHWC) -> ``[B, N, p*p*3]``: patches in row-major
    grid order, each flattened as (row, column, channel), the JAX
    package's transpose."""
    b, hh, ww, c = images.shape
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    x = images.reshape(b, gh, p, gw, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)


def _block(cfg: ViTConfig, x: torch.Tensor, lp: dict) -> torch.Tensor:
    b, s, d = x.shape
    y = L.layernorm(x, lp["norm1"], lp["norm1_b"])
    q = (y @ lp["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (y @ lp["wk"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    v = (y @ lp["wv"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    att = ops.attention(q, k, v, causal=False,
                        impl=cfg.attention_impl).reshape(b, s, d)
    x = x + att @ lp["wo"]
    y = L.layernorm(x, lp["norm2"], lp["norm2_b"])
    return x + L.gelu_mlp(y, lp["w_in"], lp["b_in"], lp["w_out"],
                          lp["b_out"])


def forward(params: dict, images: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """images ``[B, H, W, 3]`` -> class logits ``[B, num_classes]`` f32."""
    x = patchify(images.to(cfg.torch_dtype), cfg) @ params["patch_embed"] \
        + params["patch_bias"]
    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.num_layers):
        x = _block(cfg, x, {n: w[li] for n, w in per_layer.items()})
    x = L.layernorm(x[:, 0], params["final_norm"], params["final_norm_b"])
    return L.dot_f32(x, params["head_w"]) + params["head_b"].to(torch.float32)


def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """Mean cross-entropy of the class logits against ``labels [B]``."""
    return L.cross_entropy(forward(params, images, cfg), labels)
