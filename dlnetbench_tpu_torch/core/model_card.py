"""Architecture cards — the port's copy of the JAX package's
``core/model_card.py`` reader, over the port's own copy of the cards
(``dlnetbench_tpu_torch/data/models/*.json``, the same JSON schema)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

CARD_DIR = Path(__file__).resolve().parent.parent / "data" / "models"


@dataclasses.dataclass(frozen=True)
class MoEParams:
    num_experts: int
    num_experts_per_tok: int


@dataclasses.dataclass(frozen=True)
class ModelCard:
    name: str
    embed_dim: int
    num_heads: int
    ff_dim: int
    seq_len: int
    num_encoder_blocks: int = 0
    num_decoder_blocks: int = 0
    moe_params: MoEParams | None = None
    vocab_size: int = 0
    num_kv_heads: int = 0           # 0 => MHA (kv heads == heads)
    gated_mlp: bool = False         # SwiGLU (llama family) vs GELU
    tied_embeddings: bool = False
    max_position_embeddings: int = 0  # learned positions; 0 => RoPE
    image_size: int = 0
    patch_size: int = 0
    num_classes: int = 0

    @property
    def num_layers(self) -> int:
        return self.num_encoder_blocks + self.num_decoder_blocks

    @property
    def is_vit(self) -> bool:
        return self.patch_size > 0

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def num_experts(self) -> int:
        return self.moe_params.num_experts if self.moe_params else 1


def _parse_card(name: str, raw: dict) -> ModelCard:
    moe = None
    if "moe_params" in raw:
        moe = MoEParams(
            num_experts=int(raw["moe_params"]["num_experts"]),
            num_experts_per_tok=int(raw["moe_params"]["num_experts_per_tok"]),
        )
    known = {f.name for f in dataclasses.fields(ModelCard)}
    kwargs = {k: v for k, v in raw.items() if k in known and k != "moe_params"}
    return ModelCard(name=name, moe_params=moe, **kwargs)


def load_model_card(name: str, card_dir: Path | str | None = None) -> ModelCard:
    """Load ``<card_dir>/<name>.json`` (default: the port's cards)."""
    d = Path(card_dir) if card_dir else CARD_DIR
    with open(d / f"{name}.json") as f:
        raw = json.load(f)
    return _parse_card(name, raw)

