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
    def is_moe(self) -> bool:
        return self.moe_params is not None

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def num_experts(self) -> int:
        return self.moe_params.num_experts if self.moe_params else 1

    @property
    def top_k(self) -> int:
        return self.moe_params.num_experts_per_tok if self.moe_params else 1

    def attn_params_per_layer(self) -> int:
        d, dkv = self.embed_dim, self.kv_dim
        return d * d + 2 * d * dkv + d * d  # Wq, Wk, Wv, Wo

    def mlp_params_per_expert(self) -> int:
        n_mat = 3 if self.gated_mlp else 2
        return n_mat * self.embed_dim * self.ff_dim

    def num_params(self) -> int:
        """Analytic total parameter count (norms included coarsely)."""
        d = self.embed_dim
        per_layer = self.attn_params_per_layer() + 2 * d  # + two norms
        if self.is_moe:
            per_layer += self.num_experts * self.mlp_params_per_expert()
            per_layer += d * self.num_experts  # router
        else:
            per_layer += self.mlp_params_per_expert()
        total = self.num_layers * per_layer + d  # final norm
        if self.vocab_size:
            total += self.vocab_size * d  # input embedding
            if not self.tied_embeddings:
                total += self.vocab_size * d  # LM head
        if self.max_position_embeddings:
            total += self.max_position_embeddings * d
        if self.is_vit:
            total += 3 * self.patch_size ** 2 * d        # patch embed
            total += (self.seq_len + 1) * d              # cls + positions
            total += d * self.num_classes                # classifier head
        return total

    def non_expert_params(self) -> int:
        """Params not sharded by expert parallelism; zero for dense
        models."""
        if not self.is_moe:
            return 0
        return self.num_params() - self.num_layers * self.num_experts * \
            self.mlp_params_per_expert()


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



def list_model_cards(card_dir: Path | str | None = None) -> list[str]:
    """Names of the cards in ``card_dir`` (default: the port's), sorted."""
    d = Path(card_dir) if card_dir else CARD_DIR
    return sorted(p.stem for p in d.glob("*.json"))


def arch_name_from_stats_name(stats_name: str) -> str:
    """``llama3_8b_16_bfloat16`` -> ``llama3_8b``: the card name is the
    stats name without its trailing ``_<batch>_<dtype>``."""
    parts = stats_name.split("_")
    if len(parts) < 3:
        raise ValueError(f"not a stats name: {stats_name!r}")
    return "_".join(parts[:-2])
