"""HuggingFace-config import: architecture cards from HF model configs
(the JAX package's ``hf_import.py``, on the port's own
``core/model_card.py`` and card directory).

What every layer of the port consumes is the architecture card, so
"importing a HF model" means mapping its config (``model_type`` gpt2 /
llama / mistral / mixtral / vit) onto ``ModelCard`` fields and writing
the card's JSON.  Hub access is tried only when asked for (``--hub``)
and is never needed: for the nine registry models the committed cards
are the fallback, so ``--all`` works with no network.  ``--weights``
(with ``--hub``) asks ``transformers`` to fill its local weight cache;
nothing in the port reads weights, which are seeded.

    python -m dlnetbench_tpu_torch.hf_import --list
    python -m dlnetbench_tpu_torch.hf_import --all --out_dir DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Mapping

from dlnetbench_tpu_torch.core.model_card import (
    ModelCard,
    MoEParams,
    load_model_card,
)

# the nine models of the registry, keyed by the card names
REGISTRY: dict[str, str] = {
    "gpt2_l": "gpt2-large",
    "gpt2_xl": "gpt2-xl",
    "llama3_8b": "meta-llama/Meta-Llama-3-8B",
    "llama3_70b": "meta-llama/Meta-Llama-3-70B",
    "minerva_7b": "sapienzanlp/Minerva-7B-instruct-v1.0",
    "mixtral_8x7b": "mistralai/Mixtral-8x7B-v0.1",
    "vit_b": "google/vit-base-patch16-224",
    "vit_l": "google/vit-large-patch16-224",
    "vit_h": "google/vit-huge-patch14-224-in21k",
}


def card_from_hf_config(name: str, cfg: Mapping[str, Any] | Any) -> ModelCard:
    """Map a HF config (a dict or a ``PretrainedConfig``) to a ModelCard.

    Dispatches on ``model_type``; covers the architecture families of the
    registry: gpt2 (learned positions, tied embeddings), llama/mistral
    (RoPE + SwiGLU + GQA), mixtral (adds MoE), vit (encoder + classifier).
    """
    if hasattr(cfg, "to_dict"):
        cfg = cfg.to_dict()
    mt = cfg.get("model_type", "")

    if mt == "gpt2":
        n_embd = int(cfg["n_embd"])
        n_positions = int(cfg.get("n_positions") or cfg.get("n_ctx") or 1024)
        return ModelCard(
            name=name,
            embed_dim=n_embd,
            num_heads=int(cfg["n_head"]),
            ff_dim=int(cfg.get("n_inner") or 4 * n_embd),
            seq_len=n_positions,
            num_decoder_blocks=int(cfg["n_layer"]),
            vocab_size=int(cfg["vocab_size"]),
            max_position_embeddings=n_positions,
            tied_embeddings=True,
        )

    if mt in ("llama", "mistral", "mixtral"):
        moe = None
        if mt == "mixtral":
            moe = MoEParams(
                num_experts=int(cfg["num_local_experts"]),
                num_experts_per_tok=int(cfg["num_experts_per_tok"]),
            )
        heads = int(cfg["num_attention_heads"])
        return ModelCard(
            name=name,
            embed_dim=int(cfg["hidden_size"]),
            num_heads=heads,
            num_kv_heads=int(cfg.get("num_key_value_heads") or heads),
            ff_dim=int(cfg["intermediate_size"]),
            seq_len=int(cfg["max_position_embeddings"]),
            num_decoder_blocks=int(cfg["num_hidden_layers"]),
            vocab_size=int(cfg["vocab_size"]),
            gated_mlp=True,
            moe_params=moe,
        )

    if mt == "vit":
        image = int(cfg["image_size"])
        patch = int(cfg["patch_size"])
        return ModelCard(
            name=name,
            embed_dim=int(cfg["hidden_size"]),
            num_heads=int(cfg["num_attention_heads"]),
            ff_dim=int(cfg["intermediate_size"]),
            seq_len=(image // patch) ** 2 + 1,   # patches + [cls]
            num_encoder_blocks=int(cfg["num_hidden_layers"]),
            image_size=image,
            patch_size=patch,
            num_classes=int(cfg.get("num_labels") or 1000),
        )

    raise ValueError(f"unsupported HF model_type {mt!r} for {name}")


def card_to_json(card: ModelCard) -> dict:
    """Card -> the on-disk JSON schema (zero, False and None fields are
    left out)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(ModelCard):
        if f.name in ("name", "moe_params"):
            continue
        v = getattr(card, f.name)
        if v:
            out[f.name] = v
    if card.moe_params is not None:
        out["moe_params"] = {
            "num_experts": card.moe_params.num_experts,
            "num_experts_per_tok": card.moe_params.num_experts_per_tok,
        }
    return out


def fetch_card(name: str, *, allow_hub: bool = False) -> tuple[ModelCard, str]:
    """Return (card, source) for a registry model.

    source is "hub" when a live HF config was fetched and mapped,
    "fallback" when the committed card was used (no network, no access
    to a gated model, or no ``transformers``).
    """
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; registry: {sorted(REGISTRY)}")
    if allow_hub:
        try:
            from transformers import AutoConfig
            cfg = AutoConfig.from_pretrained(REGISTRY[name])
            return card_from_hf_config(name, cfg), "hub"
        except Exception as e:  # no net, gated repo, missing transformers
            print(f"[hf_import] hub fetch failed for {name} ({e!r}); "
                  f"using committed card", file=sys.stderr)
    return load_model_card(name), "fallback"


def import_model(name: str, out_dir: Path, *, allow_hub: bool = False,
                 weights: bool = False) -> Path:
    card, source = fetch_card(name, allow_hub=allow_hub)
    if weights and allow_hub:
        try:
            from transformers import AutoModel
            AutoModel.from_pretrained(REGISTRY[name])  # populate HF cache
        except Exception as e:  # gated / offline: card still gets written
            print(f"[hf_import] weight fetch failed for {name} ({e!r})",
                  file=sys.stderr)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    with open(path, "w") as f:
        json.dump(card_to_json(card), f, indent=2)
        f.write("\n")
    print(f"{name}: wrote {path} (source: {source})")
    return path


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Import HF model configs as architecture cards")
    p.add_argument("models", nargs="*", help="registry names (see --list)")
    p.add_argument("--list", action="store_true", dest="list_models")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out_dir", type=Path,
                   default=Path(__file__).parent / "data" / "models")
    p.add_argument("--hub", action="store_true",
                   help="attempt live HF hub fetch before falling back")
    p.add_argument("--weights", action="store_true",
                   help="also populate the local HF weight cache (needs --hub)")
    args = p.parse_args(argv)

    if args.weights and not args.hub:
        p.error("--weights requires --hub (weight fetch needs hub access)")
    if args.list_models:
        for name, hf in REGISTRY.items():
            print(f"{name:16s} {hf}")
        return 0
    names = sorted(REGISTRY) if args.all else args.models
    if not names:
        p.error("no models given (use --all or --list)")
    for name in names:
        import_model(name, args.out_dir, allow_hub=args.hub,
                     weights=args.weights)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
