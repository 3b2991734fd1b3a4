"""The torch port's ``hf_import.py`` held against the JAX package's: each
HF config dict maps to the card JAX's ``card_from_hf_config`` gives,
``--all`` writes byte-identical JSON, ``--list`` prints the same lines,
and the refusals and the offline fallback match.  ``--hub`` runs with
``transformers`` made unimportable, so nothing is ever fetched."""
from __future__ import annotations

import dataclasses
import sys

import pytest

from dlnetbench_tpu import hf_import as JH
from dlnetbench_tpu.core.model_card import load_model_card as jax_card
from dlnetbench_tpu_torch import hf_import as TH
from dlnetbench_tpu_torch.core.model_card import CARD_DIR
from dlnetbench_tpu_torch.core.model_card import load_model_card as torch_card

# the public HF configs of the registry models (tests/test_hf_import.py's
# four, and the rest of the registry's families)
CONFIGS = {
    "gpt2_l": {"model_type": "gpt2", "n_embd": 1280, "n_head": 20,
               "n_layer": 36, "n_positions": 1024, "n_inner": None,
               "vocab_size": 50257},
    "gpt2_xl": {"model_type": "gpt2", "n_embd": 1600, "n_head": 25,
                "n_layer": 48, "n_ctx": 1024, "vocab_size": 50257},
    "llama3_8b": {"model_type": "llama", "hidden_size": 4096,
                  "num_attention_heads": 32, "num_key_value_heads": 8,
                  "intermediate_size": 14336,
                  "max_position_embeddings": 8192, "num_hidden_layers": 32,
                  "vocab_size": 128256},
    "minerva_7b": {"model_type": "mistral", "hidden_size": 4096,
                   "num_attention_heads": 32, "num_key_value_heads": 8,
                   "intermediate_size": 14336,
                   "max_position_embeddings": 16384,
                   "num_hidden_layers": 32, "vocab_size": 51200},
    "mixtral_8x7b": {"model_type": "mixtral", "hidden_size": 4096,
                     "num_attention_heads": 32, "num_key_value_heads": 8,
                     "intermediate_size": 14336,
                     "max_position_embeddings": 32768,
                     "num_hidden_layers": 32, "vocab_size": 32000,
                     "num_local_experts": 8, "num_experts_per_tok": 2},
    "vit_b": {"model_type": "vit", "hidden_size": 768,
              "num_attention_heads": 12, "intermediate_size": 3072,
              "num_hidden_layers": 12, "image_size": 224, "patch_size": 16,
              "num_labels": 1000},
    "vit_h": {"model_type": "vit", "hidden_size": 1280,
              "num_attention_heads": 16, "intermediate_size": 5120,
              "num_hidden_layers": 32, "image_size": 224,
              "patch_size": 14},
    "mha_llama": {"model_type": "llama", "hidden_size": 256,
                  "num_attention_heads": 4, "intermediate_size": 512,
                  "max_position_embeddings": 128, "num_hidden_layers": 2,
                  "vocab_size": 97},
}


class _Config:
    """A ``PretrainedConfig`` stand-in: the mapping reads ``to_dict``."""

    def __init__(self, d):
        self._d = d

    def to_dict(self):
        return dict(self._d)


@pytest.fixture
def no_hub(monkeypatch):
    """``transformers`` unimportable and the hub offline: a ``--hub`` run
    takes the fallback without reaching for the network."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mapping_matches_jax(name):
    want = JH.card_from_hf_config(name, CONFIGS[name])
    got = TH.card_from_hf_config(name, CONFIGS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TH.card_to_json(got) == JH.card_to_json(want)
    got = TH.card_from_hf_config(name, _Config(CONFIGS[name]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["gpt2_l", "llama3_8b", "mixtral_8x7b",
                                  "vit_b"])
def test_mapping_reproduces_the_port_card(name):
    got = TH.card_from_hf_config(name, CONFIGS[name])
    assert got == torch_card(name)


def test_unknown_model_type_refused_as_jax():
    with pytest.raises(ValueError) as et:
        TH.card_from_hf_config("x", {"model_type": "mamba"})
    with pytest.raises(ValueError) as ej:
        JH.card_from_hf_config("x", {"model_type": "mamba"})
    assert str(et.value) == str(ej.value)
    with pytest.raises(KeyError) as et:
        TH.fetch_card("not_a_model")
    with pytest.raises(KeyError) as ej:
        JH.fetch_card("not_a_model")
    assert str(et.value) == str(ej.value)


def test_registry_and_cards_match_jax():
    assert TH.REGISTRY == JH.REGISTRY
    for name in TH.REGISTRY:
        assert dataclasses.asdict(torch_card(name)) == \
            dataclasses.asdict(jax_card(name))


def test_all_writes_what_jax_writes(tmp_path, capsys):
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    assert TH.main(["--all", "--out_dir", str(tdir)]) == 0
    tout = capsys.readouterr().out
    assert JH.main(["--all", "--out_dir", str(jdir)]) == 0
    jout = capsys.readouterr().out
    assert tout.replace(str(tdir), "D") == jout.replace(str(jdir), "D")
    names = sorted(p.name for p in tdir.glob("*.json"))
    assert names == sorted(p.name for p in jdir.glob("*.json"))
    assert names == sorted(f"{n}.json" for n in TH.REGISTRY)
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n
        # and what was written reads back as the committed card
        assert torch_card(n[:-5], tdir) == torch_card(n[:-5])


def test_named_models_only(tmp_path, capsys):
    assert TH.main(["gpt2_xl", "vit_h", "--out_dir", str(tmp_path)]) == 0
    assert sorted(p.stem for p in tmp_path.glob("*.json")) == \
        ["gpt2_xl", "vit_h"]
    assert "gpt2_xl: wrote" in capsys.readouterr().out


def test_list_matches_jax(capsys):
    assert TH.main(["--list"]) == 0
    tout = capsys.readouterr().out
    assert JH.main(["--list"]) == 0
    assert tout == capsys.readouterr().out
    assert "meta-llama/Meta-Llama-3-8B" in tout and "gpt2-large" in tout


@pytest.mark.parametrize("argv", [["--weights", "gpt2_l"], []])
def test_usage_errors_match_jax(argv, capsys):
    with pytest.raises(SystemExit) as et:
        TH.main(argv)
    terr = capsys.readouterr().err
    with pytest.raises(SystemExit) as ej:
        JH.main(argv)
    jerr = capsys.readouterr().err
    assert et.value.code == ej.value.code == 2
    assert terr.splitlines()[-1] == jerr.splitlines()[-1]


def test_hub_falls_back_to_the_committed_card(tmp_path, capsys, no_hub):
    assert TH.main(["--hub", "--weights", "gpt2_l", "--out_dir",
                    str(tmp_path)]) == 0
    cap = capsys.readouterr()
    assert "hub fetch failed for gpt2_l" in cap.err
    assert "using committed card" in cap.err
    assert "weight fetch failed for gpt2_l" in cap.err
    assert "(source: fallback)" in cap.out
    assert torch_card("gpt2_l", tmp_path) == torch_card("gpt2_l")


def test_default_out_dir_is_the_port_cards(monkeypatch):
    seen = []
    monkeypatch.setattr(TH, "import_model",
                        lambda name, out_dir, **kw: seen.append(out_dir))
    assert TH.main(["gpt2_l"]) == 0
    assert seen == [CARD_DIR]
