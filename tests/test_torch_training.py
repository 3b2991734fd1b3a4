"""The torch port's training slice held against the JAX package: the
tiny model's logits, loss, gradients and two chained SGD steps (also
under a sliding-window and a document-segment attention mask, where JAX
runs its splash kernels in interpret mode and the port its splash op's
plain versions), the RMSNorm backward, the loss, the roofline counts,
the mask knobs, and the bench entry point's headline and
``longcontext_ab`` lines.

The model is a tiny f32 llama-style config (embed 512, 4/2 heads of
128, ff 1024, 2 layers, vocab 512, S 256, B 2).  JAX runs it with
``attention_impl="flash"`` (the Pallas kernels in interpret mode),
``scan_layers=False`` and ``logits_f32=False``; the port runs the same
weights (``params_from_numpy``) through its flash op's plain versions.
Bars: logits 1e-4 absolute, loss 1e-5 relative, every gradient leaf
within 1e-3 of that leaf's max-abs, and the two steps' update of every
weight within two ulps of the weight plus 1e-3 of the leaf's largest
update (f32 throughout; the gap is summation order)."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlnetbench_tpu.core import roofline as JR
from dlnetbench_tpu.core.model_card import load_model_card as jax_card
from dlnetbench_tpu.models import bench_step as JB
from dlnetbench_tpu.models import layers as JL
from dlnetbench_tpu.models import transformer as JT
from dlnetbench_tpu_torch import bench as TBENCH
from dlnetbench_tpu_torch.core import hardware as TH
from dlnetbench_tpu_torch.core import roofline as TR
from dlnetbench_tpu_torch.core.model_card import load_model_card as torch_card
from dlnetbench_tpu_torch.metrics import stats as TS
from dlnetbench_tpu_torch.models import bench_step as TB
from dlnetbench_tpu_torch.models import layers as TL
from dlnetbench_tpu_torch.models import transformer as TT

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, embed_dim=512, num_heads=4, num_kv_heads=2,
            ff_dim=1024, num_layers=2, seq_len=256, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    """``{"layers.wq": leaf, ...}`` of a nested dict."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat(val, name + "."))
        else:
            out[name] = val
    return out


def close_per_leaf(got: dict, want: dict, rel: float) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().float().numpy()
        assert g.shape == w.shape, name
        bound = rel * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, name


@pytest.fixture(scope="module")
def tiny():
    jcfg = JT.TransformerConfig(gated=True, max_positions=0,
                                attention_impl="flash", scan_layers=False,
                                logits_f32=False, **TINY)
    tcfg = TT.TransformerConfig(logits_f32=False, **TINY)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tokens = np.random.default_rng(4).integers(
        0, TINY["vocab_size"], (2, TINY["seq_len"] + 1)).astype(np.int32)
    loss, grads = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tokens),
                                                 jcfg)
    logits = JT.forward(jp, jnp.asarray(tokens[:, :-1]), jcfg)
    p2, losses = jax.jit(JB.make_train_k(jcfg, 2))(jp, jnp.asarray(tokens))
    np_tree = jax.tree.map(np.asarray, jp)
    return {"jcfg": jcfg, "tcfg": tcfg, "np_params": np_tree,
            "tokens": tokens, "loss": float(loss), "logits": logits,
            "grads": flat(jax.tree.map(np.asarray, grads)),
            "p2": flat(jax.tree.map(np.asarray, p2)),
            "losses": np.asarray(losses)}


def torch_params(tiny):
    return TT.params_from_numpy(tiny["np_params"], "cpu")


# the masked tiny models: a window shorter than the sequence, and
# documents (avg 50) shorter than a kernel tile
MASKS = {"window": {"attention_window": 64},
         "segments": {"attention_seg_avg": 50, "attention_seg_seed": 3}}


@pytest.fixture(scope="module", params=sorted(MASKS))
def masked(request):
    knobs = MASKS[request.param]
    jcfg = JT.TransformerConfig(gated=True, max_positions=0,
                                attention_impl="flash", scan_layers=False,
                                logits_f32=False, **TINY, **knobs)
    tcfg = TT.TransformerConfig(logits_f32=False, **TINY, **knobs)
    jp = JT.init_params(jax.random.key(1), jcfg)
    tokens = np.random.default_rng(5).integers(
        0, TINY["vocab_size"], (2, TINY["seq_len"] + 1)).astype(np.int32)
    loss, grads = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tokens),
                                                 jcfg)
    logits = JT.forward(jp, jnp.asarray(tokens[:, :-1]), jcfg)
    p2, losses = jax.jit(JB.make_train_k(jcfg, 2))(jp, jnp.asarray(tokens))
    return {"jcfg": jcfg, "tcfg": tcfg,
            "np_params": jax.tree.map(np.asarray, jp),
            "tokens": tokens, "loss": float(loss), "logits": logits,
            "grads": flat(jax.tree.map(np.asarray, grads)),
            "p2": flat(jax.tree.map(np.asarray, p2)),
            "losses": np.asarray(losses)}


def test_masked_config_reaches_the_splash_op(masked):
    spec = masked["tcfg"].mask_spec
    assert spec is not None and not spec.is_plain_causal
    assert spec.to_dict() == masked["jcfg"].mask_spec.to_dict()
    # the masks change the model: the dense-causal loss differs
    dense = dataclasses.replace(masked["tcfg"], attention_window=0,
                                attention_seg_avg=0)
    params = torch_params(masked)
    tok = torch.from_numpy(masked["tokens"])
    with torch.no_grad():
        assert abs(float(TT.loss_fn(params, tok, dense))
                   - masked["loss"]) > 1e-4


def test_tiny_logits_and_loss_match_jax(tiny):
    check_logits_and_loss(tiny)


def test_masked_logits_and_loss_match_jax(masked):
    check_logits_and_loss(masked)


def check_logits_and_loss(tiny):
    params = torch_params(tiny)
    tok = torch.from_numpy(tiny["tokens"])
    with torch.no_grad():
        logits = TT.forward(params, tok[:, :-1], tiny["tcfg"])
        loss = float(TT.loss_fn(params, tok, tiny["tcfg"]))
    assert logits.dtype == torch.float32
    assert float(np.abs(logits.numpy() - np.asarray(tiny["logits"])).max()) \
        < 1e-4
    assert abs(loss - tiny["loss"]) <= 1e-5 * abs(tiny["loss"])


def test_tiny_gradients_match_jax(tiny):
    check_gradients(tiny)


def test_masked_gradients_match_jax(masked):
    check_gradients(masked)


def check_gradients(tiny):
    params = torch_params(tiny)
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = TT.loss_fn(params, torch.from_numpy(tiny["tokens"]),
                      tiny["tcfg"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    close_per_leaf(dict(zip(leaves, grads)), tiny["grads"], 1e-3)


def test_two_chained_steps_match_jax_make_train_k(tiny):
    check_two_steps(tiny)


def test_masked_two_chained_steps_match_jax_make_train_k(masked):
    check_two_steps(masked)


def check_two_steps(tiny):
    """The update itself, p2 - p0, against JAX's, element by element:
    two SGD steps at lr 1e-3 move a weight by ~1e-6-1e-5, far under any
    bar set on the weights.  Each side rounds p - lr * g to f32 at the
    weight's own scale, twice, so the two may differ by two ulps of the
    weight, plus 1e-3 of the leaf's largest move for the gradients'
    summation order (the gradient bar above)."""
    params = torch_params(tiny)
    params, losses = TB.make_train_k(tiny["tcfg"], 2)(
        params, torch.from_numpy(tiny["tokens"]))
    assert losses.shape == (2,) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), tiny["losses"], rtol=1e-5)
    assert float(losses[1]) < float(losses[0])
    got, p0 = flat(params), flat(tiny["np_params"])
    assert sorted(got) == sorted(tiny["p2"]) == sorted(p0)
    for name, start in p0.items():
        start = np.asarray(start, np.float32)
        want = np.asarray(tiny["p2"][name], np.float32) - start
        moved = got[name].numpy() - start
        assert float(np.abs(want).max()) > 0, name
        bound = 2 * np.spacing(np.abs(start)) + 1e-3 * np.abs(want).max()
        assert (np.abs(moved - want) <= bound).all(), name
    assert not any(p.requires_grad for p in got.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax_custom_vjp(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    scale = 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    jdt = jnp.dtype(dtype)
    jx, js, jdy = (jnp.asarray(a).astype(jdt) for a in (x, scale, dy))
    jy, vjp = jax.vjp(JL.rmsnorm, jx, js)
    jdx, jds = vjp(jdy)
    tdt = getattr(torch, dtype)
    tx, ts = (torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (x, scale))
    ty = TL.rmsnorm(tx, ts)
    ty.backward(torch.from_numpy(dy).to(tdt))
    assert ty.dtype == tdt and tx.grad.dtype == tdt
    # f32: summation order only; bf16: one bf16 rounding of the output
    # and gradients (the cast points are the same)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((ty, jy), (tx.grad, jdx), (ts.grad, jds)):
        want = np.asarray(want.astype(jnp.float32))
        err = float(np.abs(got.detach().float().numpy() - want).max())
        assert err <= tol * max(1.0, float(np.abs(want).max())), err


def test_rmsnorm_forward_unchanged_without_grad():
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    s = torch.randn(64, dtype=torch.bfloat16)
    var = x.float().square().mean(dim=-1, keepdim=True)
    want = (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * s
    assert torch.equal(TL.rmsnorm(x, s), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(12)
    logits = 3 * rng.standard_normal((2, 16, 300), dtype=np.float32)
    targets = rng.integers(0, 300, (2, 16)).astype(np.int32)
    want = float(JL.cross_entropy(jnp.asarray(logits).astype(dtype),
                                  jnp.asarray(targets)))
    got = float(TL.cross_entropy(
        torch.from_numpy(logits).to(getattr(torch, dtype)),
        torch.from_numpy(targets)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("name", ["bench", "gpt2_l", "llama3_8b"])
def test_roofline_counts_equal_jax(name):
    if name == "bench":
        jc, tc = JB.bench_card(), TB.bench_card()
    else:
        jc, tc = jax_card(name), torch_card(name)
    assert (tc.head_dim, tc.kv_dim, tc.is_moe, tc.top_k) == \
        (jc.head_dim, jc.kv_dim, jc.is_moe, jc.top_k)
    assert tc.num_params() == jc.num_params()
    assert tc.non_expert_params() == jc.non_expert_params()
    for b in (1, 2):
        assert TR.model_flops(tc, b) == JR.model_flops(jc, b)
        assert TR.model_bytes(tc, b, "bfloat16") == \
            JR.model_bytes(jc, b, "bfloat16")
        assert TR.train_step_bytes(tc, b, "bfloat16") == \
            JR.train_step_bytes(jc, b, "bfloat16")
    assert TR.BWD_FWD_RATIO == JR.BWD_FWD_RATIO


def test_hardware_presets_and_device_names():
    assert TH.hw_key_for_device_name("NVIDIA H100 80GB HBM3") == "h100_sxm"
    assert TH.hw_key_for_device_name("NVIDIA H100 PCIe") == "h100_pcie"
    assert TH.hw_key_for_device_name("cpu") is None
    assert TH.hw_key_for_device_name(None) is None
    sxm = TH.HARDWARE["h100_sxm"]
    assert (sxm.peak("bfloat16"), sxm.hbm_bandwidth) == (989e12, 3.35e12)
    assert TH.HARDWARE["h100_pcie"].peak("bfloat16") == 756e12
    with pytest.raises(ValueError):
        sxm.peak("nvfp4")


def test_flag_low_mode_matches_jax():
    from dlnetbench_tpu.metrics import stats as JS
    for line in ({"value": 10.0, "best": 6.0, "n": 3},
                 {"value": 10.0, "best": 9.0, "n": 3},
                 {"value": 10.0, "best": 5.0, "n": 1, "note": "x"}):
        got = TS.flag_low_mode(dict(line))
        want = JS.flag_low_mode(dict(line))
        assert ("note" in got) == ("note" in want)


def test_headline_formulas_match_bench_py():
    """The port's headline line from a fixed step time: the ratio keys
    by bench.py's formulas, priced with the H100 preset."""
    card = TB.bench_card()
    cfg = TB.bench_cfg(card)
    line = TBENCH.headline({"value": 0.2, "best": 0.19,
                            "band": [0.19, 0.21], "n": 3}, 10.9, card,
                           cfg, "NVIDIA H100 80GB HBM3", "h100_sxm")
    b, s, d, v = TB.BATCH, TB.SEQ, card.embed_dim, TB.VOCAB
    fwd = JR.model_flops(JB.bench_card(), b) + 2 * b * s * d * v
    assert line["tflops_achieved"] == round(3 * fwd / 0.2 / 1e12, 2)
    assert line["value"] == 200.0 and line["band"] == [190.0, 210.0]
    assert line["logits_dtype"] == "bfloat16"
    assert 0 < line["vs_baseline_causal"] < line["vs_baseline"] < 1
    assert "H100" in line["metric"] and "h100_sxm" in line["metric"]


def test_transformer_config_knobs():
    cfg = TT.TransformerConfig(**TINY)
    assert cfg.logits_f32
    # the MLP recipes: the JAX package's five knobs, its defaults, and
    # every combination it accepts; the remat knobs, attention_impl
    # (ops.attention's dispatch: on the card "auto" and "flash" run the
    # kernels and "xla" is refused) and scan_layers (accepted, the loop
    # is Python's) with the JAX package's defaults
    jcfg = JT.TransformerConfig(gated=True, max_positions=0, **TINY)
    for knob in ("mlp_dtype", "int8_backward", "quant_fusion",
                 "quant_scaling", "mlp_backward", "remat", "remat_policy",
                 "remat_scope", "attention_impl", "scan_layers"):
        assert getattr(cfg, knob) == getattr(jcfg, knob), knob
    for knobs in ({"mlp_dtype": "int8"},
                  {"mlp_dtype": "int8", "int8_backward": "switchback"},
                  {"mlp_dtype": "int8", "quant_fusion": "fused"},
                  {"mlp_dtype": "float8"},
                  {"mlp_dtype": "float8", "quant_fusion": "fused",
                   "quant_scaling": "delayed"},
                  {"mlp_backward": "split"}, {"mlp_backward": "pallas"}):
        got = TT.TransformerConfig(**TINY, **knobs)
        JT.TransformerConfig(gated=True, max_positions=0, **TINY, **knobs)
        assert TT.needs_qstate(got) == (knobs.get("quant_scaling")
                                        == "delayed")


def test_mask_knobs_match_jax():
    """The three mask knobs: the JAX validation message for message, the
    same ``mask_spec`` (None when off), and the bench config takes them
    as overrides (what ``bench_step.build`` passes on), as the JAX
    ``build`` does."""
    for knobs in ({"attention_window": -1}, {"attention_seg_avg": -4},
                  {"attention_window": -2, "attention_seg_avg": -1}):
        with pytest.raises(ValueError) as te:
            TT.TransformerConfig(**TINY, **knobs)
        with pytest.raises(ValueError) as je:
            JT.TransformerConfig(gated=True, max_positions=0, **TINY,
                                 **knobs)
        assert str(te.value) == str(je.value)
    for knobs in ({}, {"attention_window": 64},
                  {"attention_seg_avg": 50, "attention_seg_seed": 3},
                  {"attention_window": 32, "attention_seg_avg": 80,
                   "attention_seg_seed": 5}, {"attention_seg_seed": 9}):
        got = TT.TransformerConfig(**TINY, **knobs).mask_spec
        want = JT.TransformerConfig(gated=True, max_positions=0, **TINY,
                                    **knobs).mask_spec
        assert (got is None) == (want is None), knobs
        if got is not None:
            assert got.to_dict() == want.to_dict() \
                and got.label() == want.label()
    cfg = TB.bench_cfg(TB.bench_card(), attention_window=64,
                       attention_seg_avg=50, attention_seg_seed=2)
    assert (cfg.attention_window, cfg.attention_seg_avg,
            cfg.attention_seg_seed) == (64, 50, 2)
    assert cfg.mask_spec.label() == "causal&window(64)&seg(avg=50,seed=2)"


LC_SUMMARIES = {
    "dense": {"value": 0.020, "best": 0.019, "band": [0.019, 0.021],
              "n": 3},
    "splash_causal": {"value": 0.019, "best": 0.018,
                      "band": [0.018, 0.020], "n": 3},
    "splash_window": {"value": 0.005, "best": 0.0045,
                      "band": [0.0045, 0.0055], "n": 3},
    "splash_segment": {"value": 0.010, "best": 0.009,
                       "band": [0.009, 0.011], "n": 3},
}
LC_ROUNDS = {"dense": [0.019, 0.020, 0.021],
             "splash_causal": [0.018, 0.019, 0.020],
             "splash_window": [0.0045, 0.005, 0.0055],
             "splash_segment": [0.009, 0.010, 0.011]}


@pytest.mark.parametrize("variant", ["win", "overlap", "bimodal"])
def test_longcontext_line_matches_jax(variant):
    """The ``longcontext_ab`` line from the same summaries: every key
    and value of the JAX bench's ``_longcontext_line``."""
    import copy

    import bench as jbench
    summ, rounds = copy.deepcopy(LC_SUMMARIES), copy.deepcopy(LC_ROUNDS)
    if variant == "overlap":       # the window leg no faster than dense
        summ["splash_window"] = dict(summ["dense"])
        rounds["splash_window"] = list(rounds["dense"])
    if variant == "bimodal":
        summ["splash_window"]["best"] = 0.002
    info = {name: {"attention_mask": name, "mask_sparsity": 0.5,
                   "block_skip_fraction": 0.4, "expected_speedup": e}
            for name, e in (("splash_causal", 1.0), ("splash_window", 4.0),
                            ("splash_segment", 0.0))}
    got = TBENCH.longcontext_ab_line(summ, rounds, metric="m",
                                     mask_info=info)
    want = jbench._longcontext_line(summ, rounds, metric="m",
                                    mask_info=info)
    # the low-mode note's wording is the port's (no tunnel on a card)
    assert ("note" in got) == ("note" in want) == (variant == "bimodal")
    got.pop("note", None)
    want.pop("note", None)
    assert got == want
    assert isinstance(got["band_disjoint_win"], bool)
    assert set(got["speedup_vs_sparsity"]) == {"splash_causal",
                                               "splash_window"}


def test_longcontext_line_runs_on_cpu(monkeypatch, capsys):
    """``bench_longcontext_ab`` at a tiny ``DLNB_BENCH_LC_*`` shape on the
    CPU (plain versions): all four legs, the paired ratio bands, the
    tile accounting at K6's tiles; the CPU launches no kernel."""
    from dlnetbench_tpu_torch.ops import attention_mask as TM
    from dlnetbench_tpu_torch.ops import flash_attention as TFA
    for knob, val in (("SEQ", "256"), ("HEADS", "2"), ("WINDOW", "64"),
                      ("SEG", "96"), ("K", "2")):
        monkeypatch.setenv(f"DLNB_BENCH_LC_{knob}", val)
    before = (TFA.fwd_launches, TFA.splash_fwd_launches)
    line = TBENCH.bench_longcontext_ab(None, None, "cpu",
                                       torch.device("cpu"))
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert (TFA.fwd_launches, TFA.splash_fwd_launches) == before
    legs = ("dense", "splash_causal", "splash_window", "splash_segment")
    for leg in legs:
        assert set(line[leg]) == {"value", "best", "band", "n"}
        assert line[leg]["n"] == TBENCH.ROUNDS and line[leg]["value"] > 0
    for leg in legs[1:]:
        assert line[f"ratio_{leg}_vs_dense"]["value"] > 0
    assert line["value"] == line["splash_window"]["value"]
    assert "B=1 S=256 Hq=2 Hkv=1 Dh=128" in line["metric"]
    assert "{}x{} tiles".format(*TFA.FWD_TILES) in line["metric"]
    spec = TM.MaskSpec(causal=True, window=64)
    st = TM.block_mask(spec, 256, *TFA.FWD_TILES).stats()
    assert line["masks"]["splash_window"]["block_skip_fraction"] \
        == st["block_skip_fraction"]
    assert line["masks"]["splash_window"]["attention_mask"] == spec.label()
    assert line["masks"]["splash_causal"]["expected_speedup"] == 1.0
    assert line["masks"]["splash_segment"]["attention_mask"] \
        == "causal&seg(avg=96,seed=0)"
    assert line["tflops_dense"] >= 0


def test_flagship_cfg_matches_graft_entry():
    import __graft_entry__ as graft
    from dlnetbench_tpu_torch import entry
    want, got = graft._flagship_cfg(), entry.flagship_cfg()
    for field in ("vocab_size", "embed_dim", "num_heads", "num_kv_heads",
                  "ff_dim", "num_layers", "seq_len", "dtype",
                  "logits_f32"):
        assert getattr(got, field) == getattr(want, field), field


def test_cuda_default_without_a_card_is_an_error(monkeypatch, capsys):
    from dlnetbench_tpu_torch import cli, entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        TBENCH.main([])
    assert exc.value.code == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["train"])
    with pytest.raises(RuntimeError, match="is_available"):
        entry.entry()


TINY_BENCH_ENV = {"DLNB_BENCH_SEQ": "128", "DLNB_BENCH_LAYERS": "2",
                  "DLNB_BENCH_VOCAB": "256", "DLNB_BENCH_EMBED": "256",
                  "DLNB_BENCH_FF": "512", "DLNB_BENCH_HEADS": "2",
                  "DLNB_BENCH_KV_HEADS": "1", "DLNB_BENCH_K": "2",
                  "DLNB_BENCH_LC_SEQ": "256", "DLNB_BENCH_LC_HEADS": "2"}
HEADLINE_KEYS = {"metric", "value", "best", "band", "n", "vs_baseline",
                 "vs_baseline_causal", "vs_baseline_bwd_aware",
                 "vs_baseline_decoder_only", "tflops_achieved",
                 "tflops_executed", "loss", "logits_dtype"}


AUX_KEYS = ("fp8_mlp", "fp8_swiglu", "int8_matmul", "int8_fused_ab",
            "fp8_fused_ab", "tuned_ab", "checkpoint_ab", "serving_decode",
            "kv_density_ab", "sampling_ab", "longcontext_ab", "moe_ab",
            "int8_step", "int8_switchback_step", "recommended_step")
# a bench process alone is one rank: straggler_ab and spmd_overlap_ab
# print their skip notes
SKIPPED = ["straggler A/B", "spmd overlap A/B"]


@pytest.mark.parametrize("argv", [
    ["-m", "dlnetbench_tpu_torch.bench", "--platform", "cpu"],
    ["-m", "dlnetbench_tpu_torch.cli", "train", "--platform", "cpu"],
    ["-m", "dlnetbench_tpu_torch.bench", "--platform", "cpu",
     "--skip-aux"]])
def test_bench_entry_prints_the_headline_line_on_cpu(argv):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(REPO), "HOME": str(Path.home()),
           "OMP_NUM_THREADS": "2", **TINY_BENCH_ENV}
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(t) for t in proc.stdout.strip().splitlines()]
    line = lines[-1]
    assert HEADLINE_KEYS <= set(line)
    # the MLP recipes' aux lines come first, in order, and ride inside
    # the headline under the JAX bench's keys; --skip-aux prints the
    # headline alone
    if "--skip-aux" in argv:
        assert len(lines) == 1
        assert line["recommended_step"]["recipe"] == "bf16"
    else:
        assert [ln["metric"] for ln in lines[:-1]
                if "skipped" not in ln] == [
            line[k]["metric"] for k in AUX_KEYS]
        assert [ln["metric"] for ln in lines[:-1]
                if "skipped" in ln] == SKIPPED
        for key in ("int8_fused_ab", "fp8_fused_ab"):
            assert {"composed", "fused", "fused_delayed"} <= set(line[key])
        assert {"tuned_ms", "frozen_ms", "ratio_tuned_vs_frozen",
                "band_disjoint_win", "db_prior_hit", "configs",
                "search"} <= set(line["tuned_ab"])
        assert "[ephemeral]" in line["tuned_ab"]["metric"]
        assert {"dense_ms", "moe_ms", "moe_grouped_ms",
                "ratio_moe_grouped_vs_dense"} <= set(line["moe_ab"])
        assert {"dense", "splash_causal", "splash_window",
                "splash_segment", "ratio_splash_window_vs_dense",
                "speedup_vs_sparsity", "masks", "band_disjoint_win",
                "tflops_dense"} <= set(line["longcontext_ab"])
        assert abs(line["int8_step"]["loss"] - line["loss"]) \
            <= 0.02 * line["loss"]
        # the serving lines (the JAX bench's tiny engines)
        assert line["serving_decode"]["token_parity"] is True
        assert line["sampling_ab"]["token_identity"] is True
        assert all(line["kv_density_ab"]["variants"][dt]["parity_ok"]
                   for dt in ("int8", "fp8"))
    assert line["n"] == 3 and line["value"] > 0
    assert line["vs_baseline"] is None       # no preset prices the CPU
    assert "B=2 S=128" in line["metric"] and "cpu" in line["metric"]
    # unit-variance logits: loss near ln V (+ ~0.5)
    assert abs(line["loss"] - np.log(256)) < 1.5
    assert line["logits_dtype"] == "bfloat16"
