"""The headline train-step benchmark of the torch package (the headline
path of the JAX package's root ``bench.py``):

    python -m dlnetbench_tpu_torch.bench [--platform cuda|cpu] [--skip-aux]

Builds the bench step (``models/bench_step.py``: llama3_8b width, 4
layers, vocab 32768, B=2, S=6144, bf16, SGD), runs one warm call, then
3 rounds of K=10 chained steps (``DLNB_BENCH_K``), each fenced with
``torch.cuda.synchronize()``, and prints one JSON line last with the
JAX package's headline keys: ``value`` is the median ms per step over
the rounds, ``best``/``band``/``n`` their spread, and the ``vs_*``
ratios the roofline time of the step's credited work over the measured
time, priced with the card's preset (``core/hardware.py``) by the same
formulas (``core/roofline.py``).  On the CPU (``--platform cpu``, for
tests at tiny ``DLNB_BENCH_*`` shapes) there is no preset and every
``vs_*`` key is null.  ``cuda`` (the default) without a card is an
error.

Before the headline it prints the JAX ``bench.py``'s auxiliary lines of
the MLP recipes, which also ride inside the headline under the same
keys: ``int8_fused_ab`` and ``fp8_fused_ab`` (paired interleaved rounds
of composed / fused / fused_delayed up-projection chains at the bench
shape, K=8: the fused variants run kernel K11), ``moe_ab`` (paired
rounds of three 2-layer train-step chains at matched active FFN
parameters — a dense FFN of ff = top_k * f_e, the capacity-dispatch MoE
with batched library products, and the same MoE through the grouped
kernel K12 — with the layer-0 router stats as record globals; shapes
from ``DLNB_BENCH_MOE_{EXPERTS,TOPK,FF,LAYERS,SEQ,K}``, default 8
experts, top-2, f_e = ff / 2, 2 layers, S = min(S, 2048), K = 4),
``longcontext_ab`` (printed before ``moe_ab``, as the JAX bench does:
paired rounds of K=4 chained attention forwards at B=1, S=64k, Hq=8,
Hkv=2, Dh=128 — the causal flash kernel K3 against the splash kernel K6
under the plain-causal, window(S/16) and segment(avg=S/8) masks, with
each mask's block accounting at K6's own tiles; shapes from
``DLNB_BENCH_LC_{SEQ,HEADS,KV_HEADS,WINDOW,SEG,K}``), ``int8_step`` and ``int8_switchback_step`` (the headline step with
``mlp_dtype="int8"``, priced by the split-peak roofline), and
``recommended_step`` (the fastest of bf16, int8_master and
int8_switchback whose loss is within 2 % of bf16's).  ``--skip-aux``
prints the headline alone.  An auxiliary line that fails fails the run:
nothing degrades to a skip marker.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from dlnetbench_tpu_torch.ops.common import PLATFORMS

ROUNDS = 3
AB_K = 8          # chain depth of the fused A/B lines (the JAX bench's)
STEP_K = 10       # chained steps of the int8 step lines (the JAX bench's)
# numerics bar of the recommended-step recipe: single-step loss within
# this relative band of the bf16 headline's (the JAX bench's)
REC_NUMERICS_BAR_REL = 0.02


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="dlnetbench_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default="cuda", choices=list(PLATFORMS),
                   help="cuda (default; an error without a card) or cpu")
    p.add_argument("--skip-aux", "--skip_aux", dest="skip_aux",
                   action="store_true",
                   help="measure only the headline train step (aux lines "
                        "print nothing)")
    return p, p.parse_args(argv)


def band_ms(summary_s: dict) -> dict:
    """best/band/n of a seconds-summary, in ms."""
    return {"best": round(summary_s["best"] * 1e3, 3),
            "band": [round(v * 1e3, 3) for v in summary_s["band"]],
            "n": summary_s["n"]}


def time_steps(train_k, carry, tokens, k: int, device):
    """``(summary_s, loss)`` of a ``make_train_k`` chain: one warm call,
    then ``ROUNDS`` timed calls of k chained steps; the summary is in
    seconds a step, the loss the last step's of the last call."""
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.utils.timing import fence, time_callable
    last = {}

    def step():
        last["losses"] = train_k(carry, tokens)[1]

    step()                                  # warm call
    fence(device)
    samples = time_callable(step, reps=ROUNDS, device=device)
    return (stats.summarize([t / k for t in samples]),
            float(last["losses"][-1]))


def roofline_s(flops: int, nbytes: int, hw, dtype_key: str) -> float:
    """min(peak, AI*BW) time of a measured kernel or chain."""
    ai = flops / max(nbytes, 1)
    return flops / min(hw.peak(dtype_key), ai * hw.hbm_bandwidth)


def flag_above_peak(line: dict) -> dict:
    """A reading above the card's peak cannot be a device time: flag the
    time as a lower bound and the rate as an upper bound."""
    if (line.get("vs_baseline") or 0) > 1.0:
        line["note"] = ("above-peak reading: the time is a lower bound and "
                        "the rate an upper bound")
    return line


def measure_paired(progs: dict, k: int, device, rounds: int = ROUNDS):
    """The pairing protocol: within each round every variant runs back
    to back, so per-round ratios between variants cancel slow drift.
    Returns per-variant summaries (s per iteration) and the raw
    per-round samples."""
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.utils.timing import time_callable
    times: dict[str, list[float]] = {name: [] for name in progs}
    for _ in range(rounds):
        for name, prog in progs.items():
            times[name].append(time_callable(prog, reps=1,
                                             device=device)[0] / k)
    return {n: stats.summarize(ts) for n, ts in times.items()}, times


def ab_line(metric: str, summaries_s: dict, round_times_s: dict,
            flops_per_iter: int, roofline_time_s: float | None) -> dict:
    """One paired fused-vs-composed A/B line: ``value`` is the fused
    median; each variant carries its own ``{value, best, band, n}`` in
    ms, and each non-composed variant a paired per-round ratio band vs
    composed (< 1.0 = faster).  ``vs_baseline`` is null without a
    roofline (the CPU)."""
    from dlnetbench_tpu_torch.metrics import stats
    fused = summaries_s["fused"]
    line = {
        "metric": metric,
        "value": round(fused["value"] * 1e3, 3),
        "unit": "ms",
        **band_ms(fused),
        "vs_baseline": (None if roofline_time_s is None
                        else round(roofline_time_s / fused["value"], 4)),
        "tflops_fused": round(flops_per_iter / fused["value"] / 1e12, 2),
        "tflops_composed": round(
            flops_per_iter / summaries_s["composed"]["value"] / 1e12, 2),
    }
    for name, s in summaries_s.items():
        line[name] = {"value": round(s["value"] * 1e3, 3), **band_ms(s)}
    comp_rounds = round_times_s["composed"]
    for name in summaries_s:
        if name == "composed":
            continue
        ratios = [t / c for t, c in zip(round_times_s[name], comp_rounds)]
        line[f"ratio_{name}_vs_composed"] = stats.summarize(ratios,
                                                            ndigits=4)
    return stats.flag_low_mode(flag_above_peak(line))


def recommended_step(bf16_summary_s: dict, bf16_loss: float,
                     candidates: dict) -> dict:
    """Among the step recipes this run measured (the bf16 headline and
    the int8 lines), the fastest whose single-step loss is within
    ``REC_NUMERICS_BAR_REL`` of bf16's; candidates that were not run
    (None) do not compete, and bf16 always does."""
    entries = {"bf16": {"value": round(bf16_summary_s["value"] * 1e3, 3),
                        **band_ms(bf16_summary_s),
                        "loss": round(bf16_loss, 4), "passes": True}}
    for name, ln in candidates.items():
        if not ln or "value" not in ln or "loss" not in ln:
            continue
        passes = (abs(ln["loss"] - bf16_loss)
                  <= REC_NUMERICS_BAR_REL * abs(bf16_loss))
        entries[name] = {"value": ln["value"], "best": ln.get("best"),
                         "band": ln.get("band"), "n": ln.get("n"),
                         "loss": ln["loss"], "passes": passes}
    winner = min((nm for nm, e in entries.items() if e["passes"]),
                 key=lambda nm: entries[nm]["value"])
    e = entries[winner]
    return {
        "metric": "recommended_step",
        "recipe": winner,
        "value": e["value"],
        "unit": "ms",
        "best": e["best"],
        "band": e["band"],
        "n": e["n"],
        "numerics_bar": (f"single-step loss within "
                         f"{REC_NUMERICS_BAR_REL:.0%} of the bf16 "
                         f"headline's (convergence evidence: "
                         f"docs/studies/int8_step_r5)"),
        "candidates": entries,
    }


def bench_quant_fused_ab(card, hw_key, device_name: str, device,
                         fmt: str) -> dict:
    """Paired fused-vs-composed quantized-matmul A/B at the bench shape:
    three variants of the ``(T, D) @ (D, F)`` up projection chained
    ``AB_K`` deep — ``composed`` (amax, quantize into a materialized
    copy, the library product, then ``sx * sw``), ``fused`` (one amax
    reduction, then K11) and ``fused_delayed`` (K11 with the amax
    carried through the chain as state: no reduction before it).  The
    weight is quantized once per chain in every variant (the JAX
    package's XLA hoists it), so the A/B isolates the per-step
    activation quantization."""
    from dlnetbench_tpu_torch.core.hardware import (BYTES_PER_ELEMENT,
                                                    HARDWARE)
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.ops import fp8 as qf8
    from dlnetbench_tpu_torch.ops import int8 as q8
    from dlnetbench_tpu_torch.ops import quantized_matmul as qmm
    from dlnetbench_tpu_torch.utils.timing import fence
    peak_key = "int8" if fmt == "int8" else "float8"
    label = f"{'int8' if fmt == 'int8' else 'fp8'} fused-quant A/B"
    product = q8.int8_product if fmt == "int8" else qf8.e4m3_product
    tokens, d, f = bs.BATCH * bs.SEQ, card.embed_dim, card.ff_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    x = torch.randn(tokens, d, generator=gen,
                    device=device).to(torch.bfloat16)
    gen.manual_seed(12)
    w = (torch.randn(d, f, generator=gen, device=device)
         * 0.02).to(torch.bfloat16)
    wq, sw = qmm.quantize_tensor(w, fmt)
    wq = qmm.k_major(wq).t()        # column-major: no copy per call

    def composed(xc):
        xq, sx = qmm.quantize_tensor(xc, fmt)
        return (product(xq, wq) * (sx * sw)).to(xc.dtype)

    def fused(xc):
        sx = qmm.scale_from_amax(qmm.amax_of(xc), fmt)
        return qmm.fused_matmul(xc, wq, sw, sx, fmt=fmt)

    def chain_of(dot):
        def run():
            xc = x
            for _ in range(AB_K):
                # feed a slice back so each product depends on the last
                xc = (xc + dot(xc)[:, :d] * 1e-6).to(xc.dtype)
            return xc
        return run

    def delayed_run():
        xc, am = x, qmm.amax_of(x)
        for _ in range(AB_K):
            y, am = qmm.fused_matmul(xc, wq, sw,
                                     qmm.scale_from_amax(am, fmt), fmt=fmt,
                                     collect_amax=True)
            xc = (xc + y[:, :d] * 1e-6).to(xc.dtype)
        return xc, am

    progs = {"composed": chain_of(composed), "fused": chain_of(fused),
             "fused_delayed": delayed_run}
    for prog in progs.values():
        prog()                                   # warm
    fence(device)
    summaries, round_times = measure_paired(progs, AB_K, device)
    flops = 2 * tokens * d * f
    # fused-path traffic: x read once in bf16, the quantized weight read,
    # the bf16 output written
    nbytes = int(BYTES_PER_ELEMENT["bfloat16"] * (tokens * d + tokens * f)
                 + BYTES_PER_ELEMENT[peak_key] * d * f)
    hw = HARDWARE[hw_key] if hw_key else None
    where = (f"{hw_key}, {peak_key} peak {hw.peak(peak_key) / 1e12:.0f} T/s"
             if hw else "no preset")
    line = ab_line(
        f"{label}: fused-quantization Hopper matmul K11 (shared-memory "
        f"prologue quantize + in-register sa*sb epilogue; fused_delayed "
        f"carries amax as chain state) vs composed recipe (library "
        f"product), paired interleaved rounds, {tokens} tok D={d} F={f}, "
        f"{device_name} ({where})",
        summaries, round_times, flops,
        roofline_s(flops, nbytes, hw, peak_key) if hw else None)
    print(json.dumps(line), flush=True)
    return line


def moe_ab_line(summaries_s: dict, round_times_s: dict, *, metric: str,
                moe_info: dict, active_params: dict) -> dict:
    """The dense-FFN-vs-MoE A/B line (the JAX ``bench.py``'s
    ``_moe_ab_line``): ``value`` is the sparse MoE's median ms; each
    variant carries its ``{value, best, band, n}`` in ms, each MoE
    variant a paired per-round ratio band vs dense (at matched active
    params the ratio is the price of routing, dispatch and combine), and
    ``moe_info`` the routing knobs and the measured router stats."""
    from dlnetbench_tpu_torch.metrics import stats
    mo = summaries_s["moe"]
    dense_rounds = round_times_s["dense"]
    line = {
        "metric": metric,
        "value": round(mo["value"] * 1e3, 3),
        "unit": "ms",
        **band_ms(mo),
    }
    for name, s in summaries_s.items():
        line[f"{name}_ms"] = {"value": round(s["value"] * 1e3, 3),
                              **band_ms(s)}
    for name in summaries_s:
        if name == "dense":
            continue
        ratios = [t / d for t, d in zip(round_times_s[name], dense_rounds)
                  if d > 0]
        line[f"ratio_{name}_vs_dense"] = stats.summarize(ratios, ndigits=4)
    line["band_disjoint"] = (
        stats.bands_overlap(mo["band"], summaries_s["dense"]["band"])
        is False)
    line["active_params"] = active_params
    line.update(moe_info)
    return stats.flag_low_mode(line)


def moe_ab_shape(card) -> dict:
    """The ``moe_ab`` chains' shape knobs (``DLNB_BENCH_MOE_*``)."""
    from dlnetbench_tpu_torch.models import bench_step as bs
    top_k = bs.env_int("DLNB_BENCH_MOE_TOPK", 2)
    return {"experts": bs.env_int("DLNB_BENCH_MOE_EXPERTS", 8),
            "top_k": top_k,
            "f_e": (bs.env_int("DLNB_BENCH_MOE_FF", 0)
                    or max(128, card.ff_dim // top_k)),
            "layers": bs.env_int("DLNB_BENCH_MOE_LAYERS", 2),
            "seq": bs.env_int("DLNB_BENCH_MOE_SEQ", min(bs.SEQ, 2048)),
            "k": bs.env_int("DLNB_BENCH_MOE_K", 4),
            "capacity_factor": 1.25}


def router_probe(params: dict, tokens, cfg) -> dict:
    """The measured layer-0 routing of a MoE model over a token batch
    ``[B, S]`` as record globals (``moe.stats_globals``): the tokens'
    embeddings, RMS-normalized by layer 0's MLP norm, through layer 0's
    router — a cheap probe that skips the attention before it."""
    from dlnetbench_tpu_torch.models import layers as L
    from dlnetbench_tpu_torch.models import moe as moe_mod
    with torch.no_grad():
        lp = params["layers"]
        y = L.rmsnorm(params["embed"][tokens.reshape(-1)], lp["norm2"][0])
        stats = moe_mod.dispatch(y, lp["w_router"][0], cfg.num_experts,
                                 cfg.top_k, cfg.moe_capacity_factor,
                                 with_stats=True)[3]
    return moe_mod.stats_globals(
        stats, num_experts=cfg.num_experts, top_k=cfg.top_k,
        capacity_factor=cfg.moe_capacity_factor, drop_seed=None,
        group_tokens=0)


def bench_moe_ab(card, hw_key, device_name: str, device) -> dict:
    """Dense FFN vs MoE at matched active params: three train-step
    chains under the pairing protocol — a dense model with ``ff = top_k *
    f_e``, the capacity-dispatch MoE (``moe_impl="sparse"``) with E
    experts of width ``f_e`` (the same per-token FFN parameters, so the
    paired ratio prices routing, dispatch and combine, not model size),
    and the same MoE through the grouped kernel K12
    (``moe_impl="grouped"``).  The router stats are the layer-0 routing
    of the benched MoE over the benched tokens' normalized embeddings."""
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.models import transformer as tfm
    from dlnetbench_tpu_torch.utils.timing import fence
    sh = moe_ab_shape(card)
    e, top_k, f_e, cf = (sh["experts"], sh["top_k"], sh["f_e"],
                         sh["capacity_factor"])
    layers, seq, k = sh["layers"], sh["seq"], sh["k"]
    base = dict(vocab_size=bs.VOCAB, embed_dim=card.embed_dim,
                num_heads=card.num_heads, num_kv_heads=card.num_kv_heads,
                num_layers=layers, seq_len=seq, logits_f32=False)
    cfgs = {
        "dense": tfm.TransformerConfig(ff_dim=top_k * f_e, **base),
        "moe": tfm.TransformerConfig(
            ff_dim=f_e, num_experts=e, top_k=top_k, moe_impl="sparse",
            moe_capacity_factor=cf, **base),
        "moe_grouped": tfm.TransformerConfig(
            ff_dim=f_e, num_experts=e, top_k=top_k, moe_impl="grouped",
            moe_capacity_factor=cf, **base),
    }
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, bs.VOCAB, (bs.BATCH, seq + 1), generator=gen,
                           device=device)
    progs = {}
    for name, cfg in cfgs.items():
        params = tfm.init_params(cfg, seed=0, device=device)
        train_k = bs.make_train_k(cfg, k)

        def prog(p=params, f=train_k):
            return f(p, tokens)
        prog()                                   # warm
        progs[name] = prog
    fence(device)
    summaries, round_times = measure_paired(progs, k, device)
    del progs

    # the benched MoE's weights as they were before the chains trained
    moe_info = router_probe(
        tfm.init_params(cfgs["moe"], seed=0, device=device),
        tokens[:, :-1], cfgs["moe"])
    d = card.embed_dim
    active = {"dense_ffn_params": 3 * d * top_k * f_e,
              "moe_active_ffn_params": 3 * d * top_k * f_e,
              "moe_total_ffn_params": 3 * d * e * f_e,
              "router_params": d * e}
    line = moe_ab_line(
        summaries, round_times,
        metric=f"moe A/B: dense FFN (ff={top_k * f_e}) vs {e}-expert "
               f"top-{top_k} MoE (f_e={f_e}, cf={cf}; matched active "
               f"params; sparse dispatch vs grouped Hopper expert-FFN "
               f"kernel K12), {layers}L B={bs.BATCH} S={seq}, "
               f"{device_name} ({hw_key})",
        moe_info=moe_info, active_params=active)
    print(json.dumps(line), flush=True)
    return line


def longcontext_ab_line(summaries_s: dict, round_times_s: dict, *,
                        metric: str, mask_info: dict) -> dict:
    """The dense-vs-splash long-context A/B line (the JAX ``bench.py``'s
    ``_longcontext_line``): ``value`` is the window-masked splash median
    ms; every variant carries its ``{value, best, band, n}`` in ms, each
    masked variant a paired per-round ratio band vs dense, and
    ``speedup_vs_sparsity`` the measured speedup (from the paired ratio
    median) over the mask's block-accounting expectation (1.0 = the win
    is exactly the skipped work); ``mask_info`` carries each mask's
    label, sparsity and tile skip stats."""
    from dlnetbench_tpu_torch.metrics import stats
    win = summaries_s["splash_window"]
    dense_rounds = round_times_s["dense"]
    line = {
        "metric": metric,
        "value": round(win["value"] * 1e3, 3),
        "unit": "ms",
        **band_ms(win),
    }
    for name, s in summaries_s.items():
        line[name] = {"value": round(s["value"] * 1e3, 3), **band_ms(s)}
    speedup_vs_sparsity = {}
    for name, s in summaries_s.items():
        if name == "dense":
            continue
        ratios = [t / d for t, d in zip(round_times_s[name], dense_rounds)
                  if d > 0]
        ratio_band = stats.summarize(ratios, ndigits=4)
        line[f"ratio_{name}_vs_dense"] = ratio_band
        info = mask_info.get(name)
        if info and info.get("expected_speedup") and ratio_band["value"]:
            measured = 1.0 / ratio_band["value"]
            speedup_vs_sparsity[name] = round(
                measured / info["expected_speedup"], 4)
    line["speedup_vs_sparsity"] = speedup_vs_sparsity
    line["masks"] = mask_info
    # the window variant's win over dense with disjoint bands
    line["band_disjoint_win"] = bool(
        win["value"] < summaries_s["dense"]["value"]
        and stats.bands_overlap(win["band"],
                                summaries_s["dense"]["band"]) is False)
    return stats.flag_low_mode(line)


def longcontext_shape() -> dict:
    """The ``longcontext_ab`` chains' shape knobs
    (``DLNB_BENCH_LC_*``; the JAX bench's defaults)."""
    from dlnetbench_tpu_torch.models import bench_step as bs
    s = bs.env_int("DLNB_BENCH_LC_SEQ", 64 * 1024)
    hq = bs.env_int("DLNB_BENCH_LC_HEADS", 8)
    return {"seq": s, "heads": hq,
            "kv_heads": bs.env_int("DLNB_BENCH_LC_KV_HEADS",
                                   max(1, hq // 4)),
            "head_dim": 128,
            "window": bs.env_int("DLNB_BENCH_LC_WINDOW", max(1, s // 16)),
            "seg_avg": bs.env_int("DLNB_BENCH_LC_SEG", max(1, s // 8)),
            "k": bs.env_int("DLNB_BENCH_LC_K", 4)}


def longcontext_specs(sh: dict) -> dict:
    """The three splash legs' masks."""
    from dlnetbench_tpu_torch.ops.attention_mask import MaskSpec
    return {"splash_causal": MaskSpec(causal=True),
            "splash_window": MaskSpec(causal=True, window=sh["window"]),
            "splash_segment": MaskSpec(causal=True, seg_avg=sh["seg_avg"],
                                       seg_seed=0)}


def longcontext_operands(sh: dict, device):
    """Seeded q ``[1, S, Hq, Dh]``, k, v ``[1, S, Hkv, Dh]``: bf16 on the
    card, f32 on the CPU (as the JAX bench runs bf16 on the TPU only)."""
    dt = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    gen = torch.Generator(device=device)
    out = []
    for seed, h in ((20, sh["heads"]), (21, sh["kv_heads"]),
                    (22, sh["kv_heads"])):
        gen.manual_seed(seed)
        out.append(torch.randn(1, sh["seq"], h, sh["head_dim"],
                               generator=gen, device=device).to(dt))
    return out


def bench_longcontext_ab(card, hw_key, device_name: str, device) -> dict:
    """Dense-vs-splash long-context A/B: B=1 attention forwards at S=64k
    under the pairing protocol — per round every variant runs K chained
    calls back to back, so the per-round ratios cancel drift.  The dense
    leg is the causal flash kernel K3; the splash legs are K6 under the
    plain-causal, window and segment masks, visiting only the tiles
    their BlockMask leaves, so each leg's speedup should track its
    mask's tile skip fraction; the line reports the ratio.  ``card`` is
    unused (the shape is the line's own), as in the JAX bench."""
    del card
    from dlnetbench_tpu_torch.ops import attention_mask as amask
    from dlnetbench_tpu_torch.ops import flash_attention as fa
    from dlnetbench_tpu_torch.utils.timing import fence
    sh = longcontext_shape()
    s, hq, hkv, dh, k_chain = (sh["seq"], sh["heads"], sh["kv_heads"],
                               sh["head_dim"], sh["k"])
    q, k, v = longcontext_operands(sh, device)
    specs = longcontext_specs(sh)

    def chain_of(attn):
        def run():
            qc = q
            for _ in range(k_chain):
                # feed the output back so each call depends on the last
                qc = (qc + attn(qc) * 1e-6).to(qc.dtype)
            return qc
        return run

    progs = {"dense": chain_of(
        lambda qc: fa.flash_attention(qc, k, v, True))}
    for name, spec in specs.items():
        progs[name] = chain_of(
            lambda qc, _sp=spec: fa.splash_attention(qc, k, v, _sp))
    for prog in progs.values():
        prog()                                   # warm
    fence(device)
    summaries, round_times = measure_paired(progs, k_chain, device)

    # tile accounting at K6's own tiles: tiles visited under each mask
    # against the dense-causal tiles
    bq, bk = fa.FWD_TILES
    dense_stats = amask.block_mask(specs["splash_causal"], s, bq,
                                   bk).stats()
    dense_visited = dense_stats["blocks_total"] - dense_stats[
        "blocks_skipped"]
    mask_info = {}
    for name, spec in specs.items():
        st = amask.block_mask(spec, s, bq, bk).stats()
        visited = st["blocks_total"] - st["blocks_skipped"]
        mask_info[name] = {
            **amask.record_globals(spec, s),
            "block_skip_fraction": st["block_skip_fraction"],
            "expected_speedup": round(dense_visited / max(visited, 1), 4),
        }
    flops = 2 * s * s * hq * dh          # the causal forward's two products
    line = longcontext_ab_line(
        summaries, round_times,
        metric=f"longcontext A/B: dense causal flash K3 vs block-sparse "
               f"splash K6 (causal / window({sh['window']}) / segment(avg="
               f"{sh['seg_avg']}) masks; skipped tiles are neither loaded "
               f"nor multiplied; tile accounting at K6's {bq}x{bk} tiles; "
               f"paired interleaved rounds, forward only), B=1 S={s} "
               f"Hq={hq} Hkv={hkv} Dh={dh}, {device_name} ({hw_key})",
        mask_info=mask_info)
    line["tflops_dense"] = round(flops / summaries["dense"]["value"] / 1e12,
                                 2)
    print(json.dumps(line), flush=True)
    return line


def bench_int8_step(card, hw_key, device_name: str, device,
                    bf16_step_s: float,
                    int8_backward: str = "master") -> dict:
    """The headline step with ``mlp_dtype="int8"`` (composed: forward MLP
    products in int8, backward straight-through in bf16, or with
    ``int8_backward="switchback"`` the dx-side backward products in int8
    too), ``STEP_K`` chained steps a round.  ``vs_baseline`` divides by
    the split-peak roofline: the int8 products at the int8 peak, the
    rest of the step at the bf16 peak (the step's arithmetic intensity
    is thousands of FLOP a byte, so the compute-bound form is exact)."""
    from dlnetbench_tpu_torch.core import roofline
    from dlnetbench_tpu_torch.core.hardware import HARDWARE
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.models import bench_step as bs
    train_k, carry, tokens, _, _ = bs.build(
        STEP_K, device=device, mlp_dtype="int8",
        int8_backward=int8_backward)
    summary, loss = time_steps(train_k, carry, tokens, STEP_K, device)
    step_s = summary["value"]
    del carry, tokens
    lm_head_flops = 2 * bs.BATCH * bs.SEQ * card.embed_dim * bs.VOCAB
    total_flops = 3 * (roofline.model_flops(card, bs.BATCH) + lm_head_flops)
    int8_flops = roofline.mlp_flops(card, bs.BATCH)     # forward MLP
    if int8_backward == "switchback":
        int8_flops *= 2                 # + the dx-side backward products
        bwd_desc = ("dx-side bwd dots int8 too (SwitchBack recipe), dW "
                    "master bf16")
        delta_desc = "mlp_dtype + int8_backward the only deltas"
    else:
        bwd_desc = "bwd straight-through bf16"
        delta_desc = "mlp_dtype the only delta"
    vs = None
    if hw_key:
        hw = HARDWARE[hw_key]
        split_s = (int8_flops / hw.peak("int8")
                   + (total_flops - int8_flops) / hw.peak("bfloat16"))
        vs = round(split_s / step_s, 4)
    line = stats.flag_low_mode({
        "metric": f"int8-MLP train step (fwd MLP dots int8 via fused "
                  f"swiglu VJP, {bwd_desc}; headline config, "
                  f"{delta_desc}), {device_name} ({hw_key})",
        "value": round(step_s * 1e3, 3),
        "unit": "ms",
        **band_ms(summary),
        "speedup_vs_bf16": round(bf16_step_s / step_s, 4),
        "headline_bf16_ms": round(bf16_step_s * 1e3, 3),
        "vs_baseline": vs,
        "tflops_achieved": round(total_flops / step_s / 1e12, 2),
        "loss": round(loss, 4),
    })
    print(json.dumps(line), flush=True)
    return line


def headline(step_summary: dict, loss: float, card, cfg,
             device_name: str, hw_key: str | None) -> dict:
    """The headline line from a seconds-per-step summary: the JAX
    package's keys and formulas (3x the forward for fwd + bwd, the LM
    head credited, the causal half of the score products elided in
    ``vs_baseline_causal``, the step's pass-by-pass traffic in
    ``vs_baseline_bwd_aware``)."""
    from dlnetbench_tpu_torch.core import roofline
    from dlnetbench_tpu_torch.core.hardware import HARDWARE
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.models import bench_step as bs
    step_s = step_summary["value"]
    lm_head_flops = 2 * bs.BATCH * bs.SEQ * card.embed_dim * bs.VOCAB
    fwd_flops = roofline.model_flops(card, bs.BATCH) + lm_head_flops
    total_flops = 3 * fwd_flops
    achieved = total_flops / step_s
    causal_elided = (card.num_layers * 2 * bs.BATCH * bs.SEQ * bs.SEQ
                     * card.embed_dim)
    executed_ratio = (fwd_flops - causal_elided) / fwd_flops
    ratios = dict.fromkeys(("vs_baseline", "vs_baseline_causal",
                            "vs_baseline_bwd_aware",
                            "vs_baseline_decoder_only"))
    if hw_key is not None:
        hw = HARDWARE[hw_key]
        roofline_s = 3 * roofline.roofline_time_s(
            fwd_flops, roofline.model_bytes(card, bs.BATCH, "bfloat16"),
            hw, "bfloat16")
        roofline_dec_s = 3 * roofline.forward_time_s(card, bs.BATCH,
                                                     "bfloat16", hw_key)
        roofline_bwd_s = roofline.roofline_time_s(
            total_flops, roofline.train_step_bytes(card, bs.BATCH,
                                                   "bfloat16"),
            hw, "bfloat16")
        vs = roofline_s / step_s
        ratios = {
            "vs_baseline": round(vs, 4),
            "vs_baseline_causal": round(vs * executed_ratio, 4),
            "vs_baseline_bwd_aware": round(roofline_bwd_s / step_s, 4),
            "vs_baseline_decoder_only": round(roofline_dec_s / step_s, 4),
        }
    return stats.flag_low_mode({
        "metric": (f"llama3_8b-shaped {bs.LAYERS}L train step, "
                   f"B={bs.BATCH} S={bs.SEQ}, {device_name} ({hw_key})"),
        "value": round(step_s * 1e3, 3),
        "unit": "ms",
        **band_ms(step_summary),
        **ratios,
        "tflops_achieved": round(achieved / 1e12, 2),
        "tflops_executed": round(achieved * executed_ratio / 1e12, 2),
        "loss": round(loss, 4),
        "logits_dtype": "float32" if cfg.logits_f32 else "bfloat16",
    })


def main(argv=None) -> int:
    from dlnetbench_tpu_torch.core.hardware import hw_key_for_device_name
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.ops.common import resolve_device
    parser, args = _parse_args(argv)
    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        parser.error(str(e))
    if device.type == "cuda":
        device_name = torch.cuda.get_device_name(device)
        hw_key = hw_key_for_device_name(device_name)
    else:
        device_name, hw_key = "cpu", None
    k = bs.env_int("DLNB_BENCH_K", 10)
    train_k, params, tokens, card, cfg = bs.build(k, device=device)
    summary, loss = time_steps(train_k, params, tokens, k, device)
    # free the headline's weights and activations before the aux lines
    del train_k, params, tokens
    if device.type == "cuda":
        torch.cuda.empty_cache()
    aux = {}
    if not args.skip_aux:
        for key, fmt in (("int8_fused_ab", "int8"),
                         ("fp8_fused_ab", "float8")):
            aux[key] = bench_quant_fused_ab(card, hw_key, device_name,
                                            device, fmt)
        aux["longcontext_ab"] = bench_longcontext_ab(card, hw_key,
                                                     device_name, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        aux["moe_ab"] = bench_moe_ab(card, hw_key, device_name, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for key, mode in (("int8_step", "master"),
                          ("int8_switchback_step", "switchback")):
            aux[key] = bench_int8_step(card, hw_key, device_name, device,
                                       summary["value"], mode)
    recommended = recommended_step(
        summary, loss, {"int8_master": aux.get("int8_step"),
                        "int8_switchback": aux.get("int8_switchback_step")})
    if not args.skip_aux:
        print(json.dumps(recommended), flush=True)
    line = headline(summary, loss, card, cfg, device_name, hw_key)
    line.update(aux)
    line["recommended_step"] = recommended
    print(f"bench: {line['value']} ms/step (band {line['band']}), loss "
          f"{line['loss']}, vs_baseline {line['vs_baseline']} on "
          f"{device_name}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
