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
the serving tier's lines ``serving_decode`` (the classic 1-step
engine, the fused N=16 loop and N=16 with ngram speculation replaying
one seeded saturating plan in paired rounds: e2e p99, TTFT, TPOT and
tokens/s bands, the dispatch decomposition, the host-fraction drop and
``token_parity``), ``kv_density_ab`` (dense, int8 and fp8 paged KV at
equal pool bytes: admitted concurrency, tokens/s and the decode-parity
bars) and ``sampling_ab`` (seeded sampling at T=0.8, fused N=16 against
N=16 speculative sampling, and ``token_identity`` of the 1-step and
fused sampled streams) — tiny engines with the JAX lines' model, plan
and engine configurations, the decode attention pinned to the gather
math as the JAX lines pin it (``--live-metrics PATH`` streams the
1-step engine's windowed snapshots to PATH, as the JAX bench does);
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

On a card the headline, the fused A/B lines, ``longcontext_ab`` and the
int8 step lines carry an ``attribution`` block
(``analysis/attribution.attribute_kernel``: the measured time against
the line's own credited FLOPs and byte model on the card's preset; on
the CPU there is no preset and no block).  ``--check BASELINE`` runs the
regression sentinel (``sentinel.py``) against a baseline bench artifact:
the verdict rides the headline as ``sentinel``, and the run exits 3 on a
regression (median worse by more than ``--check-threshold`` percent with
disjoint bands) and 2 when the baseline has no comparable headline; the
measurement prints in full either way.
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
    p.add_argument("--check", default=None, metavar="BASELINE",
                   help="regression sentinel: compare this run's headline "
                        "and aux lines against a baseline bench artifact "
                        "(a capture with parsed/tail or a bench stdout "
                        "JSONL), write a 'sentinel' section into the "
                        "headline, exit 3 on a regression and 2 when the "
                        "baseline has no comparable headline")
    p.add_argument("--check-threshold", "--check_threshold",
                   dest="check_threshold", type=float, default=5.0,
                   help="percent slowdown that (with disjoint bands) "
                        "counts as a regression (default 5)")
    p.add_argument("--live-metrics", "--live_metrics",
                   dest="live_metrics", default=None, metavar="PATH",
                   help="the serving_decode line's 1-step engine streams "
                        "one windowed snapshot JSONL line per 0.5 s of "
                        "engine time to PATH (rolling TTFT/TPOT "
                        "percentiles, queue depth, KV occupancy — "
                        "serving/metrics.LiveMetricsWriter)")
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


def stamp_attr(line: dict, *, time_s: float, flops: float, nbytes: float,
               hw, dtype_key: str, peak_flops: float | None = None) -> dict:
    """Stamp the attribution block of a measured line (the JAX
    ``bench.py``'s ``_stamp_attr``); no block without a preset."""
    from dlnetbench_tpu_torch.analysis import attribution
    if hw is None:
        return line
    block = attribution.attribute_kernel(
        time_s, flops, nbytes, hw, dtype_key, peak_flops=peak_flops,
        source="model")
    if block is not None:
        line["attribution"] = block
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
    # attribution of the fused path (the line's value)
    line = stamp_attr(line, time_s=summaries["fused"]["value"], flops=flops,
                      nbytes=nbytes, hw=hw, dtype_key=peak_key)
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


# -- the serving tier's aux lines ------------------------------------

def serving_model():
    """The serving lines' model (the JAX bench's: embed 64, 4/2 heads,
    ff 128, 2 layers, vocab 256, f32)."""
    from dlnetbench_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab_size=256, embed_dim=64, num_heads=4,
                             num_kv_heads=2, ff_dim=128, num_layers=2,
                             seq_len=64, dtype="float32")


def serving_rounds_block(eng, completed, plan, wall: float, base,
                         admitted: bool = False) -> dict:
    """One round's ``serving`` block, as the JAX bench assembles it."""
    from dlnetbench_tpu_torch.serving import metrics as smetrics
    return smetrics.serving_block(
        completed, plan, slo_ttft_ms=base.slo_ttft_ms,
        slo_tpot_ms=base.slo_tpot_ms, wall_s=wall,
        engine_steps=eng.engine_steps, cache_stats=eng.cache.stats(),
        queue_depth_max=eng.queue_depth_max,
        batch_occupancy_mean=eng.batch_occupancy_mean(),
        decode_loop=eng.decode_loop_block(),
        **({"admitted_peak": eng.concurrent_peak} if admitted else {}))


def serving_variant_block(base_rounds: list[dict],
                          rounds: list[dict]) -> dict:
    """Per-variant A/B sub-object of the serving_decode line (the JAX
    ``_serving_variant_block``): serving figures with bands, the
    dispatch decomposition and the paired per-round speedup over the
    1-step baseline."""
    from dlnetbench_tpu_torch.metrics import stats
    dl = [r.get("decode_loop") or {} for r in rounds]
    block = {
        "tokens_per_s": stats.summarize(
            [r["tokens_per_s"] for r in rounds], ndigits=2),
        "tpot_p50_ms": stats.summarize(
            [r["tpot_ms"]["p50"] for r in rounds], ndigits=3),
        "e2e_p99_ms": stats.summarize(
            [r["e2e_ms"]["p99"] for r in rounds], ndigits=3),
        "speedup_tokens_per_s": stats.summarize(
            [r["tokens_per_s"] / b["tokens_per_s"]
             for b, r in zip(base_rounds, rounds)
             if b["tokens_per_s"] > 0], ndigits=3),
        "steps_per_dispatch": stats.summarize(
            [d.get("steps_per_dispatch", 0.0) for d in dl], ndigits=3),
        "tokens_per_sync": stats.summarize(
            [d.get("tokens_per_sync", 0.0) for d in dl], ndigits=3),
        "multi_step_n": (dl[0] or {}).get("multi_step_n"),
    }
    spec = (dl[0] or {}).get("spec")
    if isinstance(spec, dict):
        block["spec"] = {
            "k": spec.get("k"), "drafter": spec.get("drafter"),
            "acceptance_rate": stats.summarize(
                [(d.get("spec") or {}).get("acceptance_rate", 0.0)
                 for d in dl], ndigits=4),
        }
    return block


def serving_host_frac_ab(base_rounds: list[dict],
                         multi_rounds: list[dict],
                         spec_rounds: list[dict] | None) -> dict | None:
    """The host-fraction A/B of the serving_decode line (the JAX
    ``_serving_host_frac_ab``): per-round host fractions with the
    per-dispatch floor solved from the paired 1-step and N-step rounds
    (``analysis.attribution.dispatch_decomposition``) folded in, banded
    per variant, and whether the 1-step -> N-step drop is band-disjoint."""
    from dlnetbench_tpu_torch.analysis import attribution as A
    from dlnetbench_tpu_torch.metrics import stats
    floors: list[float] = []
    fracs: dict[str, list[float]] = {}
    variants = {"one_step": base_rounds, "multi_step": multi_rounds}
    if spec_rounds:
        variants["speculative"] = spec_rounds
    for i, (b, m) in enumerate(zip(base_rounds, multi_rounds)):
        dec = A.dispatch_decomposition(b.get("decode_loop") or {},
                                       m.get("decode_loop") or {})
        if dec is None:
            return None
        floors.append(dec["dispatch_us"])
        for name, rnds in variants.items():
            r = rnds[i]
            host = A.serving_host_us(r.get("decode_loop") or {},
                                     dec["dispatch_us"])
            fracs.setdefault(name, []).append(
                host / (r["wall_s"] * 1e6))
    one = stats.summarize(fracs["one_step"], ndigits=4)
    multi = stats.summarize(fracs["multi_step"], ndigits=4)
    disjoint = (stats.bands_overlap(one["band"], multi["band"])
                is False and multi["value"] < one["value"])
    out = {
        "dispatch_us": stats.summarize(floors, ndigits=1),
        "one_step_host_frac": one,
        "multi_step_host_frac": multi,
        "band_disjoint_drop": disjoint,
        "verdict": ("host fraction dropped, bands disjoint — the "
                    "fused loop amortizes the measured per-dispatch "
                    "floor" if disjoint else
                    "host-fraction bands overlap — no flip at this "
                    "scale/noise"),
    }
    if spec_rounds:
        out["speculative_host_frac"] = stats.summarize(
            fracs["speculative"], ndigits=4)
    return out


def serving_decode_line(rounds: list[dict], suffix: str = "", *,
                        multi_rounds: list[dict] | None = None,
                        spec_rounds: list[dict] | None = None,
                        token_parity: bool | None = None) -> dict:
    """The serving_decode aux line from per-round ``serving`` blocks (the
    JAX ``_serving_decode_line``): ``value`` is the 1-step engine's
    round-median e2e p99 in ms, TTFT/TPOT/p99 each with their band; with
    ``multi_rounds``/``spec_rounds`` the paired A/B, the host-fraction
    drop and the token-parity lock."""
    from dlnetbench_tpu_torch.metrics import stats
    p99 = [r["e2e_ms"]["p99"] for r in rounds]
    summary = stats.summarize(p99, ndigits=3)
    line = {
        "metric": f"serving_decode: paged-KV continuous-batching "
                  f"decode, e2e p99 under a seeded open-loop poisson "
                  f"plan (serving/){suffix}",
        "value": summary["value"],
        "unit": "ms",
        "best": summary["best"],
        "band": summary["band"],
        "n": summary["n"],
        "ttft_p50_ms": stats.summarize(
            [r["ttft_ms"]["p50"] for r in rounds], ndigits=3),
        "tpot_p50_ms": stats.summarize(
            [r["tpot_ms"]["p50"] for r in rounds], ndigits=3),
        "p99_ms": summary,
        "tokens_per_s": stats.summarize(
            [r["tokens_per_s"] for r in rounds], ndigits=2),
        "goodput_frac": stats.summarize(
            [r["goodput_frac"] for r in rounds], ndigits=4),
        "requests": rounds[0]["completed"],
        "offered_rps": rounds[0]["offered_rps"],
    }
    if multi_rounds:
        line["multi_step"] = serving_variant_block(rounds, multi_rounds)
        if spec_rounds:
            line["speculative"] = serving_variant_block(rounds,
                                                        spec_rounds)
        flip = serving_host_frac_ab(rounds, multi_rounds, spec_rounds)
        if flip is not None:
            line["attribution_flip"] = flip
        if token_parity is not None:
            line["token_parity"] = bool(token_parity)
    return stats.flag_low_mode(line)


def bench_serving_decode(device_name: str, device,
                         live_path: str | None = None) -> dict:
    """The serving A/B line (the JAX ``_bench_serving_decode``): the
    classic 1-step engine, the fused N=16 loop and the fused loop with
    ngram speculation over the same weights replay one seeded
    saturating plan, interleaved per round after a discarded warm round.
    ``attn_impl`` is pinned to the gather math on every device, as in
    the JAX line (whose verify pass is gather math).  ``live_path``
    attaches the live metrics stream to the 1-step engine only (three
    engines in one stream would interleave incomparable snapshots)."""
    import dataclasses

    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig)
    mc = serving_model()
    base = ServingConfig(slots=4, page_size=8, num_pages=48,
                         max_seq_len=40, slo_ttft_ms=250.0,
                         slo_tpot_ms=100.0, attn_impl="gather")
    n_fused = 16
    variants = {
        "one_step": base,
        "multi_step": dataclasses.replace(base, multi_step_n=n_fused),
        "speculative": dataclasses.replace(
            base, multi_step_n=n_fused, speculative=True, spec_k=4,
            drafter="ngram"),
    }
    plan = ArrivalPlan(kind="poisson", rate_rps=5000.0,
                       num_requests=8, seed=0, prompt_len=[8, 16],
                       output_len=[16, 24])
    params = init_params(mc, seed=0, device=device)
    requests = plan.sample()
    engines = {name: Engine(mc, cfg, params=params, device=device)
               for name, cfg in variants.items()}
    if live_path:
        from dlnetbench_tpu_torch.serving.metrics import LiveMetricsWriter
        engines["one_step"].live = LiveMetricsWriter(live_path)
    streams: dict[str, dict] = {}
    for eng in engines.values():
        eng.run(requests)   # warm round, discarded
    rounds: dict[str, list] = {name: [] for name in engines}
    for _ in range(ROUNDS):
        for name, eng in engines.items():
            completed, wall = eng.run(requests)
            streams[name] = dict(eng.token_streams)
            rounds[name].append(serving_rounds_block(
                eng, completed, plan, wall, base))
    parity = all(streams[name] == streams["one_step"]
                 for name in engines)
    line = serving_decode_line(
        rounds["one_step"],
        suffix=f", {len(requests)} req slots={base.slots} "
               f"page={base.page_size} vs fused N={n_fused} vs "
               f"N={n_fused}+spec, {device_name}",
        multi_rounds=rounds["multi_step"],
        spec_rounds=rounds["speculative"], token_parity=parity)
    print(json.dumps(line), flush=True)
    return line


def sampling_ab_line(sampled_rounds: list[dict], spec_rounds: list[dict],
                     suffix: str = "", *,
                     token_identity: bool | None = None) -> dict:
    """The sampling_ab aux line (the JAX ``_sampling_ab_line``): seeded
    sampling at T=0.8, the fused N-step engine against the same engine
    with speculative sampling (truncated drafter); ``value`` is the
    speculative arm's round-median e2e p99 in ms, both arms with bands,
    the speculative arm's acceptance band, whether its tokens/s band
    lies above the other's, and ``token_identity``: the classic 1-step
    sampled streams equal the fused N-step ones."""
    from dlnetbench_tpu_torch.metrics import stats

    def _bands(rounds: list[dict]) -> dict:
        return {
            "e2e_p99_ms": stats.summarize(
                [r["e2e_ms"]["p99"] for r in rounds], ndigits=3),
            "tpot_p50_ms": stats.summarize(
                [r["tpot_ms"]["p50"] for r in rounds], ndigits=3),
            "tokens_per_s": stats.summarize(
                [r["tokens_per_s"] for r in rounds], ndigits=2),
        }
    sampled, spec = _bands(sampled_rounds), _bands(spec_rounds)
    spec["acceptance_rate"] = stats.summarize(
        [((r.get("decode_loop") or {}).get("spec") or {})
         .get("acceptance_rate", 0.0) for r in spec_rounds],
        ndigits=4)
    tps_s, tps_p = sampled["tokens_per_s"], spec["tokens_per_s"]
    disjoint = (stats.bands_overlap(tps_s["band"], tps_p["band"])
                is False and tps_p["value"] > tps_s["value"])
    p99 = spec["e2e_p99_ms"]
    line = {
        "metric": f"sampling_ab: seeded sampling T=0.8 — fused decode "
                  f"vs lossless speculative sampling (rejection "
                  f"verify, truncated drafter), same seeded plan "
                  f"(serving/sampling){suffix}",
        "value": p99["value"],
        "unit": "ms",
        "best": p99["best"],
        "band": p99["band"],
        "n": p99["n"],
        "sampled": sampled,
        "spec_sampled": spec,
        "tokens_per_s_band_disjoint_gain": disjoint,
        "verdict": ("speculative sampling pushed sampled tokens/s "
                    "above the non-spec arm, bands disjoint — the "
                    "rejection verify kept the speedup sampling used "
                    "to forfeit" if disjoint else
                    "tokens/s bands overlap — no speculation gain "
                    "under sampling at this scale/noise"),
    }
    if token_identity is not None:
        line["token_identity"] = bool(token_identity)
    return stats.flag_low_mode(line)


def bench_sampling_ab(device_name: str, device) -> dict:
    """The sampling A/B (the JAX ``_bench_sampling_ab``): fused N=16
    seeded sampling against fused N=16 speculative sampling on the same
    weights, plan and draw keys, interleaved per round; a classic 1-step
    sampled engine runs alongside as the witness of the token identity.
    Gather attention on every device, as in the JAX line."""
    import dataclasses

    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig)
    mc = serving_model()
    base = ServingConfig(slots=4, page_size=8, num_pages=48,
                         max_seq_len=40, slo_ttft_ms=250.0,
                         slo_tpot_ms=100.0, attn_impl="gather",
                         temperature=0.8, top_p=0.95, sample_seed=7)
    n_fused = 16
    variants = {
        "sampled": dataclasses.replace(base, multi_step_n=n_fused),
        "spec_sampled": dataclasses.replace(
            base, multi_step_n=n_fused, speculative=True, spec_k=4,
            drafter="truncated", drafter_layers=1),
    }
    plan = ArrivalPlan(kind="poisson", rate_rps=5000.0,
                       num_requests=8, seed=0, prompt_len=[8, 16],
                       output_len=[16, 24])
    params = init_params(mc, seed=0, device=device)
    requests = plan.sample()
    engines = {name: Engine(mc, cfg, params=params, device=device)
               for name, cfg in variants.items()}
    one_step = Engine(mc, base, params=params, device=device)
    one_step.run(requests)          # the witness: one replay suffices
    one_step.run(requests)
    witness = dict(one_step.token_streams)
    for eng in engines.values():
        eng.run(requests)   # warm round, discarded
    rounds: dict[str, list] = {name: [] for name in engines}
    identity = True
    for _ in range(ROUNDS):
        for name, eng in engines.items():
            completed, wall = eng.run(requests)
            if name == "sampled":
                identity = identity and (dict(eng.token_streams)
                                         == witness)
            rounds[name].append(serving_rounds_block(
                eng, completed, plan, wall, base))
    line = sampling_ab_line(
        rounds["sampled"], rounds["spec_sampled"],
        suffix=f", {len(requests)} req slots={base.slots} "
               f"N={n_fused} spec_k=4 T={base.temperature} "
               f"top_p={base.top_p}, {device_name}",
        token_identity=identity)
    print(json.dumps(line), flush=True)
    return line


def kv_parity_err(cache_dtype: str, seed: int, device) -> float:
    """One seeded decode-parity probe (the JAX ``_kv_parity_err``): the
    same token stream written into a dense and a quantized page pool
    (the engine's own write path) and the max absolute error of the
    decode attention (the gather math) against the dense cache."""
    import numpy as np

    from dlnetbench_tpu_torch.serving import kv_cache as KV
    base = dict(num_layers=1, num_kv_heads=2, head_dim=16, num_pages=8,
                page_size=4, max_seqs=2, max_pages_per_seq=4)
    cc_q = KV.CacheConfig(**base, cache_dtype=cache_dtype)
    kd, vd = KV.device_buffers(KV.CacheConfig(**base), device)
    kq, vq, ks, vs = KV.device_buffers(cc_q, device)
    bt = torch.arange(8, dtype=torch.int32, device=device).reshape(2, 4)
    rng = np.random.RandomState(seed)
    fmt = cc_q.quant_fmt
    ok = torch.ones((2, 1), dtype=torch.bool, device=device)
    for t in range(10):
        knew = torch.from_numpy(rng.randn(2, 1, 2, 16).astype(
            np.float32)).to(device)
        vnew = torch.from_numpy(rng.randn(2, 1, 2, 16).astype(
            np.float32)).to(device)
        pos = torch.full((2,), t, dtype=torch.int32, device=device)
        pid = bt.long()[:, t // 4]
        kd[0][:, pid, t % 4, :] = knew[:, 0].transpose(0, 1)
        vd[0][:, pid, t % 4, :] = vnew[:, 0].transpose(0, 1)
        KV.quant_write_span(kq, ks, 0, knew, pos, ok, bt, fmt=fmt,
                            page_size=4, num_pages=8)
        KV.quant_write_span(vq, vs, 0, vnew, pos, ok, bt, fmt=fmt,
                            page_size=4, num_pages=8)
    q = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32)).to(
        device) * 16 ** -0.5
    lengths = torch.tensor([10, 9], dtype=torch.int32, device=device)
    ref = KV.paged_attention_decode(q, kd[0], vd[0], lengths, bt,
                                    impl="gather")
    got = KV.paged_attention_decode(q, kq[0], vq[0], lengths, bt,
                                    k_scale=ks[0], v_scale=vs[0],
                                    fmt=fmt, impl="gather")
    return float((got - ref).abs().max())


def kv_density_line(rounds: dict, parity: dict, pool_bytes: int,
                    suffix: str = "") -> dict:
    """The kv_density_ab aux line (the JAX ``_kv_density_line``):
    ``rounds`` maps cache dtype -> per-round ``serving`` blocks of
    engines sized to the same pool bytes, ``parity`` quant dtype ->
    per-round decode-parity max errors.  ``value`` is the dense
    engine's round-median e2e p99 ms; each variant carries admitted
    slots, tokens/s, e2e p99 and goodput bands, the quantized ones
    their capacity ratio to dense and their parity bar."""
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.serving.kv_cache import QUANT_DECODE_TOL
    base = rounds["bf16"]
    summary = stats.summarize([r["e2e_ms"]["p99"] for r in base],
                              ndigits=3)
    base_adm = [r["admitted_concurrency_peak"] for r in base]
    variants = {}
    for name, rnds in rounds.items():
        v = {
            "num_pages": rnds[0]["kv_cache"]["num_pages"],
            "pool_bytes": rnds[0]["kv_cache"]["pool_bytes"],
            "admitted_slots": stats.summarize(
                [r["admitted_concurrency_peak"] for r in rnds],
                ndigits=2),
            "tokens_per_s": stats.summarize(
                [r["tokens_per_s"] for r in rnds], ndigits=2),
            "e2e_p99_ms": stats.summarize(
                [r["e2e_ms"]["p99"] for r in rnds], ndigits=3),
            "goodput_frac": stats.summarize(
                [r["goodput_frac"] for r in rnds], ndigits=4),
            "goodput_rps": stats.summarize(
                [r["goodput_rps"] for r in rnds], ndigits=3),
        }
        if name != "bf16":
            v["capacity_x"] = stats.summarize(
                [r["admitted_concurrency_peak"] / b
                 for r, b in zip(rnds, base_adm) if b > 0], ndigits=3)
            errs = parity[name]
            tol = QUANT_DECODE_TOL[name]
            v["parity_max_err"] = stats.summarize(errs, ndigits=6)
            v["parity_tol"] = tol
            v["parity_ok"] = bool(max(errs) <= tol)
        variants[name] = v
    return stats.flag_low_mode({
        "metric": f"kv_density_ab: dense vs int8 vs fp8 paged-KV "
                  f"decode at equal pool bytes, admitted concurrency "
                  f"+ parity bars (serving/){suffix}",
        "value": summary["value"],
        "unit": "ms",
        "best": summary["best"],
        "band": summary["band"],
        "n": summary["n"],
        "pool_bytes_budget": pool_bytes,
        "variants": variants,
    })


def bench_kv_density(device_name: str, device) -> dict:
    """The density A/B (the JAX ``_bench_kv_density``): dense, int8 and
    fp8 paged-KV engines sized to the same pool bytes replay one seeded
    saturating plan, interleaved per round; slots exceed what any pool
    holds, so the pool caps admitted concurrency.  Gather attention, as
    in the JAX line."""
    import dataclasses

    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig)
    mc = serving_model()
    dense = ServingConfig(slots=24, page_size=8, num_pages=25,
                          max_seq_len=40, slo_ttft_ms=400.0,
                          slo_tpot_ms=150.0, attn_impl="gather")
    cc_args = dict(num_layers=mc.num_layers,
                   num_kv_heads=mc.num_kv_heads, head_dim=mc.head_dim,
                   page_size=dense.page_size, max_seqs=dense.slots,
                   max_pages_per_seq=dense.max_seq_len
                   // dense.page_size, dtype=mc.dtype)
    budget = KV.CacheConfig(**cc_args, num_pages=dense.num_pages,
                            cache_dtype="bf16").pool_bytes
    variants = {"bf16": dense}
    for cd in ("int8", "fp8"):
        pages = KV.pages_for_pool_bytes(
            budget, KV.CacheConfig(**cc_args, num_pages=1,
                                   cache_dtype=cd))
        variants[cd] = dataclasses.replace(dense, cache_dtype=cd,
                                           num_pages=pages)
    plan = ArrivalPlan(kind="poisson", rate_rps=5000.0,
                       num_requests=20, seed=0, prompt_len=[8, 16],
                       output_len=[12, 20])
    params = init_params(mc, seed=0, device=device)
    requests = plan.sample()
    engines = {name: Engine(mc, cfg, params=params, device=device)
               for name, cfg in variants.items()}
    for eng in engines.values():
        eng.run(requests)   # warm round, discarded
    rounds: dict[str, list] = {name: [] for name in engines}
    parity: dict[str, list] = {"int8": [], "fp8": []}
    for rnd in range(ROUNDS):
        for name, eng in engines.items():
            completed, wall = eng.run(requests)
            rounds[name].append(serving_rounds_block(
                eng, completed, plan, wall, dense, admitted=True))
        for cd in parity:
            parity[cd].append(kv_parity_err(cd, rnd, device))
    line = kv_density_line(
        rounds, parity, budget,
        suffix=f", {len(requests)} req slots={dense.slots} "
               f"page={dense.page_size}, {device_name}")
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
    # attribution of the window leg (the line's value): the dense FLOPs
    # scaled by the tiles the window visits, q, k, v and the output
    # read or written once
    from dlnetbench_tpu_torch.core.hardware import HARDWARE
    win_visited = 1.0 - mask_info["splash_window"]["block_skip_fraction"]
    line = stamp_attr(
        line, time_s=summaries["splash_window"]["value"],
        flops=flops * win_visited / max(
            1.0 - dense_stats["block_skip_fraction"], 1e-9),
        nbytes=q.element_size() * s * (2 * hq + 2 * hkv) * dh,
        hw=HARDWARE.get(hw_key), dtype_key="bfloat16")
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
    vs = split_s = None
    hw = HARDWARE[hw_key] if hw_key else None
    if hw is not None:
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
    # attribution against the split-peak roofline vs_baseline prices: the
    # effective peak is total_flops / split_s
    if hw is not None:
        line = stamp_attr(
            line, time_s=step_s, flops=total_flops,
            nbytes=roofline.train_step_bytes(card, bs.BATCH, "bfloat16"),
            hw=hw, dtype_key="bfloat16", peak_flops=total_flops / split_s)
    print(json.dumps(line), flush=True)
    return line


def headline(step_summary: dict, loss: float, card, cfg,
             device_name: str, hw_key: str | None) -> dict:
    """The headline line from a seconds-per-step summary: the JAX
    package's keys and formulas (3x the forward for fwd + bwd, the LM
    head credited, the causal half of the score products elided in
    ``vs_baseline_causal``, the step's pass-by-pass traffic in
    ``vs_baseline_bwd_aware``), with the attribution block of the step
    against those credited FLOPs and that traffic on the card's preset
    (none on the CPU)."""
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
    line = stats.flag_low_mode({
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
    return stamp_attr(
        line, time_s=step_s, flops=total_flops,
        nbytes=roofline.train_step_bytes(card, bs.BATCH, "bfloat16"),
        hw=HARDWARE.get(hw_key), dtype_key="bfloat16")


def sentinel_check(line: dict, baseline: str,
                   threshold_pct: float) -> int:
    """Judge ``line`` (the headline, its aux lines inside it) against the
    baseline artifact at ``baseline``: the verdict rides ``line`` as
    ``sentinel``; returns the exit code — 3 on a regression, 2 when the
    baseline has no comparable headline (a tripwire that silently
    disarms is worse than none), else 0."""
    from dlnetbench_tpu_torch import sentinel
    try:
        base_lines = sentinel.bench_lines(baseline)
    except (OSError, ValueError) as e:
        print(f"--check: cannot read baseline ({e})", file=sys.stderr)
        base_lines = {}
    rc = 0
    if not base_lines.get("headline"):
        print(f"--check: baseline {baseline} has no comparable headline — "
              f"sentinel cannot arm", file=sys.stderr)
        rc = 2
    cur_lines = {"headline": line,
                 **{k: v for k, v in line.items() if sentinel.is_ms_line(v)}}
    line["sentinel"] = sentinel.check(base_lines, cur_lines, threshold_pct,
                                      baseline_label=str(baseline))
    if line["sentinel"].get("verdict") == "regression":
        print(f"sentinel: REGRESSION vs {baseline}: "
              f"{', '.join(line['sentinel']['regressions'])}",
              file=sys.stderr)
        rc = sentinel.RC_REGRESSION
    return rc


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
        # the serving tier's lines (tiny engines; the JAX bench's order)
        aux["serving_decode"] = bench_serving_decode(
            device_name, device, args.live_metrics)
        aux["kv_density_ab"] = bench_kv_density(device_name, device)
        aux["sampling_ab"] = bench_sampling_ab(device_name, device)
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
    rc = 0
    if args.check:
        rc = sentinel_check(line, args.check, args.check_threshold)
    print(f"bench: {line['value']} ms/step (band {line['band']}), loss "
          f"{line['loss']}, vs_baseline {line['vs_baseline']} on "
          f"{device_name}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
