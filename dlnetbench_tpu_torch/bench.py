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
shape, K=8: the fused variants run kernel K11), ``int8_step`` and
``int8_switchback_step`` (the headline step with ``mlp_dtype="int8"``,
priced by the split-peak roofline), and ``recommended_step`` (the
fastest of bf16, int8_master and int8_switchback whose loss is within
2 % of bf16's).  ``--skip-aux`` prints the headline alone.  An
auxiliary line that fails fails the run: nothing degrades to a skip
marker.
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
