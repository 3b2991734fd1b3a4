"""The headline train-step benchmark of the torch package (the headline
path of the JAX package's root ``bench.py``):

    python -m dlnetbench_tpu_torch.bench [--platform cuda|cpu] [--skip-aux]
        [--trace-out PATH] [--fault PLAN] [--check BASELINE]

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

Before the headline it prints the JAX ``bench.py``'s auxiliary lines,
which also ride inside the headline under the same keys, in its order:
the 8-bit lines ``fp8_mlp`` (one square ``(T, D) @ (D, D)`` e4m3
product a step, K=10), ``fp8_swiglu`` (the ``swiglu_fp8`` path stage
by stage: 2 x the gate/up stage + the down stage, each K=8) and
``int8_matmul`` (``(T, D) @ (D, D)`` int8 -> int32, ``>> 8`` between
steps, K=40) — in JAX XLA dots, so here the composed recipes' library
products (``torch._scaled_mm`` with unit scales and the JAX epilogue,
``torch._int_mm``), never K11 — each priced against the card's own
8-bit peak; the MLP recipes' ``int8_fused_ab`` and ``fp8_fused_ab``
(paired interleaved rounds
of composed / fused / fused_delayed up-projection chains at the bench
shape, K=8: the fused variants run kernel K11); ``tuned_ab`` (the e4m3
fused SwiGLU chain on K11, K=4, frozen-default against DB-tuned cluster
sizes per projection: a seeded three-candidate search per projection
shape, committed to ``DLNB_TUNING_DB_DIR`` or an ephemeral DB, a record
already there measured and never overwritten, then paired interleaved
rounds; with ``DLNB_TUNING_DB_DIR`` set the headline stamps it as
``tuning_db_dir``); the fault lines
``straggler_ab`` (the tiny DP step clean and with a delay on rank 1,
interleaved: it needs a world of >= 2 ranks, so a bench process alone
prints the JAX bench's skip note) and ``checkpoint_ab`` (the tiny DP
step with a per-step snapshot save in stall and async mode against
none, the ``auto`` backend, interleaved: the fraction of the save cost
async moves off the timed path); ``moe_ab`` (paired
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
bars), ``sampling_ab`` (seeded sampling at T=0.8, fused N=16 against
N=16 speculative sampling, and ``token_identity`` of the 1-step and
fused sampled streams), ``disagg_ab`` (a world-2 monolithic engine
against a 1p+1d disaggregated pair, int8 pages on the migration wire,
``token_parity``) and ``fleet_ab`` (two-replica fleets under
round_robin, p2c and prefix_affinity, ``token_parity``; both on the
first two cards, absent below two as in the JAX bench) — tiny engines with the JAX lines' model, plan
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
``spmd_overlap_ab`` (last, as in the JAX bench: the SPMD step's
paired overlap-vs-baseline A/B, ``models/overlap_bench.py``; one rank
prints the JAX bench's skip note) and ``recommended_step`` (the
fastest of bf16, int8_master and int8_switchback whose loss is within
2 % of bf16's).  ``--skip-aux``
prints the headline alone.  An auxiliary line that fails fails the run:
nothing degrades to a skip marker (``straggler_ab``'s note says the line
cannot run on one rank, and a preset without an 8-bit peak skips that
line, as the JAX bench does).

``--fault PLAN`` injects the plan's delay and jitter events at the
headline's step boundaries inside its timed window (the warm call stays
clean); the headline stamps ``fault_plan`` and its verdict is
``faulted``; a plan with other kinds is refused (exit 2) with the JAX
bench's message.  ``--trace-out PATH`` writes the merged Chrome trace of
the run: the host spans (build, timed, profile, one ``aux`` span a
line), the device timeline of one more headline call under
``torch.profiler`` (K3-K5 among its kernels on a card), the headline's
attribution and, with ``DLNB_TELEMETRY=1``, the flight ring as counter
tracks; a failed capture leaves a note on stderr and the headline as
it was.

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
import contextlib
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
    p.add_argument("--trace-out", "--trace_out", dest="trace_out",
                   default=None, metavar="PATH",
                   help="write a merged host+device Chrome/Perfetto trace "
                        "of this bench run: the host spans (build, timed, "
                        "profile, one per aux line), the device timeline "
                        "of one profiled headline call and, with "
                        "DLNB_TELEMETRY=1, the flight ring as counter "
                        "tracks")
    p.add_argument("--fault", default=None, metavar="PLAN",
                   help="JSON fault plan (faults/plan.py schema) whose "
                        "delay/jitter events are injected at the "
                        "headline's step boundaries INSIDE the timed "
                        "window; the headline stamps the plan and its "
                        "attribution verdict becomes 'faulted'")
    return p, p.parse_args(argv)


def band_ms(summary_s: dict) -> dict:
    """best/band/n of a seconds-summary, in ms."""
    return {"best": round(summary_s["best"] * 1e3, 3),
            "band": [round(v * 1e3, 3) for v in summary_s["band"]],
            "n": summary_s["n"]}


def time_steps(train_k, carry, tokens, k: int, device, injector=None):
    """``(summary_s, loss)`` of a ``make_train_k`` chain: one warm call,
    then ``ROUNDS`` timed calls of k chained steps; the summary is in
    seconds a step, the loss the last step's of the last call.  An
    ``injector`` (``faults/inject.py``) applies k steps' faults before
    each timed call, inside its timed window; the warm call stays
    clean."""
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.utils.timing import fence, time_callable
    last = {}

    def step():
        last["losses"] = train_k(carry, tokens)[1]

    def timed_step():
        injector.before_chain(k)
        step()

    step()                                  # warm call
    fence(device)
    samples = time_callable(step if injector is None else timed_step,
                            reps=ROUNDS, device=device)
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
               hw, dtype_key: str, peak_flops: float | None = None,
               faulted: bool = False) -> dict:
    """Stamp the attribution block of a measured line (the JAX
    ``bench.py``'s ``_stamp_attr``); no block without a preset."""
    from dlnetbench_tpu_torch.analysis import attribution
    if hw is None:
        return line
    block = attribution.attribute_kernel(
        time_s, flops, nbytes, hw, dtype_key, peak_flops=peak_flops,
        faulted=faulted, source="model")
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


TUNED_AB_K = 4   # chained swiglu steps of the tuned A/B (the JAX bench's)


def tuned_ab_line(summaries_s: dict, round_times_s: dict,
                  flops_per_iter: int, roofline_time_s: float | None, *,
                  metric: str, db_path: str, configs: dict,
                  db_prior_hit: dict, search_meta: dict) -> dict:
    """The tuned-vs-frozen A/B line (the JAX bench's ``_tuned_ab_line``
    schema): ``value`` is the tuned chain's median ms; both variants ship
    ``{value, best, band, n}`` in ms and their rates; the paired
    per-round ratio band says what tuning bought, and
    ``band_disjoint_win`` whether the win cleared the noise bands.
    ``vs_baseline`` and ``vs_baseline_frozen`` are null without a
    roofline (the CPU)."""
    from dlnetbench_tpu_torch.metrics import stats
    tuned, frozen = summaries_s["tuned"], summaries_s["frozen"]
    ratios = [t / f for t, f in zip(round_times_s["tuned"],
                                    round_times_s["frozen"]) if f > 0]
    line = {
        "metric": metric,
        "value": round(tuned["value"] * 1e3, 3),
        "unit": "ms",
        **band_ms(tuned),
        "vs_baseline": (None if roofline_time_s is None
                        else round(roofline_time_s / tuned["value"], 4)),
        "vs_baseline_frozen": (
            None if roofline_time_s is None
            else round(roofline_time_s / frozen["value"], 4)),
        "tflops_tuned": round(flops_per_iter / tuned["value"] / 1e12, 2),
        "tflops_frozen": round(flops_per_iter / frozen["value"] / 1e12,
                               2),
        "tuned_ms": {"value": round(tuned["value"] * 1e3, 3),
                     **band_ms(tuned)},
        "frozen_ms": {"value": round(frozen["value"] * 1e3, 3),
                      **band_ms(frozen)},
        "ratio_tuned_vs_frozen": stats.summarize(ratios, ndigits=4),
        "band_disjoint_win": bool(
            tuned["value"] < frozen["value"]
            and stats.bands_overlap(tuned["band"],
                                    frozen["band"]) is False),
        "db_path": db_path,
        "db_prior_hit": db_prior_hit,
        "configs": configs,
        "search": search_meta,
    }
    return stats.flag_low_mode(flag_above_peak(line))


def bench_tuned_ab(card, hw_key, device_name: str, device) -> dict | None:
    """Tuned-vs-frozen e4m3 fused SwiGLU A/B on kernel K11 (the JAX
    bench's ``tuned_ab``, with the card's knob: K11's cluster size in
    place of the TPU kernel's grid blocks).  For each projection shape
    (gate/up ``(T, D) @ (D, F)``, down ``(T, F) @ (F, D)``) the seeded
    search (``tuning``: splitmix64 candidate order, K-chained fence
    timing, band-aware pruning) runs over three candidates with the
    frozen default among them (``default_cluster``, what an untuned
    launch takes, and the other cluster sizes that divide N / 256) and
    commits the winner to the tuning DB (``DLNB_TUNING_DB_DIR`` if set,
    else an ephemeral directory; the line says which).  A record the DB
    already holds for a key is measured, never overwritten.  Then the
    whole chain (gate, up, silu * up, down, ``TUNED_AB_K`` steps) runs
    frozen and tuned in paired interleaved rounds.  An ephemeral DB is
    removed after the line."""
    import shutil
    import tempfile

    from dlnetbench_tpu_torch import tuning
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.ops import quantized_matmul as qmm
    fmt = "float8"
    hw, where = _eight_bit_hw(hw_key, fmt, "tuned A/B")
    if where is None:
        return None
    tokens, d, f = bs.BATCH * bs.SEQ, card.embed_dim, card.ff_dim
    x = _seeded((tokens, d), 13, device)
    h0 = _seeded((tokens, f), 17, device)
    weights = {}
    for name, shape, seed in (("gate", (d, f), 14), ("up", (d, f), 15),
                              ("down", (f, d), 16)):
        wq, sw = qmm.quantize_tensor(_seeded(shape, seed, device, 0.02),
                                     fmt)
        weights[name] = (qmm.k_major(wq).t(), sw)  # column-major

    db_root = tuning.db_dir()
    ephemeral = db_root is None
    if ephemeral:
        db_root = tempfile.mkdtemp(prefix="dlnb_tuning_ephemeral_")
    try:
        return _tuned_ab(tokens, d, f, x, h0, weights, db_root, ephemeral,
                         device, device_name, hw, where)
    finally:
        if ephemeral:
            shutil.rmtree(db_root, ignore_errors=True)


def _tuned_ab(tokens, d, f, x, h0, weights, db_root, ephemeral, device,
              device_name, hw, where) -> dict:
    """``bench_tuned_ab``'s search, commit and paired rounds on the DB
    at ``db_root``."""
    from dlnetbench_tpu_torch import tuning
    from dlnetbench_tpu_torch.core.hardware import BYTES_PER_ELEMENT
    from dlnetbench_tpu_torch.ops import quantized_matmul as qmm
    from dlnetbench_tpu_torch.utils.timing import fence, time_callable
    fmt, k = "float8", TUNED_AB_K
    db = tuning.TuningDB(db_root)
    hwk = tuning.hw_key(device)

    def dot(xc, proj: str, cluster: int):
        wq, sw = weights[proj]
        sx = qmm.scale_from_amax(qmm.amax_of(xc), fmt)
        return qmm.fused_matmul(xc, wq, sw, sx, fmt=fmt, cluster=cluster)

    def stage_chain(proj: str, carry, cluster: int):
        def run():
            for _ in range(k):
                # a slice fed back: each product depends on the last
                carry[:, :d] += dot(carry, proj, cluster)[:, :d] * 1e-6
            return carry
        return run

    shapes = {"up": (tokens, d, f, "up", x), "down": (tokens, f, d, "down",
                                                      h0)}
    frozen = {name: {"cluster": qmm.default_cluster(n)}
              for name, (_, _, n, _, _) in shapes.items()}
    configs: dict = {}
    db_prior_hit: dict = {}
    search_meta: dict = {}
    for name, (t_, k_, n_, proj, arg) in shapes.items():
        key = tuning.params.quantized_matmul_key(t_, k_, n_, fmt,
                                                 arg.dtype)
        prior = db.get("quantized_matmul", key, hwk)
        db_prior_hit[name] = prior is not None
        if prior is not None:
            # a record the DB holds (a CLI tune, perhaps over a richer
            # grid) is measured, never overwritten by this line's search
            cfg = {**frozen[name], **prior.get("config", {})}
            qmm.check_cluster(cfg, n_, "tuned A/B")
            configs[name] = cfg
            search_meta[name] = {"reused_db_record": True,
                                 "tuned_band": prior.get("band")}
            continue
        candidates = [dict(frozen[name])] + [
            {"cluster": c} for c in qmm.CLUSTERS
            if c != frozen[name]["cluster"] and (n_ // qmm.TILE_N) % c == 0]
        progs: dict = {}
        carry = arg.clone()         # the stage chains' own, updated in place

        def measure(cfg, _proj=proj, _carry=carry, _progs=progs):
            c = cfg["cluster"]
            if c not in _progs:
                _progs[c] = stage_chain(_proj, _carry, c)
                _progs[c]()                          # warm
                fence(device)
            return time_callable(_progs[c], reps=1, device=device)[0] / k

        res = tuning.tune_and_commit(db, "quantized_matmul", key, hwk,
                                     candidates, measure, seed=0,
                                     rounds=ROUNDS, k=k)
        configs[name] = res["config"]
        search_meta[name] = {
            "candidates": len(candidates), "pruned": res["pruned"],
            "seed": res["seed"],
            "tuned_band_ms": {
                kk: ([round(v * 1e3, 3) for v in vv] if kk == "band"
                     else round(vv * 1e3, 3) if kk in ("value", "best")
                     else vv)
                for kk, vv in res["band"].items()}}

    def swiglu_chain(c_up: int, c_down: int):
        def run():
            xc = x
            for _ in range(k):
                g = dot(xc, "gate", c_up)
                u = dot(xc, "up", c_up)
                h = qmm.silu_hidden(g, u)
                xc = (xc + dot(h, "down", c_down) * 1e-6).to(xc.dtype)
            return xc
        return run

    progs = {
        "frozen": swiglu_chain(frozen["up"]["cluster"],
                               frozen["down"]["cluster"]),
        "tuned": swiglu_chain(configs["up"]["cluster"],
                              configs["down"]["cluster"]),
    }
    for prog in progs.values():
        prog()                                       # warm
    fence(device)
    summaries, round_times = measure_paired(progs, k, device)
    flops = 6 * tokens * d * f      # three T*D*F products an iteration
    # fused-path traffic: x and h read once in bf16 (no quantized copy
    # in memory), the e4m3 weights read, the bf16 outputs written
    nbytes = int(BYTES_PER_ELEMENT["bfloat16"]
                 * (tokens * d + 2 * tokens * f + tokens * f + tokens * d)
                 + BYTES_PER_ELEMENT[fmt] * (2 * d * f + f * d))
    line = tuned_ab_line(
        summaries, round_times, flops,
        roofline_s(flops, nbytes, hw, fmt) if hw else None,
        metric=(f"tuned A/B: fp8(e4m3) fused swiglu chain on K11, "
                f"DB-tuned vs frozen-default cluster sizes (seeded search "
                f"committed to the tuning DB"
                f"{' [ephemeral]' if ephemeral else ''}; paired "
                f"interleaved rounds), {tokens} tok D={d} F={f}, "
                f"{device_name} ({where})"),
        db_path=str(db.path), configs=configs,
        db_prior_hit=db_prior_hit, search_meta=search_meta)
    line = stamp_attr(line, time_s=summaries["tuned"]["value"],
                      flops=flops, nbytes=nbytes, hw=hw, dtype_key=fmt)
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


def scale_devices(device, devices=None) -> list | None:
    """The two devices of the serving-at-scale lines: ``devices`` when
    given, else the first two cards; None below two (the JAX bench's
    ``len(jax.devices()) < 2``: on the CPU, torch has one device)."""
    if devices is not None:
        return list(devices)[:2]
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def disagg_line(mono_rounds: list[dict], dis_rounds: list[dict],
                suffix: str = "", *,
                token_parity: bool | None = None) -> dict:
    """The disagg_ab aux line (the JAX ``_disagg_line``) from paired
    per-round ``serving`` blocks: ``value`` is the disaggregated arm's
    round-median e2e p99 in ms; both arms with TTFT p50/p99, TPOT p50
    and tokens/s bands, the migration's bytes and per-send p50 ms bands
    and its bytes ratio, and whether splitting pulled the decode TPOT
    band below the monolithic one, bands disjoint."""
    from dlnetbench_tpu_torch.metrics import stats

    def _bands(rounds: list[dict]) -> dict:
        return {
            "ttft_p50_ms": stats.summarize(
                [r["ttft_ms"]["p50"] for r in rounds], ndigits=3),
            "ttft_p99_ms": stats.summarize(
                [r["ttft_ms"]["p99"] for r in rounds], ndigits=3),
            "tpot_p50_ms": stats.summarize(
                [r["tpot_ms"]["p50"] for r in rounds], ndigits=3),
            "tokens_per_s": stats.summarize(
                [r["tokens_per_s"] for r in rounds], ndigits=2),
        }
    mono, dis = _bands(mono_rounds), _bands(dis_rounds)
    migs = [r.get("migration") or {} for r in dis_rounds]
    dis["migration_bytes"] = stats.summarize(
        [float(m.get("bytes", 0)) for m in migs], ndigits=1)
    dis["migration_ms_p50"] = stats.summarize(
        [float((m.get("ms") or {}).get("p50", float("nan")))
         for m in migs], ndigits=3)
    dis["migration_bytes_ratio"] = migs[0].get("bytes_ratio_vs_bf16")
    p99 = stats.summarize([r["e2e_ms"]["p99"] for r in dis_rounds],
                          ndigits=3)
    disjoint = (stats.bands_overlap(mono["tpot_p50_ms"]["band"],
                                    dis["tpot_p50_ms"]["band"]) is False
                and dis["tpot_p50_ms"]["value"]
                < mono["tpot_p50_ms"]["value"])
    line = {
        "metric": f"disagg_ab: monolithic vs disaggregated "
                  f"prefill/decode at equal chips, same seeded "
                  f"saturating plan (serving/disagg){suffix}",
        "value": p99["value"],
        "unit": "ms",
        "best": p99["best"],
        "band": p99["band"],
        "n": p99["n"],
        "monolithic": mono,
        "disaggregated": dis,
        "tpot_band_disjoint_drop": disjoint,
        "verdict": ("decode TPOT dropped, bands disjoint — the "
                    "prefill mesh's interference left the decode "
                    "replica" if disjoint else
                    "TPOT bands overlap — no interference flip at "
                    "this scale/noise"),
    }
    if token_parity is not None:
        line["token_parity"] = bool(token_parity)
    return stats.flag_low_mode(line)


def bench_disagg_ab(device_name: str, device,
                    devices=None) -> dict | None:
    """The disaggregation A/B (the JAX ``_bench_disagg_ab``): a
    monolithic world-2 engine and a 1p+1d disaggregated pair on the same
    two devices, weights and seeded saturating plan, int8 pages (the
    quantized wire), interleaved per round after a discarded warm round;
    the token-parity lock compares the full greedy streams.  None below
    two devices (``scale_devices``)."""
    import dataclasses

    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.serving import metrics as smetrics
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.disagg import DisaggServer
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig)
    devs = scale_devices(device, devices)
    if devs is None:
        return None
    mc = serving_model()
    # gather attention on both arms, as in the JAX line
    mono_cfg = ServingConfig(
        slots=4, page_size=8, num_pages=48, max_seq_len=40,
        slo_ttft_ms=250.0, slo_tpot_ms=100.0, attn_impl="gather",
        cache_dtype="int8", multi_step_n=8, adaptive_n=True, world=2)
    dis_cfg = dataclasses.replace(
        mono_cfg, disaggregate=True, prefill_ranks=1, decode_ranks=1)
    plan = ArrivalPlan(kind="poisson", rate_rps=5000.0,
                       num_requests=8, seed=0, prompt_len=[8, 16],
                       output_len=[16, 24])
    params = init_params(mc, seed=0, device=devs[0])
    requests = plan.sample()
    mono = Engine(mc, mono_cfg, params=params, devices=devs)
    dis = DisaggServer(mc, dis_cfg, params=params, devices=devs)
    mono.run(requests)  # warm round, discarded
    dis.run(requests)
    mono_rounds, dis_rounds = [], []
    streams = {}
    for _ in range(ROUNDS):
        completed, wall = mono.run(requests)
        streams["mono"] = dict(mono.token_streams)
        mono_rounds.append(serving_rounds_block(mono, completed, plan,
                                                wall, mono_cfg))
        completed, wall = dis.run(requests)
        streams["dis"] = dis.token_streams
        dis_rounds.append(smetrics.serving_block(
            completed, plan, slo_ttft_ms=mono_cfg.slo_ttft_ms,
            slo_tpot_ms=mono_cfg.slo_tpot_ms, wall_s=wall,
            engine_steps=dis.engine_steps(),
            cache_stats=dis.decode.cache.stats(),
            queue_depth_max=dis.prefill.queue_depth_max,
            batch_occupancy_mean=dis.decode.batch_occupancy_mean(),
            decode_loop=dis.decode.decode_loop_block(),
            migration=dis.channel.stats_block()))
    line = disagg_line(
        mono_rounds, dis_rounds,
        suffix=f", {len(requests)} req slots={mono_cfg.slots} "
               f"int8 KV, world=2 (1p+1d), {device_name}",
        token_parity=streams["dis"] == streams["mono"])
    print(json.dumps(line), flush=True)
    return line


def fleet_line(arm_rounds: dict, suffix: str = "", *,
               token_parity: bool | None = None) -> dict:
    """The fleet_ab aux line (the JAX ``_fleet_line``) from per-policy
    per-round ``{"serving": ..., "fleet": ...}`` dicts: ``value`` is the
    prefix_affinity arm's round-median TTFT p50 in ms; every arm with
    TTFT p50/p99 and tokens/s bands, the affinity arm's hit rate and
    prefix-token reuse, and whether affinity pulled TTFT p50 below the
    round_robin band, bands disjoint."""
    from dlnetbench_tpu_torch.metrics import stats

    def _bands(rounds: list[dict]) -> dict:
        srv = [r["serving"] for r in rounds]
        return {
            "ttft_p50_ms": stats.summarize(
                [r["ttft_ms"]["p50"] for r in srv], ndigits=3),
            "ttft_p99_ms": stats.summarize(
                [r["ttft_ms"]["p99"] for r in srv], ndigits=3),
            "tokens_per_s": stats.summarize(
                [r["tokens_per_s"] for r in srv], ndigits=2),
        }
    arms = {pol: _bands(rounds) for pol, rounds in arm_rounds.items()}
    pa_rounds = arm_rounds["prefix_affinity"]
    arms["prefix_affinity"]["affinity_hit_rate"] = stats.summarize(
        [r["fleet"]["affinity_hit_rate"] for r in pa_rounds], ndigits=4)
    arms["prefix_affinity"]["prefix_reuse_tokens"] = stats.summarize(
        [float(r["fleet"]["prefix_reuse_tokens"]) for r in pa_rounds],
        ndigits=1)
    p50 = arms["prefix_affinity"]["ttft_p50_ms"]
    rr = arms["round_robin"]["ttft_p50_ms"]
    disjoint = (stats.bands_overlap(rr["band"], p50["band"]) is False
                and p50["value"] < rr["value"])
    replicas = pa_rounds[0]["fleet"]["replicas"]
    line = {
        "metric": f"fleet_ab: round_robin vs p2c vs prefix_affinity "
                  f"routing at equal chips ({replicas} replicas), same "
                  f"seeded prefix-heavy plan (serving/fleet){suffix}",
        "value": p50["value"],
        "unit": "ms",
        "best": p50["best"],
        "band": p50["band"],
        "n": p50["n"],
        "round_robin": arms["round_robin"],
        "p2c": arms["p2c"],
        "prefix_affinity": arms["prefix_affinity"],
        "ttft_band_disjoint_drop": disjoint,
        "verdict": ("prefix-affinity TTFT p50 dropped below "
                    "round_robin, bands disjoint — routing to the "
                    "pages beat routing blind" if disjoint else
                    "TTFT bands overlap — no routing flip at this "
                    "scale/noise"),
    }
    if token_parity is not None:
        line["token_parity"] = bool(token_parity)
    return stats.flag_low_mode(line)


def bench_fleet_ab(device_name: str, device, devices=None) -> dict | None:
    """The routing A/B (the JAX ``_bench_fleet_ab``): three two-replica
    fleets on the same two devices, weights and seeded prefix-heavy
    plan, prefix sharing on every arm, differing only in routing,
    interleaved per round after a discarded warm round; the
    token-parity lock compares the three arms' streams.  None below two
    devices."""
    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.serving import metrics as smetrics
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.fleet import FleetConfig, FleetServer
    from dlnetbench_tpu_torch.serving.scheduler import ServingConfig
    devs = scale_devices(device, devices)
    if devs is None:
        return None
    mc = serving_model()
    cfg = ServingConfig(
        slots=2, page_size=8, num_pages=64, max_seq_len=64,
        slo_ttft_ms=250.0, slo_tpot_ms=100.0, attn_impl="gather",
        prefix_sharing=True, warmup_requests=0)
    # spaced arrivals: affinity has pages to route to only once earlier
    # prompts have prefilled and published
    plan = ArrivalPlan(kind="poisson", rate_rps=120.0,
                       num_requests=12, seed=2, prompt_len=[36, 44],
                       output_len=[4, 8], shared_prefix_len=32,
                       prefix_pool=2)
    params = init_params(mc, seed=0, device=devs[0])
    requests = plan.sample()
    servers = {
        pol: FleetServer(mc, cfg, FleetConfig(replicas=2, routing=pol),
                         params=params, devices=devs)
        for pol in ("round_robin", "p2c", "prefix_affinity")}
    for srv in servers.values():
        srv.run(requests)  # warm round, discarded
    rounds: dict = {pol: [] for pol in servers}
    streams: dict = {}
    for _ in range(ROUNDS):
        for pol, srv in servers.items():   # interleaved
            completed, wall = srv.run(requests)
            streams[pol] = srv.token_streams
            rounds[pol].append({
                "serving": smetrics.serving_block(
                    completed, plan, slo_ttft_ms=cfg.slo_ttft_ms,
                    slo_tpot_ms=cfg.slo_tpot_ms, wall_s=wall,
                    engine_steps=srv.engine_steps(),
                    queue_depth_max=srv.queue_depth_max,
                    batch_occupancy_mean=srv.batch_occupancy_mean(),
                    admitted_peak=srv.concurrent_peak),
                "fleet": srv.fleet_block(completed)})
    parity = (streams["round_robin"] == streams["p2c"]
              == streams["prefix_affinity"])
    line = fleet_line(
        rounds,
        suffix=f", {len(requests)} req slots={cfg.slots}/replica, "
               f"shared_prefix={plan.shared_prefix_len} "
               f"pool={plan.prefix_pool}, {device_name}",
        token_parity=parity)
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


def skipped(metric: str, why: str) -> None:
    """A skip marker line (the JAX bench's ``_skipped``): the line
    cannot run here, and says why."""
    print(json.dumps({"metric": metric, "skipped": why}), flush=True)


def combine_linear(terms: list[tuple[float, dict]]) -> dict:
    """Summary of a weighted sum of independently measured stages:
    medians, bests and bounds add linearly; n is the weakest stage's."""
    return {
        "value": sum(w * s["value"] for w, s in terms),
        "best": sum(w * s["best"] for w, s in terms),
        "band": [sum(w * s["band"][0] for w, s in terms),
                 sum(w * s["band"][1] for w, s in terms)],
        "n": min(s["n"] for _, s in terms),
    }


def chain_summary(chain, k: int, device) -> dict:
    """One warm call of a k-deep chain, then ``ROUNDS`` timed calls;
    the summary in seconds an iteration (the JAX bench's
    ``_measure_chain``)."""
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.utils.timing import fence, time_callable
    chain()
    fence(device)
    return stats.summarize([t / k for t in time_callable(
        chain, reps=ROUNDS, device=device)])


FP8_MLP_K = 10       # chained products of the 8-bit lines (the JAX bench's)
FP8_SWIGLU_K = 8
INT8_MATMUL_K = 40


def eight_bit_line(metric: str, summary_s: dict, *, ops: int, nbytes: int,
                   hw, peak_key: str, rate_key: str) -> dict:
    """An 8-bit chain's line from its seconds-an-iteration summary: the
    JAX bench's keys, ``vs_baseline`` the roofline time at the card's
    own ``peak_key`` rate over the measured one (null without a
    preset), the above-peak and low-mode flags, the attribution
    block."""
    from dlnetbench_tpu_torch.metrics import stats
    t_s = summary_s["value"]
    line = {
        "metric": metric,
        "value": round(t_s * 1e3, 3),
        "unit": "ms",
        **band_ms(summary_s),
        "vs_baseline": (None if hw is None else round(
            roofline_s(ops, nbytes, hw, peak_key) / t_s, 4)),
        rate_key: round(ops / t_s / 1e12, 2),
    }
    line = stats.flag_low_mode(flag_above_peak(line))
    return stamp_attr(line, time_s=t_s, flops=ops, nbytes=nbytes, hw=hw,
                      dtype_key=peak_key)


def _eight_bit_hw(hw_key, peak_key: str, label: str):
    """``(hw, where)`` of an 8-bit line: the preset and the metric's
    note of its peak; ``(None, None)`` after a skip marker when the
    preset has no such peak."""
    from dlnetbench_tpu_torch.core.hardware import HARDWARE
    if hw_key is None:
        return None, "no preset"
    hw = HARDWARE[hw_key]
    try:
        peak = hw.peak(peak_key)
    except ValueError:
        skipped(f"{label} ({hw_key})", f"{hw_key} has no {peak_key} peak")
        return None, None
    unit = "TOP/s" if peak_key == "int8" else "TF/s"
    short = "fp8" if peak_key == "float8" else peak_key
    return hw, f"{hw_key}, {short} peak {peak / 1e12:.0f} {unit}"


def _e4m3_chain_dot(w: torch.Tensor):
    """The composed e4m3 product against ``w``, its quantization hoisted
    out of the chain as XLA hoists it (``ops/fp8.quantized_weight_dot``:
    ``torch._scaled_mm`` on the card, unit scales, f32 out, then the JAX
    epilogue)."""
    from dlnetbench_tpu_torch.ops import fp8 as qf8
    from dlnetbench_tpu_torch.ops import quantized_matmul as qmm
    wq, sw = qmm.quantize_tensor(w, "float8")
    wq = qmm.k_major(wq).t()        # column-major: no copy per call
    return lambda xc: qf8.quantized_weight_dot(xc, wq, sw)


def _seeded(shape, seed: int, device, scale: float = 1.0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device=device)
            * scale).to(torch.bfloat16)


def bench_fp8_mlp(card, hw_key, device_name: str, device) -> dict | None:
    """The e4m3 MLP-projection product against the card's own fp8 peak:
    one square ``(T, D) @ (D, D)`` product a step, ``FP8_MLP_K`` deep
    (the JAX bench's chain shape), through the composed recipe's library
    product — never K11."""
    from dlnetbench_tpu_torch.core.hardware import BYTES_PER_ELEMENT
    from dlnetbench_tpu_torch.models import bench_step as bs
    hw, where = _eight_bit_hw(hw_key, "float8", "fp8 mlp matmul")
    if where is None:
        return None
    tokens, d = bs.BATCH * bs.SEQ, card.embed_dim
    x = _seeded((tokens, d), 2, device)
    dot = _e4m3_chain_dot(_seeded((d, d), 3, device, 0.02))

    def chain():
        xc = x
        for _ in range(FP8_MLP_K):
            xc = dot(xc)
        return xc

    summary = chain_summary(chain, FP8_MLP_K, device)
    ops = 2 * tokens * d * d
    # e4m3 operand reads + the bf16 output write
    nbytes = int(BYTES_PER_ELEMENT["float8"] * (tokens * d + d * d)
                 + BYTES_PER_ELEMENT["bfloat16"] * tokens * d)
    line = eight_bit_line(
        f"fp8(e4m3) mlp-projection matmul, {tokens} tok D={d}, "
        f"{device_name} ({where})", summary, ops=ops, nbytes=nbytes,
        hw=hw, peak_key="float8", rate_key="tflops_achieved")
    print(json.dumps(line), flush=True)
    return line


def bench_fp8_swiglu(card, hw_key, device_name: str,
                     device) -> dict | None:
    """The ``swiglu_fp8`` path stage by stage, as the JAX bench measures
    it: the gate/up ``(T, D) @ (D, F)`` stage and the down ``(T, F) @
    (F, D)`` stage each a chained program ``FP8_SWIGLU_K`` deep, the
    chain's time 2 x up + 1 x down (the silu*u between them is not
    billed)."""
    from dlnetbench_tpu_torch.core.hardware import BYTES_PER_ELEMENT
    from dlnetbench_tpu_torch.models import bench_step as bs
    hw, where = _eight_bit_hw(hw_key, "float8", "fp8 swiglu chain")
    if where is None:
        return None
    tokens, d, f = bs.BATCH * bs.SEQ, card.embed_dim, card.ff_dim
    x = _seeded((tokens, d), 5, device)
    up = _e4m3_chain_dot(_seeded((d, f), 6, device, 0.02))
    down = _e4m3_chain_dot(_seeded((f, d), 7, device, 0.02))
    h = _seeded((tokens, f), 8, device)

    def up_chain():
        xc = x
        for _ in range(FP8_SWIGLU_K):
            # a slice fed back: each product depends on the last
            xc = (xc + up(xc)[:, :d] * 1e-6).to(xc.dtype)
        return xc

    def down_chain():
        for _ in range(FP8_SWIGLU_K):
            # the whole (T, D) result feeds the carry
            h[:, :d] += down(h) * 1e-6
        return h

    summary = combine_linear(
        [(2, chain_summary(up_chain, FP8_SWIGLU_K, device)),
         (1, chain_summary(down_chain, FP8_SWIGLU_K, device))])
    ops = 6 * tokens * d * f  # three T*D*F products
    nbytes = int(BYTES_PER_ELEMENT["float8"]
                 * (2 * tokens * d + 2 * d * f + 2 * tokens * f + f * d)
                 + BYTES_PER_ELEMENT["bfloat16"] * (2 * tokens * f
                                                    + tokens * d))
    line = eight_bit_line(
        f"fp8(e4m3) swiglu chain (gate+up+down as separate chained "
        f"stages, as the JAX bench measures them), {tokens} tok D={d} "
        f"F={f}, {device_name} ({where})", summary, ops=ops,
        nbytes=nbytes, hw=hw, peak_key="float8",
        rate_key="tflops_achieved")
    print(json.dumps(line), flush=True)
    return line


def bench_int8_matmul(card, hw_key, device_name: str,
                      device) -> dict | None:
    """The int8 product against the card's own int8 peak: a square
    ``(T, D) @ (D, D)`` int8 x int8 -> int32 product a step, rescaled to
    int8 (``>> 8``) between steps, ``INT8_MATMUL_K`` deep — the JAX
    bench's chain through ``torch._int_mm`` (``ops/int8.int32_product``)."""
    from dlnetbench_tpu_torch.core.hardware import BYTES_PER_ELEMENT
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.ops import int8
    hw, where = _eight_bit_hw(hw_key, "int8", "int8 matmul")
    if where is None:
        return None
    tokens, d = bs.BATCH * bs.SEQ, card.embed_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    x = torch.randint(-127, 128, (tokens, d), generator=gen, device=device,
                      dtype=torch.int8)
    gen.manual_seed(10)
    w = torch.randint(-127, 128, (d, d), generator=gen, device=device,
                      dtype=torch.int8)
    w = w.t().contiguous().t()      # column-major: no copy per call

    def chain():
        xc = x
        for _ in range(INT8_MATMUL_K):
            xc = (int8.int32_product(xc, w) >> 8).to(torch.int8)
        return xc

    summary = chain_summary(chain, INT8_MATMUL_K, device)
    ops = 2 * tokens * d * d
    nbytes = int(BYTES_PER_ELEMENT["int8"] * (2 * tokens * d + d * d))
    line = eight_bit_line(
        f"int8 matmul, {tokens} tok D={d}, {device_name} ({where})",
        summary, ops=ops, nbytes=nbytes, hw=hw, peak_key="int8",
        rate_key="tops_achieved")
    print(json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def proxy_world(platform: str):
    """This process's process group for a proxy line (a one-rank group
    on a free port when none is up, torn down after); yields its
    device."""
    import torch.distributed as dist

    from dlnetbench_tpu_torch.parallel import multihost
    owned = not dist.is_initialized()
    device = multihost.initialize(platform)
    try:
        yield device
    finally:
        if owned:
            multihost.shutdown()


def _tiny_dp(device):
    """The JAX bench's tiny dp proxy for its fault lines."""
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    cfg = ProxyConfig(size_scale=1e-3, time_scale=1e-3)
    return dp.build(load_model_stats("gpt2_l_16_bfloat16"), 2, cfg,
                    make_flat_mesh(device), dtype=torch.float32)


def bench_straggler_ab(platform: str) -> dict | None:
    """Paired faulted-vs-clean straggler A/B: the tiny dp step timed
    clean and with a scripted per-step delay on rank 1 injected inside
    the timed window, interleaved per round; ``value`` is the measured
    amplification (inflation / injected delay).  It needs a world of
    >= 2 ranks — one rank has no collective to gate — so a bench
    process alone prints the JAX bench's skip note; the four-card
    counterpart is ``torchrun --nproc_per_node 4 -m
    dlnetbench_tpu_torch.cli dp --fault '<delay on rank 1>'``."""
    from dlnetbench_tpu_torch.analysis.attribution import straggler_block
    from dlnetbench_tpu_torch.faults.inject import FaultInjector
    from dlnetbench_tpu_torch.faults.plan import FaultEvent, FaultPlan
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.utils import timing

    with proxy_world(platform) as device:
        n = multihost.world_size()
        if n < 2:
            skipped("straggler A/B",
                    f"needs >= 2 devices, have {n} — no collective for a "
                    f"straggler to gate")
            return None
        bundle = _tiny_dp(device)
        k, rounds = 4, 3
        # a delay ~3x a clean step, floored at 2 ms
        warm_s = timing.time_chain(bundle.full, k=k, device=device)
        delay_us = max(3 * warm_s * 1e6, 2000.0)
        plan = FaultPlan(events=[FaultEvent(
            kind="delay", ranks=[1], magnitude_us=delay_us)]).validate()
        injector = FaultInjector(plan, world=n, rank=multihost.rank())

        def faulted_step():
            injector.before_step()
            return bundle.full()

        clean_s, faulted_s = [], []
        for _ in range(rounds):  # interleaved: adjacent in time per round
            clean_s.append(timing.time_chain(bundle.full, k=k,
                                             device=device))
            faulted_s.append(timing.time_chain(faulted_step, k=k,
                                               device=device))
    clean = stats.summarize(clean_s)
    faulted = stats.summarize(faulted_s)
    amp = (faulted["value"] - clean["value"]) / (delay_us / 1e6)
    line = {
        "metric": "straggler A/B (dp step, faulted vs clean)",
        "value": round(amp, 3),
        "unit": "x (step inflation / injected delay)",
        "injected_ms": round(delay_us / 1e3, 3),
        "clean_ms": {"value": round(clean["value"] * 1e3, 3),
                     **band_ms(clean)},
        "faulted_ms": {"value": round(faulted["value"] * 1e3, 3),
                       **band_ms(faulted)},
        "n": rounds,
        "world": n,
    }
    attr = straggler_block(clean["value"] * 1e3, faulted["value"] * 1e3,
                           delay_us / 1e3)
    if attr is not None:
        line["attribution"] = attr
    print(json.dumps(line), flush=True)
    return line


def bench_overlap_ab(platform: str) -> dict | None:
    """Paired overlap-vs-baseline A/B of the SPMD train step
    (``models/overlap_bench.py``): the real dp x pp x tp step with
    ``tp_overlap="decomposed"`` + ``grad_sync="bucketed"`` against the
    blocking baseline, interleaved rounds, and the measured overlap
    fraction from the full / compute / comm decomposition, at the JAX
    bench's shape (``entry.BENCH_SPMD``: embed 2048, 16/16 heads, ff
    8192, 4 layers, S 2048, vocab 32768, 4 experts, bf16).  It needs a
    world of >= 2 ranks — one rank has no communication to overlap — so
    a bench process alone prints the JAX bench's skip note; the
    four-card counterpart is ``torchrun --nproc_per_node 4 -m
    dlnetbench_tpu_torch.entry --shape bench``."""
    from dlnetbench_tpu_torch.entry import BENCH_SPMD
    from dlnetbench_tpu_torch.models import overlap_bench, spmd
    from dlnetbench_tpu_torch.parallel import multihost

    n = multihost.launcher_world()
    if n < 2:
        skipped("spmd overlap A/B",
                f"needs >= 2 devices, have {n} — single-chip session has "
                f"no communication to overlap")
        return None
    with proxy_world(platform) as device:
        mesh = spmd.grid_mesh(*spmd.factor_mesh(n), device)
        line = overlap_bench.measure(mesh, cfg_kwargs=dict(BENCH_SPMD))
    print(json.dumps(line), flush=True)
    return line


def bench_checkpoint_ab(platform: str) -> dict:
    """Paired stall-vs-async checkpoint A/B: the tiny dp step with a
    per-step snapshot save (``utils/checkpoint.SnapshotCheckpointer``,
    the ``auto`` backend: dcp) in both modes, against the save-free
    step, interleaved per round.  ``stall`` puts the whole durable write
    on the timed path; ``async`` keeps only the device-to-host snapshot
    there and drains the writer thread between chains.  ``value`` is the
    fraction of the measured save cost the async mode moved off the
    timed path, beside the three step bands and the per-save cost."""
    import itertools
    import shutil
    import tempfile
    from pathlib import Path

    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.utils import timing
    from dlnetbench_tpu_torch.utils.checkpoint import SnapshotCheckpointer

    k, rounds = 4, 3
    root = tempfile.mkdtemp(prefix="dlnb_ckpt_ab_")
    try:
        with proxy_world(platform) as device:
            bundle = _tiny_dp(device)
            ckpts = {mode: SnapshotCheckpointer(
                Path(root) / mode, bundle.state, every=1, mode=mode, keep=2)
                for mode in ("stall", "async")}
            counters = {mode: itertools.count() for mode in ckpts}

            def step_with(mode):
                bundle.full()
                ckpts[mode].on_step(next(counters[mode]))

            base_s, stall_s, async_s = [], [], []
            for _ in range(rounds):  # interleaved: adjacent per round
                base_s.append(timing.time_chain(bundle.full, k=k,
                                                device=device))
                stall_s.append(timing.time_chain(
                    lambda: step_with("stall"), k=k, device=device))
                async_s.append(timing.time_chain(
                    lambda: step_with("async"), k=k, device=device))
                ckpts["async"].wait()  # drain the writer off the window
        base = stats.summarize(base_s)
        stall = stats.summarize(stall_s)
        asyn = stats.summarize(async_s)
        save_cost = stall["value"] - base["value"]
        hidden = ((stall["value"] - asyn["value"]) / save_cost
                  if save_cost > 0 else 0.0)
        line = {
            "metric": "checkpoint A/B (dp step, stall vs async save)",
            "value": round(hidden, 3),
            "unit": "fraction of save cost off the critical path "
                    "(async vs stall)",
            "baseline_ms": {"value": round(base["value"] * 1e3, 3),
                            **band_ms(base)},
            "stall_ms": {"value": round(stall["value"] * 1e3, 3),
                         **band_ms(stall)},
            "async_ms": {"value": round(asyn["value"] * 1e3, 3),
                         **band_ms(asyn)},
            # the measured durable-save cost (stall mode: the whole write)
            "save_ms": stats.summarize(ckpts["stall"].checkpoint_ms,
                                       ndigits=3),
            "state_bytes": ckpts["stall"].state_bytes,
            "backend": ckpts["stall"].backend,
            "n": rounds,
        }
        print(json.dumps(line), flush=True)
        return line
    finally:
        shutil.rmtree(root, ignore_errors=True)


def headline(step_summary: dict, loss: float, card, cfg,
             device_name: str, hw_key: str | None,
             fault_plan=None) -> dict:
    """The headline line from a seconds-per-step summary: the JAX
    package's keys and formulas (3x the forward for fwd + bwd, the LM
    head credited, the causal half of the score products elided in
    ``vs_baseline_causal``, the step's pass-by-pass traffic in
    ``vs_baseline_bwd_aware``), with the attribution block of the step
    against those credited FLOPs and that traffic on the card's preset
    (none on the CPU).  A ``fault_plan`` rides the line and makes the
    verdict ``faulted``."""
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
        **({"fault_plan": fault_plan.to_dict()} if fault_plan else {}),
    })
    return stamp_attr(
        line, time_s=step_s, flops=total_flops,
        nbytes=roofline.train_step_bytes(card, bs.BATCH, "bfloat16"),
        hw=HARDWARE.get(hw_key), dtype_key="bfloat16",
        faulted=fault_plan is not None)


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


FAULT_KINDS = ("delay", "jitter")   # what the bench's --fault honors


def main(argv=None) -> int:
    from dlnetbench_tpu_torch.metrics import spans, telemetry
    parser, args = _parse_args(argv)
    fault_plan = None
    if args.fault:
        # parsed and checked before any build: the bench is one process
        # with no degradation policy, so only slowdowns make sense here
        from dlnetbench_tpu_torch.faults.plan import FaultPlan
        try:
            fault_plan = FaultPlan.loads(args.fault).validate()
        except (ValueError, OSError, KeyError) as e:
            parser.error(f"--fault: {e}")
        bad = sorted({e.kind for e in fault_plan.events
                      if e.kind not in FAULT_KINDS})
        if bad:
            print(f"--fault: bench.py only honors delay/jitter events "
                  f"(got {', '.join(bad)}) — crash/drop/partition need "
                  f"a multi-rank harness with a degradation policy "
                  f"(cli.py --fault)", file=sys.stderr)
            return 2
    tracer = spans.enable() if args.trace_out else None
    tele_on = (not telemetry.is_enabled()
               and telemetry.enable_from_env() is not None)
    try:
        return _run_bench(args, parser, tracer, fault_plan)
    finally:
        # never leak this run's tracer or recorder into later calls
        if tracer is not None and spans.current() is tracer:
            spans.disable()
        if tele_on:
            telemetry.disable()


def trace_headline(train_k, params, tokens, device) -> list | None:
    """The device events of one more headline call under
    ``torch.profiler`` (``metrics/profiling.trace_step``); None, with a
    note on stderr, when the capture fails — the trace is auxiliary."""
    from dlnetbench_tpu_torch.metrics import profiling
    try:
        return profiling.trace_step(
            lambda: train_k(params, tokens), device,
            span_attrs={"what": "headline iteration"})
    except Exception as e:
        print(f"trace-out device profile failed ({type(e).__name__}: "
              f"{e}); headline unaffected", file=sys.stderr)
        return None


def write_trace(path: str, tracer, device_label: str, events,
                line: dict, step_s: float) -> None:
    """The merged trace: the host spans, the profiled call's device
    track, the headline's attribution and the flight ring as counter
    tracks."""
    from dlnetbench_tpu_torch.metrics import spans, telemetry
    extra = spans.attribution_counter_events(line.get("attribution") or {},
                                             dur_us=step_s * 1e6)
    rec_now = telemetry.current()
    if rec_now is not None:
        extra = extra + spans.telemetry_counter_events(
            rec_now.telemetry_block(last=rec_now.capacity),
            rec_now.anomalies_block())
    try:
        spans.write_chrome_trace(
            path, tracer, [(device_label, events)] if events else None,
            extra_events=extra)
        print(f"merged host+device trace -> {path}", file=sys.stderr)
    except OSError as e:
        print(f"trace-out write failed ({e}); headline unaffected",
              file=sys.stderr)


def _run_bench(args, parser, tracer, fault_plan) -> int:
    from dlnetbench_tpu_torch import tuning
    from dlnetbench_tpu_torch.core.hardware import hw_key_for_device_name
    from dlnetbench_tpu_torch.metrics import spans
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.ops.common import resolve_device
    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        parser.error(str(e))
    # the tuning DB, an opt-in warm-state directory, is stamped into the
    # headline so every artifact says which tuning state produced it
    tuning_db_dir = tuning.db_dir()
    if tuning_db_dir:
        print(f"tuning db: {tuning_db_dir}", file=sys.stderr)
    if device.type == "cuda":
        device_name = torch.cuda.get_device_name(device)
        hw_key = hw_key_for_device_name(device_name)
    else:
        device_name, hw_key = "cpu", None
    k = bs.env_int("DLNB_BENCH_K", 10)
    with spans.span("build", what="headline"):
        train_k, params, tokens, card, cfg = bs.build(k, device=device)
    injector = None
    if fault_plan is not None:
        from dlnetbench_tpu_torch.faults.inject import FaultInjector
        injector = FaultInjector(fault_plan)
    with spans.span("timed", what="headline", reps=ROUNDS, k=k):
        summary, loss = time_steps(train_k, params, tokens, k, device,
                                   injector)
    events = None
    if args.trace_out:
        # captured while the step and its buffers are still alive
        events = trace_headline(train_k, params, tokens, device)
    # free the headline's weights and activations before the aux lines
    del train_k, params, tokens
    if device.type == "cuda":
        torch.cuda.empty_cache()
    aux = {}

    def run_aux(key, fn, *fn_args):
        with spans.span("aux", line=key):
            out = fn(*fn_args)
        if out is not None:
            aux[key] = out

    if not args.skip_aux:
        # the JAX bench's order: the 8-bit lines, the fused A/B lines,
        # the fault lines, then the serving tier's
        run_aux("fp8_mlp", bench_fp8_mlp, card, hw_key, device_name,
                device)
        run_aux("fp8_swiglu", bench_fp8_swiglu, card, hw_key, device_name,
                device)
        run_aux("int8_matmul", bench_int8_matmul, card, hw_key,
                device_name, device)
        for key, fmt in (("int8_fused_ab", "int8"),
                         ("fp8_fused_ab", "float8")):
            run_aux(key, bench_quant_fused_ab, card, hw_key, device_name,
                    device, fmt)
        run_aux("tuned_ab", bench_tuned_ab, card, hw_key, device_name,
                device)
        run_aux("straggler_ab", bench_straggler_ab, args.platform)
        run_aux("checkpoint_ab", bench_checkpoint_ab, args.platform)
        # the serving tier's lines (tiny engines)
        run_aux("serving_decode", bench_serving_decode, device_name,
                device, args.live_metrics)
        run_aux("kv_density_ab", bench_kv_density, device_name, device)
        run_aux("sampling_ab", bench_sampling_ab, device_name, device)
        # the serving-at-scale lines: two devices or none (the JAX
        # bench's rule)
        run_aux("disagg_ab", bench_disagg_ab, device_name, device)
        run_aux("fleet_ab", bench_fleet_ab, device_name, device)
        run_aux("longcontext_ab", bench_longcontext_ab, card, hw_key,
                device_name, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        run_aux("moe_ab", bench_moe_ab, card, hw_key, device_name, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for key, mode in (("int8_step", "master"),
                          ("int8_switchback_step", "switchback")):
            run_aux(key, bench_int8_step, card, hw_key, device_name,
                    device, summary["value"], mode)
        # last of all, as in the JAX bench: six train-step programs of
        # its own (2 configs x 3 A/B variants); one rank skips it
        run_aux("spmd_overlap_ab", bench_overlap_ab, args.platform)
    recommended = recommended_step(
        summary, loss, {"int8_master": aux.get("int8_step"),
                        "int8_switchback": aux.get("int8_switchback_step")})
    if not args.skip_aux:
        print(json.dumps(recommended), flush=True)
    line = headline(summary, loss, card, cfg, device_name, hw_key,
                    fault_plan)
    if tuning_db_dir:
        line["tuning_db_dir"] = tuning_db_dir
    line.update(aux)
    line["recommended_step"] = recommended
    rc = 0
    if args.check:
        rc = sentinel_check(line, args.check, args.check_threshold)
    print(f"bench: {line['value']} ms/step (band {line['band']}), loss "
          f"{line['loss']}, vs_baseline {line['vs_baseline']} on "
          f"{device_name}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    if tracer is not None:
        spans.disable()
        label = (f"cuda:{device.index or 0}" if device.type == "cuda"
                 else "cpu")
        # the cli's track name for one rank (trace_summary reads it)
        write_trace(args.trace_out, tracer, f"rank 0 ({label})", events,
                    line, summary["value"])
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
