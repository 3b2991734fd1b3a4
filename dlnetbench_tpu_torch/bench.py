"""The headline train-step benchmark of the torch package (the headline
path of the JAX package's root ``bench.py``):

    python -m dlnetbench_tpu_torch.bench [--platform cuda|cpu]

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
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from dlnetbench_tpu_torch.ops.common import PLATFORMS

ROUNDS = 3


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="dlnetbench_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default="cuda", choices=list(PLATFORMS),
                   help="cuda (default; an error without a card) or cpu")
    return p, p.parse_args(argv)


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
        "best": round(step_summary["best"] * 1e3, 3),
        "band": [round(v * 1e3, 3) for v in step_summary["band"]],
        "n": step_summary["n"],
        **ratios,
        "tflops_achieved": round(achieved / 1e12, 2),
        "tflops_executed": round(achieved * executed_ratio / 1e12, 2),
        "loss": round(loss, 4),
        "logits_dtype": "float32" if cfg.logits_f32 else "bfloat16",
    })


def main(argv=None) -> int:
    from dlnetbench_tpu_torch.core.hardware import hw_key_for_device_name
    from dlnetbench_tpu_torch.metrics import stats
    from dlnetbench_tpu_torch.models import bench_step as bs
    from dlnetbench_tpu_torch.ops.common import resolve_device
    from dlnetbench_tpu_torch.utils.timing import fence, time_callable
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
    last = {}

    def step():
        last["losses"] = train_k(params, tokens)[1]

    step()                                  # warm call
    fence(device)
    samples = time_callable(step, reps=ROUNDS, device=device)
    summary = stats.summarize([t / k for t in samples])
    loss = float(last["losses"][-1])
    line = headline(summary, loss, card, cfg, device_name, hw_key)
    print(f"bench: {line['value']} ms/step (band {line['band']}), loss "
          f"{line['loss']}, vs_baseline {line['vs_baseline']} on "
          f"{device_name}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
