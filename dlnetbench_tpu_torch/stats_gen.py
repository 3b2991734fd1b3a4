"""Stats-file generator (the port's copy of the JAX package's
``stats_gen.py``), pricing each model on an NVIDIA card by default.

Parameter counts are analytic from the architecture card, FLOP counts
are family-correct (GQA, SwiGLU, MoE top-k) and times come from the
roofline of ``core.roofline`` on a ``core.hardware`` preset, so
generation is offline and instant.

Usage:
    python -m dlnetbench_tpu_torch.stats_gen llama3_8b --batch_size 16 \\
        --dtype bfloat16
    python -m dlnetbench_tpu_torch.stats_gen --all   # the 9 x 4 x 2 grid
"""
from __future__ import annotations

import argparse
from pathlib import Path

from dlnetbench_tpu_torch.core import roofline
from dlnetbench_tpu_torch.core.hardware import (BYTES_PER_ELEMENT,
                                                DEFAULT_DEVICE, HARDWARE)
from dlnetbench_tpu_torch.core.model_card import (ModelCard,
                                                  list_model_cards,
                                                  load_model_card)
from dlnetbench_tpu_torch.core.model_stats import (ModelStats,
                                                   save_model_stats)

BATCH_GRID = (16, 32, 64, 128)
DTYPE_GRID = ("bfloat16", "float8")


def generate_stats(card: ModelCard, batch: int, dtype: str,
                   device: str = DEFAULT_DEVICE) -> ModelStats:
    fwd_flops = roofline.model_flops(card, batch)
    fwd_s = roofline.forward_time_s(card, batch, dtype, device)
    ffn_fwd_s = roofline.ffn_forward_time_s(card, batch, dtype, device)
    step_s = roofline.train_step_time_s(card, batch, dtype, device)
    return ModelStats(
        name=f"{card.name}_{batch}_{dtype}",
        forward_flops=fwd_flops,
        backward_flops=int(fwd_flops * roofline.BWD_FWD_RATIO),
        model_size=card.num_params(),
        non_expert_size=card.non_expert_params(),
        fwd_us=fwd_s * 1e6,
        bwd_us=fwd_s * roofline.BWD_FWD_RATIO * 1e6,
        batch_size=batch,
        ffn_fwd_us=ffn_fwd_s * 1e6,
        ffn_bwd_us=ffn_fwd_s * roofline.BWD_FWD_RATIO * 1e6,
        experts=card.num_experts,
        seq_len=card.seq_len,
        embed_dim=card.embed_dim,
        device=HARDWARE[device].name,
        dtype=dtype,
        bytes_per_element=BYTES_PER_ELEMENT[dtype],
        step_us=step_s * 1e6,
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", nargs="?", help="architecture card name")
    p.add_argument("--all", action="store_true",
                   help="generate the full model x batch x dtype grid")
    p.add_argument("--list", action="store_true", help="list known models")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16",
                   choices=sorted(BYTES_PER_ELEMENT))
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   choices=sorted(HARDWARE))
    p.add_argument("--out_dir", type=Path, default=None)
    args = p.parse_args(argv)

    if args.list:
        for m in list_model_cards():
            print(m)
        return 0

    supported = set(HARDWARE[args.device].peak_flops)
    jobs = []
    if args.all:
        grid_dtypes = [dt for dt in DTYPE_GRID if dt in supported]
        dropped = [dt for dt in DTYPE_GRID if dt not in supported]
        if dropped:
            print(f"note: skipping dtypes {dropped} — no peak for "
                  f"{args.device}")
        for name in list_model_cards():
            for b in BATCH_GRID:
                for dt in grid_dtypes:
                    jobs.append((name, b, dt))
    elif args.model:
        if args.dtype not in supported:
            p.error(f"device {args.device} has no peak for dtype "
                    f"{args.dtype!r}; supported: {sorted(supported)}")
        jobs.append((args.model, args.batch_size, args.dtype))
    else:
        p.error("give a model name, --all, or --list")

    known = list_model_cards()
    for name, b, dt in jobs:
        if name not in known:
            p.error(f"unknown model {name!r}; known models: "
                    f"{', '.join(known)}")
        card = load_model_card(name)
        stats = generate_stats(card, b, dt, args.device)
        path = save_model_stats(stats, args.out_dir)
        print(f"wrote {path}  (fwd {stats.fwd_us/1e3:.3f} ms, "
              f"{stats.model_size/1e9:.2f} B params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
