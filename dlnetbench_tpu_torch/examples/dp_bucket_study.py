"""End-to-end DP bucket-count study — the reference's headline workflow
(sweep -> parse -> plot) on the port (the repo's
``examples/dp_bucket_study.py``).

The reference's loop: sbatchman submits a job grid over NCCL knobs,
parser.py walks the completed jobs into DataFrames, plot_dp.py draws
runtime scaling and barrier scatter (reference plots/plot_dp.py:29,
:80).  Here the same loop runs on the cards of one host:

    python -m dlnetbench_tpu_torch.examples.dp_bucket_study \\
        --out_dir /tmp/dp_study [--devices 4] [--platform cuda|cpu]

sweeps the dp proxy over bucket counts (``sweep.main``), ingests the
tagged records, prints the mean runtime and barrier a bucket count and
the effective bandwidth a point, and writes scaling + barrier + Pareto
PNGs (where matplotlib is installed; otherwise it names each PNG it
skipped).  ``--devices`` is the world of every point, as in the JAX
study, but here the world comes from ``torch.distributed.run``
(``sweep --nproc``: NCCL on the cards, gloo with ``--platform cpu``)
where the JAX study's is a virtual CPU mesh; at ``--devices 1`` the
points run in this process.  ``--platform`` is ``cuda`` unless the
caller asks for ``cpu``; without a card, ``cuda`` is an error.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PASSTHROUGH = ["-r", "3", "-w", "1", "--size_scale", "1e-5",
               "--time_scale", "1e-4", "--no_topology"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dlnetbench_tpu_torch.examples.dp_bucket_study",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out_dir", type=Path, default=Path("/tmp/dp_study"))
    ap.add_argument("--model", default="gpt2_l_16_bfloat16")
    ap.add_argument("--buckets", default="2,4,8")
    ap.add_argument("--devices", type=int, default=8,
                    help="world of every point (ranks under "
                         "torch.distributed.run; 1: in this process)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error("--devices must be >= 1")
    from dlnetbench_tpu_torch.ops.common import resolve_device
    try:
        resolve_device(args.platform)
    except RuntimeError as e:
        ap.error(str(e))

    args.out_dir.mkdir(parents=True, exist_ok=True)
    records = args.out_dir / "records.jsonl"
    records.unlink(missing_ok=True)

    # 1. sweep (each point a torchrun world, or in process at world 1);
    # the points' processes import the package from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    from dlnetbench_tpu_torch import sweep
    rc = sweep.main([
        "dp", "--model", args.model, "--out", str(records),
        "--axis", f"num_buckets={args.buckets}",
        "--nproc", str(args.devices), "--",
        "--platform", args.platform, *PASSTHROUGH])
    if rc != 0:
        return rc

    # 2. ingest (reference plots/parser.py:213-256 shape: rank x run rows)
    from dlnetbench_tpu_torch.metrics.parser import (load_records,
                                                     records_to_dataframe)
    recs = load_records(records, "dp")
    df = records_to_dataframe(recs)
    summary = (df.groupby("num_buckets")[["runtime", "barrier_time"]]
               .mean().sort_index())
    print("\nmean per bucket count (us):")
    print(summary.to_string(float_format=lambda v: f"{v:12.1f}"))

    # 2b. effective bandwidth, kept per sweep point — blending bucket
    # counts would erase the axis the study exists to compare
    import pandas as pd

    from dlnetbench_tpu_torch.analysis.bandwidth import bandwidth_summary
    per_point = []
    for rec in recs:
        s = bandwidth_summary([rec])
        if not s.empty:
            s.insert(0, "num_buckets", rec["global"].get("num_buckets"))
            per_point.append(s)
    if per_point:
        bw = pd.concat(per_point).sort_values("num_buckets")
        print("\neffective bandwidth (comm-only allreduce schedule):")
        print(bw[["num_buckets", "collective", "group_size", "time_us",
                  "algbw_GBps", "busbw_GBps"]].to_string(index=False))

    # 3. plots (reference plots/plot_dp.py, plots_pareto_energy.py)
    from dlnetbench_tpu_torch.analysis import plots
    names = ("runtime_by_bucket", "barrier_by_bucket", "pareto")
    plt = plots.headless_pyplot()
    if plt is None:
        for name in names:
            print(f"matplotlib is not installed: skipped "
                  f"{args.out_dir}/{name}.png")
        return 0
    fig, ax = plt.subplots(figsize=(6, 4))
    for nb, sub in df.groupby("num_buckets"):
        ax.plot(sub.groupby("run")["runtime"].mean(), marker="o",
                label=f"{nb} buckets")
    ax.set_xlabel("run"), ax.set_ylabel("runtime (us)"), ax.legend()
    fig.savefig(args.out_dir / "runtime_by_bucket.png", dpi=120)

    ax = plots.plot_barrier_scatter_by_bucket(df)
    ax.figure.savefig(args.out_dir / "barrier_by_bucket.png", dpi=120)

    ax = plots.plot_pareto(df, x="runtime", group_by="num_buckets",
                           y="barrier_time")
    ax.figure.savefig(args.out_dir / "pareto.png", dpi=120)

    print(f"\nwrote {args.out_dir}/{{runtime_by_bucket,barrier_by_bucket,"
          f"pareto}}.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
