#!/usr/bin/env python3
"""Interference study — what the `_loop` congestor binaries exist for
(the repo's ``examples/congestion_study.py``, on the port's native
tier).

The reference builds a `_loop` variant of every proxy (infinite run
loop, `-DPROXY_LOOP`, reference Makefile.common:96-109, dp.cpp:251-256)
to generate *sustained* background traffic for interference studies
(SURVEY.md §5.3).  This script runs that study shape end to end on one
machine:

  1. measure the dp proxy as a job of ``--world`` processes (solo
     baseline),
  2. start a dp_loop congestor job of the same shape,
  3. measure dp again under load,
  4. report runtime and exposed-comm (barrier) inflation.

    python -m dlnetbench_tpu_torch.examples.congestion_study \\
        --out_dir /tmp/congestion [--backend tcp|nccl] [--world N]

``--backend tcp`` (the default without a card) runs both jobs over the
TCP fabric, whose frames share the kernel loopback path the way cluster
jobs share fabric links.  ``--backend nccl`` (the default on a card)
runs them over NCCL, one card a process: the measured job on cards
0..N-1 and the congestor on the next N when the host has them (four
cards: two pairs on separate cards, sharing the NVLink switch), else on
the same cards (one card: both jobs' burns and collectives share it).
The world is 2 (JAX's pair) unless the host has one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from dlnetbench_tpu_torch.utils import congest, native_build

REPO = Path(__file__).resolve().parents[2]


def measure(tag: str, out_dir: Path, args, bin_dir: Path, job: dict) -> dict:
    # one record file per process, merged afterwards
    outs = [out_dir / f"{tag}_p{r}.jsonl" for r in range(args.world)]
    for o in outs:
        o.unlink(missing_ok=True)
    procs = congest.launch_pair(
        bin_dir, "dp", args.model, REPO, args.time_scale, args.size_scale,
        extra=["--num_buckets", str(args.num_buckets),
               "--runs", str(args.runs), "--warmup", "1"], outs=outs, **job)
    try:
        for p in procs:
            if p.wait(timeout=600) != 0:
                raise SystemExit(f"{tag}: dp rank exited {p.returncode}")
    finally:
        congest.kill_group(procs)  # reap survivors on any failure
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    from dlnetbench_tpu_torch.metrics.parser import load_records
    merged = merge_records([r for o in outs for r in load_records(o)])
    runtimes = [t for row in merged["ranks"] for t in row["runtimes"]]
    barriers = [t for row in merged["ranks"] for t in row["barrier_time"]]
    out = {"tag": tag,
           "runtime_us": sum(runtimes) / len(runtimes),
           "barrier_us": sum(barriers) / len(barriers),
           "backend": merged["global"]["backend"],
           "transport": merged["global"].get("transport")}
    if job.get("cards") is not None:
        out["cards"] = job["cards"]
    joules = [j for row in merged["ranks"]
              for j in row.get("energy_consumed", [])]
    if joules:
        out["energy_j_per_run"] = sum(joules) / len(joules)
        out["energy_source"] = merged["global"].get("energy_source")
    return out


def card_count() -> int:
    try:
        import torch
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    except ImportError:
        return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out_dir", type=Path, default=Path("/tmp/congestion"))
    ap.add_argument("--model", default="gpt2_l_16_bfloat16")
    ap.add_argument("--num_buckets", type=int, default=4)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--time_scale", type=float, default=1e-3)
    ap.add_argument("--size_scale", type=float, default=3e-3,
                    help="large enough buckets that bandwidth, not "
                         "latency, dominates the allreduce")
    ap.add_argument("--backend", choices=("tcp", "nccl"), default=None,
                    help="tcp (the default without a card) or nccl (the "
                         "default on a card)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of each job (default 2; 1 on a "
                         "one-card host)")
    args = ap.parse_args(argv)
    cards = card_count()
    args.backend = args.backend or ("nccl" if cards else "tcp")
    if args.world is None:
        args.world = 1 if args.backend == "nccl" and cards == 1 else 2
    job: dict = {"backend": args.backend, "world": args.world}
    loop_job = dict(job)
    if args.backend == "nccl":
        if cards < args.world:
            raise SystemExit(f"--backend nccl --world {args.world} needs "
                             f"{args.world} cards; {cards} visible")
        job["cards"] = list(range(args.world))
        loop_job["cards"] = (list(range(args.world, 2 * args.world))
                             if cards >= 2 * args.world else job["cards"])
        job["env"] = loop_job["env"] = native_build.nccl_env()
    try:
        bin_dir = native_build.native_bin(
            REPO, targets=native_build.DEFAULT_TARGETS + ("dp_loop",))
    except Exception as e:
        raise SystemExit(f"could not build the native binaries: {e}")
    args.out_dir.mkdir(parents=True, exist_ok=True)

    solo = measure("solo", args.out_dir, args, bin_dir, job)

    # sustained background traffic: the _loop binary never returns —
    # start it (fresh-port retry inside), measure under load, kill it
    congestors = congest.launch_pair_retry(
        bin_dir, "dp_loop", args.model, REPO, args.time_scale,
        args.size_scale, extra=["--num_buckets", str(args.num_buckets)],
        settle_s=3.0 if args.backend == "nccl" else 1.0, **loop_job)
    try:
        congested = measure("congested", args.out_dir, args, bin_dir, job)
    finally:
        congest.kill_group(congestors)

    report = {
        "solo": solo, "congested": congested,
        "congestor_cards": loop_job.get("cards"),
        "runtime_inflation":
            congested["runtime_us"] / max(solo["runtime_us"], 1e-9),
        "barrier_inflation":
            congested["barrier_us"] / max(solo["barrier_us"], 1e-9),
    }
    if "energy_j_per_run" in solo and "energy_j_per_run" in congested:
        report["energy_inflation"] = (
            congested["energy_j_per_run"]
            / max(solo["energy_j_per_run"], 1e-9))
    (args.out_dir / "report.json").write_text(json.dumps(report, indent=2))
    print(f"backend {args.backend}, world {args.world}"
          + (f", cards {job['cards']} against a congestor on "
             f"{loop_job['cards']}" if "cards" in job else ""))
    print(f"solo:      runtime {solo['runtime_us']:12.1f} us   "
          f"barrier {solo['barrier_us']:10.1f} us")
    print(f"congested: runtime {congested['runtime_us']:12.1f} us   "
          f"barrier {congested['barrier_us']:10.1f} us")
    print(f"inflation: runtime x{report['runtime_inflation']:.2f}   "
          f"barrier x{report['barrier_inflation']:.2f}")
    if "energy_inflation" in report:
        print(f"energy:    solo {solo['energy_j_per_run']:.3f} J/run   "
              f"congested {congested['energy_j_per_run']:.3f} J/run   "
              f"x{report['energy_inflation']:.2f} "
              f"({solo.get('energy_source')})")
    print(f"wrote {args.out_dir}/report.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
