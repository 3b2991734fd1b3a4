"""The native C++ tier across the cards of one host, in both of the nccl
fabric's layouts — one process over the cards (``--procs 1``) and one
process a card (``--procs N``):

1. ``nccl_selftest`` at world N (every op and dtype, e4m3 included);
2. the seven proxies at world N on the pod study's grid points (JAX's
   ``examples/pod_study.py`` shapes at ``--size_scale 0.05
   --time_scale 0.01``), each record's runtime and copies, and the
   bandwidth table of ``analysis/bandwidth.py`` over them;
3. DP's allreduce alone: ``dp`` at ``--time_scale 0`` (no burn, so a
   run is the buckets' allreduces and the wait), both models; bus GB/s
   = the buckets' bytes x 2(N-1)/N over the median runtime, the
   reference's comm-only figure;
4. ``examples/congestion_study.py --world 2``: a measured pair on two
   cards against a ``dp_loop`` pair on two others.

    python -m dlnetbench_tpu_torch.native_cards --out DIR [--cards 4]
        [--parts selftest,proxies,busbw,congestion]

Prints the card's name and power limit first and last, and one line a
run; records and reports land in ``DIR``.  Needs the cards (and builds
the card flavour of ``utils/native_build``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from dlnetbench_tpu_torch.utils import native_build
from dlnetbench_tpu_torch.utils.net import free_port

SIZE_SCALE, TIME_SCALE = 0.05, 0.01


def grid(dense: str, moe: str, world: int) -> list:
    """One pod-study point a proxy (the hybrid_2d schedules and DP on
    both models) at ``world``."""
    return [("dp", {"model": dense, "num_buckets": 4, "d": world}),
            ("dp", {"model": moe, "num_buckets": 4, "d": world}),
            ("fsdp", {"model": dense, "num_units": 8,
                      "sharding_factor": max(world // 2, 1)}),
            *[("hybrid_2d", {"model": dense, "num_stages": world,
                             "num_microbatches": 8, "dp": 1,
                             "schedule": s})
              for s in ("gpipe", "1f1b", "zb")],
            ("hybrid_3d", {"model": dense, "num_stages": max(world // 2, 1),
                           "num_microbatches": 8, "tp": 2, "dp": 1}),
            ("hybrid_3d_moe", {"model": moe, "num_stages":
                               max(world // 2, 1), "num_microbatches": 8,
                               "num_expert_shards": 2, "dp": 1}),
            ("ring_attention", {"model": dense, "sp": world, "dp": 1,
                                "max_layers": 2}),
            ("ulysses", {"model": dense, "sp": world, "dp": 1,
                         "max_layers": 2})]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--parts", default="selftest,proxies,busbw,congestion")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.cards:
        print(f"needs {args.cards} CUDA cards", file=sys.stderr)
        return 2
    from dlnetbench_tpu_torch.analysis.bandwidth import bandwidth_summary
    from dlnetbench_tpu_torch.examples import congestion_study
    from dlnetbench_tpu_torch.examples import pod_study as P
    from dlnetbench_tpu_torch.metrics.parser import load_records
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().replace("\n", " | ")
    print(f"cards: {card}", flush=True)
    t0 = time.perf_counter()
    bin_dir = native_build.native_bin(flavour="cuda")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    env = native_build.nccl_env()
    n = args.cards
    parts = set(args.parts.split(","))
    failed = 0

    # 1. the selftest in both layouts
    for procs in ((1, n) if "selftest" in parts else ()):
        port = free_port()
        t0 = time.perf_counter()
        ps = []
        for r in range(procs):
            argv_r = [str(bin_dir / "nccl_selftest"), "--world", str(n)]
            if procs > 1:
                first, k = P._balanced(n, procs, r)
                argv_r += ["--procs", str(procs), "--rank", str(r),
                           "--coordinator", f"127.0.0.1:{port}",
                           "--devices",
                           ",".join(str(first + i) for i in range(k))]
            ps.append(subprocess.Popen(argv_r, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True,
                                       env=env))
        outs = [p.communicate(timeout=600) for p in ps]
        reps = [json.loads(o.strip().splitlines()[-1]) if o.strip() else {}
                for o, _ in outs]
        ok = all(p.returncode == 0 and rep.get("ok") for p, rep in
                 zip(ps, reps))
        failed += not ok
        print(f"nccl_selftest world {n} procs {procs}: "
              f"{'ok' if ok else 'FAILED'}; checks "
              f"{[rep.get('checks') for rep in reps]}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            for o, e in outs:
                print(o[-1500:], e[-2500:], file=sys.stderr)

    # 2. the proxies in both layouts, and their bandwidth table
    for procs in ((1, n) if "proxies" in parts else ()):
        path = args.out / f"proxies_procs{procs}.jsonl"
        path.unlink(missing_ok=True)
        ns = SimpleNamespace(devices=n, platform="cuda", runs=args.runs,
                             full_scale=False, size_scale=SIZE_SCALE,
                             time_scale=TIME_SCALE, tier="native",
                             backend="nccl", procs=procs)
        t0 = time.perf_counter()
        bad = P.run_native_plan(grid(P.DENSE, P.MOE, n), ns, path)
        failed += bad
        print(f"proxies world {n} procs {procs}: {bad} failed, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        recs = load_records(path) if path.exists() else []
        for rec in recs:
            g = rec["global"]
            rts = sorted(t for row in rec["ranks"] for t in row["runtimes"])
            print(f"  {rec['section']} {g['model']} {g.get('schedule', '')}"
                  f" world {g['world_size']} procs "
                  f"{g.get('num_processes', 1)} transport {g['transport']}:"
                  f" runtime median {rts[len(rts) // 2]:.1f} us, timed "
                  f"copies {g['timed_copies']}, late twins "
                  f"{g['late_twins']}, burn {g['burn_ns_per_iter']:.1f} "
                  f"ns an iteration", flush=True)
        if recs:
            bw = bandwidth_summary(recs)
            cols = [c for c in ("section", "model", "collective",
                                "group_size", "bound", "time_us",
                                "algbw_GBps", "busbw_GBps") if c in bw]
            print(bw[cols].to_string(index=False), flush=True)
            bw.to_csv(args.out / f"bandwidth_procs{procs}.csv", index=False)

    # 3. DP's allreduce alone, both layouts
    for procs in ((1, n) if "busbw" in parts else ()):
        path = args.out / f"dp_comm_procs{procs}.jsonl"
        path.unlink(missing_ok=True)
        ns = SimpleNamespace(devices=n, platform="cuda", runs=5,
                             full_scale=False, size_scale=SIZE_SCALE,
                             time_scale=0.0, tier="native",
                             backend="nccl", procs=procs)
        plan = [("dp", {"model": m, "num_buckets": 4, "d": n})
                for m in (P.DENSE, P.MOE)]
        failed += P.run_native_plan(plan, ns, path)
        for rec in (load_records(path) if path.exists() else []):
            g = rec["global"]
            rts = sorted(t for row in rec["ranks"] for t in row["runtimes"])
            med = rts[len(rts) // 2]
            nbytes = sum(g["bucket_bytes"])
            bus = nbytes * 2 * (n - 1) / n / (med * 1e-6) / 1e9
            print(f"dp allreduce alone, {g['model']}, world {n} procs "
                  f"{procs}: {len(g['bucket_bytes'])} buckets, {nbytes} "
                  f"bytes a rank, runtime median {med:.1f} us: bus "
                  f"{bus:.2f} GB/s (runtimes {rts})", flush=True)

    # 4. two pairs on separate cards
    if "congestion" in parts:
        t0 = time.perf_counter()
        rc = congestion_study.main(["--out_dir",
                                    str(args.out / "congestion"),
                                    "--runs", "10", "--world", "2"])
        failed += rc != 0
        print(f"congestion_study rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"cards: {card}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
