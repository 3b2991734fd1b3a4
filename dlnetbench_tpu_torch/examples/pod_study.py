"""North-star pod study — every proxy workload on llama3_70b + mixtral,
one command producing the effective-bandwidth table and the three plot
families (the repo's ``examples/pod_study.py``, its Python tier, on the
port; reference BASELINE.md's "effective bus GB/s + iter time per
collective").

The reference runs this as a SLURM grid (sbatchman) over
dp/fsdp/hybrid_3d/hybrid_3d_moe and parses the job outputs back into
DataFrames (reference plots/parser.py:213-256).  Here it is one
command on the cards of one host:

    python -m dlnetbench_tpu_torch.examples.pod_study \\
        --out_dir /tmp/pod_study --devices 4 [--platform cuda|cpu]

runs all 7 proxies (dp, fsdp, hybrid_2d/3d/3d-moe, ring_attention,
ulysses) at reduced buffer/time scale (``--full_scale``: none), then
prints per-collective effective bandwidth and writes
bandwidth_summary.csv and scaling / barrier-scatter / Pareto PNGs.
Every point is a fresh ``python -m torch.distributed.run
--nproc_per_node <world> -m dlnetbench_tpu_torch.cli <proxy>`` (NCCL
on the cards, gloo with ``--platform cpu``), tagged ``proxy=<name>``
so the combined records file stays one flat, parseable study.  The
world is the point's ``d`` on the DP scaling axis and ``--devices``
otherwise; the port's ``cli`` takes its world from the launcher and
refuses ``-d``, so ``d`` is the process count and never a flag.

The other modes, each into ``--out_dir``:

* ``--serving`` (with ``--disagg`` or ``--fleet``): capacity
  calibration, the offered-load sweep and a straggler point, each a
  ``cli serve`` process, then the knee and straggler verdicts and
  serving_summary.csv.  Every point pins ``--attn_impl gather`` on
  both platforms: the study's model has head_dim 16, which the card's
  paged-attention kernels K1/K2 do not take (multiples of 32), and on
  the CPU gather is what the JAX study's ``auto`` runs.
* ``--kv_density``: the bench's ``kv_density_ab`` line on the study's
  device, then the prefix-sharing A/B through ``run_serving`` /
  ``Engine``; it fails unless the acceptance bars hold.
* ``--fault``: the straggler (fsdp, world 4), crash + shrink (dp,
  world 3) and preempt + rejoin (dp, world 3) points through the
  port's own ``cli`` under ``torch.distributed.run`` where the JAX
  study drives the native binaries, then the seeded goodput sweep (dp
  at world ``--devices``, npz stall checkpoints) and the Daly verdict.
  The drop + retry point (3) needs a frame layer, which the Python
  tier does not have: it runs on the port's native TCP fabric, two
  ``dp`` processes, as JAX's study runs it.  Under ``shrink`` the dead
  rank is a bystander process that exits 0 and rank 0 writes the
  degraded record, so the crash point checks that record's
  ``degraded_world``.

``--tier native`` runs the grid on the port's C++ binaries
(``dlnetbench_tpu_torch/native/``, built by ``utils/native_build``),
one binary a point with an explicit ``--world``: ``--backend shm``
(threads of one process, ``--platform cpu``) or ``--backend nccl``
(NCCL on the cards, ``--platform cuda``; the seat of JAX's
``pjrt-hier``), with ``--procs`` OS processes a point, each on its
balanced share of the cards, their records merged.  ``--congest`` runs
a ``dp_loop`` congestor job (``--congest_model``) for the whole sweep:
over TCP beside an shm sweep, over NCCL beside an nccl sweep (on the
cards after the study's when the host has them).

``--report_only`` re-analyzes an existing ``records.jsonl``.  Where
matplotlib is not installed (the card machine), a study prints its
tables, writes its CSVs and JSON, and names each PNG it skipped.
``--platform`` is ``cuda`` unless the caller asks for ``cpu``; without a
card, ``cuda`` is an error.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from dlnetbench_tpu_torch.utils import native_build
from dlnetbench_tpu_torch.utils.net import free_port

REPO = Path(__file__).resolve().parents[2]
CLI = "dlnetbench_tpu_torch.cli"

DENSE = "llama3_70b_16_bfloat16"
MOE = "mixtral_8x7b_16_bfloat16"


def build_plan(models: list[str], devices: int) -> list[tuple[str, dict]]:
    """(proxy, flags) for every study point.

    Grid shapes mirror the reference's study configurations scaled to the
    available world size: dp scaling over world sizes and bucket counts
    (reference plots/plot_dp.py:29, :80), fsdp with hybrid sharding
    (sharding_factor x replicas = world, reference
    cpp/data_parallel/fsdp.cpp:217), the three hybrids on stagexdp(xtp/ep)
    grids (reference cpp/hybrid_parallel/*.cpp), and the two
    sequence-parallel extensions on sp x dp grids.
    """
    half = max(devices // 2, 1)
    quarter = max(devices // 4, 1)
    plan: list[tuple[str, dict]] = []

    for model in models:
        # dp runtime scaling over world sizes (last point = full world)
        w = devices
        worlds = []
        while w >= 2:
            worlds.append(w)
            w //= 2
        for w in sorted(worlds):
            plan.append(("dp", {"model": model, "num_buckets": 4, "d": w}))
        # dp bucket study at full world (barrier-scatter axis)
        for nb in (2, 8):
            plan.append(("dp", {"model": model, "num_buckets": nb,
                                "d": devices}))
        plan.append(("fsdp", {"model": model, "num_units": 8,
                              "sharding_factor": half}))
        # pipeline-schedule comparison: reference GPipe vs the rebuild's
        # 1F1B and ZB-H1 extras, same grid and microbatch totals
        for sch in ("gpipe", "1f1b", "zb"):
            plan.append(("hybrid_2d", {"model": model, "num_stages": 4,
                                       "num_microbatches": 8,
                                       "dp": quarter, "schedule": sch}))
        plan.append(("hybrid_3d", {"model": model, "num_stages": 2,
                                   "num_microbatches": 8, "tp": 2,
                                   "dp": quarter}))
        if model == MOE:
            plan.append(("hybrid_3d_moe", {"model": model, "num_stages": 2,
                                           "num_microbatches": 8,
                                           "num_expert_shards": 2,
                                           "dp": quarter}))
        plan.append(("ring_attention", {"model": model, "sp": 4,
                                        "dp": quarter, "max_layers": 2}))
        plan.append(("ulysses", {"model": model, "sp": 4, "dp": quarter,
                                 "max_layers": 2}))
    return plan


def _env() -> dict:
    """This environment, with the checkout on PYTHONPATH: every point is
    a fresh process that imports the package from it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def _launch(world: int) -> list[str]:
    """The argv prefix before ``-m <module>``: the interpreter alone at
    world 1 (a process started alone is world 1), else
    ``torch.distributed.run`` with ``world`` ranks on a free port."""
    if world <= 1:
        return [sys.executable]
    return [sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", str(world), "--master_port",
            str(free_port())]


def run_plan(plan, args, records: Path) -> int:
    if getattr(args, "tier", "jax") == "native":
        return run_native_plan(plan, args, records)
    env = _env()
    failed = 0
    for i, (proxy, flags) in enumerate(plan):
        desc = " ".join(f"{k}={v}" for k, v in flags.items())
        flags = dict(flags)
        # the dp scaling axis "d" IS the world; cli takes it from the
        # launcher, never as a flag
        world = int(flags.pop("d", args.devices))
        argv = _launch(world) + [
            "-m", CLI, proxy, "--out", str(records),
            "--platform", args.platform, "-r", str(args.runs), "-w", "1",
            "--no_topology", "--tag", f"proxy={proxy}"]
        if not args.full_scale:
            argv += ["--size_scale", str(args.size_scale),
                     "--time_scale", str(args.time_scale)]
        for k, v in flags.items():
            argv += [f"--{k}", str(v)]
        print(f"[{i + 1}/{len(plan)}] {proxy} {desc} (world {world})",
              flush=True)
        rc = subprocess.run(argv, env=env,
                            stdout=subprocess.DEVNULL).returncode
        if rc != 0:
            print(f"  FAILED rc={rc}", file=sys.stderr)
            failed += 1
    return failed


def run_native_plan(plan, args, records: Path) -> int:
    """The grid on the native binaries: JAX's ``--tier native`` argv
    (explicit ``--world``; the dp scaling axis ``d`` is the world), with
    ``--backend nccl`` (and ``--procs``) on the cards."""
    try:  # built on first use; the tree's hash covers the sources
        bin_dir = native_build.native_bin(REPO)
    except Exception as e:
        raise SystemExit(f"--tier native could not build: {e}")
    env = native_build.nccl_env() if args.backend == "nccl" else _env()
    failed = 0
    for i, (proxy, flags) in enumerate(plan):
        desc = " ".join(f"{k}={v}" for k, v in flags.items())
        flags = dict(flags)
        world = flags.pop("d", args.devices)
        argv = [str(bin_dir / proxy), "--model", flags.pop("model"),
                "--world", str(world), "--out", str(records),
                "--runs", str(args.runs), "--warmup", "1",
                "--no_topology", "--base_path", str(REPO)]
        if not args.full_scale:
            argv += ["--size_scale", str(args.size_scale),
                     "--time_scale", str(args.time_scale)]
        for k, v in flags.items():
            argv += [f"--{k}", str(v)]
        print(f"[{i + 1}/{len(plan)}] {proxy} {desc}", flush=True)
        if args.backend == "nccl" and args.procs > 1:
            rc = _run_procs_point(argv, world, records, env, args.procs)
        else:
            if args.backend == "nccl":
                argv += ["--backend", "nccl"]
            rc = subprocess.run(argv, env=env,
                                stdout=subprocess.DEVNULL).returncode
        if rc != 0:
            print(f"  FAILED rc={rc}", file=sys.stderr)
            failed += 1
    return failed


def _balanced(world: int, procs: int, p: int) -> tuple[int, int]:
    """(first rank, ranks) of process ``p`` in the native tier's
    balanced layout (native/include/dlnb/schedule.hpp)."""
    base, rem = divmod(world, procs)
    return p * base + min(p, rem), base + (1 if p < rem else 0)


def _run_procs_point(argv: list[str], world, records: Path, env,
                     nprocs: int) -> int:
    """One point over ``nprocs`` OS processes of the nccl fabric, each
    on its balanced share of the cards, their per-process records merged
    into the study's stream (JAX's ``_run_hier_point``, NCCL in the
    PJRT hierarchy's seat).  Nonzero for any per-point failure."""
    if int(world) < nprocs:
        print(f"  skipped (world {world} < {nprocs} processes)",
              file=sys.stderr)
        return 0
    base = [a for j, a in enumerate(argv)
            if argv[j - 1] != "--out" and a != "--out"]
    parts = [records.parent / f".procs_p{r}.jsonl" for r in range(nprocs)]
    for attempt in range(3):
        for p in parts:
            p.unlink(missing_ok=True)
        port = free_port()
        procs = []
        for r in range(nprocs):
            first, n = _balanced(int(world), nprocs, r)
            procs.append(subprocess.Popen(
                base + ["--backend", "nccl", "--procs", str(nprocs),
                        "--rank", str(r), "--coordinator",
                        f"127.0.0.1:{port}", "--devices",
                        ",".join(str(first + i) for i in range(n)),
                        "--out", str(parts[r])],
                env=env, stdout=subprocess.DEVNULL))
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=900))
            except subprocess.TimeoutExpired:
                rcs.append(124)
        if any(rcs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(rc == 0 for rc in rcs):
            break
        if attempt == 2:
            return next((abs(rc) for rc in rcs if rc != 0), 1)
    from dlnetbench_tpu_torch.metrics.merge import merge_files
    try:
        merge_files(records, parts)
    except ValueError as e:
        print(f"  merge failed: {e}", file=sys.stderr)
        return 1
    finally:
        for p in parts:
            p.unlink(missing_ok=True)
    return 0


# ---------------------------------------------------------------------
# --serving mode: the latency-vs-offered-load study (docs/SERVING.md).
# Offered load is swept as a FRACTION of this machine's measured
# capacity (a saturating calibration run first), so the knee lands
# inside the sweep on any box; each load point runs SERVING_SEEDS
# arrival-plan seeds and the report bands p99/goodput over them.  One
# extra point injects a straggler delay into the decode loop at
# SERVING_FAULT_FRAC of capacity — the fault-composition proof: the
# same fault-plan JSON that drives the training tier measurably
# inflates serving p99.

SERVING_FRACTIONS = (0.25, 0.5, 1.0, 1.5, 2.0)
# 5 seeds per load point: each point's p99 is the MEDIAN over seeds
# with the full band shown — on a small shared box a single co-tenant
# stall lands squarely in one run's nearest-rank p99, and 3 seeds give
# that outlier veto power over the knee shape
SERVING_SEEDS = (0, 1, 2, 3, 4)
# long enough that sustained overload accumulates a real backlog: at
# 2x capacity the LAST arrival waits ~half the arrival span, so the
# span must dwarf a single request's clean service time or the queue
# never shows in p99
SERVING_REQUESTS = 120
SERVING_FLAGS = [
    "--slots", "4", "--page_size", "8", "--num_pages", "64",
    "--max_seq_len", "64", "--embed", "64", "--heads", "4",
    "--kv_heads", "2", "--ff", "128", "--layers", "2", "--vocab", "256",
    "--slo_ttft_ms", "100", "--slo_tpot_ms", "30",
]
SERVING_FAULT_DELAY_US = 20000  # straggler sleep per engine step
# the straggler point's load (a fraction the sweep also runs: the
# report holds it against that fraction's clean p99)
SERVING_FAULT_FRAC = 0.5
# head_dim 16 (embed 64 over 4 heads): K1/K2 take multiples of 32, so
# every point runs the gather attention, on the card and on the CPU
SERVING_ATTN = ["--attn_impl", "gather"]


def serving_arrival(rate: float, seed: int,
                    n: int = SERVING_REQUESTS) -> str:
    return json.dumps({"kind": "poisson", "rate_rps": round(rate, 3),
                       "num_requests": n, "seed": seed,
                       "prompt_len": [8, 16], "output_len": [4, 8]})


# --disagg: the same sweep over the disaggregated engine — the prefill
# and decode devices split the two capacity ranks, KV pages migrate in
# the stored dtype, and the report's serving_summary carries the
# migration_* columns next to the latency bands
DISAGG_FLAGS = [
    "--disaggregate", "--world", "2", "--prefill_ranks", "1",
    "--decode_ranks", "1", "--multi_step_n", "4",
]

# --fleet: the same sweep over a two-replica FLEET — the seeded router
# places every arrival (p2c on the live load score), each replica keeps
# its own page pool, and the report's serving_summary carries the
# fleet_routing/fleet_replicas/fleet_goodput_per_chip_s columns next to
# the latency bands.  Capacity doubles (2 engines), so the same
# calibrate-then-sweep protocol finds this arm's own knee.
FLEET_FLAGS = [
    "--replicas", "2", "--routing", "p2c",
]


def _serve_argv(records: Path, arrival: str, tags: list[str],
                extra: list[str] | None = None, *,
                platform: str = "cuda") -> list:
    argv = [sys.executable, "-m", CLI, "serve",
            "--arrival", arrival, "--platform", platform,
            "--out", str(records)] + SERVING_FLAGS + SERVING_ATTN \
        + (extra or [])
    for t in tags:
        argv += ["--tag", t]
    return argv


def run_serving_plan(args, records: Path) -> int:
    from dlnetbench_tpu_torch.metrics.parser import load_records

    env = _env()
    failed = 0
    if args.disagg:
        extra, eng = DISAGG_FLAGS, "disagg"
    elif args.fleet:
        extra, eng = FLEET_FLAGS, "fleet"
    else:
        extra, eng = None, "mono"
    eng_tag = f"engine={eng}"
    print(f"serving points: {' '.join(SERVING_ATTN)} on --platform "
          f"{args.platform} (head_dim 16: the paged-attention kernels "
          f"K1/K2 take multiples of 32)", flush=True)

    def serve(arrival, tags, fault=None):
        argv = _serve_argv(records, arrival, tags + [eng_tag], extra,
                           platform=args.platform)
        if fault:
            argv += ["--fault", fault]
        return subprocess.run(argv, env=env,
                              stdout=subprocess.DEVNULL).returncode

    # 1. capacity calibration: a saturating rate (every request queued
    # at t~0) — measured_rps IS the engine's drain capacity here
    calib = records.parent / ".serving_calib.jsonl"
    calib.unlink(missing_ok=True)
    print("[serving 0] capacity calibration (saturating arrivals)",
          flush=True)
    rc = subprocess.run(
        _serve_argv(calib, serving_arrival(10000.0, 0, SERVING_REQUESTS),
                    ["load_frac=calib", eng_tag], extra,
                    platform=args.platform),
        env=env, stdout=subprocess.DEVNULL).returncode
    if rc != 0 or not calib.exists():
        raise SystemExit(f"serving calibration failed rc={rc}")
    capacity = load_records(calib)[0]["global"]["serving"]["measured_rps"]
    calib.unlink(missing_ok=True)
    print(f"  capacity ~{capacity:.1f} req/s on this box", flush=True)

    # 2. the load sweep: fractions of capacity x arrival seeds
    n_pts = len(SERVING_FRACTIONS) * len(SERVING_SEEDS)
    for i, frac in enumerate(SERVING_FRACTIONS):
        for seed in SERVING_SEEDS:
            print(f"[serving {i + 1}/{len(SERVING_FRACTIONS)}] "
                  f"load {frac:.2f}x capacity, seed {seed} "
                  f"({n_pts} runs total)", flush=True)
            rc = serve(serving_arrival(capacity * frac, seed,
                                       SERVING_REQUESTS),
                       [f"load_frac={frac}", f"serving_seed={seed}"])
            if rc != 0:
                print(f"  FAILED frac={frac} seed={seed} rc={rc}",
                      file=sys.stderr)
                failed += 1

    # 3. the faulted point: a straggler delay on every decode-loop step
    # — same FaultPlan JSON as the training tier
    fault = json.dumps({"events": [{
        "kind": "delay", "iteration": 0,
        "magnitude_us": SERVING_FAULT_DELAY_US}]})
    print(f"[serving fault] {SERVING_FAULT_FRAC:.2f}x capacity + "
          f"{SERVING_FAULT_DELAY_US / 1000:.0f} ms straggler per "
          f"decode step", flush=True)
    rc = serve(serving_arrival(capacity * SERVING_FAULT_FRAC, 0,
                               SERVING_REQUESTS),
               [f"load_frac={SERVING_FAULT_FRAC}",
                "serving_fault=straggler"], fault)
    if rc != 0:
        print("  FAILED", file=sys.stderr)
        failed += 1
    return failed


def serving_report(args, records: Path) -> int:
    """The latency-vs-load table with stat bands over seeds, the knee
    verdict, and the straggler-composition verdict — enforced at
    generation time like the goodput study's Daly check."""
    from dlnetbench_tpu_torch.analysis.bandwidth import serving_summary
    from dlnetbench_tpu_torch.metrics.parser import load_records
    from dlnetbench_tpu_torch.metrics.stats import summarize

    recs = load_records(records)
    rows = []
    for rec in recs:
        g = rec.get("global", {})
        srv = g.get("serving")
        if not srv:
            continue
        v = g.get("variables", {})
        rows.append({
            "frac": v.get("load_frac", "?"),
            "fault": v.get("serving_fault", "-"),
            "offered_rps": srv["offered_rps"],
            "p99_ms": srv["e2e_ms"]["p99"],
            "ttft_p99_ms": srv["ttft_ms"]["p99"],
            "goodput_frac": srv["goodput_frac"],
            "goodput_rps": srv["goodput_rps"],
        })
    clean = {}
    for r in rows:
        if r["fault"] == "-":
            clean.setdefault(r["frac"], []).append(r)
    print("\n=== serving: latency vs offered load (bands over "
          f"{len(SERVING_SEEDS)} arrival seeds) ===")
    print(f"{'load':>6} {'offered_rps':>12} {'p99_ms':>24} "
          f"{'ttft_p99_ms':>24} {'goodput@SLO':>22}")
    by_frac = {}
    for frac in sorted(clean, key=lambda f: float(f)):
        pts = clean[frac]
        p99 = summarize([p["p99_ms"] for p in pts], ndigits=3)
        ttft = summarize([p["ttft_p99_ms"] for p in pts], ndigits=3)
        good = summarize([p["goodput_frac"] for p in pts], ndigits=4)
        offered = sum(p["offered_rps"] for p in pts) / len(pts)
        by_frac[float(frac)] = (p99, good)
        print(f"{frac:>6} {offered:>12.1f} "
              f"{p99['value']:>10.1f} {str(p99['band']):>13} "
              f"{ttft['value']:>10.1f} {str(ttft['band']):>13} "
              f"{good['value']:>8.2f} {str(good['band']):>13}")
    rc = 0
    if by_frac:
        lo, hi = min(by_frac), max(by_frac)
        knee = by_frac[hi][0]["value"] / max(by_frac[lo][0]["value"],
                                             1e-9)
        print(f"\nknee: p99({hi}x) / p99({lo}x) = {knee:.1f}x, "
              f"goodput@SLO {by_frac[lo][1]['value']:.2f} -> "
              f"{by_frac[hi][1]['value']:.2f}")
        if knee < 2.0:
            print("VERDICT: no visible saturation knee (p99 inflation "
                  "< 2x across the sweep) — the study failed its "
                  "acceptance bar", file=sys.stderr)
            rc = 1
    faulted = [r for r in rows if r["fault"] != "-"]
    if faulted:
        base = clean.get(faulted[0]["frac"], [])
        base_p99 = (summarize([p["p99_ms"] for p in base])["value"]
                    if base else float("nan"))
        f_p99 = faulted[0]["p99_ms"]
        print(f"straggler composition: clean p99 {base_p99:.1f} ms -> "
              f"faulted p99 {f_p99:.1f} ms at load "
              f"{faulted[0]['frac']}x "
              f"(+{SERVING_FAULT_DELAY_US / 1000:.0f} ms/step delay)")
        if not f_p99 > base_p99:
            print("VERDICT: injected straggler did NOT inflate p99 — "
                  "fault composition broke", file=sys.stderr)
            rc = 1
    ss = serving_summary(recs)
    if not ss.empty:
        ss.to_csv(args.out_dir / "serving_summary.csv", index=False)
        print(f"\nwrote {records} and "
              f"{args.out_dir}/serving_summary.csv")
    return rc


# ---------------------------------------------------------------------
# --kv_density mode: the serving-density study (docs/SERVING.md "Cache
# density").  Two halves into one artifact dir:
#
#   1. capacity A/B — the bench's kv_density_ab line: dense vs int8 vs
#      fp8 paged-KV engines at the SAME pool bytes (scale arrays priced
#      in), one seeded saturating plan, interleaved rounds.  Acceptance
#      (enforced HERE, at generation): both quant recipes inside their
#      stated decode-parity bars, admitted concurrency >= 1.8x dense,
#      and the goodput-at-SLO win band-DISJOINT.
#   2. prefix-sharing A/B — one prefix-heavy arrival plan (seeded
#      shared system prompts, serving/arrivals.py shared_prefix_len/
#      prefix_pool) run through the SAME engine with sharing off/on:
#      token-identical streams (lossless), prefix_hit_rate > 0 and
#      bytes_saved > 0 stamped on the sharing record, TTFT deltas
#      reported.

KV_DENSITY_MIN_CAPACITY_X = 1.8


def kv_capacity_ab(out_dir: Path, device) -> int:
    """Half 1: the bench's ``kv_density_ab`` line on ``device`` into
    ``out_dir/kv_density_ab.json``; non-zero unless its bars hold."""
    import torch

    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.metrics.stats import bands_overlap

    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rc = 0
    line = bench.bench_kv_density(name, device)
    (out_dir / "kv_density_ab.json").write_text(
        json.dumps(line, indent=1) + "\n")
    base = line["variants"]["bf16"]
    disjoint_wins = []
    for cd in ("int8", "fp8"):
        v = line["variants"][cd]
        cap = v["capacity_x"]["value"]
        disjoint = (bands_overlap(base["goodput_rps"]["band"],
                                  v["goodput_rps"]["band"]) is False
                    and v["goodput_rps"]["value"]
                    > base["goodput_rps"]["value"])
        disjoint_wins.append((cd, disjoint))
        print(f"  {cd}: parity {v['parity_max_err']['value']:.4f} "
              f"(tol {v['parity_tol']}, ok={v['parity_ok']}), "
              f"capacity {cap:.2f}x, goodput@SLO "
              f"{base['goodput_rps']['value']:.1f} -> "
              f"{v['goodput_rps']['value']:.1f} rps "
              f"(band-disjoint={disjoint})")
        # parity + the >= 1.8x capacity bar gate BOTH recipes
        if not v["parity_ok"]:
            print(f"VERDICT: {cd} decode parity exceeded its stated "
                  f"bar", file=sys.stderr)
            rc = 1
        if cap < KV_DENSITY_MIN_CAPACITY_X:
            print(f"VERDICT: {cd} admitted concurrency {cap:.2f}x < "
                  f"{KV_DENSITY_MIN_CAPACITY_X}x at equal pool bytes",
                  file=sys.stderr)
            rc = 1
    # the band-disjoint goodput-at-SLO win gates the recipe a
    # deployment would actually pick; the other recipe's number is still
    # written down above
    if not any(d for _, d in disjoint_wins):
        print("VERDICT: no quant recipe shows a band-disjoint "
              "goodput-at-SLO win vs dense at equal pool bytes",
              file=sys.stderr)
        rc = 1
    return rc


def prefix_sharing_ab(out_dir: Path, device) -> tuple[int, dict]:
    """Half 2: the prefix-heavy plan through one engine config with
    sharing off and on, records into ``out_dir/records.jsonl`` and the
    summary into ``out_dir/prefix_sharing_ab.json``; returns (rc,
    summary), rc non-zero unless sharing is lossless and measured."""
    import dataclasses

    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig,
                                                        run_serving)
    mc = TransformerConfig(
        vocab_size=256, embed_dim=64, num_heads=4, num_kv_heads=2,
        ff_dim=128, num_layers=2, seq_len=96, gated=True,
        max_positions=0, dtype="float32")
    # page-aligned 32-token system prompt over a 2-prompt pool; the
    # prefill chunk divides the prefix so shared/unshared runs chunk
    # the unshared tail identically (the bit-exactness precondition
    # docs/SERVING.md states)
    plan = ArrivalPlan(kind="poisson", rate_rps=400.0,
                       num_requests=40, seed=0,
                       prompt_len=[40, 56], output_len=[8, 16],
                       shared_prefix_len=32, prefix_pool=2)
    base_cfg = ServingConfig(slots=6, page_size=8, num_pages=96,
                             max_seq_len=96, prefill_chunk=8,
                             slo_ttft_ms=250.0, slo_tpot_ms=100.0,
                             attn_impl="gather")
    params = init_params(mc, seed=0, device=device)
    records = out_dir / "records.jsonl"
    records.unlink(missing_ok=True)
    cfgs = (("off", base_cfg),
            ("on", dataclasses.replace(base_cfg, prefix_sharing=True)))
    results = {}
    for tag, cfg in cfgs:
        res = run_serving(mc, cfg, plan, params=params, device=device)
        res.global_meta.setdefault("variables", {})["prefix_sharing"] \
            = tag
        rec = emit_result(res, path=records)
        results[tag] = rec["global"]
    # losslessness: re-run both engines capturing token streams
    streams = {}
    for tag, cfg in cfgs:
        eng = Engine(mc, cfg, params=params, device=device)
        eng.run(plan.sample())
        streams[tag] = dict(eng.token_streams)
    lossless = streams["on"] == streams["off"]
    srv_off = results["off"]["serving"]
    srv_on = results["on"]["serving"]
    hit_rate = results["on"].get("prefix_hit_rate", 0.0)
    bytes_saved = results["on"].get("prefix_bytes_saved", 0)
    summary = {
        "lossless": lossless,
        "prefix_hit_rate": hit_rate,
        "prefix_bytes_saved": bytes_saved,
        "ttft_p50_ms": {"off": srv_off["ttft_ms"]["p50"],
                        "on": srv_on["ttft_ms"]["p50"]},
        "ttft_p99_ms": {"off": srv_off["ttft_ms"]["p99"],
                        "on": srv_on["ttft_ms"]["p99"]},
        "e2e_p99_ms": {"off": srv_off["e2e_ms"]["p99"],
                       "on": srv_on["e2e_ms"]["p99"]},
        "plan": plan.to_dict(),
    }
    (out_dir / "prefix_sharing_ab.json").write_text(
        json.dumps(summary, indent=1) + "\n")
    print(f"  lossless={lossless} hit_rate={hit_rate} "
          f"bytes_saved={bytes_saved} ttft_p50 "
          f"{srv_off['ttft_ms']['p50']:.1f} -> "
          f"{srv_on['ttft_ms']['p50']:.1f} ms")
    rc = 0
    if not lossless:
        print("VERDICT: prefix sharing changed the token streams — "
              "sharing must be lossless", file=sys.stderr)
        rc = 1
    if not (hit_rate > 0 and bytes_saved > 0):
        print("VERDICT: prefix-heavy plan produced no measured "
              "sharing (hit_rate/bytes_saved)", file=sys.stderr)
        rc = 1
    return rc, summary


def run_kv_density_study(out_dir: Path, device) -> int:
    """Both halves into ``out_dir`` on ``device``; returns non-zero
    unless the acceptance bars hold."""
    print("[kv_density 1/2] capacity A/B (dense vs int8 vs fp8 at "
          "equal pool bytes)", flush=True)
    rc = kv_capacity_ab(out_dir, device)
    print("[kv_density 2/2] prefix sharing A/B (shared system "
          "prompt, sharing off vs on)", flush=True)
    return prefix_sharing_ab(out_dir, device)[0] or rc


# ---------------------------------------------------------------------
# --fault mode: the fault-injection & elastic-degradation study
# (docs/RESILIENCE.md).  Points into ONE records.jsonl, each a
# ``cli`` world under torch.distributed.run (the JAX study runs points
# 1-4 on the native binaries):
#   1. straggler  — fsdp world 4, a 30 ms delay on rank 2 from step 4
#                   on: the clean window is the in-record baseline, the
#                   summary reports straggler_amp and refuses busbw on
#                   the faulted runs;
#   2. crash      — dp world 3, rank 1 dies at step 4 under policy
#                   `shrink`: the survivors finish in a group of their
#                   own, the dead rank's process is a bystander that
#                   exits 0, and rank 0 writes the degraded record
#                   (detection_ms/recovery_ms/degraded_world);
#   3. drop       — dp over 2 TCP processes of the port's native tier
#                   (the frame layer the Python tier lacks) at 20 %
#                   injected frame loss under policy `retry`: the run
#                   completes, backoff counts ride the record;
#   4. preempt    — dp world 3, rank 2 evicted (20 ms grace) and back
#                   4 steps later: the full world restored, rejoin_ms;
#   5. goodput    — the seeded goodput-vs-interval sweep the Daly model
#                   is validated against.

FAULT_MODEL = "gpt2_l_16_bfloat16"

# the seeded goodput sweep (point 5): checkpoint intervals x seeds; each
# seed draws its own preempt trigger, so the triggers are the "failure
# arrivals" the exponential-MTBF fit treats as draws (analysis/goodput)
ELASTIC_INTERVALS = (1, 2, 4, 8)
ELASTIC_SEEDS = (0, 1, 2)
ELASTIC_RUNS = 16  # measured steps per sweep run (+1 warmup)


def elastic_plan(seed: int, *, warmup: int = 1) -> dict:
    """The seeded preempt -> rejoin plan of one sweep run: rank 2 is
    evicted at a seed-drawn step (grace 20 ms) and returns 4 steps
    later.  Deterministic given the seed — the sweep is replayable."""
    import random
    rng = random.Random(seed)
    pre = warmup + 4 + rng.randrange(5)  # plan steps 5..9
    return {"policy": "shrink", "events": [
        {"kind": "preempt", "ranks": [2], "iteration": pre,
         "magnitude_us": 20000, "seed": seed},
        {"kind": "rejoin", "ranks": [2], "iteration": pre + 4}]}


def _fault_base(platform: str, runs: int = 6) -> list[str]:
    return ["--model", FAULT_MODEL, "--platform", platform,
            "--time_scale", "0.001", "--size_scale", "0.0001",
            "--runs", str(runs), "--warmup", "1", "--no_topology"]


def _fault_point(argv: list[str], world: int, part: Path, env) -> int:
    """One fault point: ``cli`` ``argv`` at ``world`` ranks, rank 0's
    record into ``part`` (removed first); the exit code."""
    part.unlink(missing_ok=True)
    return subprocess.run(
        _launch(world) + ["-m", CLI] + argv + ["--out", str(part)],
        env=env, stdout=subprocess.DEVNULL, timeout=900).returncode


def _take_record(records: Path, part: Path) -> dict | None:
    """Append ``part``'s one record to ``records``; the record, or None
    (said on stderr) when ``part`` does not hold exactly one."""
    from dlnetbench_tpu_torch.metrics.parser import load_records
    try:
        text = part.read_text()
        recs = load_records(part)
    except (OSError, ValueError) as e:
        print(f"  no record: {e}", file=sys.stderr)
        return None
    finally:
        part.unlink(missing_ok=True)
    if len(recs) != 1:
        print(f"  expected one record, found {len(recs)}",
              file=sys.stderr)
        return None
    with open(records, "a") as f:
        f.write(text if text.endswith("\n") else text + "\n")
    return recs[0]


def run_fault_plan(args, records: Path) -> int:
    env = _env()
    base = _fault_base(args.platform)
    failed = 0
    print("fault points 1-4 run the port's cli under "
          "torch.distributed.run (the JAX study drives the native "
          "binaries there)", flush=True)

    # 1. straggler (fsdp declares a comm_model, so the faulted busbw
    # refusal + straggler_amp surface in the bandwidth table)
    plan = json.dumps({"events": [{"kind": "delay", "ranks": [2],
                                   "iteration": 4,
                                   "magnitude_us": 30000}]})
    print("[fault 1/5] straggler: fsdp world 4, 30 ms delay on rank 2 "
          "from step 4", flush=True)
    part = records.parent / ".fault_p.jsonl"
    rc = _fault_point(["fsdp", "--num_units", "4", "--sharding_factor",
                       "2", "--fault", plan] + base, 4, part, env)
    if rc != 0 or _take_record(records, part) is None:
        print(f"  FAILED rc={rc}", file=sys.stderr)
        failed += 1

    # 2. rank crash + shrink (rank 1 is the victim): every process exits
    # 0 — the victim as a bystander — and rank 0 writes the survivors'
    # degraded record
    plan = json.dumps({"events": [{"kind": "crash", "ranks": [1],
                                   "iteration": 4}]})
    print("[fault 2/5] crash+shrink: dp world 3, rank 1 dies at step 4, "
          "survivors regroup (the dead rank a bystander; rank 0 writes "
          "the degraded record)", flush=True)
    rc = _fault_point(["dp", "--num_buckets", "2", "--fault", plan,
                       "--fault_policy", "shrink"] + base, 3, part, env)
    rec = _take_record(records, part) if rc == 0 else None
    # the survivors' ranks, the victim's gone (the JAX study's merged
    # record says the same)
    degraded = (rec or {}).get("global", {}).get("degraded_world")
    if degraded != [0, 2]:
        print(f"  FAILED rc={rc} degraded_world={degraded}",
              file=sys.stderr)
        failed += 1

    # 3. drop + retry (the native tier's TCP fabric, 2 processes, 20 %
    # loss with backoff)
    failed += _drop_point(records)

    # 4. preempt + rejoin: rank 2 is gracefully evicted (20 ms drain),
    # the survivors run degraded, and the full world is restored 4
    # steps later — rejoin_ms measures the grow half
    plan = json.dumps(elastic_plan(0, warmup=1))
    print("[fault 4/5] preempt+rejoin: dp world 3, rank 2 evicted "
          "(20 ms grace), rejoins 4 steps later — full world restored",
          flush=True)
    rc = _fault_point(["dp", "--num_buckets", "2", "--fault", plan,
                       "--fault_policy", "shrink"]
                      + _fault_base(args.platform, runs=ELASTIC_RUNS),
                      3, part, env)
    if rc != 0 or _take_record(records, part) is None:
        print(f"  FAILED rc={rc}", file=sys.stderr)
        failed += 1

    # 5. the seeded goodput-vs-interval sweep (the checkpoint subsystem):
    # the full preempt -> drain-save -> restore -> shrink -> rejoin arc
    # at every checkpoint interval x seed, each a fresh world of
    # --devices ranks, stall-mode npz saves (the whole durable write on
    # the timed path — the Daly model's d).  fault_report fits the model
    # and verdicts measured-vs-predicted.
    n_pts = len(ELASTIC_INTERVALS) * len(ELASTIC_SEEDS)
    print(f"[fault 5/5] goodput sweep: dp at world {args.devices}, "
          f"intervals {ELASTIC_INTERVALS} x seeds {ELASTIC_SEEDS} "
          f"({n_pts} runs)", flush=True)
    for every in ELASTIC_INTERVALS:
        for seed in ELASTIC_SEEDS:
            ckpt_dir = records.parent / f".ckpt_e{every}_s{seed}"
            rc = subprocess.run(
                _launch(args.devices) + [
                    "-m", CLI, "dp",
                    "--model", FAULT_MODEL, "--platform", args.platform,
                    "--num_buckets", "2", "-r", str(ELASTIC_RUNS),
                    "-w", "1", "--size_scale", "0.0001",
                    "--time_scale", "0.001", "--no_topology",
                    "--fault", json.dumps(elastic_plan(seed, warmup=1)),
                    "--checkpoint_dir", str(ckpt_dir),
                    "--checkpoint_every", str(every),
                    "--checkpoint_mode", "stall",
                    "--checkpoint_backend", "npz",
                    "--tag", f"elastic_seed={seed}",
                    "--out", str(records)],
                env=env, stdout=subprocess.DEVNULL).returncode
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            if rc != 0:
                print(f"  FAILED every={every} seed={seed} rc={rc}",
                      file=sys.stderr)
                failed += 1
    return failed


DROP_PLAN = {"events": [{"kind": "drop", "ranks": [0], "iteration": 0,
                         "rate": 0.2, "magnitude_us": 200, "seed": 42}]}


def _drop_point(records: Path) -> int:
    """Fault point 3 as JAX's study runs it: dp over two TCP processes
    of the native tier, 20 % injected frame loss on rank 0 under
    policy ``retry``; the two records merged into the study's.  The
    failures (0 or 1)."""
    from dlnetbench_tpu_torch.metrics.merge import merge_files
    print("[fault 3/5] drop+retry: dp/tcp world 2 (native tier), 20 % "
          "injected frame loss, exponential backoff", flush=True)
    try:
        native = native_build.native_bin(REPO)
    except Exception as e:
        print(f"  FAILED: the native tier did not build: {e}",
              file=sys.stderr)
        return 1
    plan = json.dumps(DROP_PLAN)
    port = free_port()
    parts = [records.parent / f".fault_d{r}.jsonl" for r in range(2)]
    for p in parts:
        p.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [str(native / "dp"), "--world", "2", "--backend", "tcp",
         "--rank", str(r), "--coordinator", f"127.0.0.1:{port}",
         "--num_buckets", "2", "--fault", plan,
         "--fault_policy", "retry", "--out", str(parts[r]),
         "--model", FAULT_MODEL, "--time_scale", "0.001",
         "--size_scale", "0.0001", "--runs", "6", "--warmup", "1",
         "--no_topology", "--base_path", str(REPO)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for r in range(2)]
    rcs = [p.wait(timeout=300) for p in procs]
    failed = 0
    if any(rcs):
        print(f"  FAILED rcs={rcs}", file=sys.stderr)
        failed = 1
    else:
        try:
            merge_files(records, parts)
        except ValueError as e:
            print(f"  merge failed: {e}", file=sys.stderr)
            failed = 1
    for p in parts:
        p.unlink(missing_ok=True)
    return failed


def fault_report(args, records: Path) -> int:
    from dlnetbench_tpu_torch.analysis.bandwidth import (
        bandwidth_summary, straggler_amplification)
    from dlnetbench_tpu_torch.metrics.parser import load_records

    recs = load_records(records)
    print("\n=== fault study: one row per record "
          "(docs/RESILIENCE.md columns) ===")
    header = (f"{'section':<8} {'fault':<18} {'policy':<10} "
              f"{'straggler_amp':>13} {'detection_ms':>12} "
              f"{'recovery_ms':>11} {'rejoin_ms':>10} {'ckpt_ms':>8} "
              f"{'lost':>5} {'goodput':>8} {'drops':>6} {'retries':>8} "
              f"degraded_world")
    print(header)

    def _f(v, width, prec=3):
        return (f"{v:>{width}.{prec}f}" if isinstance(v, (int, float))
                else f"{'-':>{width}}")

    for rec in recs:
        g = rec.get("global", {})
        plan = g.get("fault_plan") or {}
        kinds = "+".join(sorted({e.get("kind", "?")
                                 for e in plan.get("events", [])})) or "-"
        amp = straggler_amplification(rec)
        print(f"{rec.get('section', '?'):<8} {kinds:<18} "
              f"{g.get('fault_policy', '-'):<10} "
              f"{amp if amp == amp else float('nan'):>13.3f} "
              f"{_f(g.get('detection_ms'), 12)} "
              f"{_f(g.get('recovery_ms'), 11)} "
              f"{_f(g.get('rejoin_ms'), 10)} "
              f"{_f(g.get('checkpoint_ms'), 8)} "
              f"{_f(g.get('lost_steps'), 5, 0)} "
              f"{_f(g.get('goodput'), 8, 2)} "
              f"{g.get('fault_drops', 0):>6} "
              f"{g.get('fault_retries', 0):>8} "
              f"{g.get('degraded_world', '-')}")

    # the Daly-interval validation over the goodput sweep records
    # (analysis/goodput.py): nonzero when the measured optimum falls
    # OUTSIDE the model's prediction band — the study's acceptance
    # criterion, enforced at generation time, not just documented
    rc = 0
    from dlnetbench_tpu_torch.analysis import goodput as goodput_mod
    try:
        verdict = goodput_mod.validate_sweep(recs)
    except ValueError:
        verdict = None  # no sweep records in this artifact
    if verdict is not None:
        print("\n=== checkpoint-interval planning: measured goodput vs "
              "the Daly model (analysis/goodput.py) ===")
        rc = 0 if verdict["in_band"] else 1
        goodput_mod.report(records, verdict=verdict)
        with open(args.out_dir / "goodput_verdict.json", "w") as f:
            json.dump(verdict, f, indent=1)

    bw = bandwidth_summary(recs)
    if not bw.empty:
        print("\n=== bandwidth under fault: faulted runs busbw-refused, "
              "clean runs keep their figures ===")
        cols = ["section", "collective", "bound", "time_us",
                "algbw_GBps", "busbw_GBps", "straggler_amp"]
        print(bw[cols].to_string(
            index=False, float_format=lambda v: f"{v:10.3f}"))
        bw.to_csv(args.out_dir / "fault_bandwidth_summary.csv",
                  index=False)
    print(f"\nwrote {records} and "
          f"{args.out_dir}/fault_bandwidth_summary.csv")
    return rc


def report(args, records: Path) -> None:
    import pandas as pd

    from dlnetbench_tpu_torch.analysis import plots
    from dlnetbench_tpu_torch.analysis.bandwidth import bandwidth_summary
    from dlnetbench_tpu_torch.metrics.parser import (load_records,
                                                     records_to_dataframe)

    recs = load_records(records)
    df = records_to_dataframe(recs)

    # records the JAX study's native tier wrote through its host
    # executor (a virtual mesh on the CPU) keep their note when read here
    hier_hosted = sum(1 for r in recs
                      if r.get("global", {}).get("pjrt_executor") == "host")
    if hier_hosted:
        print(f"note: {hier_hosted}/{len(recs)} study points ran the "
              f"device path on the HOST executor (virtual mesh, no TPU "
              f"plugin) — fabric numbers are loopback, not ICI/DCN")

    # --- north-star table: iter time + effective bus GB/s per collective
    per_point = []
    for rec in recs:
        s = bandwidth_summary([rec])
        if s.empty:
            continue
        g = rec.get("global", {})
        # bandwidth_summary already carries model; add proxy + world size
        s.insert(0, "proxy", g.get("variables", {}).get("proxy",
                                                        rec.get("section")))
        s.insert(1, "world", len(rec.get("ranks", [])))
        s.insert(2, "sched", g.get("schedule", ""))
        per_point.append(s)
    if per_point:
        bw = pd.concat(per_point, ignore_index=True)
        # one line per (proxy, model, world, collective): the per-iteration
        # exposed time and the standard busbw figure; 'bound' rides along
        # so "lower" rows stay labeled in the table and CSV
        cols = ["proxy", "model", "world", "sched", "collective",
                "group_size", "bound", "time_us", "algbw_GBps",
                "busbw_GBps"]
        bw = (bw.groupby(cols[:7], as_index=False)[cols[7:]].mean()
              .sort_values(["proxy", "model", "world", "sched"]))[cols]
        print("\n=== effective bandwidth per collective "
              "(mean over ranks/runs) ===")
        print(bw.to_string(index=False,
                           float_format=lambda v: f"{v:10.2f}"))
        bw.to_csv(args.out_dir / "bandwidth_summary.csv", index=False)

    # --- runtime summary per study point (schedule column distinguishes
    # the hybrid_2d gpipe/1f1b/zb comparison points)
    group_cols = ["proxy", "model", "world_size"]
    if "schedule" in df:
        group_cols.append("schedule")
    summary = (df.groupby(group_cols, dropna=False)["runtime"]
               .mean().rename("runtime_us").reset_index())
    print("\n=== mean iteration runtime (us) ===")
    print(summary.to_string(index=False,
                            float_format=lambda v: f"{v:12.1f}"))

    # --- plots
    names = ("dp_runtime_scaling", "dp_barrier_by_bucket",
             "pareto_proxies")
    if plots.headless_pyplot() is None:
        for name in names:
            print(f"matplotlib is not installed: skipped "
                  f"{args.out_dir}/{name}.png")
        print(f"\nwrote {args.out_dir}/bandwidth_summary.csv")
        return

    dp = df[df["proxy"] == "dp"]
    scaling = dp[dp["num_buckets"] == 4]
    if not scaling.empty:
        ax = plots.plot_runtime_scaling(scaling, group_by="model")
        ax.figure.savefig(args.out_dir / "dp_runtime_scaling.png", dpi=120)
    full = dp[dp["world_size"] == dp["world_size"].max()]
    if not full.empty:
        ax = plots.plot_barrier_scatter_by_bucket(full)
        ax.figure.savefig(args.out_dir / "dp_barrier_by_bucket.png", dpi=120)
    # cross-proxy exposure Pareto: mean runtime vs mean exposed comm.
    # Exposed-comm column differs per proxy; take the max-information one
    # present per proxy row (barrier_time for dp/fsdp, dp_comm_time for
    # the hybrids, ring/a2a wait for the sequence proxies).
    exposed_cols = [c for c in ("barrier_time", "dp_comm_time",
                                "ring_wait_time", "a2a_time") if c in df]
    if exposed_cols:
        exp = df.assign(exposed=df[exposed_cols].bfill(axis=1)
                        .iloc[:, 0]).dropna(subset=["exposed"])
        if not exp.empty:
            ax = plots.plot_pareto(exp, x="runtime", y="exposed",
                                   group_by="proxy")
            ax.figure.savefig(args.out_dir / "pareto_proxies.png", dpi=120)
    print(f"\nwrote {args.out_dir}/{{bandwidth_summary.csv,"
          f"dp_runtime_scaling,dp_barrier_by_bucket,pareto_proxies}}.png")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dlnetbench_tpu_torch.examples.pod_study",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out_dir", type=Path, default=Path("/tmp/pod_study"))
    ap.add_argument("--devices", type=int, default=8,
                    help="world size: ranks under torch.distributed.run "
                         "(one card each with --platform cuda)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="cuda = NCCL over the cards; cpu = gloo ranks "
                         "and the plain versions")
    ap.add_argument("--fault", action="store_true",
                    help="run the fault-injection study instead of the "
                         "proxy grid: a straggler point (fsdp, measured "
                         "amplification), a rank-crash point (dp, shrink "
                         "policy, detection/recovery + the degraded "
                         "record), a preempt+rejoin point (dp, graceful "
                         "eviction, full world restored, rejoin_ms), and "
                         "the seeded goodput-vs-checkpoint-interval sweep "
                         "the Daly model is validated against "
                         "(analysis/goodput.py) — one records.jsonl "
                         "artifact; the drop+retry point runs on the "
                         "native tier's TCP fabric")
    ap.add_argument("--serving", action="store_true",
                    help="run the serving latency-vs-load study instead "
                         "of the proxy grid: capacity calibration, an "
                         "offered-load sweep (fractions of capacity x "
                         "arrival seeds, p99/goodput-at-SLO bands, "
                         "saturation-knee verdict) and a straggler-"
                         "composed point proving fault plans inflate "
                         "serving p99 — one records.jsonl artifact")
    ap.add_argument("--disagg", action="store_true",
                    help="with --serving: run the sweep over the "
                         "DISAGGREGATED prefill/decode engine (2 "
                         "capacity ranks split 1 prefill + 1 decode, KV "
                         "pages migrating in the stored dtype) — the "
                         "serving_summary carries the migration_* "
                         "columns; run once without and once with into "
                         "different --out_dir for the Pareto comparison")
    ap.add_argument("--fleet", action="store_true",
                    help="with --serving: run the sweep over a "
                         "two-replica FLEET (seeded p2c router over "
                         "independent engines, each with its own page "
                         "pool) — the serving_summary carries the "
                         "fleet_* columns; compare against a plain "
                         "--serving run into a different --out_dir for "
                         "the equal-chips question")
    ap.add_argument("--kv_density", action="store_true",
                    help="run the serving-density study instead of the "
                         "proxy grid: dense vs int8 vs fp8 paged-KV at "
                         "equal pool bytes (admitted concurrency + "
                         "goodput-at-SLO + decode-parity bars) and a "
                         "prefix-heavy shared-system-prompt plan with "
                         "sharing off/on (lossless, hit-rate/bytes-saved, "
                         "TTFT deltas) — generation FAILS unless the "
                         "acceptance bars hold")
    ap.add_argument("--tier", default="jax", choices=("jax", "native"),
                    help="jax = the port's Python tier (cli under "
                         "torch.distributed.run; JAX's study names it "
                         "so); native = the port's C++ binaries")
    ap.add_argument("--backend", default="shm", choices=("shm", "nccl"),
                    help="native tier fabric: shm (threads of one "
                         "process, --platform cpu) or nccl (NCCL on the "
                         "cards, --platform cuda; --procs OS processes a "
                         "point, records merged — the seat of JAX's "
                         "pjrt-hier)")
    ap.add_argument("--procs", type=int, default=1,
                    help="nccl: OS processes a point, each on its "
                         "balanced share of the cards (the first "
                         "world%%procs processes one rank more)")
    ap.add_argument("--congest", action="store_true",
                    help="run a dp_loop congestor job for the duration "
                         "of the sweep — sustained background traffic "
                         "sharing the transport (TCP beside shm, NCCL "
                         "beside nccl), the reference's _loop "
                         "interference shape (Makefile.common:96-109); "
                         "the study marks its output CONGESTED")
    ap.add_argument("--congest_model", default="gpt2_l_16_bfloat16")
    ap.add_argument("--models", default=f"{DENSE},{MOE}",
                    help="comma-separated stats-file names")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--size_scale", type=float, default=1e-4,
                    help="buffer shrink factor")
    ap.add_argument("--time_scale", type=float, default=1e-4,
                    help="burn-time shrink factor")
    ap.add_argument("--full_scale", action="store_true",
                    help="real buffer sizes and burn times")
    ap.add_argument("--report_only", action="store_true",
                    help="skip the sweep; re-analyze an existing "
                         "records.jsonl in --out_dir")
    args = ap.parse_args(argv)
    if args.disagg and args.fleet:
        ap.error("--disagg and --fleet are different serving arms — "
                 "run them into separate --out_dir (the engine refuses "
                 "the composition too)")
    if args.devices < 1:
        ap.error("--devices must be >= 1")
    if args.backend == "nccl" and args.tier != "native":
        ap.error("--backend nccl applies to --tier native (the jax tier "
                 "runs NCCL through torch.distributed instead)")
    if args.tier == "native" and args.backend == "shm" \
            and args.platform != "cpu":
        ap.error("--tier native --backend shm runs the C++ binaries on the "
                 "threaded shm fabric (host CPU): pass --platform cpu, or "
                 "--backend nccl for the cards")
    if args.backend == "nccl" and args.platform != "cuda":
        ap.error("--backend nccl runs on the cards: --platform cuda")
    if args.procs < 1 or (args.procs > 1 and args.backend != "nccl"):
        ap.error("--procs > 1 applies to --tier native --backend nccl")
    if args.kv_density or not args.report_only:
        from dlnetbench_tpu_torch.ops.common import resolve_device
        try:
            device = resolve_device(args.platform)
        except RuntimeError as e:
            ap.error(str(e))

    args.out_dir.mkdir(parents=True, exist_ok=True)
    records = args.out_dir / "records.jsonl"
    failed = 0
    if args.kv_density:
        failed = run_kv_density_study(args.out_dir, device)
        if failed:
            print("\nkv-density study failed its acceptance bars",
                  file=sys.stderr)
        return 1 if failed else 0
    if args.serving:
        if not args.report_only:
            records.unlink(missing_ok=True)
            failed = run_serving_plan(args, records)
        failed += serving_report(args, records)
        if failed:
            print(f"\n{failed} serving study point(s) failed",
                  file=sys.stderr)
        return 1 if failed else 0
    if args.fault:
        if not args.report_only:
            records.unlink(missing_ok=True)
            failed = run_fault_plan(args, records)
        failed += fault_report(args, records)
        if failed:
            print(f"\n{failed} fault study point(s) failed",
                  file=sys.stderr)
        return 1 if failed else 0
    if not args.report_only:
        records.unlink(missing_ok=True)
        # a stale marker from an earlier --congest sweep into the same
        # dir would mislabel THIS solo run's tables
        (args.out_dir / "CONGESTED").unlink(missing_ok=True)
        plan = build_plan([m for m in args.models.split(",") if m],
                          args.devices)
        congestors = _start_congestors(args) if args.congest else []
        try:
            failed = run_plan(plan, args, records)
        finally:
            from dlnetbench_tpu_torch.utils.congest import kill_group
            kill_group(congestors)
    report(args, records)
    if failed:
        print(f"\n{failed} study point(s) failed", file=sys.stderr)
    return 1 if failed else 0


def _start_congestors(args) -> list:
    """A dp_loop job running for the whole sweep (JAX's
    ``_start_congestors``): two TCP processes beside an shm or jax-tier
    sweep; beside an nccl sweep, NCCL on the two cards after the
    study's when the host has them, else one rank on card 0.  The
    study's output marks the run so congested tables are never mistaken
    for solo ones."""
    from dlnetbench_tpu_torch.utils import congest
    job: dict = {}
    if args.tier == "native" and args.backend == "nccl":
        import torch
        cards = torch.cuda.device_count()
        job = {"backend": "nccl", "env": native_build.nccl_env()}
        if cards >= args.devices + 2:
            job.update(world=2, cards=[args.devices, args.devices + 1])
        else:
            job.update(world=1, cards=[0])
    bin_dir = native_build.native_bin(
        REPO, targets=native_build.DEFAULT_TARGETS + ("dp_loop",))
    procs = congest.launch_pair_retry(
        bin_dir, "dp_loop", args.congest_model, REPO,
        args.time_scale, max(args.size_scale * 10, 1e-3),
        extra=["--num_buckets", "4"],
        settle_s=3.0 if job else 1.0, **job)
    how = (f"nccl on cards {job['cards']}" if job else "tcp")
    (args.out_dir / "CONGESTED").write_text(
        f"sweep ran with a dp_loop congestor job ({how}, model "
        f"{args.congest_model}) sharing the transport\n")
    print(f"congestor job running (dp_loop over {how})", flush=True)
    return procs


if __name__ == "__main__":
    raise SystemExit(main())
