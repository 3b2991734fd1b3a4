"""Command line of the torch package:

    python -m dlnetbench_tpu_torch.cli dp --model MODEL --num_buckets N
    python -m dlnetbench_tpu_torch.cli fsdp --model MODEL --num_units N \
        [--sharding_factor S]
    python -m dlnetbench_tpu_torch.cli hybrid_2d --model MODEL \
        --num_stages S --num_microbatches M [--schedule gpipe|1f1b|zb]
    python -m dlnetbench_tpu_torch.cli hybrid_3d ... --tp T
    python -m dlnetbench_tpu_torch.cli hybrid_3d_moe ... --num_expert_shards E
    python -m dlnetbench_tpu_torch.cli ring_attention|ulysses --model MODEL \
        --sp P [--max_layers L]
    torchrun --nproc_per_node W -m dlnetbench_tpu_torch.cli dp ...
    python -m dlnetbench_tpu_torch.cli serve --arrival PLAN [flags]
    python -m dlnetbench_tpu_torch.cli train [--platform cuda|cpu]

``dp``, ``fsdp``, ``hybrid_2d``, ``hybrid_3d`` and ``hybrid_3d_moe`` are
the reference's proxies and ``ring_attention`` and ``ulysses`` the JAX
package's sequence-parallel ones, each with the JAX package's flags:
the schedule of the stats file ``--model``
(``data/model_stats/<model>.txt``) replayed with real collectives on
buffers of the model's size (``--size_scale 1``) and a calibrated burn
for the compute, timed full / compute-only / comm-only.  The world
comes from the launcher (``torchrun``: NCCL on the cards, gloo with
``--platform cpu``); started alone, a process is world 1.  Rank 0
appends one schema-v2 record to ``--out`` (or stdout), each rank's own
timers in its row, and prints the ranks' topology graph to stderr at
startup (``--no_topology``: not).  The observability channels are the
JAX package's: ``--profile`` runs one more step under
``torch.profiler`` on every rank and stamps ``global.profile`` (device
time per collective kind, over all ranks) and
``global.device_top_ops``; ``--trace-out PATH`` writes one merged
Chrome/Perfetto trace (rank 0's host spans, one device track per rank,
the flight recorder's counter tracks); ``--telemetry`` (or
``DLNB_TELEMETRY=1``) runs the flight recorder and stamps
``global.telemetry`` / ``global.anomalies``, its anomaly dumps landing
in ``--flight-dir``.  The profile and the trace are auxiliary: a
capture that fails leaves a note on stderr and the record as it was.
The resilience flags are the JAX package's too: ``--fault PLAN``
(inline JSON or ``@path``, ``faults/plan.py``) injects the plan's
delays at step boundaries and runs its crashes, preemptions and
rejoins under ``--fault_policy`` (default: the plan's own;
``faults/policy.py``), and ``--checkpoint_dir`` snapshots the proxy's
state every ``--checkpoint_every`` steps during a faulted run
(``--checkpoint_mode stall|async``, ``--checkpoint_backend
auto|dcp|npz``: ``dcp`` is ``torch.distributed.checkpoint``, in the
seat of the JAX package's orbax, which is refused by name).  A bad
plan or a plan/config conflict is a usage error; a failure inside the
measured run keeps its traceback.

``serve`` is the JAX package's ``cli serve`` (same flag names, defaults
and parse-time checks) for the slice the port covers: ``separate`` or
``inline`` prefill over an unquantized, int8 or fp8 paged KV cache; the
classic engine or the fused decode loop (``--multi_step_n``,
``--no_adaptive_n``), speculative decode (``--speculative --spec_k
--drafter --drafter_layers``), seeded sampling (``--temperature
--sample_top_k --top_p --sample_seed``), the JSON grammar
(``--grammar``), cross-request prefix sharing (``--prefix_sharing``),
MoE models (``--num_experts --top_k --moe_capacity_factor`` with the
seeded skew ``--moe_skew --moe_skew_seed``) and the windowed live
metrics stream (``--live_metrics PATH``); ``--attn_impl`` picks the
decode attention (``auto``: kernels K1/K2 on the card); with
``--telemetry`` / ``--flight-dir``.  The JAX package's ``--world``,
``--kv_shard``, ``--disaggregate`` and ``--fault`` are not ported
(argparse refuses them by name), and a MoE model with
``--speculative`` is refused with the JAX package's message.
``--platform`` is ``cuda`` unless the caller asks for ``cpu``; without
a card, ``cuda`` is an error.  The record (schema v2)
is appended to ``--out`` or written to stdout; a one-line summary goes
to stderr.

``train`` runs the headline train-step benchmark
(``dlnetbench_tpu_torch.bench``: the bench step at llama3_8b width, its
shape from the ``DLNB_BENCH_*`` variables) and prints its JSON lines,
the headline last (``--skip-aux``: the headline alone).
"""
from __future__ import annotations

import argparse
import sys

from dlnetbench_tpu_torch.metrics import spans, telemetry
from dlnetbench_tpu_torch.ops.common import PLATFORMS


def _add_serve(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arrival", required=True, metavar="PLAN",
                   help="JSON arrival plan (inline or @path; "
                        "serving/arrivals.py schema)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode slots = max continuous batch")
    p.add_argument("--page_size", type=int, default=8,
                   help="tokens per KV page")
    p.add_argument("--num_pages", type=int, default=128,
                   help="physical KV pages shared by all slots")
    p.add_argument("--max_seq_len", type=int, default=128,
                   help="per-request cap (prompt + output); a multiple "
                        "of --page_size")
    p.add_argument("--prefill", default="separate",
                   choices=["separate", "inline"],
                   help="separate: drain the whole prompt at admit "
                        "time; inline: one chunk per engine step")
    p.add_argument("--prefill_chunk", type=int, default=16)
    p.add_argument("--slo_ttft_ms", type=float, default=500.0)
    p.add_argument("--slo_tpot_ms", type=float, default=200.0)
    p.add_argument("--cache_dtype", default="bf16",
                   choices=["bf16", "int8", "fp8"],
                   help="paged-KV pool storage: bf16 = unquantized "
                        "(pools in the model dtype, kernel K1); "
                        "int8/fp8 = quantized pages with per-page, "
                        "per-head f32 scales (kernel K2)")
    p.add_argument("--attn_impl", default="auto",
                   choices=["auto", "gather"],
                   help="decode attention: auto = the hand kernel "
                        "K1/K2 on a card and its plain version on the "
                        "CPU; gather = the plain version on either")
    p.add_argument("--multi_step_n", type=int, default=1,
                   help="decode steps fused per host dispatch: >1 runs "
                        "the device-resident loop (slot state on the "
                        "device, host sync at admission boundaries "
                        "only); 1 = the classic per-token engine")
    p.add_argument("--no_adaptive_n", action="store_true",
                   help="disable the adaptive trip-count cap "
                        "(shortest remaining output + queue pressure); "
                        "the fused loop then always runs the full N")
    p.add_argument("--speculative", action="store_true",
                   help="self-drafting speculative decode inside the "
                        "fused loop: draft k, verify the k+1 fed "
                        "positions in one target pass, accept on the "
                        "device")
    p.add_argument("--spec_k", type=int, default=4,
                   help="draft tokens per verify round")
    p.add_argument("--drafter", default="ngram",
                   choices=["ngram", "truncated"],
                   help="ngram: per-slot bigram table on the device; "
                        "truncated: first --drafter_layers layers of "
                        "the target + shared head")
    p.add_argument("--drafter_layers", type=int, default=1,
                   help="truncated drafter depth (< --layers)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature: 0 = greedy; >0 samples "
                        "every generated token on the device, keyed by "
                        "(sample_seed, request id, position)")
    p.add_argument("--sample_top_k", type=int, default=0,
                   help="keep only the k highest-probability tokens "
                        "before drawing (0 = off; needs --temperature "
                        "> 0)")
    p.add_argument("--top_p", type=float, default=1.0,
                   help="nucleus sampling mass in (0, 1] (1.0 = off; "
                        "needs --temperature > 0)")
    p.add_argument("--sample_seed", type=int, default=0,
                   help="the draw-key seed (records under different "
                        "seeds refuse to merge)")
    p.add_argument("--grammar", default="", choices=["", "json"],
                   help="constrained decode: mask generated tokens to "
                        "the JSON-mode automaton (token class = token "
                        "%% 4); composes with --speculative and "
                        "--prefix_sharing")
    p.add_argument("--prefix_sharing", action="store_true",
                   help="cross-request prefix sharing: requests whose "
                        "prompts share a prefix with a resident "
                        "sequence map their block tables onto the "
                        "same physical pages (refcounts + copy-on-"
                        "write; admission charges only unshared "
                        "pages, the shared prefix skips prefill); "
                        "lossless — record stamps prefix_hit_rate/"
                        "prefix_bytes_saved")
    p.add_argument("--num_experts", type=int, default=1,
                   help=">1 turns every layer's MLP into a MoE: "
                        "decode batches tokens per expert into capacity "
                        "buffers and pays overflow ROUNDS when routing "
                        "skews — imbalance becomes a measurable p99 "
                        "story (serving/moe_decode.py)")
    p.add_argument("--top_k", type=int, default=1,
                   help="experts per token (MoE models)")
    p.add_argument("--moe_capacity_factor", type=float, default=1.0,
                   help="per-round expert capacity factor of the "
                        "serving MoE MLP")
    p.add_argument("--moe_skew", type=float, default=0.0,
                   help="seeded expert-skew injection: bias added to "
                        "the router logits (serving/moe_decode."
                        "skew_bias) — the imbalance-shaped sibling of "
                        "a fault plan's seeded delays; 0 = off")
    p.add_argument("--moe_skew_seed", type=int, default=0)
    p.add_argument("--embed", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv_heads", type=int, default=2)
    p.add_argument("--ff", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init seed (torch.Generator)")
    p.add_argument("--out", default=None,
                   help="append the JSON record to a file")
    p.add_argument("--tag", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--platform", default="cuda", choices=list(PLATFORMS),
                   help="cuda (default; an error without a card) or cpu")
    _add_telemetry(p, "per-engine-step flight ring (queue depth, "
                      "active slots, KV occupancy and fragmentation) + "
                      "the anomaly engine (SLO breach, step-time "
                      "change)")
    p.add_argument("--live-metrics", "--live_metrics",
                   dest="live_metrics", default=None, metavar="PATH",
                   help="stream one windowed snapshot JSONL line per "
                        "0.5 s of engine time (rolling TTFT/TPOT "
                        "percentiles, queue depth, occupancy) — the "
                        "live dashboard channel "
                        "(serving/metrics.LiveMetricsWriter)")


def _add_telemetry(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--telemetry", action="store_true",
                   help=f"continuous telemetry (metrics/telemetry.py): "
                        f"{what}; the record stamps telemetry + "
                        f"anomalies blocks and anomaly dumps land in "
                        f"--flight-dir.  Also enabled by DLNB_TELEMETRY=1")
    p.add_argument("--flight-dir", "--flight_dir", dest="flight_dir",
                   default=None, metavar="DIR",
                   help="where anomaly-triggered flight_<trigger>.json "
                        "ring dumps land (default: DLNB_FLIGHT_DIR; no "
                        "dir = anomalies recorded without dumps; a rank "
                        "of a multi-rank run suffixes _rank<r>)")


def _telemetry_enable(args, rank: int | None = None) -> bool:
    """Install the flight recorder for this run: the ``--telemetry`` /
    ``--flight-dir`` flags or the ``DLNB_TELEMETRY`` env channel.
    Returns True when THIS call enabled it (the caller then owns the
    disable — an already-active recorder, e.g. a test harness's, is
    never torn down here)."""
    if telemetry.is_enabled():
        return False
    if args.telemetry or args.flight_dir:
        telemetry.enable(dump_dir=args.flight_dir, rank=rank)
        return True
    return telemetry.enable_from_env(rank=rank) is not None


# --buffer_dtype -> torch dtype (the JAX package's float8 is e4m3)
BUFFER_DTYPES = {"float32": "float32", "bfloat16": "bfloat16",
                 "float8": "float8_e4m3fn", "int8": "int8"}
# gloo has no float8 type: its allreduce, allgather and reduce-scatter
# of e4m3 raise "Invalid scalar type".  NCCL reduces e4m3 on the card.
GLOO_REFUSED_DTYPES = ("float8",)


def _add_proxy(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", required=True,
                   help="stats-file name, e.g. llama3_8b_16_bfloat16")
    p.add_argument("-w", "--warmup", type=int, default=3)
    p.add_argument("-r", "--runs", type=int, default=5)
    p.add_argument("-m", "--min_exectime", type=float, default=0.0,
                   help="seconds; when set, runs are estimated from warmup")
    p.add_argument("-k", "--reps_per_fence", type=int, default=1,
                   help="K step calls per fence (utils/timing.time_chain); "
                        "1 = fence per rep (reference parity)")
    p.add_argument("--loop", action="store_true",
                   help="run the schedule forever (congestor mode)")
    p.add_argument("-d", "--devices", default=None,
                   help="refused: the world comes from the launcher "
                        "(torchrun --nproc_per_node N)")
    p.add_argument("--platform", default="cuda", choices=list(PLATFORMS),
                   help="cuda (default; NCCL, an error without a card) or "
                        "cpu (gloo)")
    p.add_argument("--buffer_dtype", default="float32",
                   choices=[*BUFFER_DTYPES, "stats"],
                   help="collective-buffer element type; 'stats' follows "
                        "the stats file's Dtype (float8 = e4m3, refused "
                        "with --platform cpu: gloo has no float8 type)")
    p.add_argument("--size_scale", type=float, default=1.0)
    p.add_argument("--time_scale", type=float, default=1.0)
    p.add_argument("--stats_dir", default=None)
    p.add_argument("--out", default=None, help="append JSON record to file")
    p.add_argument("--no_topology", action="store_true",
                   help="skip the startup topology graph of the ranks' "
                        "cards")
    p.add_argument("--profile", action="store_true",
                   help="after the timed runs, trace one more step on "
                        "every rank with torch.profiler and attach the "
                        "device time per collective kind, over all "
                        "ranks, to the record (the cross-check for the "
                        "decomposition timers)")
    p.add_argument("--trace-out", "--trace_out", dest="trace_out",
                   default=None, metavar="PATH",
                   help="write ONE merged Chrome/Perfetto trace: rank 0's "
                        "host spans (build/compile/warmup/timed/fence/"
                        "profile) on top, every rank's device timeline "
                        "of the profiled step below, collectives colored "
                        "by kind (metrics/spans.py)")
    p.add_argument("--tag", action="append", default=[], metavar="KEY=VALUE",
                   help="attach a variable to the emitted record (the "
                        "sweep driver tags each grid point this way)")
    _add_telemetry(p, "record a fixed-capacity flight ring of per-step "
                      "samples and run the anomaly engine (watchdog "
                      "stall / fault / band-aware step-time change)")
    p.add_argument("--fault", default=None, metavar="PLAN",
                   help="JSON fault plan (inline or @path; "
                        "faults/plan.py schema): delay/jitter/crash/"
                        "preempt/rejoin events injected at step "
                        "boundaries with deterministic triggers; the "
                        "record stamps the plan + recovery columns")
    p.add_argument("--fault_policy", default=None,
                   choices=["fail_fast", "retry", "shrink"],
                   help="degradation policy on a scripted failure: "
                        "fail_fast (crash propagates), retry (bounded "
                        "backoff, same world), shrink (rebuild over the "
                        "survivor ranks and finish degraded); default: "
                        "the plan's own policy")
    p.add_argument("--checkpoint_dir", default=None, metavar="DIR",
                   help="enable periodic snapshot checkpointing of the "
                        "proxy's state during a --fault run "
                        "(utils/checkpoint.py SnapshotCheckpointer): "
                        "saves every --checkpoint_every steps, restore-"
                        "from-latest priced into recovery on a crash/"
                        "preempt, lost work and goodput stamped into "
                        "the record")
    p.add_argument("--checkpoint_every", type=int, default=4,
                   help="harness steps between saves (plan step units, "
                        "warmup included; default 4)")
    p.add_argument("--checkpoint_mode", default="async",
                   choices=["stall", "async"],
                   help="stall: the whole durable write rides the timed "
                        "critical path; async: only the device-to-host "
                        "snapshot stays in the step (default)")
    p.add_argument("--checkpoint_backend", default="auto",
                   choices=["auto", "dcp", "npz", "orbax"],
                   help="auto = dcp (torch.distributed.checkpoint); npz "
                        "= the JAX package's npz layout; orbax is the "
                        "JAX package's and is refused")


def _fault_plan(args, parser, cfg):
    """The ``--fault`` plan with ``--fault_policy`` applied, checked
    against the run's config (None without ``--fault``); every problem
    knowable from the flags is a usage error, before any build."""
    if args.checkpoint_dir and not args.fault:
        parser.error("--checkpoint_dir prices checkpointing inside a "
                     "faulted run (faults/policy.py run_faulted) — it "
                     "needs --fault; a clean run has no recovery to "
                     "measure")
    if args.checkpoint_dir and args.checkpoint_every < 1:
        parser.error("--checkpoint_every must be >= 1 step")
    if args.checkpoint_dir:
        from dlnetbench_tpu_torch.utils.checkpoint import resolve_backend
        try:
            resolve_backend(args.checkpoint_backend)
        except ValueError as e:
            parser.error(f"--checkpoint_backend: {e}")
    if not args.fault:
        return None
    from dlnetbench_tpu_torch.faults.plan import FaultPlan
    try:
        plan = FaultPlan.loads(args.fault)
        if args.fault_policy:
            plan.policy = args.fault_policy
        plan.validate()
    except (ValueError, OSError, KeyError) as e:
        parser.error(f"--fault: {e}")
    try:
        plan.check_config(cfg)
    except ValueError as e:
        parser.error(str(e))
    return plan


def _add_pipeline(p: argparse.ArgumentParser) -> None:
    """Flags shared by the three pipeline (hybrid) proxies."""
    _add_proxy(p)
    p.add_argument("--num_stages", type=int, required=True)
    p.add_argument("--num_microbatches", type=int, required=True)
    p.add_argument("--schedule", choices=["gpipe", "1f1b", "zb"],
                   default="gpipe",
                   help="pipeline schedule (gpipe = reference parity; "
                        "1f1b = interleaved fwd/bwd and zb = ZB-H1 "
                        "zero-bubble, rebuild extras)")


PROXIES = ("dp", "fsdp", "hybrid_2d", "hybrid_3d", "hybrid_3d_moe",
           "ring_attention", "ulysses")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dlnetbench_tpu_torch",
        description="PyTorch/CUDA port of dlnetbench_tpu")
    sub = parser.add_subparsers(dest="proxy", required=True)
    p_dp = sub.add_parser("dp", help="bucketed data-parallel allreduce")
    _add_proxy(p_dp)
    p_dp.add_argument("--num_buckets", type=int, required=True)
    p_fsdp = sub.add_parser("fsdp", help="ZeRO-3 allgather/reduce-scatter")
    _add_proxy(p_fsdp)
    p_fsdp.add_argument("--num_units", type=int, required=True)
    p_fsdp.add_argument("--sharding_factor", type=int, default=0,
                        help="0 = whole world (no replicas)")
    p_2d = sub.add_parser("hybrid_2d", help="DP + GPipe pipeline")
    _add_pipeline(p_2d)
    p_2d.add_argument("--dp", type=int, default=0,
                      help="0 = infer from the world")
    p_3d = sub.add_parser("hybrid_3d", help="DP + PP + tensor parallel")
    _add_pipeline(p_3d)
    p_3d.add_argument("--tp", type=int, required=True)
    p_3d.add_argument("--dp", type=int, default=0)
    p_moe = sub.add_parser("hybrid_3d_moe", help="DP + PP + expert parallel")
    _add_pipeline(p_moe)
    p_moe.add_argument("--num_expert_shards", type=int, required=True)
    p_moe.add_argument("--dp", type=int, default=0)
    for name, text in (("ring_attention",
                        "ring (context-parallel) attention proxy"),
                       ("ulysses", "Ulysses sequence-parallel proxy")):
        p_seq = sub.add_parser(name, help=text)
        _add_proxy(p_seq)
        p_seq.add_argument("--sp", type=int, required=True)
        p_seq.add_argument("--dp", type=int, default=0)
        p_seq.add_argument("--max_layers", type=int, default=0,
                           help="cap replayed layers (0 = the model's "
                                "full depth)")
    _add_serve(sub.add_parser(
        "serve", help="serving tier: paged-KV decode under continuous "
                      "batching + an open-loop arrival plan"))
    train = sub.add_parser(
        "train", help="the headline train step (forward, backward, SGD) "
                      "at the bench shape and the MLP recipes' aux lines; "
                      "prints the headline JSON line last")
    train.add_argument("--platform", default="cuda",
                       choices=list(PLATFORMS),
                       help="cuda (default; an error without a card) or "
                            "cpu")
    train.add_argument("--skip-aux", "--skip_aux", dest="skip_aux",
                       action="store_true",
                       help="the headline train step alone")
    args = parser.parse_args(argv)
    if args.proxy == "train":
        from dlnetbench_tpu_torch import bench
        return bench.main(["--platform", args.platform]
                          + (["--skip-aux"] if args.skip_aux else []))
    if args.proxy in PROXIES:
        return _run_proxy(args, parser)
    tele_on = _telemetry_enable(args)
    try:
        return _run_serve(args, parser)
    finally:
        if tele_on:
            telemetry.disable()


def _tags(args, parser) -> dict:
    from dlnetbench_tpu_torch.metrics.emit import scheduler_variables
    variables = scheduler_variables()
    for tag in args.tag:
        key, sep, value = tag.partition("=")
        if not sep or not key:
            parser.error(f"--tag wants KEY=VALUE, got {tag!r}")
        variables[key] = value
    return variables


def _run_proxy(args, parser) -> int:
    import torch

    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    if args.devices is not None:
        parser.error("-d/--devices is not taken: the world comes from the "
                     "launcher — torchrun --nproc_per_node N -m "
                     "dlnetbench_tpu_torch.cli ... (one card per rank)")
    if args.reps_per_fence < 1:
        parser.error("--reps_per_fence must be >= 1")
    if getattr(args, "max_layers", 0) < 0:
        parser.error("--max_layers must be >= 0")
    variables = _tags(args, parser)
    try:
        stats = load_model_stats(args.model, args.stats_dir)
    except (FileNotFoundError, ValueError) as e:
        parser.error(str(e))
    dtype_name = (stats.dtype if args.buffer_dtype == "stats"
                  else args.buffer_dtype)
    if dtype_name not in BUFFER_DTYPES:
        parser.error(f"stats file dtype {dtype_name!r} has no buffer "
                     f"mapping; supported: {list(BUFFER_DTYPES)}")
    if args.platform == "cpu" and dtype_name in GLOO_REFUSED_DTYPES:
        parser.error(f"buffer dtype {dtype_name} (e4m3) is refused with "
                     f"--platform cpu: gloo has no float8 type (its "
                     f"collectives raise 'Invalid scalar type'); NCCL on "
                     f"a card reduces it")
    dtype = getattr(torch, BUFFER_DTYPES[dtype_name])
    cfg = ProxyConfig(warmup=args.warmup, runs=args.runs,
                      min_exectime_s=args.min_exectime, loop=args.loop,
                      size_scale=args.size_scale,
                      time_scale=args.time_scale,
                      reps_per_fence=args.reps_per_fence)
    plan = _fault_plan(args, parser, cfg)
    owned = not torch.distributed.is_initialized()
    try:
        device = multihost.initialize(args.platform)
    except RuntimeError as e:
        parser.error(str(e))
    rank = multihost.rank()
    try:
        if not args.no_topology:
            # the reference's print_topology_graph at every proxy's
            # startup (cpp/netcommunicators.hpp:142); stderr keeps
            # stdout pure JSON
            from dlnetbench_tpu_torch.utils.topology import (gather_rows,
                                                             print_topology)
            rows = gather_rows(device)
            if rank == 0:
                print_topology(rows, stream=sys.stderr)
        # the tracer and the recorder cover the WHOLE configuration —
        # build, warmup, timed runs, the profiled step
        tracer = spans.enable() if args.trace_out else None
        tele_on = _telemetry_enable(
            args, rank if multihost.world_size() > 1 else None)
        try:
            _run_measured(args, parser, stats, cfg, device, dtype,
                          dtype_name, variables, tracer, plan)
        finally:
            # a failure anywhere must not leak this run's tracer or
            # recorder into later runs in this process (the sweep's
            # in-process points, test harnesses); a tracer this run did
            # not enable (a traced sweep's) stays on
            if tracer is not None and spans.current() is tracer:
                spans.disable()
            if tele_on:
                telemetry.disable()
    finally:
        if owned:
            multihost.shutdown()
    return 0


def _run_measured(args, parser, stats, cfg, device, dtype, dtype_name,
                  variables, tracer, plan) -> None:
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.proxies.base import run_proxy
    with spans.span("build", proxy=args.proxy, model=args.model):
        bundle = _build_proxy(args, parser, stats, cfg, device, dtype)
    bundle.global_meta["buffer_dtype"] = dtype_name
    if variables:
        bundle.global_meta["variables"] = variables
    if plan is None:
        result = run_proxy(args.proxy, bundle, cfg)
    else:
        from dlnetbench_tpu_torch.faults.policy import (CheckpointPolicy,
                                                        run_faulted)
        ckpt = None
        if args.checkpoint_dir:
            ckpt = CheckpointPolicy(dir=args.checkpoint_dir,
                                    every=args.checkpoint_every,
                                    mode=args.checkpoint_mode,
                                    backend=args.checkpoint_backend)

        def rebuild(ranks):
            # a shrink runs this inside the survivors' sub-world, a
            # rejoin over the full world: the proxy builds over
            # whichever world is current (the rebuild is priced into
            # recovery_ms / rejoin_ms)
            return _build_proxy(args, parser, stats, cfg, device, dtype)

        with spans.span("faulted_run", proxy=args.proxy,
                        policy=plan.policy):
            result = run_faulted(args.proxy, bundle, cfg, plan,
                                 rebuild=rebuild,
                                 world=multihost.world_size(),
                                 checkpoint=ckpt)
    events = None
    if args.profile or args.trace_out:
        events = _profile_step(args, bundle, device)
    # every rank's own timers, meta, anomalies and profiled device
    # events, in rank order, to rank 0
    rec_now = telemetry.current()
    per_rank = multihost.all_ranks((
        result.timers_us, bundle.rank_meta,
        rec_now.anomalies_block() if rec_now is not None else None,
        events))
    if multihost.rank() != 0:
        return
    tracks = None
    if args.profile or args.trace_out:
        tracks = [(f"rank {r} ({dev})", evs)
                  for r, (_, _, _, (dev, evs)) in enumerate(per_rank)
                  if evs is not None]
        if len(tracks) < len(per_rank):
            print(f"profile: {len(per_rank) - len(tracks)} rank(s) "
                  f"captured no trace; profile and trace left out, "
                  f"record unaffected", file=sys.stderr)
            tracks = None
    if args.profile and tracks is not None:
        from dlnetbench_tpu_torch.metrics import profiling
        pooled = [e for _, evs in tracks for e in evs]
        result.global_meta["profile"] = profiling.collective_stats(pooled)
        result.global_meta["device_top_ops"] = \
            profiling.top_device_ops(pooled)
    if tracer is not None:
        spans.disable()
        _write_trace(args.trace_out, tracer, tracks)
    record = emit_result(
        result, path=args.out,
        rank_timers_us=[t for t, _, _, _ in per_rank],
        rank_meta=[m for _, m, _, _ in per_rank],
        rank_anomalies=([a for _, _, a, _ in per_rank]
                        if rec_now is not None else None))
    g = record["global"]
    print(f"{args.proxy}: {g['model']} world {g['world_size']} on "
          f"{record['mesh']['device_kind']} — runtime median "
          f"{record['ranks'][0]['summary']['runtimes']['value']} "
          f"us", file=sys.stderr)


def _profile_step(args, bundle, device) -> tuple:
    """This rank's device label and the device events of one more
    ``bundle.full`` step under ``torch.profiler`` (None, with a note on
    stderr, when the capture fails: the profile is auxiliary)."""
    from dlnetbench_tpu_torch.metrics import profiling
    label = f"cuda:{device.index or 0}" if device.type == "cuda" else "cpu"
    try:
        return label, profiling.trace_step(
            bundle.full, device, span_attrs={"proxy": args.proxy})
    except Exception as e:
        print(f"profile/trace capture failed ({type(e).__name__}: {e}); "
              f"record unaffected", file=sys.stderr)
        return label, None


def _write_trace(path: str, tracer, tracks) -> None:
    """The merged trace: rank 0's host spans, one device track per
    rank, the flight recorder's counter tracks (full resident ring +
    anomaly instants)."""
    rec_now = telemetry.current()
    extra = None
    if rec_now is not None:
        extra = spans.telemetry_counter_events(
            rec_now.telemetry_block(last=rec_now.capacity),
            rec_now.anomalies_block())
    try:
        spans.write_chrome_trace(path, tracer, tracks, extra_events=extra)
        print(f"merged host+device trace -> {path}", file=sys.stderr)
    except OSError as e:
        print(f"trace-out write failed ({e}); record unaffected",
              file=sys.stderr)


def _build_proxy(args, parser, stats, cfg, device, dtype):
    from dlnetbench_tpu_torch.core.model_card import (
        arch_name_from_stats_name, load_model_card)
    try:
        if args.proxy == "dp":
            from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
            from dlnetbench_tpu_torch.proxies import dp
            return dp.build(stats, args.num_buckets, cfg,
                            make_flat_mesh(device), dtype=dtype)
        if args.proxy == "fsdp":
            from dlnetbench_tpu_torch.proxies import fsdp
            return fsdp.build(stats, args.num_units, cfg, device,
                              sharding_factor=args.sharding_factor or None,
                              dtype=dtype)
        card = load_model_card(arch_name_from_stats_name(args.model))
        if args.proxy in ("ring_attention", "ulysses"):
            from dlnetbench_tpu_torch.proxies import ring_attention, ulysses
            mod = ring_attention if args.proxy == "ring_attention" \
                else ulysses
            return mod.build(stats, card, cfg, device, sp=args.sp,
                             dp=args.dp, dtype=dtype,
                             max_layers=args.max_layers or None)
        from dlnetbench_tpu_torch.proxies import (hybrid_2d, hybrid_3d,
                                                  hybrid_3d_moe)
        pipe = dict(num_stages=args.num_stages,
                    num_microbatches=args.num_microbatches,
                    schedule=args.schedule, dp=args.dp, dtype=dtype)
        if args.proxy == "hybrid_2d":
            return hybrid_2d.build(stats, card, cfg, device, **pipe)
        if args.proxy == "hybrid_3d":
            return hybrid_3d.build(stats, card, cfg, device, tp=args.tp,
                                   **pipe)
        return hybrid_3d_moe.build(
            stats, card, cfg, device,
            num_expert_shards=args.num_expert_shards, **pipe)
    except ValueError as e:
        parser.error(str(e))     # configuration-invariant violations


def _run_serve(args, parser) -> int:
    from dlnetbench_tpu_torch.metrics.emit import emit_result
    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.ops.common import resolve_device
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (Engine,
                                                        ServingConfig,
                                                        run_serving)
    variables = _tags(args, parser)
    try:
        plan = ArrivalPlan.loads(args.arrival)
    except (ValueError, OSError, KeyError) as e:
        parser.error(f"--arrival: {e}")
    try:
        model_cfg = TransformerConfig(
            vocab_size=args.vocab, embed_dim=args.embed,
            num_heads=args.heads, num_kv_heads=args.kv_heads,
            ff_dim=args.ff, num_layers=args.layers,
            seq_len=args.max_seq_len, dtype=args.dtype,
            num_experts=args.num_experts, top_k=args.top_k,
            moe_capacity_factor=args.moe_capacity_factor)
        srv_cfg = ServingConfig(
            slots=args.slots, page_size=args.page_size,
            num_pages=args.num_pages, max_seq_len=args.max_seq_len,
            prefill=args.prefill, prefill_chunk=args.prefill_chunk,
            slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
            attn_impl=args.attn_impl, multi_step_n=args.multi_step_n,
            adaptive_n=not args.no_adaptive_n,
            speculative=args.speculative, spec_k=args.spec_k,
            drafter=args.drafter, drafter_layers=args.drafter_layers,
            temperature=args.temperature, top_k=args.sample_top_k,
            top_p=args.top_p, sample_seed=args.sample_seed,
            grammar=args.grammar,
            cache_dtype=args.cache_dtype,
            prefix_sharing=args.prefix_sharing,
            moe_skew=args.moe_skew,
            moe_skew_seed=args.moe_skew_seed).validate()
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        parser.error(str(e))
    params = init_params(model_cfg, seed=args.seed, device=device)
    try:
        # the engine build checks the knobs against the model's shape
        # (the speculative drafter's depth, speculation on a MoE model);
        # a refusal is a usage error
        engine = Engine(model_cfg, srv_cfg, params=params, device=device)
    except ValueError as e:
        parser.error(str(e))
    result = run_serving(model_cfg, srv_cfg, plan, engine=engine,
                         live_metrics=args.live_metrics)
    if variables:
        result.global_meta["variables"] = variables
    record = emit_result(result, path=args.out)
    srv = record["global"]["serving"]
    print(f"serving: {srv['completed']} requests at offered "
          f"{srv['offered_rps']} rps on {record['mesh']['device_kind']} "
          f"— ttft p99 {srv['ttft_ms']['p99']} ms, tpot p50 "
          f"{srv['tpot_ms']['p50']} ms, {srv['tokens_per_s']} tokens/s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
