"""Command line of the torch package:

    python -m dlnetbench_tpu_torch.cli serve --arrival PLAN [flags]
    python -m dlnetbench_tpu_torch.cli train [--platform cuda|cpu]

``serve`` is the JAX package's ``cli serve`` (same flag names and
defaults) for the slice the port covers: the classic greedy engine with
``separate`` or ``inline`` prefill over an unquantized, int8 or fp8
paged KV cache.  ``--platform`` is ``cuda`` unless the caller asks for
``cpu``; without a card, ``cuda`` is an error.  The record (schema v2)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dlnetbench_tpu_torch",
        description="PyTorch/CUDA port of dlnetbench_tpu")
    sub = parser.add_subparsers(dest="proxy", required=True)
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
    return _run_serve(args, parser)


def _run_serve(args, parser) -> int:
    from dlnetbench_tpu_torch.metrics.emit import (emit_result,
                                                   scheduler_variables)
    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.ops.common import resolve_device
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.scheduler import (ServingConfig,
                                                        run_serving)
    variables = scheduler_variables()
    for tag in args.tag:
        key, sep, value = tag.partition("=")
        if not sep or not key:
            parser.error(f"--tag wants KEY=VALUE, got {tag!r}")
        variables[key] = value
    try:
        plan = ArrivalPlan.loads(args.arrival)
    except (ValueError, OSError, KeyError) as e:
        parser.error(f"--arrival: {e}")
    try:
        model_cfg = TransformerConfig(
            vocab_size=args.vocab, embed_dim=args.embed,
            num_heads=args.heads, num_kv_heads=args.kv_heads,
            ff_dim=args.ff, num_layers=args.layers,
            seq_len=args.max_seq_len, dtype=args.dtype)
        srv_cfg = ServingConfig(
            slots=args.slots, page_size=args.page_size,
            num_pages=args.num_pages, max_seq_len=args.max_seq_len,
            prefill=args.prefill, prefill_chunk=args.prefill_chunk,
            slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
            cache_dtype=args.cache_dtype).validate()
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        parser.error(str(e))
    params = init_params(model_cfg, seed=args.seed, device=device)
    result = run_serving(model_cfg, srv_cfg, plan, params=params,
                         device=device)
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
