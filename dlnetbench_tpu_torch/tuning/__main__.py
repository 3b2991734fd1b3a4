"""``python -m dlnetbench_tpu_torch.tuning`` — the tuning CLI (the
JAX package's ``python -m dlnetbench_tpu.tuning``: its ops, flags and
defaults).

    # search K11's cluster sizes for an e4m3 fused matmul on the card and
    # commit the winner
    python -m dlnetbench_tpu_torch.tuning tune --op quantized_matmul \\
        --db /tmp/dlnb_tuning --fmt float8 --tokens 4096 --d 4096 \\
        --n 14336

    # K1's pages a split at a decode shape
    python -m dlnetbench_tpu_torch.tuning tune --op paged_attention \\
        --db /tmp/dlnb_tuning --batch 8 --heads 32 --kv_heads 8 \\
        --pages 32 --page_size 16

    # the SPMD grains need a world of >= 2 ranks
    torchrun --nproc_per_node 2 -m dlnetbench_tpu_torch.tuning tune \\
        --op tp_overlap_chunks --db /tmp/dlnb_tuning

    # list what the DB holds
    python -m dlnetbench_tpu_torch.tuning show --db /tmp/dlnb_tuning

Every op measures with the K-chained fence timing of the bench lines
(``utils/timing.time_chain``, one warm launch outside the timing),
prunes band-aware, and commits the winner with its measured band under
the key the consult site builds (``tuning.params``), so a committed
record is consultable.  It runs on the card unless ``--platform cpu``
asks for the plain versions.  The configs are the card's knobs:

* ``quantized_matmul`` (K11) and ``grouped_ffn`` (K12, the gate/up
  product ``[E, C, d] @ [E, d, n]`` the key names): ``cluster`` — one
  of 1, 2, 4 dividing N / 256 (default grid: those); K12 in the master
  dtype (``--fmt none``) has the one config ``cluster`` 1;
* ``paged_attention`` / ``paged_attention_quant`` (K1/K2):
  ``pages_per_compute_block``, the pages a split of a slot's sequence
  takes (default grid: the divisors of ``--pages``);
* ``flash_fwd`` / ``flash_bwd`` / ``splash_fwd`` / ``splash_bwd``: the
  JAX package's block fields; each card kernel has one compiled tile,
  which is the one candidate;
* ``tp_overlap_chunks`` (collective-matmul ring grain) and
  ``grad_bucket_layers`` (bucketed DP grad sync): under ``torchrun`` with
  a world of >= 2 ranks; every rank measures (each sample is the
  slowest rank's, so every rank prunes alike) and rank 0 commits.
"""
from __future__ import annotations

import argparse
import json
import sys

from dlnetbench_tpu_torch.tuning import params as tparams
from dlnetbench_tpu_torch.tuning.db import TuningDB
from dlnetbench_tpu_torch.tuning.search import run_search, tune_and_commit

OPS = ("quantized_matmul", "flash_fwd", "flash_bwd", "splash_fwd",
       "splash_bwd", "paged_attention", "paged_attention_quant",
       "grouped_ffn", "tp_overlap_chunks", "grad_bucket_layers")


def _parse_candidates(spec: str | None, arity: int,
                      names: tuple[str, ...]) -> list[dict] | None:
    """``"a,b,c;d,e,f"`` -> [{names[0]: a, ...}, ...]; None passes
    through (op-specific default grid)."""
    if not spec:
        return None
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        vals = [int(v) for v in part.split(",")]
        if len(vals) != arity:
            raise ValueError(
                f"--candidates: {part!r} has {len(vals)} fields, "
                f"op wants {arity} ({','.join(names)})")
        out.append(dict(zip(names, vals)))
    if not out:
        raise ValueError("--candidates: empty after parsing")
    return out


def _chain(fn, args: tuple, k: int, device):
    """One warm launch, then a closure that takes one K-chained sample
    (seconds per iteration; ``utils/timing.time_chain``)."""
    from dlnetbench_tpu_torch.utils.timing import fence, time_chain
    fn(*args)                                   # warm, outside the timing
    fence(device)
    return lambda: time_chain(fn, *args, k=k, device=device)


def _seeded(shape, seed: int, device, dtype=None, scale: float = 1.0):
    import torch
    gen = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=gen) * scale
    return t.to(device=device, dtype=dtype or torch.float32)


def _dtype(name: str):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _clusters(n: int) -> list[dict]:
    from dlnetbench_tpu_torch.ops.quantized_matmul import CLUSTERS, TILE_N
    return [{"cluster": c} for c in CLUSTERS if (n // TILE_N) % c == 0]


def _tune_quantized_matmul(args, device):
    import torch

    from dlnetbench_tpu_torch.ops import quantized_matmul as qmm

    t, d, n, fmt = args.tokens, args.d, args.n, args.fmt
    x = _seeded((t, d), 0, device, torch.bfloat16)
    w = _seeded((d, n), 1, device, torch.bfloat16, 0.02)
    wq, sw = qmm.quantize_tensor(w, fmt)
    wq = qmm.k_major(wq).t()            # column-major: no copy per call
    sx = qmm.scale_from_amax(qmm.amax_of(x), fmt)
    key = tparams.quantized_matmul_key(t, d, n, fmt, x.dtype)
    cands = _parse_candidates(args.candidates, 1, ("cluster",)) \
        or _clusters(n)

    def measure_cfg(cfg):
        return _chain(lambda xx: qmm.fused_matmul(
            xx, wq, sw, sx, fmt=fmt, cluster=cfg["cluster"]), (x,),
            args.k, device)
    return "quantized_matmul", key, cands, measure_cfg


def _attention_operands(args, device):
    b, s = args.batch, args.seq
    hq, hkv, dh = args.heads, args.kv_heads, args.head_dim
    dt = _dtype(args.dtype)
    return (_seeded((b, s, hq, dh), 0, device, dt),
            _seeded((b, s, hkv, dh), 1, device, dt),
            _seeded((b, s, hkv, dh), 2, device, dt))


def _one_tile(op: str, cands: list[dict] | None, tile: dict) -> list[dict]:
    """The flash ops' grid: the card kernel's one compiled tile; an
    explicit candidate naming another cannot run (ValueError)."""
    for cfg in cands or []:
        if cfg != tile:
            raise ValueError(f"--op {op}: candidate {cfg} is not the card "
                             f"kernel's one compiled tile {tile}")
    return [dict(tile)]


def _tune_flash(args, device, op: str):
    """``flash_fwd`` / ``flash_bwd`` (causal) and ``splash_fwd`` /
    ``splash_bwd`` (the mask from ``--window`` / ``--seg_avg`` /
    ``--seg_seed``, riding in the key) at their one tile."""
    import importlib

    from dlnetbench_tpu_torch.ops.attention_mask import MaskSpec

    fa = importlib.import_module("dlnetbench_tpu_torch.ops.flash_attention")
    q, k, v = _attention_operands(args, device)
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    splash = op.startswith("splash")
    fwd = op.endswith("fwd")
    spec = MaskSpec(causal=True, window=args.window, seg_avg=args.seg_avg,
                    seg_seed=args.seg_seed)
    if splash:
        key = tparams.splash_key(b, s, hq, hkv, dh, spec.label(), q.dtype)
    else:
        key = (tparams.flash_fwd_key if fwd else tparams.flash_bwd_key)(
            b, s, hq, hkv, dh, True, q.dtype)
    tile = fa.FWD_CONFIG if fwd else fa.BWD_CONFIG
    names = tuple(tile)
    cands = _one_tile(op, _parse_candidates(args.candidates, len(names),
                                            names), tile)

    def run_fwd(qq, kk, vv):
        return (fa.splash_forward(qq, kk, vv, spec) if splash
                else fa.forward(qq, kk, vv, True))

    if fwd:
        def measure_cfg(cfg):
            return _chain(run_fwd, (q, k, v), args.k, device)
        return op, key, cands, measure_cfg
    out, lse = run_fwd(q, k, v)
    do = _seeded(tuple(q.shape), 3, device, q.dtype)

    def run_bwd(*a):
        return (fa.splash_backward(*a, spec) if splash
                else fa.backward(*a, True))

    def measure_cfg(cfg):
        return _chain(run_bwd, (q, k, v, out, lse, do), args.k, device)
    return op, key, cands, measure_cfg


def _paged_operands(args, device, fmt: str | None):
    import torch

    b, hq, hkv, dh = args.batch, args.heads, args.kv_heads, args.head_dim
    pages, psz = args.pages, args.page_size
    q = _seeded((b, hq, dh), 0, device)
    shape = (hkv, pages * b, psz, dh)
    lengths = torch.full((b,), pages * psz, dtype=torch.int32,
                         device=device)
    pidx = torch.arange(pages * b, dtype=torch.int32,
                        device=device).reshape(b, pages)
    if fmt is None:
        return (q, _seeded(shape, 1, device), _seeded(shape, 2, device),
                lengths, pidx), {}
    qdt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    gen = torch.Generator().manual_seed(1)
    kp = torch.randint(-127, 127, shape, generator=gen).float().to(qdt)
    vp = torch.randint(-127, 127, shape, generator=gen).float().to(qdt)
    ks = _seeded((hkv, pages * b), 3, device).abs() * 0.02 + 1e-4
    vs = _seeded((hkv, pages * b), 4, device).abs() * 0.02 + 1e-4
    return ((q, kp.to(device), vp.to(device), lengths, pidx),
            {"k_scale": ks, "v_scale": vs, "fmt": fmt})


def _tune_paged_attention(args, device, quant: bool):
    from dlnetbench_tpu_torch.serving import kv_cache as kvc

    b, hq, hkv, dh = args.batch, args.heads, args.kv_heads, args.head_dim
    pages, psz = args.pages, args.page_size
    fmt = args.fmt if quant else None
    operands, kw = _paged_operands(args, device, fmt)
    if quant:
        op = "paged_attention_quant"
        key = tparams.paged_attention_quant_key(pages, psz, b, hq, hkv,
                                                dh, fmt)
    else:
        op = "paged_attention"
        key = tparams.paged_attention_key(pages, psz, b, hq, hkv, dh)
    cands = _parse_candidates(args.candidates, 1,
                              ("pages_per_compute_block",)) or [
        {"pages_per_compute_block": c}
        for c in range(1, pages + 1) if pages % c == 0]

    def measure_cfg(cfg):
        return _chain(lambda *a: kvc.paged_attention_decode(
            *a, pages_per_compute_block=cfg["pages_per_compute_block"],
            **kw), operands, args.k, device)
    return op, key, cands, measure_cfg


def _tune_grouped_ffn(args, device):
    """K12's cluster size for the grouped expert FFN's gate/up product,
    the one ``grouped_ffn_key(E, C, d, n, fmt, dtype)`` names:
    ``[E, C, d] @ [E, d, n]`` per expert, every row live, with the fused
    quantization of ``--fmt`` ("none": the master dtype)."""
    from dlnetbench_tpu_torch.ops import grouped_matmul as gm
    from dlnetbench_tpu_torch.ops import quantized_matmul as qmm

    e, c, d, h = args.experts, args.capacity, args.d, args.n
    fmt = None if args.fmt == "none" else args.fmt
    dt = _dtype(args.dtype)
    x = _seeded((e, c, d), 0, device, dt)
    w = _seeded((e, d, h), 1, device, dt, 0.02)
    key = tparams.grouped_ffn_key(e, c, d, h, fmt or "none", x.dtype)
    kw = {}
    if fmt:
        w, sw = gm.quantize_experts(w, fmt)
        kw = {"fmt": fmt, "sw": sw,
              "sx": qmm.scale_from_amax(gm.expert_amax(x), fmt)}
    cands = _parse_candidates(args.candidates, 1, ("cluster",)) or (
        _clusters(h) if fmt else [{"cluster": 1}])

    def measure_cfg(cfg):
        return _chain(lambda xx: gm.grouped_matmul(
            xx, w, cluster=cfg["cluster"], **kw), (x,), args.k, device)
    return "grouped_ffn", key, cands, measure_cfg


# why one device has nothing to tune (the JAX package's words)
_NEEDS_TWO = {"tp_overlap_chunks": "one device has no ring to overlap",
              "grad_bucket_layers": "one device has no grad sync to "
                                    "schedule"}


def _world(args, what: str) -> int:
    from dlnetbench_tpu_torch.parallel import multihost
    n = args.tp or multihost.world_size()
    if n < 2:
        raise SystemExit(f"{what} tuning needs >= 2 devices "
                         f"({_NEEDS_TWO[what]}); start it with torchrun "
                         f"--nproc_per_node 2")
    if n != multihost.world_size():
        raise SystemExit(f"{what}: --tp {n} but the world has "
                         f"{multihost.world_size()} ranks (0 = all)")
    return n


def _slowest(measure, device):
    """``measure`` whose sample is the slowest rank's, so every rank of
    the group sees the same samples and prunes alike."""
    import torch
    import torch.distributed as dist

    def sample():
        t = torch.tensor([float(measure())], dtype=torch.float64,
                         device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())
    return sample


def _tune_tp_overlap_chunks(args, device):
    from dlnetbench_tpu_torch.ops import collective_matmul as CM
    from dlnetbench_tpu_torch.parallel import multihost

    tp = _world(args, "tp_overlap_chunks")
    d, f, s = args.d, args.n, args.seq
    dt = _dtype(args.dtype)
    x = _seeded((1, s, d), 0, device, dt)
    shard = s // tp
    r = multihost.rank()
    x_local = x[:, r * shard:(r + 1) * shard].contiguous()
    w = _seeded((d, f), 1, device, dt, 0.02)
    group = multihost.world_group()
    key = tparams.tp_overlap_chunks_key(d, f, s, tp, args.dtype)
    cands = _parse_candidates(args.candidates, 1, ("chunks",)) or [
        {"chunks": c} for c in (1, 2, 4, 8)]

    def measure_cfg(cfg):
        return _slowest(_chain(lambda xx, ww: CM.all_gather_matmul(
            xx, ww, group, gather_axis=1, chunks=cfg["chunks"]),
            (x_local, w), args.k, device), device)
    return "tp_overlap_chunks", key, cands, measure_cfg


def _tune_grad_bucket_layers(args, device):
    import dataclasses

    import torch

    from dlnetbench_tpu_torch.models import spmd

    dp = _world(args, "grad_bucket_layers")
    mesh = spmd.grid_mesh(dp, 1, 1, device)
    base = spmd.SpmdConfig(embed_dim=args.d, ff_dim=args.n,
                           seq_len=args.seq, num_layers=args.layers,
                           batch=dp * 2, num_microbatches=1,
                           grad_sync="bucketed", tp_overlap_chunks=2)
    key = tparams.grad_bucket_layers_key(base.num_layers, dp, 1,
                                         base.embed_dim, base.ff_dim)
    cands = _parse_candidates(args.candidates, 1, ("layers",)) or [
        {"layers": c} for c in (1, 2, 4) if c <= base.num_layers]
    params = spmd.shard_params(spmd.init_params(base, seed=0,
                                                device=device), mesh, base)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, base.vocab_size,
                           (base.batch, base.seq_len + 1),
                           generator=gen).to(device)

    def measure_cfg(cfg):
        c = dataclasses.replace(base, grad_bucket_layers=cfg["layers"])
        step = spmd.make_train_step(mesh, c)
        return _slowest(_chain(step, (params, tokens), args.k, device),
                        device)
    return "grad_bucket_layers", key, cands, measure_cfg


def _run_tune(args) -> int:
    from dlnetbench_tpu_torch.parallel import multihost

    db_root = args.db or tparams.db_dir()
    if not db_root:
        print("tune: no DB — pass --db DIR or set "
              f"${tparams.ENV_DB_DIR}", file=sys.stderr)
        return 2
    spmd_op = args.op in ("tp_overlap_chunks", "grad_bucket_layers")
    if spmd_op:
        device = multihost.initialize(args.platform)
    else:
        from dlnetbench_tpu_torch.ops.common import resolve_device
        device = resolve_device(args.platform)
    try:
        return _tune(args, db_root, device)
    finally:
        if spmd_op:
            multihost.shutdown()


def _tune(args, db_root: str, device) -> int:
    from dlnetbench_tpu_torch.parallel import multihost

    setups = {
        "quantized_matmul": lambda: _tune_quantized_matmul(args, device),
        "flash_fwd": lambda: _tune_flash(args, device, "flash_fwd"),
        "flash_bwd": lambda: _tune_flash(args, device, "flash_bwd"),
        "splash_fwd": lambda: _tune_flash(args, device, "splash_fwd"),
        "splash_bwd": lambda: _tune_flash(args, device, "splash_bwd"),
        "paged_attention": lambda: _tune_paged_attention(args, device,
                                                         False),
        "paged_attention_quant":
            lambda: _tune_paged_attention(args, device, True),
        "grouped_ffn": lambda: _tune_grouped_ffn(args, device),
        "tp_overlap_chunks": lambda: _tune_tp_overlap_chunks(args, device),
        "grad_bucket_layers":
            lambda: _tune_grad_bucket_layers(args, device),
    }
    try:
        op, key, cands, measure_cfg = setups[args.op]()
    except ValueError as e:
        print(f"tune: {e}", file=sys.stderr)
        return 2
    if not cands:
        print(f"tune: no applicable candidates for --op {args.op} at "
              f"this shape (the default grid's values must fit the "
              f"shape dims) — adjust the shape flags or pass an "
              f"explicit --candidates grid", file=sys.stderr)
        return 2
    hw = tparams.hw_key(device)
    lead = multihost.rank() == 0
    log = (lambda m: print(m, file=sys.stderr)) if lead else None
    if lead:
        print(f"tune: {op} key={key} hw={hw} — {len(cands)} candidates, "
              f"seed {args.seed}, {args.rounds} rounds of K={args.k} "
              f"chains", file=sys.stderr)
    db = TuningDB(db_root)

    # one measurement closure per candidate, built (and warmed) lazily
    # and kept for its rounds (the search calls measure once a round)
    built: dict[str, object] = {}

    def measure(cfg):
        ck = json.dumps(cfg, sort_keys=True)
        if ck not in built:
            built[ck] = measure_cfg(cfg)
        return built[ck]()

    if not lead:
        # the group's other ranks take part in every measurement; rank 0
        # alone commits
        run_search(cands, measure, seed=args.seed, rounds=args.rounds)
        return 0
    res = tune_and_commit(db, op, key, hw, cands, measure,
                          seed=args.seed, rounds=args.rounds, k=args.k,
                          log=log)
    print(json.dumps(res["record"]), flush=True)
    print(f"tune: committed {res['config']} "
          f"(median {res['band']['value'] * 1e3:.3f} ms, "
          f"{res['pruned']} candidate(s) pruned) -> {db.path}",
          file=sys.stderr)
    return 0


def _run_show(args) -> int:
    db_root = args.db or tparams.db_dir()
    if not db_root:
        print("show: no DB — pass --db DIR or set "
              f"${tparams.ENV_DB_DIR}", file=sys.stderr)
        return 2
    db = TuningDB(db_root)
    records = db.load()
    for rec in records.values():
        print(json.dumps(rec))
    print(f"{len(records)} record(s) in {db.path}", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    from dlnetbench_tpu_torch.ops.common import PLATFORMS

    parser = argparse.ArgumentParser(
        prog="python -m dlnetbench_tpu_torch.tuning", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tune", help="seeded search + commit on this "
                                    "device")
    t.add_argument("--op", required=True, choices=OPS)
    t.add_argument("--db", default=None,
                   help=f"DB directory (default: ${tparams.ENV_DB_DIR})")
    t.add_argument("--platform", default="cuda", choices=list(PLATFORMS),
                   help="cuda (default: the card's kernels) or cpu (their "
                        "plain versions)")
    t.add_argument("--candidates", default=None,
                   help="explicit grid, ';'-separated tuples (per-op "
                        "arity); default: the op's built-in grid")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--rounds", type=int, default=3,
                   help="K-chains per surviving candidate")
    t.add_argument("-k", type=int, default=8,
                   help="launches per fence chain")
    # shape flags (per-op subsets)
    t.add_argument("--tokens", type=int, default=256)
    t.add_argument("--d", type=int, default=256)
    t.add_argument("--n", type=int, default=256)
    t.add_argument("--fmt", default="int8",
                   choices=["int8", "float8", "none"],
                   help="quant format; 'none' (grouped_ffn only) "
                        "measures the master-dtype kernel")
    t.add_argument("--experts", type=int, default=8,
                   help="grouped_ffn: expert count E")
    t.add_argument("--capacity", type=int, default=256,
                   help="grouped_ffn: dispatch slots per expert C")
    t.add_argument("--batch", type=int, default=1)
    t.add_argument("--seq", type=int, default=1024)
    t.add_argument("--heads", type=int, default=4)
    t.add_argument("--kv_heads", type=int, default=4)
    t.add_argument("--head_dim", type=int, default=128)
    t.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    t.add_argument("--window", type=int, default=0,
                   help="splash ops: sliding-window width (0 = off)")
    t.add_argument("--seg_avg", type=int, default=0,
                   help="splash ops: seeded segment plan's average "
                        "document length (0 = off)")
    t.add_argument("--seg_seed", type=int, default=0)
    t.add_argument("--pages", type=int, default=8)
    t.add_argument("--page_size", type=int, default=8)
    t.add_argument("--layers", type=int, default=4)
    t.add_argument("--tp", type=int, default=0,
                   help="ranks of the multi-device ops (0 = the whole "
                        "torchrun world)")
    s = sub.add_parser("show", help="list the DB's records")
    s.add_argument("--db", default=None)
    args = parser.parse_args(argv)
    if args.cmd == "tune":
        if args.fmt == "none" and args.op != "grouped_ffn":
            parser.error(f"--fmt none is only meaningful for "
                         f"--op grouped_ffn (the master-dtype grouped "
                         f"kernel); --op {args.op} needs int8/float8")
        return _run_tune(args)
    return _run_show(args)


if __name__ == "__main__":
    raise SystemExit(main())
