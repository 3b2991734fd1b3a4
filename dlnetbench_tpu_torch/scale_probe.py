"""Serving at scale on the cards there are:

    python -m dlnetbench_tpu_torch.scale_probe [--out PATH]

1. ``migration``: the page-migration channel at the served geometry
   (4 layers, 8 KV heads, 16-token pages, Dh 128): 24 seeded pages in
   8-page chunks, one fenced send after a warm one, ``REPS`` sends a
   variant, on one card (cuda:0 -> cuda:0) and across two (cuda:0 ->
   cuda:1), in turns (one, two, two, one); ms a send and a page, per
   cache dtype.
2. ``kv_shard``: ``cli serve`` at llama3_8b width (4 layers, 8 slots,
   page 16, 16 seeded poisson requests, ``chip_smoke.py``'s served
   model and plan) with ``--kv_shard`` 1, 2 and 4 over the first cards,
   in turns (1, 2, 4, 4, 2, 1); TPOT and TTFT p50, tokens/s, and K1's
   launches over device steps.
3. the bench's ``disagg_ab`` and ``fleet_ab`` lines on the first two
   cards.

Each result is one JSON line on stdout (and appended to ``--out``),
beside the card's name and power limit.  Needs two cards (four for
``kv_shard`` 4; fewer shards run on fewer cards).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

REPS = 7
PLAN = {"kind": "poisson", "rate_rps": 1000, "num_requests": 16,
        "seed": 1, "prompt_len": [128, 384], "output_len": [32, 96]}
MODEL_FLAGS = ["--embed", "4096", "--heads", "32", "--kv_heads", "8",
               "--ff", "14336", "--layers", "4", "--vocab", "32768",
               "--dtype", "bfloat16"]
ENGINE_FLAGS = ["--slots", "8", "--page_size", "16", "--num_pages", "512",
                "--max_seq_len", "512", "--prefill_chunk", "64"]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def emit(out, line: dict) -> None:
    print(json.dumps(line), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")


def migration_ms(torch, src_dev, dst_dev, cache_dtype: str) -> float:
    """One fenced 24-page send ``src_dev -> dst_dev`` after a warm one,
    ms (the channel's own wall: dispatch to arrival)."""
    from dlnetbench_tpu_torch.ops.page_migration import MigrationChannel
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    cfg = KV.CacheConfig(num_layers=4, num_kv_heads=8, head_dim=128,
                         num_pages=64, page_size=16, max_seqs=8,
                         max_pages_per_seq=32, dtype="bfloat16",
                         cache_dtype=cache_dtype).validate()
    g = torch.Generator(device=src_dev)
    g.manual_seed(5)
    src = [torch.randn(t.shape, generator=g, device=src_dev).to(t.dtype)
           for t in KV.device_buffers(cfg, src_dev)]
    ch = MigrationChannel(cfg, dst_dev, chunk_pages=8)
    ids = list(range(3, 51, 2))
    ch.send(src, ids)
    ch.reset()
    ch.send(src, ids)
    return ch._sends[0].wall_ms


def migration(torch, out, name: str) -> None:
    one, two = (torch.device("cuda", 0),) * 2, (torch.device("cuda", 0),
                                                torch.device("cuda", 1))
    for dt in ("bf16", "int8"):
        ms = {"one": [], "two": []}
        for _ in range(REPS):
            for key, pair in (("one", one), ("two", two), ("two", two),
                              ("one", one)):
                ms[key].append(migration_ms(torch, *pair, dt))
        line = {"probe": "migration", "cache_dtype": dt, "pages": 24,
                "card": name}
        for key, vals in ms.items():
            med = statistics.median(vals)
            line[key] = {"ms_p50": round(med, 4),
                         "ms_min": round(min(vals), 4),
                         "ms_max": round(max(vals), 4),
                         "us_a_page": round(med / 24 * 1e3, 2),
                         "n": len(vals)}
        emit(out, line)


def kv_shard(torch, out, name: str, tmp: str) -> None:
    from dlnetbench_tpu_torch import cli
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.serving import scheduler as S
    n = torch.cuda.device_count()
    shards = [k for k in (1, 2, 4) if k <= n]
    rows = {k: [] for k in shards}
    for k in shards + shards[::-1]:
        path = f"{tmp}/kv{k}.jsonl"
        PA.launches = 0
        S.decode_device_steps = 0
        rc = cli.main(["serve", "--arrival", json.dumps(PLAN),
                       *MODEL_FLAGS, *ENGINE_FLAGS, "--kv_shard", str(k),
                       "--devices", ",".join(f"cuda:{i}"
                                             for i in range(k)),
                       "--out", path])
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"kv_shard {k}: cli rc {rc}")
        srv = json.loads(open(path).read().splitlines()[-1])["global"][
            "serving"]
        rows[k].append({"tpot_p50_ms": srv["tpot_ms"]["p50"],
                        "ttft_p50_ms": srv["ttft_ms"]["p50"],
                        "tokens_per_s": srv["tokens_per_s"],
                        "k1_launches": PA.launches,
                        "device_steps": S.decode_device_steps})
    for k, runs in rows.items():
        emit(out, {"probe": "kv_shard", "kv_shard": k, "card": name,
                   "runs": runs})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "dlnetbench_tpu_torch.scale_probe")
    p.add_argument("--out", default=None)
    p.add_argument("--tmp", default="build/scale_probe")
    args = p.parse_args(argv)
    import os

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("scale_probe: needs two CUDA cards", file=sys.stderr)
        return 1
    os.makedirs(args.tmp, exist_ok=True)
    name = card()
    print(f"card: {name}; count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    migration(torch, args.out, name)
    kv_shard(torch, args.out, name, args.tmp)
    from dlnetbench_tpu_torch import bench
    dev = torch.device("cuda", 0)
    dev_name = torch.cuda.get_device_name(0)
    for key, fn in (("disagg_ab", bench.bench_disagg_ab),
                    ("fleet_ab", bench.bench_fleet_ab)):
        line = fn(dev_name, dev)
        emit(args.out, {"probe": key, "card": name, "line": line})
    print(f"scale_probe: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
