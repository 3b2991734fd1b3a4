#!/usr/bin/env python3
"""Quickest proof that the torch port runs on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile  # also: kernel-time breakdown of a
                                     # served run (torch.profiler)

Phases, in order; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every ``dlnetbench_tpu_torch/ops/csrc/*.cu`` with nvcc for
   sm_90a (seconds and ptxas resource lines printed);
3. K1 (paged attention, bf16 pages) against its plain PyTorch version
   on the card at the decode shapes of the served model (B=8 slots,
   Hq=32, Hkv=8, Dh=128, page 16, 32 pages per slot, lengths 1..512
   with ragged last pages); tolerance 2e-2 absolute and relative, the
   JAX package's kernel-vs-gather bar (tests/test_serving.py), since the
   output is bf16.  Times (median of single launches with L2 flushed
   between them): the kernel, its plain version, and one
   ``scaled_dot_product_attention(enable_gqa=True)`` call on K/V
   gathered beforehand (a yardstick the port never calls), beside the
   bound: the bytes the call must move over the card's memory rate;
4. K2 (int8 and e4m3 pages) the same way, tolerance 2e-2 (bf16 output;
   the SDPA yardstick reads the pages dequantized beforehand);
5. a tiny f32 model served on the card and on the CPU (plain versions)
   with the same weights: greedy token streams must be equal, for each
   cache dtype;
6. serve through ``dlnetbench_tpu_torch.cli.main(["serve", ...])`` at
   llama3_8b width (4096 hidden, 32/8 heads, ff 14336, 4 layers, vocab
   32768, bf16) with 16 seeded poisson requests, once per cache dtype:
   every request completes with every token in the vocab, and the
   kernel's launch counter rose by layers x decode steps in that run;
7. the ``kernels`` JSON line, then the ``ok`` JSON line last.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
SRC = "dlnetbench_tpu_torch/ops/csrc/paged_attention.cu"

# decode shapes of the served model (llama3_8b width)
B, HQ, HKV, DH, PAGE, PMAX, NUM_PAGES = 8, 32, 8, 128, 16, 32, 512
LENGTHS = [1, 37, 100, 173, 260, 333, 421, 512]
TOL = 2e-2
SERVE_PLAN = {"kind": "poisson", "rate_rps": 1000, "num_requests": 16,
              "seed": 1, "prompt_len": [128, 384], "output_len": [32, 96]}
MODEL_FLAGS = ["--embed", "4096", "--heads", "32", "--kv_heads", "8",
               "--ff", "14336", "--layers", "4", "--vocab", "32768",
               "--dtype", "bfloat16"]
ENGINE_FLAGS = ["--slots", "8", "--page_size", "16", "--num_pages", "512",
                "--max_seq_len", "512", "--prefill_chunk", "64"]

# published H100 peaks (NVIDIA data sheet, dense): HBM bytes/s and
# tensor-core operations/s by input type, at the 700 W SXM limit
PEAK = {"SXM": {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12,
                "fp8": 1979e12},
        "PCIe": {"bytes": 2.0e12, "bf16": 756e12, "int8": 1513e12,
                 "fp8": 1513e12}}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: rc {smi.returncode} {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps: int = 30) -> float:
    """Median device time of one call, L2 flushed (a 256 MiB write)
    before each, timed with CUDA events around the call alone.  A spin
    of ~2 ms on the card sits before the first event, so the call's host
    side (Python, argument checks, launch) is queued behind it and the
    events see the device time only."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def decode_operands(torch, page_dtype: str):
    """Seeded operands at the served model's decode shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = "cuda"
    q = (torch.randn(B, HQ, DH, generator=gen, device=dev)
         * DH ** -0.5).to(torch.bfloat16)
    perm = torch.randperm(NUM_PAGES, generator=gen, device=dev)
    bt = perm[:B * PMAX].reshape(B, PMAX).to(torch.int32).contiguous()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    pools = [torch.randn(HKV, NUM_PAGES, PAGE, DH, generator=gen,
                         device=dev) for _ in range(2)]
    if page_dtype == "bf16":
        return q, [p.to(torch.bfloat16) for p in pools], None, lengths, bt
    from dlnetbench_tpu_torch.ops.quantized_matmul import (cast_q,
                                                           scale_from_amax)
    fmt = {"int8": "int8", "fp8": "float8"}[page_dtype]
    qp, sc = [], []
    for p in pools:
        s = scale_from_amax(p.abs().amax(dim=(2, 3)), fmt)
        qp.append(cast_q(p / s[:, :, None, None], fmt).contiguous())
        sc.append(s.contiguous())
    return q, qp, sc, lengths, bt


def bound(page_dtype: str, elt: int, peak: dict) -> tuple[float, str]:
    """Least time for the call: each valid token's K and V row read once
    (plus the touched pages' scales and block-table entries), q read and
    out written once; operations 4*Hq*Dh per token (QK^T and PV)."""
    pages = sum(math.ceil(n / PAGE) for n in LENGTHS)
    nbytes = (sum(LENGTHS) * HKV * DH * 2 * elt + 2 * B * HQ * DH * 2
              + pages * 4 + B * 4)
    if page_dtype != "bf16":
        nbytes += pages * HKV * 2 * 4
    ops = 4 * HQ * DH * sum(LENGTHS)
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = ops / peak[page_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                        "operations")


def kernel_phase(torch, page_dtype: str, peak: dict) -> dict:
    import torch.nn.functional as F

    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
    q, (kp, vp), sc, lengths, bt = decode_operands(torch, page_dtype)
    if page_dtype == "bf16":
        def kernel():
            return PA.paged_attention(q, kp, vp, lengths, bt)

        def plain():
            return PA.gather_attention(q, kp, vp, lengths, bt)
        k_deq = PA.take_pages(kp, bt.long()).movedim(0, 1)
        v_deq = PA.take_pages(vp, bt.long()).movedim(0, 1)
    else:
        fmt = {"int8": "int8", "fp8": "float8"}[page_dtype]

        def kernel():
            return PAQ.quant_paged_attention(q, kp, vp, sc[0], sc[1],
                                             lengths, bt, fmt=fmt)

        def plain():
            return PAQ.dequant_gather_attention(q, kp, vp, sc[0], sc[1],
                                                lengths, bt)
        idx = bt.long()
        k_deq = (PA.take_pages(kp, idx).float()
                 * sc[0][:, idx][..., None, None]).movedim(0, 1)
        v_deq = (PA.take_pages(vp, idx).float()
                 * sc[1][:, idx][..., None, None]).movedim(0, 1)
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = float((got.float() - ref.float()).abs().max())
    if not torch.isfinite(got).all():
        fail(f"{page_dtype}: kernel output not finite")
    if not torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL):
        fail(f"{page_dtype}: kernel vs plain max abs err {err} > {TOL}")
    # the yardstick: SDPA over K/V gathered (and dequantized) beforehand
    t = PMAX * PAGE
    kl = k_deq.reshape(B, HKV, t, DH).to(torch.bfloat16).contiguous()
    vl = v_deq.reshape(B, HKV, t, DH).to(torch.bfloat16).contiguous()
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask,
                                              scale=1.0, enable_gqa=True)
    lib_err = float((library()[:, :, 0].float() - ref.float()).abs().max())
    ms = timed_ms(torch, kernel)
    plain_ms = timed_ms(torch, plain, reps=10)
    library_ms = timed_ms(torch, library)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kernel()
    torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) / 50 * 1e6
    bound_ms, bound_by = bound(page_dtype, kp.element_size(), peak)
    say(f"kernel {page_dtype}: max_abs_err {err:.3e} (tol {TOL}), "
        f"sdpa err {lib_err:.3e}; kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
        f"{bound_ms:.4f} ({bound_by}) -> {bound_ms / ms:.3f} of bound; "
        f"back-to-back calls {call_us:.1f} us each (host wrapper "
        f"included)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def reference_phase(torch) -> None:
    """Tiny f32 model, same weights, on the card and on the CPU: the
    greedy token streams must be equal (K1/K2 on the card, their plain
    versions on the CPU)."""
    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.serving import scheduler as S
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mc = TransformerConfig(vocab_size=256, embed_dim=256, num_heads=4,
                           num_kv_heads=2, ff_dim=512, num_layers=2,
                           seq_len=64, dtype="float32")
    plan = ArrivalPlan.from_dict({"kind": "poisson", "rate_rps": 500.0,
                                  "num_requests": 6, "seed": 3,
                                  "prompt_len": [5, 20],
                                  "output_len": [4, 12]})
    cpu_params = init_params(mc, seed=5, device="cpu")
    gpu_params = {k: ({n: w.cuda() for n, w in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    for cd in ("bf16", "int8", "fp8"):
        cfg = S.ServingConfig(slots=4, page_size=16, num_pages=32,
                              max_seq_len=64, prefill_chunk=8,
                              cache_dtype=cd, warmup_requests=0)
        streams = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            eng = S.Engine(mc, cfg, params=params, device=dev)
            eng.run(plan.sample())
            streams[dev] = eng.token_streams
        if streams["cuda"] != streams["cpu"]:
            fail(f"reference {cd}: card streams {streams['cuda']} != CPU "
                 f"plain streams {streams['cpu']}")
        say(f"reference {cd}: {len(streams['cuda'])} greedy streams equal "
            f"on the card and on the CPU")


def serve_phase(torch, cache_dtype: str) -> dict:
    from dlnetbench_tpu_torch import cli
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
    from dlnetbench_tpu_torch.serving import scheduler as S
    engines = []
    engine_cls = S.Engine

    class RecordedEngine(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    out = OUT / f"serve_{cache_dtype}.jsonl"
    out.unlink(missing_ok=True)
    S.Engine = RecordedEngine
    try:
        PA.launches = PAQ.launches = S.decode_dispatches = 0
        t0 = time.perf_counter()
        rc = cli.main(["serve", "--arrival", json.dumps(SERVE_PLAN),
                       *MODEL_FLAGS, *ENGINE_FLAGS, "--cache_dtype",
                       cache_dtype, "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"k1": PA.launches, "k2": PAQ.launches,
                  "steps": S.decode_dispatches}
    finally:
        S.Engine = engine_cls
    if rc != 0:
        fail(f"serve {cache_dtype}: cli rc {rc}")
    rec = json.loads(out.read_text().splitlines()[-1])
    srv = rec["global"]["serving"]
    if srv["completed"] != SERVE_PLAN["num_requests"]:
        fail(f"serve {cache_dtype}: {srv['completed']} of "
             f"{SERVE_PLAN['num_requests']} requests completed")
    eng = engines[-1]
    for c in eng.completed:
        toks = eng.token_streams[c.rid]
        if len(toks) != c.output_len or not all(0 <= t < 32768
                                                for t in toks):
            fail(f"serve {cache_dtype}: request {c.rid} tokens {toks[:8]}"
                 f"... (len {len(toks)}, want {c.output_len} in vocab)")
    layers = int(MODEL_FLAGS[MODEL_FLAGS.index("--layers") + 1])
    mine, other = (("k1", "k2") if cache_dtype == "bf16"
                   else ("k2", "k1"))
    if counts[mine] != layers * counts["steps"] or counts[mine] == 0 \
            or counts[other] != 0:
        fail(f"serve {cache_dtype}: launches {counts} != {layers} layers "
             f"x {counts['steps']} decode steps on {mine}")
    say(f"serve {cache_dtype}: {srv['completed']} requests, "
        f"{counts[mine]} {mine} launches = {layers} x {counts['steps']} "
        f"decode steps (warm-up run included); ttft p50 "
        f"{srv['ttft_ms']['p50']} p99 {srv['ttft_ms']['p99']} ms, tpot "
        f"p50 {srv['tpot_ms']['p50']} ms, {srv['tokens_per_s']} tokens/s, "
        f"wall {srv['wall_s']} s (cli {wall:.1f} s); decode_loop "
        f"{json.dumps(srv['decode_loop'])}")
    return {"launches": counts[mine], "serving": srv}


def profile_phase(torch) -> None:
    """Kernel-time breakdown of a served run at the same width (bf16 and
    int8 caches), from torch.profiler's device events; the rows go to
    build/chip_smoke/profile_<cache>.json."""
    from torch.profiler import ProfilerActivity, profile

    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.serving import scheduler as S
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    mc = TransformerConfig(vocab_size=32768, embed_dim=4096, num_heads=32,
                           num_kv_heads=8, ff_dim=14336, num_layers=4,
                           seq_len=512, dtype="bfloat16")
    for cd in ("bf16", "int8"):
        cfg = S.ServingConfig(slots=8, page_size=16, num_pages=512,
                              max_seq_len=512, prefill_chunk=64,
                              cache_dtype=cd, warmup_requests=8)
        eng = S.Engine(mc, cfg, params=init_params(mc, device="cuda"))
        plan = ArrivalPlan.from_dict({**SERVE_PLAN, "num_requests": 8})
        S.run_serving(mc, cfg, plan, engine=eng)     # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(plan.sample())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0)),
                 e.count) for e in prof.key_averages()]
        rows = [r for r in rows if r[1] > 0]
        busy = sum(r[1] for r in rows if not r[0].startswith("aten::")
                   and not r[0].startswith("cuda"))
        top = sorted(rows, key=lambda r: -r[1])[:40]
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / f"profile_{cd}.json").write_text(json.dumps(
            {"wall_s": wall, "rows": top}, indent=1))
        say(f"profile {cd}: wall {wall:.3f} s, kernel time "
            f"{busy / 1e6:.3f} s ({busy / 1e6 / wall:.3f} of wall; "
            f"device idle share {1 - busy / 1e6 / wall:.3f})")
        for key, t_us, n in top:
            if key.startswith("aten::") or key.startswith("cuda"):
                continue
            say(f"  {t_us / 1e3:10.3f} ms  {n:6d}x  {key[:90]}")


def main(argv: list[str]) -> int:
    if not (ROOT / "dlnetbench_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"no dlnetbench_tpu_torch package beside {__file__}: run "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{name}; count {torch.cuda.device_count()}")
    peak = PEAK["PCIe" if "PCIe" in name else "SXM"]
    OUT.mkdir(parents=True, exist_ok=True)

    from dlnetbench_tpu_torch.ops import _build
    build = _build.build()
    say(f"build: {len(build.libs)} kernel libraries in "
        f"{build.seconds:.1f} s")
    for src, log in build.log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {src}: {line.strip()}")

    results = {dt: kernel_phase(torch, dt, peak)
               for dt in ("bf16", "int8", "fp8")}
    reference_phase(torch)
    served = {dt: serve_phase(torch, dt) for dt in ("bf16", "int8", "fp8")}
    if "--profile" in argv:
        profile_phase(torch)

    kernels = []
    for dt, label, replaces in (
            ("bf16", "K1 paged_attention (bf16 pages)",
             "dlnetbench_tpu/serving/kv_cache.py:768"),
            ("int8", "K2 quant_paged_attention (int8 pages)",
             "dlnetbench_tpu/ops/paged_attention_quant.py:48"),
            ("fp8", "K2 quant_paged_attention (e4m3 pages)",
             "dlnetbench_tpu/ops/paged_attention_quant.py:48")):
        kernels.append({"name": label, "route": "cuda", "source": SRC,
                        "replaces": replaces,
                        "launches": served[dt]["launches"],
                        **results[dt]})
    say(card)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
