#!/usr/bin/env python3
"""Quickest proof that the torch port runs on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile  # also: kernel-time breakdowns of a
                                     # served run and of the train step
                                     # under each MLP recipe
                                     # (torch.profiler)

Phases, in order; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every ``dlnetbench_tpu_torch/ops/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, in parallel; seconds and ptxas resource
   lines printed);
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
5. K3/K4/K5 (flash attention forward, dq, dk/dv) against their plain
   versions at the train step's shapes (B=2, S=6144, Hq=32, Hkv=8,
   Dh=128, bf16, causal), plus a non-causal and a Dh=64 case at S=1024;
   each kernel is held alone (the plain backward reads the kernel's O,
   lse and D).  Tolerances: every row of O, dq, dk and dv (the Dh
   values of one batch, position and head) within 2^-6 of that row's
   own max-abs (floored at 1e-3 of the tensor's, for rows that cancel
   to ~0) — both sides round the output to bf16 (one ulp apart at
   most, <= 2^-7 of the row's largest value) after f32 sums of the same
   bf16-rounded p and ds taken in another order; a bar per row keeps it
   at the scale of the values it separates, where late rows of O and
   late keys' dk/dv are ten times under their tensor's max-abs.  lse
   and D 1e-3 absolute.  Times as in 3, at the train shape; the yardsticks
   are SDPA's forward (K3) and SDPA's backward, which computes dq, dk
   and dv together (K4 and K5 both list it);
5b. K11 (the fused-quantization matmul) at the train step's MLP shapes
   (gate/up [12288, 4096] @ [4096, 14336], down [12288, 14336] @
   [14336, 4096]), int8 and e4m3, with and without amax, against its
   plain version on the card: int8 bit-exact; e4m3 every row within
   2^-6 of its max-abs and a relative Frobenius error <= 1e-2 (the JAX
   bar); amax exactly max |x|; a stale scale (0.1 x the amax) gives a
   finite, saturated output equal to the plain version's.  Yardstick:
   ``torch._int_mm`` / ``torch._scaled_mm`` on operands quantized
   beforehand;
5c. K9 (dg, du) and K10 (dWd) at the same shape against their plain
   versions: dg and du every row within 2^-6 of its max-abs, dWd within
   1e-3; yardsticks one ``torch.mm`` each (dy @ Wd^T, h^T @ dy);
6. a tiny f32 model served on the card and on the CPU (plain versions)
   with the same weights: greedy token streams must be equal, for each
   cache dtype;
7. serve through ``dlnetbench_tpu_torch.cli.main(["serve", ...])`` at
   llama3_8b width (4096 hidden, 32/8 heads, ff 14336, 4 layers, vocab
   32768, bf16) with 16 seeded poisson requests, once per cache dtype:
   every request completes with every token in the vocab, and the
   kernel's launch counter rose by layers x decode steps in that run;
8. a tiny f32 model (TF32 off) takes 2 SGD steps on the card (K3/K4/K5,
   f32 kernels) and on the CPU (plain versions) from the same weights
   and tokens: losses within 1e-5 relative and every parameter within
   1e-5 of its tensor's max-abs (f32 on both sides; summation order);
8b. the MLP recipes' train steps at the bench shape through
   ``bench_step.build`` (counters reset before and read after each):
   int8 composed and fused give bitwise-equal first losses and K11
   launched 3 x layers x steps in the fused run; e4m3 fused with delayed
   scaling keeps finite losses and moves its qstate off the initial
   ones, then holds it within 5 %; ``mlp_backward="pallas"`` gives the
   autograd loss bitwise and every gradient leaf within 2e-2 of its
   max-abs, with K9 and K10 launched layers x steps;
9. train through ``dlnetbench_tpu_torch.bench.main([])`` at the bench
   shape (llama3_8b width, 4 layers, vocab 32768, B=2, S=6144, bf16):
   the MLP aux lines come first, under the headline's keys, with the A/B
   bands and int8_step's loss within 2 % of the headline's; the headline
   line has a finite loss within 1.5 of ln(32768) and vs_baseline in
   (0, 1.05]; each of K3/K4/K5 launched layers x steps times (warm calls
   included) and K11 as often as the A/B chains launch it;
10. ``dlnetbench_tpu_torch.entry.entry()`` forward once at S=1024: logits
   [1, 1024, 32768], finite, K3 launched once per layer;
11. the ``kernels`` JSON line, then the ``ok`` JSON line last.
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
FLASH_SRC = "dlnetbench_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {"fwd": "dlnetbench_tpu/ops/flash_attention.py:126",
                  "dq": "dlnetbench_tpu/ops/flash_attention.py:242",
                  "dkv": "dlnetbench_tpu/ops/flash_attention.py:279"}

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

# the train step's attention shapes (b, s, hq, hkv, dh, causal) first,
# then a non-causal and a Dh=64 case
FLASH_CASES = [(2, 6144, 32, 8, 128, True), (1, 1024, 32, 8, 128, False),
               (1, 1024, 16, 4, 64, True)]
# O, dq, dk, dv: each row (the Dh values of one batch, position and head)
# against 2^-6 of that row's own max-abs (floored at 1e-3 of the
# tensor's); lse and D: absolute
FLASH_TOL_ROW, FLASH_TOL_LSE = 2.0 ** -6, 1e-3

MLP_SRC = "dlnetbench_tpu_torch/ops/csrc/mlp_matmul.cu"
MLP_REPLACES = {"k11": "dlnetbench_tpu/ops/quantized_matmul.py:112",
                "k9": "dlnetbench_tpu/ops/mlp_backward.py:50",
                "k10": "dlnetbench_tpu/ops/mlp_backward.py:103"}
# the train step's MLP: T = B * S tokens, hidden D, ff F
MLP_T, MLP_D, MLP_F = 12288, 4096, 14336
# K11 e4m3 (bf16 output): each row within 2^-6 of its max-abs and a
# relative Frobenius error <= 1e-2 (the JAX bar); int8 is bit-exact
E4M3_TOL_ROW, E4M3_TOL_FRO = 2.0 ** -6, 1e-2
# K9 dg/du (bf16 outputs, one ulp apart at most): 2^-6 of the row's
# max-abs; K10 dWd (f32 output; summation order differs, and the kernel's
# approximate sigmoid can move an element of the recomputed h by one bf16
# rounding): 1e-3 of the row's max-abs
DGDU_TOL_ROW, DWD_TOL_ROW = 2.0 ** -6, 1e-3
# mlp_backward="pallas" vs the autograd backward, each gradient leaf
# within this share of its max-abs: the default path rounds dh and the
# f32 silu-gradient terms to bf16 where K9 keeps dh in f32 registers
PALLAS_TOL_LEAF = 2e-2


def abs_err(a, r) -> float:
    return float((a.float() - r.float()).abs().max())


def row_err(a, r) -> float:
    """Worst row's max abs error over the plain row's max-abs, the latter
    floored at 1e-3 of the tensor's: a row that cancels to ~0 (dq of
    query 0 under the causal mask: O = v_0, so dp - D = 0) keeps f32
    rounding of its terms."""
    err = (a.float() - r.float()).abs().amax(dim=-1)
    scale = r.float().abs().amax(dim=-1)
    return float((err / scale.clamp_min(1e-3 * scale.max())).max())


def fro_err(a, r) -> float:
    """Relative Frobenius error ||a - r|| / ||r||."""
    d = (a.float() - r.float()).norm()
    return float(d / r.float().norm().clamp_min(1e-30))


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


def flash_operands(torch, b, s, hq, hkv, dh, seed=0):
    """Seeded bf16 q, k, v and an output cotangent dO."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    return (rand(b, s, hq, dh), rand(b, s, hkv, dh), rand(b, s, hkv, dh),
            rand(b, s, hq, dh))


def flash_bound(kind: str, b, s, hq, hkv, dh, causal,
                peak: dict) -> tuple[float, str]:
    """Least time for one launch: each operand read once and each output
    written once (bf16 rows, f32 lse/D), against 2 * B * Hq * Dh
    operations per (query, key) pair this run attends (the causal
    triangle, diagonal included) and per product — 2 products in the
    forward, 3 in dq (s, dp, dq), 4 in dk/dv (s, dv, dp, dk)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    ops = 2 * products * b * hq * dh * pairs
    big, small, row = b * s * hq * dh * 2, b * s * hkv * dh * 2, b * hq * s * 4
    nbytes = {"fwd": big + 2 * small + big + row,
              "dq": 3 * big + 2 * small + row + big + row,
              "dkv": 2 * big + 2 * small + 2 * row + 2 * small}[kind]
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = ops / peak["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(torch, case, peak: dict, timed: bool) -> dict:
    """K3, K4 and K5 each against its plain version on the same inputs
    (the plain backward reads the kernels' O, lse and D); with ``timed``,
    their times beside the plain versions', SDPA's and the bound."""
    import torch.nn.functional as F

    from dlnetbench_tpu_torch.ops import flash_attention as FA
    b, s, hq, hkv, dh, causal = case
    q, k, v, do = flash_operands(torch, b, s, hq, hkv, dh)
    out, lse = FA.kernel_forward(q, k, v, causal)
    dq, dcap = FA.kernel_dq(q, k, v, out, lse, do, causal)
    dk, dv = FA.kernel_dkv(q, k, v, do, lse, dcap, causal)
    torch.cuda.synchronize()
    p_out, p_lse = FA.plain_forward(q, k, v, causal)
    p_dq, p_dcap = FA.plain_dq(q, k, v, out, lse, do, causal)
    p_dk, p_dv = FA.plain_dkv(q, k, v, do, lse, dcap, causal)

    pairs = {"o": (out, p_out), "lse": (lse, p_lse), "d": (dcap, p_dcap),
             "dq": (dq, p_dq), "dk": (dk, p_dk), "dv": (dv, p_dv)}
    errs = {n: abs_err(a, r) for n, (a, r) in pairs.items()}
    rows = {n: row_err(*pairs[n]) for n in ("o", "dq", "dk", "dv")}
    label = f"flash {case}"
    for name, t in (("o", out), ("lse", lse), ("dq", dq), ("dk", dk),
                    ("dv", dv)):
        if not torch.isfinite(t).all():
            fail(f"{label}: {name} not finite")
    say(f"{label}: worst row err / row max-abs O {rows['o']:.3e} dq "
        f"{rows['dq']:.3e} dk {rows['dk']:.3e} dv {rows['dv']:.3e} (bar "
        f"{FLASH_TOL_ROW:.3e}); max abs err O {errs['o']:.3e} lse "
        f"{errs['lse']:.3e} D {errs['d']:.3e} (bar {FLASH_TOL_LSE}) dq "
        f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e}; "
        f"max-abs O {float(p_out.float().abs().max()):.3e} dq "
        f"{float(p_dq.float().abs().max()):.3e} dk "
        f"{float(p_dk.float().abs().max()):.3e} dv "
        f"{float(p_dv.float().abs().max()):.3e}")
    bad = [f"{n} row err {e:.3e} > {FLASH_TOL_ROW:.3e} of the row's "
           f"max-abs" for n, e in rows.items() if not e <= FLASH_TOL_ROW]
    bad += [f"{n} max abs err {errs[n]:.3e} > {FLASH_TOL_LSE}"
            for n in ("lse", "d") if not errs[n] <= FLASH_TOL_LSE]
    if bad:
        fail(f"{label}: kernels disagree with their plain versions: "
             f"{'; '.join(bad)}")
    del p_out, p_lse, p_dq, p_dcap, p_dk, p_dv
    if not timed:
        return {}
    # the yardsticks: SDPA on [B, H, S, Dh] views of the same tensors
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=True)
        return torch.autograd.grad(o, leaves, dot)
    sdpa_err = abs_err(sdpa_fwd().transpose(1, 2), out)
    runs = {
        "fwd": (lambda: FA.kernel_forward(q, k, v, causal),
                lambda: FA.plain_forward(q, k, v, causal)),
        "dq": (lambda: FA.kernel_dq(q, k, v, out, lse, do, causal),
               lambda: FA.plain_dq(q, k, v, out, lse, do, causal)),
        "dkv": (lambda: FA.kernel_dkv(q, k, v, do, lse, dcap, causal),
                lambda: FA.plain_dkv(q, k, v, do, lse, dcap, causal)),
    }
    lib_fwd = timed_ms(torch, sdpa_fwd)
    lib_bwd = timed_ms(torch, sdpa_fwd_bwd) - lib_fwd
    results = {}
    for kind, (kernel, plain) in runs.items():
        ms = timed_ms(torch, kernel)
        plain_ms = timed_ms(torch, plain, reps=5)
        bound_ms, bound_by = flash_bound(kind, *case, peak)
        err = {"fwd": errs["o"], "dq": errs["dq"],
               "dkv": max(errs["dk"], errs["dv"])}[kind]
        results[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_fwd if kind == "fwd" else lib_bwd}
        say(f"flash {kind}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"bound_ms {bound_ms:.4f} ({bound_by}) -> {bound_ms / ms:.3f} "
            f"of bound")
    say(f"flash yardsticks: SDPA forward {lib_fwd:.4f} ms (err vs K3 "
        f"{sdpa_err:.3e}), SDPA backward (dq, dk, dv together) "
        f"{lib_bwd:.4f} ms against K4 + K5 "
        f"{results['dq']['ms'] + results['dkv']['ms']:.4f} ms")
    return results


def flash_counts() -> dict:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    return {"fwd": FA.fwd_launches, "dq": FA.dq_launches,
            "dkv": FA.dkv_launches}


def reset_flash_counts() -> None:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    FA.fwd_launches = FA.dq_launches = FA.dkv_launches = 0


def train_reference_phase(torch) -> None:
    """Tiny f32 model (TF32 off), same weights and tokens, 2 SGD steps on
    the card (the f32 flash kernels) and on the CPU (plain versions)."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(vocab_size=256, embed_dim=256, num_heads=2,
                              num_kv_heads=1, ff_dim=512, num_layers=2,
                              seq_len=128, dtype="float32",
                              logits_f32=False)
    cpu = T.init_params(cfg, seed=7, device="cpu")
    gpu = {k: ({n: w.cuda() for n, w in v.items()}
               if isinstance(v, dict) else v.cuda())
           for k, v in cpu.items()}
    gen = torch.Generator()
    gen.manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len + 1),
                           generator=gen)
    step = BS.make_train_k(cfg, 2)
    start = [p.clone() for p in BS.leaves(cpu)]
    reset_flash_counts()
    _, gpu_losses = step(gpu, tokens.cuda())
    torch.cuda.synchronize()
    counts = flash_counts()
    _, cpu_losses = step(cpu, tokens)
    want = cfg.num_layers * 2
    if counts != {"fwd": want, "dq": want, "dkv": want}:
        fail(f"train reference: flash launches {counts}, want {want} each")
    gl, cl = gpu_losses.cpu(), cpu_losses
    if not torch.allclose(gl, cl, rtol=1e-5, atol=0) or not gl[1] < gl[0]:
        fail(f"train reference: card losses {gl.tolist()} vs CPU "
             f"{cl.tolist()}")
    # the update itself (two steps at lr 1e-3 move a weight ~1e-6), each
    # element within two f32 ulps of its weight (each side rounds
    # p - lr * g twice) plus 1e-3 of the leaf's largest move
    worst = 0.0
    for p0, c, g in zip(start, BS.leaves(cpu), BS.leaves(gpu)):
        moved, ref = g.cpu() - p0, c - p0
        ulp = torch.nextafter(p0.abs(), torch.tensor(math.inf)) - p0.abs()
        lim = 2 * ulp + 1e-3 * ref.abs().max()
        worst = max(worst, float(((moved - ref).abs() / lim).max()))
        if not float(ref.abs().max()) > 0 or worst > 1:
            fail(f"train reference: a leaf's update differs between card "
                 f"and CPU by {worst:.3e} of its bar (or did not move)")
    say(f"train reference: 2 f32 SGD steps, losses card {gl.tolist()} CPU "
        f"{cl.tolist()}; every weight's update within {worst:.3e} of its "
        f"bar (2 ulps + 1e-3 of the leaf's largest move); flash launches "
        f"{counts}")


def reset_mlp_counts() -> None:
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    Q.fused_launches = MB.dgdu_launches = MB.dwd_launches = 0


def mlp_counts() -> dict:
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    return {"k11": Q.fused_launches, "k9": MB.dgdu_launches,
            "k10": MB.dwd_launches}


def seeded(torch, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)
    return rand


def bound_ms(ops: float, nbytes: float, peak: dict,
             kind: str) -> tuple[float, str]:
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = ops / peak[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmm_check(torch, fmt: str, y, ref, label: str) -> dict:
    """K11 against its plain version: int8 bit-exact, e4m3 by row and
    Frobenius bars; both finite."""
    if not torch.isfinite(y.float()).all():
        fail(f"{label}: output not finite")
    errs = {"max_abs_err": abs_err(y, ref), "row": row_err(y, ref),
            "fro": fro_err(y, ref)}
    if fmt == "int8":
        if not torch.equal(y, ref):
            fail(f"{label}: int8 kernel differs from the plain version "
                 f"(max abs err {errs['max_abs_err']:.3e}); it must be "
                 f"bit-exact")
    elif not (errs["row"] <= E4M3_TOL_ROW and errs["fro"] <= E4M3_TOL_FRO):
        fail(f"{label}: e4m3 row err {errs['row']:.3e} (bar "
             f"{E4M3_TOL_ROW:.3e}), Frobenius {errs['fro']:.3e} (bar "
             f"{E4M3_TOL_FRO})")
    return errs


def qmm_phase(torch, fmt: str, peak: dict) -> dict:
    """K11 at the train step's MLP shapes (gate/up [T, D] @ [D, F], down
    [T, F] @ [F, D]), with and without amax, against the plain version on
    the card; a stale-scale case; times at the up-projection shape."""
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    kind = "int8" if fmt == "int8" else "fp8"
    rand = seeded(torch, 21)
    out, worst = {}, 0.0
    for proj, (k, n) in (("up", (MLP_D, MLP_F)), ("down", (MLP_F, MLP_D))):
        x = rand(MLP_T, k)
        w = rand(k, n, scale=k ** -0.5)
        wq, sw = Q.quantize_tensor(w, fmt)
        w_t = Q.k_major(wq)
        amax = Q.amax_of(x)
        sx = Q.scale_from_amax(amax, fmt)
        for collect in (False, True):
            y, am = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt, collect)
            torch.cuda.synchronize()
            ref, _ = Q.plain_fused_matmul(x, wq, sw, sx, fmt, False)
            label = f"K11 {kind} {proj} amax={collect}"
            errs = qmm_check(torch, fmt, y, ref, label)
            if collect and not torch.equal(am, amax):
                fail(f"{label}: amax {float(am)} != max|x| {float(amax)}")
            worst = max(worst, errs["max_abs_err"])
            say(f"{label}: max abs err {errs['max_abs_err']:.3e}, worst "
                f"row {errs['row']:.3e}, Frobenius {errs['fro']:.3e}"
                + (f"; amax {float(am)} exact" if collect else ""))
            del y, ref
        if proj == "up":
            out = qmm_times(torch, fmt, x, wq, w_t, sw, sx, peak)
        del x, w, wq, w_t
        torch.cuda.empty_cache()
    # a stale carried amax (0.1 of the truth): saturated, finite, equal
    # to the plain version's saturated result
    x = rand(1024, MLP_D)
    wq, sw = Q.quantize_tensor(rand(MLP_D, MLP_D, scale=MLP_D ** -0.5),
                               fmt)
    stale = Q.scale_from_amax(0.1 * Q.amax_of(x), fmt)
    y, am = Q.kernel_fused_matmul(x, Q.k_major(wq), sw, stale, fmt, True)
    torch.cuda.synchronize()
    ref, _ = Q.plain_fused_matmul(x, wq, sw, stale, fmt, False)
    errs = qmm_check(torch, fmt, y, ref, f"K11 {kind} stale scale")
    fresh, _ = Q.plain_fused_matmul(x, wq, sw, Q.scale_from_amax(
        Q.amax_of(x), fmt), fmt, False)
    if torch.equal(y, fresh) or not torch.equal(am, Q.amax_of(x)):
        fail(f"K11 {kind} stale scale: output not saturated or amax "
             f"{float(am)} not fresh")
    say(f"K11 {kind} stale scale (0.1 x amax): finite, saturated, max abs "
        f"err vs plain {errs['max_abs_err']:.3e}; amax out fresh")
    return {"max_abs_err": max(worst, errs["max_abs_err"]), **out}


def qmm_times(torch, fmt, x, wq, w_t, sw, sx, peak) -> dict:
    """K11, its plain version and the library product on operands
    quantized beforehand, at [T, D] @ [D, F]."""
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    kind = "int8" if fmt == "int8" else "fp8"
    t, k = x.shape
    n = w_t.shape[0]
    xq = Q.cast_q(x.float() / sx, fmt)
    if fmt == "int8":
        def library():
            return torch._int_mm(xq, w_t.t())
    else:
        def library():
            return torch._scaled_mm(xq, w_t.t(), scale_a=sx, scale_b=sw,
                                    out_dtype=torch.bfloat16)
    y, _ = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt, False)
    lib = library()
    ref = (lib.float() * (sx * sw)).to(torch.bfloat16) if fmt == "int8" \
        else lib
    lib_err = abs_err(y, ref)
    del y, lib, ref
    ms = timed_ms(torch, lambda: Q.kernel_fused_matmul(x, w_t, sw, sx, fmt,
                                                       False))
    plain_ms = timed_ms(torch, lambda: Q.plain_fused_matmul(
        x, wq, sw, sx, fmt, False), reps=5)
    library_ms = timed_ms(torch, library)
    b_ms, b_by = bound_ms(2 * t * k * n, t * k * 2 + k * n + t * n * 2,
                          peak, kind)
    say(f"K11 {kind}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} ({'torch._int_mm' if fmt == 'int8' else 'torch._scaled_mm'}, "
        f"err vs K11 {lib_err:.3e}) bound_ms {b_ms:.4f} ({b_by}) -> "
        f"{b_ms / ms:.3f} of bound, {2 * t * k * n / ms / 1e9:.1f} T/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def mlp_bwd_phase(torch, peak: dict) -> dict:
    """K9 and K10 at the train step's MLP shape against their plain
    versions on the card; times beside the plain versions', one
    torch.mm each (dy . Wd^T; h^T . dy on h computed beforehand) and the
    bound."""
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    rand = seeded(torch, 31)
    t, d, f = MLP_T, MLP_D, MLP_F
    dy = rand(t, d, scale=0.1)
    wd = rand(f, d, scale=f ** -0.5)
    g, u = rand(t, f), rand(t, f)
    dg, du = MB.kernel_dgdu(dy, wd, g, u)
    dw = MB.kernel_dwd(g, u, dy)
    torch.cuda.synchronize()
    pdg, pdu = MB.plain_dgdu(dy, wd, g, u)
    pdw = MB.plain_dwd(g, u, dy)
    for name, a in (("dg", dg), ("du", du), ("dWd", dw)):
        if not torch.isfinite(a.float()).all():
            fail(f"K9/K10: {name} not finite")
    rows = {"dg": row_err(dg, pdg), "du": row_err(du, pdu),
            "dwd": row_err(dw, pdw)}
    errs = {"k9": max(abs_err(dg, pdg), abs_err(du, pdu)),
            "k10": abs_err(dw, pdw)}
    say(f"K9/K10: worst row err / row max-abs dg {rows['dg']:.3e} du "
        f"{rows['du']:.3e} (bar {DGDU_TOL_ROW:.3e}) dWd {rows['dwd']:.3e} "
        f"(bar {DWD_TOL_ROW}); max abs err K9 {errs['k9']:.3e} K10 "
        f"{errs['k10']:.3e}")
    if not (rows["dg"] <= DGDU_TOL_ROW and rows["du"] <= DGDU_TOL_ROW
            and rows["dwd"] <= DWD_TOL_ROW):
        fail(f"K9/K10 disagree with their plain versions: {rows}")
    del dg, du, dw, pdg, pdu, pdw
    h = MB.silu_parts(g.float())[0].mul_(u.float()).to(torch.bfloat16)
    runs = {
        "k9": (lambda: MB.kernel_dgdu(dy, wd, g, u),
               lambda: MB.plain_dgdu(dy, wd, g, u),
               lambda: torch.mm(dy, wd.t()),
               t * d * 2 + f * d * 2 + 4 * t * f * 2),
        "k10": (lambda: MB.kernel_dwd(g, u, dy),
                lambda: MB.plain_dwd(g, u, dy),
                lambda: torch.mm(h.t(), dy, out_dtype=torch.float32),
                2 * t * f * 2 + t * d * 2 + f * d * 4),
    }
    out = {}
    for name, (kernel, plain, library, nbytes) in runs.items():
        ms = timed_ms(torch, kernel)
        plain_ms = timed_ms(torch, plain, reps=5)
        library_ms = timed_ms(torch, library)
        b_ms, b_by = bound_ms(2 * t * d * f, nbytes, peak, "bf16")
        out[name] = {"max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms}
        say(f"{name.upper()}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} (one torch.mm) bound_ms "
            f"{b_ms:.4f} ({b_by}) -> {b_ms / ms:.3f} of bound, "
            f"{2 * t * d * f / ms / 1e9:.1f} TFLOP/s")
    return out


def quant_train_phase(torch) -> dict:
    """The quantized and fused-backward train steps at the bench shape,
    through ``bench_step.build`` with the JAX package's overrides; the
    launch counters are reset before and read after each run."""
    import dataclasses

    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    layers = BS.LAYERS
    launches = {}

    def run(steps: int, **overrides):
        train_k, carry, tokens, _, cfg = BS.build(steps, **overrides)
        reset_mlp_counts()
        carry, losses = train_k(carry, tokens)
        torch.cuda.synchronize()
        counts = mlp_counts()
        losses = losses.cpu()
        if not torch.isfinite(losses).all():
            fail(f"quant train {overrides}: losses {losses.tolist()}")
        return carry, tokens, cfg, losses, counts

    # int8 composed vs fused: the same recipe, so the first loss is
    # bitwise equal; K11 launched 3 x layers a step in the fused run only
    steps = 2
    losses = {}
    for fusion in ("composed", "fused"):
        _, _, _, losses[fusion], counts = run(steps, mlp_dtype="int8",
                                              quant_fusion=fusion)
        want = 3 * layers * steps if fusion == "fused" else 0
        if counts != {"k11": want, "k9": 0, "k10": 0}:
            fail(f"quant train int8 {fusion}: launches {counts}, want K11 "
                 f"{want}")
        launches["k11_int8"] = launches.get("k11_int8", 0) + counts["k11"]
        torch.cuda.empty_cache()
    if losses["composed"][0].item() != losses["fused"][0].item():
        fail(f"quant train: int8 fused first loss {losses['fused'][0]!r} "
             f"!= composed {losses['composed'][0]!r} (must be bitwise)")
    say(f"quant train int8: composed losses {losses['composed'].tolist()}, "
        f"fused {losses['fused'].tolist()} (first bitwise equal); K11 "
        f"{launches['k11_int8']} = 3 x {layers} layers x {steps} steps")

    # e4m3 fused with delayed scaling: the state moves off its ones and
    # then holds still on the same batch
    steps = 3
    (params, qs), tokens, cfg, l1, counts = run(
        steps, mlp_dtype="float8", quant_fusion="fused",
        quant_scaling="delayed")
    if counts["k11"] != 3 * layers * steps:
        fail(f"quant train e4m3 delayed: K11 launches {counts['k11']}")
    launches["k11_e4m3"] = counts["k11"]
    qs1 = qs.clone()
    (_, qs), l2 = BS.make_train_k(cfg, 1)((params, qs), tokens)
    torch.cuda.synchronize()
    drift = float((qs / qs1 - 1).abs().max())
    if not (torch.isfinite(qs1).all() and bool((qs1 != 1).all())
            and torch.isfinite(l2).all() and drift < 0.05):
        fail(f"quant train e4m3 delayed: qstate {qs1.tolist()} -> "
             f"{qs.tolist()}, losses {l1.tolist()} {l2.tolist()}")
    say(f"quant train e4m3 fused delayed: losses {l1.tolist()} then "
        f"{l2.tolist()}; qstate {qs1.cpu().tolist()} (moved off 1.0; next "
        f"step drifts {drift:.2e}); K11 {counts['k11']}")
    del params, qs, qs1, tokens
    torch.cuda.empty_cache()

    # mlp_backward="pallas" against the autograd backward on the same
    # weights: the forward is the same, so the loss is bitwise equal
    _, params, tokens, _, cfg = BS.build(1)
    cfg_p = dataclasses.replace(cfg, mlp_backward="pallas")
    ps = BS.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss_d = T.loss_fn(params, tokens, cfg)
    grads_d = torch.autograd.grad(loss_d, ps)
    reset_mlp_counts()
    loss_p = T.loss_fn(params, tokens, cfg_p)
    grads_p = torch.autograd.grad(loss_p, ps)
    torch.cuda.synchronize()
    counts = mlp_counts()
    worst = max(float((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30))
                for a, b in zip(grads_p, grads_d))
    if loss_p.item() != loss_d.item() or worst > PALLAS_TOL_LEAF \
            or counts != {"k11": 0, "k9": layers, "k10": layers}:
        fail(f"quant train pallas: loss {loss_p.item()!r} vs "
             f"{loss_d.item()!r}, worst leaf {worst:.3e} (bar "
             f"{PALLAS_TOL_LEAF}), launches {counts}")
    del grads_d, grads_p, loss_d, loss_p
    for p in ps:
        p.requires_grad_(False)
    steps = 2
    reset_mlp_counts()
    params, lp = BS.make_train_k(cfg_p, steps)(params, tokens)
    torch.cuda.synchronize()
    counts = mlp_counts()
    if counts != {"k11": 0, "k9": layers * steps, "k10": layers * steps} \
            or not torch.isfinite(lp).all():
        fail(f"quant train pallas: {steps} steps, launches {counts}, "
             f"losses {lp.tolist()}")
    launches["k9"], launches["k10"] = counts["k9"], counts["k10"]
    say(f"quant train pallas: loss bitwise equal to autograd's, worst "
        f"gradient leaf {worst:.3e} of its max-abs (bar "
        f"{PALLAS_TOL_LEAF}); {steps} steps, losses {lp.tolist()}, K9 "
        f"{counts['k9']} K10 {counts['k10']} = {layers} layers x {steps} "
        f"steps")
    del params, tokens, ps
    torch.cuda.empty_cache()
    return launches


def train_phase(torch) -> dict:
    """The headline train step through ``bench.main([])``."""
    import contextlib
    import io

    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step as BS
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    reset_mlp_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts()
    k11 = mlp_counts()["k11"]
    if rc != 0:
        fail(f"train: bench rc {rc}")
    lines = [json.loads(t) for t in buf.getvalue().strip().splitlines()]
    line = lines[-1]
    for ln in lines[:-1]:
        say(f"train aux line: {json.dumps(ln)}")
    say(f"train headline: {json.dumps({k: v for k, v in line.items() if not isinstance(v, dict)})}")
    aux_keys = ("int8_fused_ab", "fp8_fused_ab", "int8_step",
                "int8_switchback_step", "recommended_step")
    if [ln["metric"] for ln in lines[:-1]] != [line[k]["metric"]
                                              for k in aux_keys] \
            or line["recommended_step"]["metric"] != "recommended_step":
        fail(f"train: aux lines {[ln.get('metric') for ln in lines]} do "
             f"not match the headline's keys {aux_keys}")
    for key in ("int8_fused_ab", "fp8_fused_ab"):
        ab = line[key]
        for var in ("composed", "fused", "fused_delayed"):
            if set(ab[var]) != {"value", "best", "band", "n"} \
                    or not ab[var]["value"] > 0:
                fail(f"train: {key} {var} band {ab[var]}")
    rel = abs(line["int8_step"]["loss"] - line["loss"]) / line["loss"]
    if not rel <= 0.02:
        fail(f"train: int8_step loss {line['int8_step']['loss']} not "
             f"within 2 % of the headline's {line['loss']}")
    want_k11 = 2 * 2 * (1 + bench.ROUNDS) * bench.AB_K
    if k11 != want_k11:
        fail(f"train: K11 launches {k11} != {want_k11} (2 formats x 2 "
             f"fused variants x {1 + bench.ROUNDS} chains x {bench.AB_K})")
    steps = (BS.env_int("DLNB_BENCH_K", 10)
             + 2 * bench.STEP_K) * (1 + bench.ROUNDS)
    want = BS.LAYERS * steps
    loss = line["loss"]
    if not (math.isfinite(loss) and abs(loss - math.log(BS.VOCAB)) < 1.5):
        fail(f"train: loss {loss} not within 1.5 of ln({BS.VOCAB})")
    vs = line["vs_baseline"]
    if vs is None or not 0 < vs <= 1.05:
        fail(f"train: vs_baseline {vs} not in (0, 1.05]")
    if counts != {"fwd": want, "dq": want, "dkv": want}:
        fail(f"train: flash launches {counts}, want {BS.LAYERS} layers x "
             f"{steps} steps = {want} each")
    say(f"train: {line['value']} ms/step, vs_baseline {vs}, loss {loss}; "
        f"int8_step {line['int8_step']['value']} ms (loss "
        f"{line['int8_step']['loss']}), int8_switchback_step "
        f"{line['int8_switchback_step']['value']} ms, recommended "
        f"{line['recommended_step']['recipe']}; flash launches {counts} = "
        f"{BS.LAYERS} layers x {steps} steps (headline and both int8 "
        f"lines, warm calls included); K11 {k11} in the A/B chains; bench "
        f"wall {wall:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {"counts": counts, "line": line}


def entry_phase(torch) -> None:
    """The flagship forward through ``entry.entry()`` at S=1024."""
    from dlnetbench_tpu_torch import entry
    fn, (params, tokens) = entry.entry()
    reset_flash_counts()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    counts = flash_counts()
    layers = entry.flagship_cfg().num_layers
    if tuple(logits.shape) != (1, 1024, 32768) \
            or logits.dtype != torch.float32:
        fail(f"entry: logits {tuple(logits.shape)} {logits.dtype}")
    if not torch.isfinite(logits).all():
        fail("entry: logits not finite")
    if counts != {"fwd": layers, "dq": 0, "dkv": 0}:
        fail(f"entry: flash launches {counts}, want fwd {layers}")
    say(f"entry: logits {tuple(logits.shape)} finite, std "
        f"{float(logits.std()):.3f}; flash launches {counts}")


def profile_rows(prof, wall: float, label: str) -> None:
    """Write the top device rows of a profile to
    build/chip_smoke/profile_<label>.json and print the device busy
    share."""
    from torch.autograd import DeviceType
    rows = [(e.key, getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
             e.device_type == DeviceType.CUDA)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    # device-side events only (kernels, copies, sets): host ops and
    # autograd nodes carry the device time of the kernels they launched
    kernels = [r[:3] for r in rows if r[3]]
    rows = [r[:3] for r in rows]
    busy = sum(r[1] for r in kernels)
    top = sorted(rows, key=lambda r: -r[1])[:40]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"profile_{label}.json").write_text(json.dumps(
        {"wall_s": wall, "busy_s": busy / 1e6, "rows": top}, indent=1))
    say(f"profile {label}: wall {wall:.3f} s, kernel time "
        f"{busy / 1e6:.3f} s ({busy / 1e6 / wall:.3f} of wall; "
        f"device idle share {1 - busy / 1e6 / wall:.3f})")
    for key, t_us, n in sorted(kernels, key=lambda r: -r[1])[:25]:
        say(f"  {t_us / 1e3:10.3f} ms  {n:6d}x  {key[:90]}")


# the step recipes profiled with --profile: label -> build overrides
PROFILE_RECIPES = {
    "train": {},
    "train_int8": {"mlp_dtype": "int8"},
    "train_int8_fused": {"mlp_dtype": "int8", "quant_fusion": "fused"},
    "train_e4m3_delayed": {"mlp_dtype": "float8", "quant_fusion": "fused",
                           "quant_scaling": "delayed"},
    "train_pallas_bwd": {"mlp_backward": "pallas"},
}


def profile_train(torch, label: str, overrides: dict) -> None:
    """ms a step (one round of K chained steps after a warm round,
    unprofiled), then device busy share and top kernels over a profiled
    round, of the bench train step under a recipe's overrides."""
    from torch.profiler import ProfilerActivity, profile

    from dlnetbench_tpu_torch.models import bench_step as BS
    k = BS.env_int("DLNB_BENCH_K", 10)
    train_k, carry, tokens, _, _ = BS.build(k, **overrides)
    carry, _ = train_k(carry, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = train_k(carry, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / k * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_k(carry, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"profile {label} {overrides}: {k} steps, {step_ms:.3f} ms a step "
        f"unprofiled, {wall / k * 1e3:.1f} ms under the profiler")
    profile_rows(prof, wall, label)


def profile_phase(torch) -> None:
    """Kernel-time breakdown of a served run at the same width (bf16 and
    int8 caches), from torch.profiler's device events; the rows go to
    build/chip_smoke/profile_<cache>.json, then the train step's."""
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
        profile_rows(prof, wall, cd)


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
    from dlnetbench_tpu_torch.core.hardware import (HARDWARE,
                                                    hw_key_for_device_name)
    hw_key = hw_key_for_device_name(name)
    if hw_key is None:
        say(f"no preset for {name!r}: bounds priced against h100_sxm")
    hw = HARDWARE[hw_key or "h100_sxm"]
    peak = {"bytes": hw.hbm_bandwidth, "bf16": hw.peak("bfloat16"),
            "int8": hw.peak("int8"), "fp8": hw.peak("float8")}
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
    flash = flash_phase(torch, FLASH_CASES[0], peak, timed=True)
    for case in FLASH_CASES[1:]:
        flash_phase(torch, case, peak, timed=False)
    torch.cuda.empty_cache()
    qmm = {fmt: qmm_phase(torch, fmt, peak) for fmt in ("int8", "float8")}
    torch.cuda.empty_cache()
    mlp_bwd = mlp_bwd_phase(torch, peak)
    torch.cuda.empty_cache()
    reference_phase(torch)
    served = {dt: serve_phase(torch, dt) for dt in ("bf16", "int8", "fp8")}
    torch.cuda.empty_cache()
    train_reference_phase(torch)
    quant_launches = quant_train_phase(torch)
    trained = train_phase(torch)
    torch.cuda.empty_cache()
    entry_phase(torch)
    torch.cuda.empty_cache()
    if "--profile" in argv:
        profile_phase(torch)
        torch.cuda.empty_cache()
        for label, overrides in PROFILE_RECIPES.items():
            profile_train(torch, label, overrides)
            torch.cuda.empty_cache()

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
    for kind, label in (("fwd", "K3 flash_attention forward"),
                        ("dq", "K4 flash_attention dq"),
                        ("dkv", "K5 flash_attention dk/dv")):
        kernels.append({"name": label, "route": "cuda",
                        "source": FLASH_SRC,
                        "replaces": FLASH_REPLACES[kind],
                        "launches": trained["counts"][kind],
                        **flash[kind]})
    for key, label, res in (
            ("k9", "K9 dgdu (SwiGLU backward dg, du)", mlp_bwd["k9"]),
            ("k10", "K10 dwd (SwiGLU backward dWd)", mlp_bwd["k10"]),
            ("k11_int8", "K11 fused_matmul (int8)", qmm["int8"]),
            ("k11_e4m3", "K11 fused_matmul (e4m3)", qmm["float8"])):
        kernels.append({"name": label, "route": "cuda", "source": MLP_SRC,
                        "replaces": MLP_REPLACES[key.split("_")[0]],
                        "launches": quant_launches[key], **res})
    say(card)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
