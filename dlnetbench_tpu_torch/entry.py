"""Entry points of the JAX package's ``__graft_entry__``.

``entry()``: the flagship forward: llama3_8b width (4096 hidden, 32/8
heads, ff 14336), cut to 4 layers, seq 1024 and vocab 32768, seeded
random weights, one batch of seeded tokens.

    fn, (params, tokens) = entry()
    logits = fn(params, tokens)       # [1, 1024, 32768] f32

``dryrun_multichip(n)``: the SPMD tier (``models/spmd.py``) and the
seven proxies over a world of n ranks, one process a rank:

    torchrun --nproc_per_node 4 -m dlnetbench_tpu_torch.entry [--shape bench]
    python -m dlnetbench_tpu_torch.entry --platform cpu --shape jax   # world 1

On the card the dryrun's default shape is ``CARD_TINY`` (embed 256, 4
heads: head_dim 64, S 256), not the JAX package's (head_dim 16, S 32),
which the flash kernels cannot take.  Both run on the card unless the
caller asks for ``platform="cpu"``.
"""
from __future__ import annotations

import math

import torch


def flagship_cfg():
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.models.transformer import TransformerConfig
    card = load_model_card("llama3_8b")
    return TransformerConfig.from_card(card, seq_len=1024, num_layers=4,
                                       vocab_size=32768)


def entry(platform: str = "cuda"):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the forward
    (no gradient) of the flagship config."""
    from dlnetbench_tpu_torch.models import transformer as tfm
    from dlnetbench_tpu_torch.ops.common import resolve_device
    device = resolve_device(platform)
    cfg = flagship_cfg()
    params = tfm.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.seq_len),
                           generator=gen, device=device)

    def fn(params, tokens):
        with torch.no_grad():
            return tfm.forward(params, tokens, cfg)

    return fn, (params, tokens)


# ------------------------------------------------------------------ #
# The multi-rank dry run (the JAX package's __graft_entry__
# ``dryrun_multichip``)
# ------------------------------------------------------------------ #
# the SPMD shape the card dryrun takes in place of the JAX package's
# default (embed 64, 4 heads -> head_dim 16, S 32): the flash kernels
# take S a multiple of 128 and head_dim 64 or 128, and a CUDA tensor has
# no other attention path (ops.attention)
CARD_TINY = dict(vocab_size=512, embed_dim=256, num_heads=4,
                 num_kv_heads=4, ff_dim=512, seq_len=256)
# the bench's spmd_overlap_ab shape (the JAX bench's, bench.py:1766-1769)
BENCH_SPMD = dict(embed_dim=2048, num_heads=16, num_kv_heads=16,
                  ff_dim=8192, num_layers=4, seq_len=2048,
                  vocab_size=32768, num_experts=4, dtype="bfloat16")
SHAPES = {"jax": {}, "tiny": CARD_TINY, "bench": BENCH_SPMD}
PARITY_TOL = 1e-4      # the JAX dryrun's loss and parameter bars


class _Budget:
    """The dryrun's wall-clock budget (``DLNB_DRYRUN_DEADLINE_S``, 480 s
    by default): a stage past it prints a skip marker instead of
    running and is listed in ``skipped``; every completed stage prints
    its elapsed time."""

    def __init__(self, n: int, log):
        import os
        import time
        self.deadline_s = float(os.environ.get("DLNB_DRYRUN_DEADLINE_S",
                                               "480"))
        self.t0 = time.monotonic()
        self.n, self.log = n, log
        self.skipped: list[str] = []

    def elapsed(self) -> float:
        import time
        return time.monotonic() - self.t0

    def over(self, stage: str) -> bool:
        el = self.elapsed()
        if el > self.deadline_s:
            self.skipped.append(stage)
            self.log(f"dryrun_multichip({self.n}): {stage} skipped "
                     f"(deadline {self.deadline_s:.0f}s exceeded at "
                     f"+{el:.0f}s)")
            return True
        return False

    def ok(self, msg: str) -> None:
        self.log(f"dryrun_multichip({self.n}): {msg} OK "
                 f"(+{self.elapsed():.0f}s)")


class _Run:
    """What the stages share: the world, the device, the log, the
    budget, and a tally of the train steps run (``steps``)."""

    def __init__(self, n, device, shape: dict, log):
        self.n, self.device, self.shape, self.log = n, device, shape, log
        self.budget = _Budget(n, log)
        self.steps = 0

    def step(self, step, params, tokens):
        self.steps += 1
        return step(params, tokens)


def dryrun_multichip(n: int, platform: str = "cuda", shape: str = "tiny",
                     log=print) -> dict:
    """Build and run the SPMD tier on this world of ``n`` ranks: the
    step at the factored mesh, ring and Ulysses, the overlap paths'
    parity against the blocking baseline (f32, JAX's 1e-4 bars) and the
    paired overlap line (world >= 2: one rank issues no collective to
    decompose or overlap), the long-context masks (ring against
    megatron, a world of a multiple of 4), the MoE knobs, and the seven
    proxies on the same world.

    ``n`` must be the world's size: ``torchrun --nproc_per_node n -m
    dlnetbench_tpu_torch.entry`` starts it (every rank calls this).
    ``shape``: "tiny" (``CARD_TINY``, what the flash kernels take),
    "jax" (the JAX package's own tiny default, the CPU only) or "bench"
    (``BENCH_SPMD``, bf16 at full width; its parity stages run it in
    f32).  Rank 0 logs.  Returns the stages' results, ``steps`` the
    train steps this rank ran and ``skipped`` the stages the deadline
    skipped; a failed bar raises."""
    import torch.distributed as dist

    from dlnetbench_tpu_torch.parallel import multihost
    if multihost.launcher_world() != n:
        raise ValueError(
            f"dryrun_multichip({n}) needs a world of {n} ranks, have "
            f"{multihost.launcher_world()}: start it with torchrun "
            f"--nproc_per_node {n} -m dlnetbench_tpu_torch.entry")
    owned = not dist.is_initialized()
    device = multihost.initialize(platform)
    if multihost.rank() != 0:
        log = lambda *_: None  # noqa: E731
    try:
        return _dryrun_body(_Run(n, device, SHAPES[shape], log))
    finally:
        if owned:
            multihost.shutdown()


def _leaves(params: dict) -> list:
    from dlnetbench_tpu_torch.models.spmd import _leaves_with_specs
    return [t for t, _ in _leaves_with_specs(params, "megatron")]


def _finite(params: dict) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in _leaves(params))


def _dryrun_body(run: _Run) -> dict:
    from dlnetbench_tpu_torch.models import spmd
    n, device = run.n, run.device
    dp, pp, tp = spmd.factor_mesh(n)
    m = 2
    base = dict(run.shape, batch=dp * m * 2, num_microbatches=m)
    out = {"mesh": (dp, pp, tp), "loss": {}}
    for sp_mode in ("megatron", "ring", "ulysses"):
        if sp_mode != "megatron" and run.budget.over(f"sp_mode={sp_mode}"):
            continue
        mesh, _, step, params, tokens = spmd.build(
            n, spmd.SpmdConfig(**base, sp_mode=sp_mode), device=device)
        new, loss = run.step(step, params, tokens)
        if not (math.isfinite(float(loss)) and _finite(new)):
            raise AssertionError(f"{sp_mode} dryrun loss not finite: "
                                 f"{float(loss)}")
        out["loss"][sp_mode] = float(loss)
        run.budget.ok(f"mesh {dict(mesh.axes)} sp_mode={sp_mode} loss "
                      f"{float(loss):.4f}")
        del new, params
    out["overlap"] = _dryrun_overlap(run, base)
    out["longcontext"] = _dryrun_longcontext(run)
    out["moe"] = _dryrun_moe(run, base)
    _dryrun_proxies(run)
    out["steps"] = run.steps
    out["skipped"] = list(run.budget.skipped)
    return out


def _parity(run: _Run, kw_ref: dict, kw_x: dict, label: str) -> dict:
    """One step of each config from the same weights and tokens: the
    loss and every updated parameter within ``PARITY_TOL``."""
    from dlnetbench_tpu_torch.models import spmd
    _, _, step_r, params, tokens = spmd.build(
        run.n, spmd.SpmdConfig(**kw_ref), device=run.device)
    p_ref, l_ref = run.step(step_r, params, tokens)
    _, _, step_x, _, _ = spmd.build(run.n, spmd.SpmdConfig(**kw_x),
                                    device=run.device)
    p_x, l_x = run.step(step_x, params, tokens)
    dl = abs(float(l_x) - float(l_ref))
    dmax = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(_leaves(p_x), _leaves(p_ref)))
    if not dl <= PARITY_TOL * max(1.0, abs(float(l_ref))):
        raise AssertionError(f"{label}: loss parity broken "
                             f"({float(l_x)} vs {float(l_ref)})")
    if not dmax <= PARITY_TOL:
        raise AssertionError(f"{label}: param drift {dmax}")
    run.budget.ok(f"{label} loss-parity dloss={dl:.2e} dparam={dmax:.2e}")
    return {"loss": float(l_x), "loss_ref": float(l_ref), "dloss": dl,
            "dparam_max": dmax}


def _dryrun_overlap(run: _Run, base: dict) -> dict:
    """The decomposed collective matmuls and the bucketed gradient sync
    give the blocking baseline's step (lossless capacity, f32); then
    the paired overlap line at the run's own shape and dtype.  One rank
    has neither: its step issues no collective, so both knobs leave the
    program as it is."""
    import json
    if run.n < 2:
        run.log(f"dryrun_multichip({run.n}): overlap parity skipped (one "
                f"rank issues no collective to decompose)")
        run.log(json.dumps({"metric": "spmd overlap A/B",
                            "skipped": f"needs >= 2 devices, have "
                                       f"{run.n} — single-chip session "
                                       f"has no communication to "
                                       f"overlap"}))
        return {}
    kw0 = dict(base, capacity_factor=8.0, dtype="float32")
    matrix = [
        ("tp_overlap=decomposed", dict(tp_overlap="decomposed")),
        ("grad_sync=bucketed", dict(grad_sync="bucketed")),
        ("tp_overlap=decomposed+grad_sync=bucketed",
         dict(tp_overlap="decomposed", grad_sync="bucketed")),
        ("sp_mode=ring+tp_overlap=decomposed",
         dict(sp_mode="ring", tp_overlap="decomposed")),
    ]
    out = {}
    for label, kw in matrix:
        if run.budget.over(label):
            continue
        ref = dict(kw0, sp_mode=kw.get("sp_mode", "megatron"))
        out[label] = _parity(run, ref, dict(kw0, **kw), label)
    if not run.budget.over("spmd overlap A/B"):
        from dlnetbench_tpu_torch.models import overlap_bench, spmd
        mesh = spmd.grid_mesh(*spmd.factor_mesh(run.n), run.device)
        line = overlap_bench.measure(mesh, cfg_kwargs=dict(run.shape),
                                     rounds=2, reps=1)
        run.log(json.dumps(line))
        out["line"] = line
        run.budget.ok("spmd overlap A/B line")
    return out


def _dryrun_longcontext(run: _Run) -> dict:
    """The masked paths: the sparse ring step (hop gating, in-hop masks)
    gives the megatron step applying the same mask on the gathered
    sequence (f32, 1e-4), and the mask skips hops beyond the causal
    triangle.  On a mesh (n/4, 1, 4), so the world is a multiple of 4;
    the JAX dryrun's masks at S = 32, scaled to the run's sequence."""
    import dataclasses
    import json

    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.ops import attention_mask as amask
    n = run.n
    if n % 4:
        run.log(f"dryrun_multichip({n}): longcontext masked parity "
                f"skipped (needs a multiple of 4 ranks for the tp=4 mesh)")
        return {}
    mesh = spmd.grid_mesh(n // 4, 1, 4, run.device)
    f = run.shape.get("seq_len", spmd.SpmdConfig().seq_len) // 32
    matrix = [
        ("window", dict(attention_window=8 * f)),
        ("segments", dict(attention_seg_avg=12 * f, attention_seg_seed=4)),
        ("window+segments", dict(attention_window=12 * f,
                                 attention_seg_avg=16 * f)),
    ]
    out = {}
    for label, kw in matrix:
        if run.budget.over(f"longcontext mask={label}"):
            continue
        cfg_m = spmd.SpmdConfig(**dict(run.shape, dtype="float32"),
                                batch=2 * (n // 4), num_microbatches=2,
                                capacity_factor=8.0, sp_mode="megatron",
                                **kw)
        cfg_r = dataclasses.replace(cfg_m, sp_mode="ring")
        glob = spmd.init_params(cfg_m, seed=0)
        gen = torch.Generator()
        gen.manual_seed(1)
        tokens = torch.randint(0, cfg_m.vocab_size,
                               (cfg_m.batch, cfg_m.seq_len + 1),
                               generator=gen)
        trees, losses = [], []
        for cfg in (cfg_m, cfg_r):
            p, loss = run.step(spmd.make_train_step(mesh, cfg),
                               spmd.shard_params(glob, mesh, cfg), tokens)
            trees.append(spmd.gather_params(p, mesh, cfg))
            losses.append(float(loss))
        dl = abs(losses[0] - losses[1])
        (g_m, g_r) = trees
        dmax = max([float(abs(g_m[k] - g_r[k]).max())
                    for k in ("embed", "final_norm", "head")]
                   + [float(abs(g_m["layers"][k] - g_r["layers"][k]).max())
                      for k in spmd.LAYER_KEYS])
        if not dl <= PARITY_TOL * max(1.0, abs(losses[0])):
            raise AssertionError(f"longcontext {label}: loss parity broken "
                                 f"({losses[1]} vs {losses[0]})")
        if not dmax <= PARITY_TOL:
            raise AssertionError(f"longcontext {label}: param drift {dmax}")
        stats = cfg_r.ring_hop_stats(4)
        causal = amask.ring_skipped_hop_fraction(None, cfg_r.seq_len, 4)
        if not stats["ring_skipped_hop_fraction"] > causal:
            raise AssertionError(
                f"longcontext {label}: mask skips no hop beyond the causal "
                f"triangle ({stats['ring_skipped_hop_fraction']} <= "
                f"{causal}) — gating inert")
        line = {"metric": f"longcontext masked parity ({label}): sparse "
                          f"ring vs dense-masked megatron, one train step",
                "dloss": dl, "dparam_max": dmax,
                **amask.record_globals(cfg_r.mask_spec, cfg_r.seq_len),
                **stats}
        run.log(json.dumps(line))
        out[label] = line
        run.budget.ok(f"longcontext mask={label} dloss={dl:.2e} "
                      f"skipped_hops={stats['ring_skipped_hop_fraction']}")
    return out


def _dryrun_moe(run: _Run, base: dict) -> dict:
    """The expert-parallel knobs: the seeded grouped routing keeps the
    same tokens whole or in shards (exact), and the decomposed
    all-to-all and the grouped expert FFN (K12 on the card) each give
    the monolithic einsum step (f32, seeded routing at finite
    capacity, 1e-4)."""
    import json

    from dlnetbench_tpu_torch.models import moe as MoE
    if run.budget.over("moe routing shard-invariance"):
        return {}
    device = run.device
    t, d, e, k, g = 64, 32, 4, 2, 16
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    x = torch.randn((t, d), generator=gen, device=device)
    wr = torch.randn((d, e), generator=gen, device=device)
    full = MoE.dispatch(x, wr, e, k, 1.0, drop_seed=11, group_tokens=g,
                        gids=torch.arange(t, device=device))[1]
    shards = 4
    h, ch = t // shards, full.shape[2] // shards
    for s in range(shards):
        part = MoE.dispatch(x[s * h:(s + 1) * h], wr, e, k, 1.0,
                            drop_seed=11, group_tokens=g,
                            gids=torch.arange(s * h, (s + 1) * h,
                                              device=device))[1]
        if not torch.equal(full[s * h:(s + 1) * h, :, s * ch:(s + 1) * ch],
                           part):
            raise AssertionError(f"moe routing differs on shard {s} vs "
                                 f"single-device")
    run.budget.ok(f"moe routing token-identical across {shards} shards")
    kw0 = dict(base, capacity_factor=1.0, moe_drop_seed=11,
               moe_group_tokens=8, dtype="float32")
    matrix = [
        ("moe_a2a=decomposed", dict(moe_a2a="decomposed", moe_chunks=2)),
        ("moe_ffn_impl=grouped", dict(moe_ffn_impl="grouped")),
        ("moe_a2a=decomposed+grouped",
         dict(moe_a2a="decomposed", moe_ffn_impl="grouped")),
    ]
    out = {}
    for label, kw in matrix:
        if run.budget.over(f"moe {label}"):
            continue
        res = _parity(run, kw0, dict(kw0, **kw), f"moe {label}")
        line = {"metric": f"moe parity ({label}) vs monolithic einsum, "
                          f"one train step, seeded grouped routing",
                "dloss": res["dloss"], "dparam_max": res["dparam_max"],
                "moe_drop_seed": 11, "moe_group_tokens": 8}
        run.log(json.dumps(line))
        out[label] = line
    return out


def _dryrun_proxies(run: _Run) -> None:
    """The seven proxy families on the same world (tiny time and size
    scales): DP, FSDP, hybrid_3d, 1F1B, Ulysses and ring attention, and
    the ZB MoE pipeline, each built and one full step issued."""
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import (dp, fsdp, hybrid_2d,
                                              hybrid_3d, hybrid_3d_moe,
                                              ring_attention, ulysses)
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    from dlnetbench_tpu_torch.utils.timing import fence
    n, device = run.n, run.device
    cfg = ProxyConfig(warmup=1, runs=1, time_scale=1e-4, size_scale=1e-5)

    def stage(label, thunk):
        if run.budget.over(label):
            return
        thunk().full()
        fence(device)
        run.budget.ok(f"{label}:")

    stats = load_model_stats("gpt2_l_16_bfloat16")
    card = load_model_card("gpt2_l")
    stage("dp", lambda: dp.build(stats, 2, cfg, make_flat_mesh(device)))
    if n % 2 == 0:
        stage("fsdp[shard=2]", lambda: fsdp.build(stats, 3, cfg, device,
                                                  sharding_factor=2))
    if n % 4:
        run.log(f"dryrun_multichip({n}): hybrid_3d, hybrid_2d[1f1b], "
                f"ulysses[sp=4], ring_attention[sp=4] and "
                f"hybrid_3d_moe[zb] skipped (their 2 x 2 grids and sp=4 "
                f"need a multiple of 4 ranks)")
        return
    stage("hybrid_3d[tp=2]", lambda: hybrid_3d.build(
        stats, card, cfg, device, num_stages=2, num_microbatches=4, tp=2))
    stage("hybrid_2d[1f1b]", lambda: hybrid_2d.build(
        stats, card, cfg, device, num_stages=2, num_microbatches=4,
        schedule="1f1b"))
    llama_stats = load_model_stats("llama3_8b_16_bfloat16")
    llama_card = load_model_card("llama3_8b")
    stage("ulysses[sp=4]", lambda: ulysses.build(
        llama_stats, llama_card, cfg, device, sp=4, max_layers=2))
    stage("ring_attention[sp=4]", lambda: ring_attention.build(
        llama_stats, llama_card, cfg, device, sp=4, max_layers=2))
    moe_stats = load_model_stats("mixtral_8x7b_16_bfloat16")
    moe_card = load_model_card("mixtral_8x7b")
    stage("hybrid_3d_moe[zb]", lambda: hybrid_3d_moe.build(
        moe_stats, moe_card, cfg, device, num_stages=2,
        num_microbatches=4, num_expert_shards=2, schedule="zb"))


def main(argv=None) -> int:
    """``python -m dlnetbench_tpu_torch.entry [--platform cuda|cpu]
    [--shape tiny|jax|bench]``: ``dryrun_multichip`` over the world the
    launcher gives (``torchrun --nproc_per_node N``; world 1 without
    one)."""
    import argparse
    ap = argparse.ArgumentParser(prog="python -m dlnetbench_tpu_torch.entry")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shape", default="tiny", choices=tuple(SHAPES))
    args = ap.parse_args(argv)
    from dlnetbench_tpu_torch.parallel import multihost
    dryrun_multichip(multihost.launcher_world(), platform=args.platform,
                     shape=args.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
