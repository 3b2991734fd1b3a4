"""MoE core (the JAX package's ``models/moe.py``): seeded deterministic
routing, capacity and drop accounting, routing stats, and the grouped
expert FFN.

* **Seeded grouped token drop** — capacity is enforced per group of
  ``group_tokens`` consecutive tokens, and within a group the dispatch
  queue order is a seeded murmur-style priority over global token ids
  (``token_priority``) instead of arrival order, so the kept set is a
  pure function of (tokens, router weights, seed, group size).
  ``drop_seed=None`` with one group delegates to
  ``layers.moe_dispatch``.
* **Drop closed form** — ``expected_drops``, ``sum_{g,e} max(0, n_ge -
  cap_g)``.
* **Routing stats** — per-expert load, drop count and router entropy
  (``dispatch(..., with_stats=True)``) and ``stats_globals``, which
  shapes them as record globals.
* **Grouped expert FFN** — ``moe_grouped`` runs the sparse MoE through
  the grouped matmul (``ops/grouped_matmul.py``, kernel K12 on the
  card): per-expert token batches, rows past an expert's kept count
  skipped.

Routing is computed by ``layers.capacity_routing`` as indices (gathers,
no one-hot einsum); the one-hots are built only where the return value
promises them.  ``spmd_a2a_elems`` is the SPMD step's per-rank
dispatch-buffer size, the schedule twin of ``a2a_elems_per_rank``.
"""
from __future__ import annotations

import numpy as np
import torch

from dlnetbench_tpu_torch.models import layers as L

_F32 = torch.float32
_U32 = 0xFFFFFFFF


# ----------------------------------------------------------- priority
def token_priority(seed: int, gids: torch.Tensor) -> torch.Tensor:
    """Seeded per-token drop priority: a 32-bit murmur3-style finalizer
    over the global token id, xor-folded with the seed — the JAX
    package's ``uint32`` arithmetic in int64, masked to 32 bits after
    each multiply (a wrapped int64 product keeps its low 32 bits).
    Returns int64 holding the ``uint32`` values."""
    h = (gids.to(torch.int64) & _U32) ^ ((seed * 0x9E3779B9) & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def group_capacity(group_tokens: int, top_k: int, num_experts: int,
                   capacity_factor: float) -> int:
    """Per-(group, expert) dispatch slots — the one capacity spelling
    (``layers.moe_capacity`` at group = the whole batch)."""
    return L.moe_capacity(group_tokens, top_k, num_experts,
                          capacity_factor)


def expected_drops(counts: torch.Tensor, cap_g: int) -> torch.Tensor:
    """Tokens routed beyond their (group, expert) capacity; ``counts``
    is the ``[G, E]`` routed-assignment histogram."""
    return torch.clamp_min(counts - cap_g, 0).sum()


# ----------------------------------------------------------- dispatch
def route(x2d, w_router, num_experts: int, top_k: int,
          capacity_factor: float, *, drop_seed: int | None = None,
          group_tokens: int = 0, gids=None):
    """``(routing, counts [G, E] f32, cap_g)`` of ``dispatch``'s
    schedule, held as indices (``layers.Routing``)."""
    t = x2d.shape[0]
    e = num_experts
    g = group_tokens or t
    if t % g:
        raise ValueError(f"moe.dispatch: {t} tokens not divisible by "
                         f"group_tokens={g}")
    n_groups = t // g
    cap_g = group_capacity(g, top_k, e, capacity_factor)
    weights, idx = L.moe_router(x2d, w_router, top_k)
    order = None
    if drop_seed is not None:
        if gids is None:
            gids = torch.arange(t, dtype=torch.int32, device=x2d.device)
        prio = token_priority(drop_seed, gids).reshape(n_groups, g)
        order = torch.argsort(prio, dim=1, stable=True)     # queue order
    routing = L.capacity_routing(weights, idx, e, cap_g,
                                 n_groups=n_groups, order=order)
    counts = torch.zeros((t, e), dtype=_F32, device=x2d.device).scatter(
        1, idx, 1.0).reshape(n_groups, g, e).sum(dim=1)      # [G, E]
    return routing, counts, cap_g


def dispatch(x2d, w_router, num_experts: int, top_k: int,
             capacity_factor: float, *, drop_seed: int | None = None,
             group_tokens: int = 0, gids=None, with_stats: bool = False):
    """Capacity-based token dispatch with seeded grouped token drop.

    Returns ``(xe [E, C_total, d] f32, disp [T, E, C_total], gate [T,
    E])`` (+ ``stats`` with ``with_stats``) — the ``layers.moe_dispatch``
    contract with the expert buffer split into per-group capacity blocks
    (``C_total = G * cap_g``).  ``group_tokens = 0`` (one group) with
    ``drop_seed = None`` is the legacy path and delegates to
    ``layers.moe_dispatch``; ``drop_seed`` orders each group's queue by
    ``token_priority`` over ``gids`` (global token ids, default
    ``arange(T)``); ``group_tokens > 0`` enforces capacity per group of
    that many consecutive tokens (T must divide evenly)."""
    if drop_seed is None and not group_tokens and not with_stats:
        return L.moe_dispatch(x2d, w_router, num_experts, top_k,
                              capacity_factor)
    routing, counts, cap_g = route(
        x2d, w_router, num_experts, top_k, capacity_factor,
        drop_seed=drop_seed, group_tokens=group_tokens, gids=gids)
    xe = routing.buffers(x2d).to(_F32)
    disp, gate = routing.disp(), routing.gate
    if not with_stats:
        return xe, disp, gate
    stats = _routing_stats(x2d, w_router, counts, routing.kept(), cap_g)
    return xe, disp, gate, stats


def _routing_stats(x2d, w_router, counts, kept, cap_g: int) -> dict:
    """Routing stats: routed and kept histograms, the drop count and its
    closed form (equal by construction), and the entropy of the mean
    full-softmax router distribution normalized to [0, 1] by ln E."""
    e = counts.shape[-1]
    probs = torch.softmax(L.router_logits(x2d, w_router), dim=-1)
    p_mean = probs.mean(dim=0)
    entropy = -(p_mean * torch.log(p_mean + 1e-12)).sum()
    routed = counts.sum(dim=0)
    return {
        "routed": routed,
        "kept": kept,
        "dropped": routed.sum() - kept.sum(),
        "expected_dropped": expected_drops(counts, cap_g),
        "entropy": entropy / torch.log(torch.tensor(float(e))),
    }


def stats_globals(stats, *, num_experts: int, top_k: int,
                  capacity_factor: float, drop_seed: int | None,
                  group_tokens: int) -> dict:
    """Routing stats as record globals: the knobs are comparable
    (different routing configs are different runs), the measured
    load/drop/entropy ride the volatile ``moe`` block."""
    def host(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
    routed = host(stats["routed"]).astype(float)
    total = max(float(routed.sum()), 1.0)
    load = routed / total
    mean = max(float(load.mean()), 1e-12)
    return {
        "moe_experts": int(num_experts),
        "moe_top_k": int(top_k),
        "moe_capacity_factor": float(capacity_factor),
        "moe_drop_seed": (int(drop_seed) if drop_seed is not None
                          else None),
        "moe_group_tokens": int(group_tokens),
        "moe": {
            "expert_load": [round(float(v), 6) for v in load],
            "load_imbalance": round(float(load.max()) / mean, 4),
            "drop_rate": round(float(host(stats["dropped"])) / total, 6),
            "router_entropy": round(float(host(stats["entropy"])), 6),
        },
    }


# -------------------------------------------------- grouped expert FFN
def expert_ffn(xe, w_gate, w_up, w_down, *, impl: str = "einsum",
               quant: str | None = None, counts=None,
               mlp_int8: bool = False):
    """The expert-FFN dispatch point: ``xe`` ``[E, C, d]`` dispatch
    buffers -> ``[E, C, d]`` f32.

    * ``impl="einsum"`` — batched library products with f32 results
      (``layers.expert_swiglu``); ``mlp_int8`` runs its three products
      through ``ops/int8.int8_dot_batched`` (per-tensor scales, exact
      int32 sums, straight-through backward);
    * ``impl="grouped"`` — the grouped matmul (kernel K12 on the card)
      with optional fused int8/e4m3 quantization (``quant``) and
      count-aware row skipping (``counts``).
    """
    if impl == "grouped":
        from dlnetbench_tpu_torch.ops.grouped_matmul import grouped_ffn
        return grouped_ffn(xe, w_gate, w_up, w_down, counts=counts,
                           fmt=quant).to(_F32)
    if impl != "einsum":
        raise ValueError(f"moe.expert_ffn: unknown impl {impl!r} "
                         f"(einsum | grouped)")
    if mlp_int8:
        from dlnetbench_tpu_torch.ops.int8 import int8_dot_batched
        dt = xe.dtype
        g = int8_dot_batched(xe, w_gate.to(dt))
        u = int8_dot_batched(xe, w_up.to(dt))
        h = torch.nn.functional.silu(g.to(_F32)) * u.to(_F32)
        return int8_dot_batched(h.to(dt), w_down.to(dt)).to(_F32)
    return L.expert_swiglu(xe, w_gate, w_up, w_down)


def moe_grouped(x2d, w_router, w_gate, w_up, w_down, top_k: int,
                capacity_factor: float = 1.25, *,
                quant: str | None = None, drop_seed: int | None = None):
    """Sparse MoE through the grouped matmul
    (``TransformerConfig.moe_impl="grouped"``): ``layers.moe_sparse``'s
    schedule with the expert FFN run as per-expert token batches, rows
    past an expert's kept-token count skipped; ``quant`` selects the
    fused int8/e4m3 recipes.  The kept counts stay on the device: the
    kernel reads them there."""
    e = w_gate.shape[0]
    routing, _, _ = route(x2d, w_router, e, top_k, capacity_factor,
                          drop_seed=drop_seed)
    counts = torch.clamp_max(routing.kept(),
                             float(routing.capacity)).to(torch.int32)
    y = expert_ffn(routing.buffers(x2d), w_gate, w_up, w_down,
                   impl="grouped", quant=quant, counts=counts)
    return routing.combine(y).to(x2d.dtype)


# ------------------------------------------------------- schedule twin
def a2a_elems_per_rank(tokens_per_mb: int, top_k: int, embed_dim: int,
                       ep: int) -> int:
    """The native schedule's per-rank all-to-all message arithmetic:
    ``tokens_per_mb * top_k * embed_dim // num_expert_shards``."""
    return tokens_per_mb * top_k * embed_dim // ep


def spmd_a2a_elems(cfg, dp: int, tp: int) -> int:
    """The SPMD step's per-rank dispatch-buffer elements per microbatch
    tick: the ``[E, C, d]`` buffer its MoE block hands the EP
    all-to-all (``models/spmd.py``).  At ``capacity_factor == 1`` (and
    divisible shapes) this equals ``a2a_elems_per_rank`` over this
    rank's token share."""
    mb_size = cfg.batch // (dp * cfg.num_microbatches)
    t_loc = mb_size * (cfg.seq_len // tp)
    cap = group_capacity(cfg.moe_group_tokens or t_loc, cfg.top_k,
                         cfg.num_experts, cfg.capacity_factor)
    n_groups = t_loc // (cfg.moe_group_tokens or t_loc)
    return cfg.num_experts * n_groups * cap * cfg.embed_dim
