"""MoE decode for the serving tier (the JAX package's
``serving/moe_decode.py``): per-expert token batching under continuous
batching.

Training drops the tokens routed past an expert's capacity; a serving
engine cannot, since every admitted slot's token must give its next
token this step.  So the serving MoE MLP batches tokens per expert into
capacity-``C`` buffers and, when routing overflows an expert, runs
further ROUNDS until every routed (token, expert) pair is computed:
lossless, at a cost of ``ceil(max_expert_load / C)`` rounds, each of
which reads every expert's weights.  Expert imbalance is therefore a
latency effect.  ``skew_bias`` injects it: a seeded per-expert
router-logit bias.

The round count depends on the data.  The JAX package runs the rounds
as a device ``while_loop``; eager torch needs the count on the host, so
``moe_mlp_rounds`` reads it once per call (one value per MoE layer and
step, counted in ``host_reads``) and issues exactly that many rounds —
never the static bound ``ceil(slots * top_k / C)``, which would make
every step pay the worst case.  The expert products are batched torch
products with f32 results (``layers.dot_f32``), as the JAX package's
are einsums outside any Pallas kernel; the grouped kernel K12 is not
used here, because it skips experts with no tokens and so would change
the cost of a round.

Each routed pair's expert output is kept apart until the last round and
the top-k gated sum is taken once, over the pairs in rank order (the
JAX package adds each round's combine into a running sum).  A token's
result then does not depend on which round, or which capacity slot, its
experts fell into — that is, on the other tokens in the batch — so the
fused loop's streams equal the 1-step engine's on the card, where a
dispatch can batch a request with other co-runners than a 1-step run
does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dlnetbench_tpu_torch.models import layers as L
from dlnetbench_tpu_torch.models.moe import group_capacity
from dlnetbench_tpu_torch.serving.arrivals import _Rng

_F32 = torch.float32

# round counts read back to the host by ``moe_mlp_rounds`` in this
# process (one a call); reset by the caller
host_reads = 0


def _read_max(load: torch.Tensor) -> int:
    """The one host read of ``moe_mlp_rounds``: the largest expert load
    (counted in ``host_reads``)."""
    global host_reads
    host_reads += 1
    return int(load.max())


def skew_bias(num_experts: int, skew: float, seed: int,
              device="cpu") -> torch.Tensor | None:
    """Seeded per-expert router-logit bias emulating expert-load skew
    (the splitmix64 stream of ``serving/arrivals.py``, the JAX package's
    draws bit for bit).  ``skew = 0`` returns None: no bias is added."""
    if skew == 0.0:
        return None
    rng = _Rng((seed + 1) * 0xA24BAED4)
    draws = np.array([rng.u01() for _ in range(num_experts)],
                     dtype=np.float32)
    return torch.from_numpy(float(skew) * draws).to(device)


def decode_capacity(batch: int, top_k: int, num_experts: int,
                    capacity_factor: float) -> int:
    """Per-round, per-expert slots of the serving MoE MLP: the training
    tier's capacity arithmetic (``models/moe.group_capacity``) over the
    decode batch."""
    return group_capacity(batch, top_k, num_experts, capacity_factor)


def moe_mlp_rounds(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                   capacity: int, bias=None, active=None):
    """The serving MoE MLP: ``x`` [B, d], one token per slot (or per
    prefill-chunk row) -> ``(y [B, d], load [E] int32, rounds)``.

    Tokens are batched per expert into ``capacity`` dispatch slots a
    round, in slot order; overflow runs further rounds until every
    routed pair is computed, so ``y`` is the top-k gated sum ``sum_e
    gate[b, e] * f_e(x_b)`` whatever the round count.  ``bias`` (the
    seeded skew) is added to the router logits; ``active`` [B] bool
    masks rows out of routing (no capacity, no load).  ``load`` stays
    on ``x``'s device; ``rounds`` (``ceil(max load / capacity)``) is a
    host int, read once."""
    b, d = x.shape
    e = w_gate.shape[0]
    logits = L.router_logits(x, w_router)
    if bias is not None:
        logits = logits + bias[None, :]
    # the top k by a stable descending sort: lax.top_k's order on ties
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[:, :top_k], dim=-1)
    experts = torch.arange(e, device=x.device)
    onehot = (idx[:, :top_k, None] == experts).to(_F32)     # [B, k, E]
    mask = onehot.sum(dim=1)                                # [B, E]
    if active is not None:
        mask = mask * active.to(_F32)[:, None]
    pos = torch.cumsum(mask, dim=0) - 1.0                   # queue order
    load = mask.sum(dim=0)                                  # [E]
    rounds = -(-_read_max(load) // capacity)
    # each routed pair (token b, choice j): its expert, its place in the
    # expert's queue, the round and capacity slot that place falls in
    choice = idx[:, :top_k]
    pair_pos = pos.gather(1, choice).long()                 # [B, k]
    pair_round = pair_pos.div(capacity, rounding_mode="floor")
    pair_row = choice * capacity + pair_pos.remainder(capacity)
    pair_on = mask.gather(1, choice) > 0
    xf = x.to(_F32)
    cols = torch.arange(capacity, device=x.device, dtype=_F32)
    pair_out = torch.zeros((b, top_k, d), dtype=_F32, device=x.device)
    for r in range(rounds):
        lo = float(r * capacity)
        sel = mask * (pos >= lo) * (pos < lo + capacity)
        disp = ((pos - lo)[..., None] == cols).to(_F32) * sel[..., None]
        xe = torch.einsum("bec,bd->ecd", disp, xf).to(x.dtype)
        h = F.silu(L.dot_f32(xe, w_gate)) * L.dot_f32(xe, w_up)
        out = L.dot_f32(h.to(x.dtype), w_down)              # [E, C, d]
        taken = out.reshape(e * capacity, d)[pair_row]      # [B, k, d]
        here = pair_on & (pair_round == r)
        pair_out = torch.where(here[..., None], taken, pair_out)
    # the gated sum over each token's pairs, in rank order
    y = (pair_out * (weights * pair_on)[..., None]).sum(dim=1)
    return y.to(x.dtype), load.to(torch.int32), rounds
