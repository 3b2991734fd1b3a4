"""Schedule algebra — the pure math of every proxy workload (the port's
copy of the JAX package's ``core/schedule.py``; no device involved).

Every quantity a proxy derives at startup (bucket sizes, padded shards,
rank-grid coordinates, per-phase message sizes, per-stage compute times)
is a pure function over ``ModelStats`` / ``ModelCard`` here.

Reference counterparts:
  * bucket split            — cpp/data_parallel/dp.cpp:159-164
  * FSDP units/shards/grid  — cpp/data_parallel/fsdp.cpp:217-265
  * 2D pipe grid + messages — cpp/hybrid_parallel/hybrid_2d.cpp:236-276
  * 3D grid + TP messages   — cpp/hybrid_parallel/hybrid_3d.cpp:283-325
  * MoE A2A + two-level sync— cpp/hybrid_parallel/hybrid_3d_moe.cpp:291-363

A rank's (dp, pp, tp/ep) coordinates are its place in the process
groups of ``parallel/mesh.py``; the communicator-color math is kept to
verify grid consistency against the reference.
"""
from __future__ import annotations

import dataclasses
import math

from dlnetbench_tpu_torch.core.model_card import ModelCard
from dlnetbench_tpu_torch.core.model_stats import ModelStats


# --------------------------------------------------------------------- #
# Data-parallel bucketing
# --------------------------------------------------------------------- #
def split_buckets(total: int, num_buckets: int) -> list[int]:
    """Split ``total`` elements into ``num_buckets`` near-equal buckets,
    remainder spread one-per-bucket from the front (reference
    dp.cpp:159-164 semantics).  sum(result) == total always."""
    if num_buckets <= 0:
        raise ValueError("num_buckets must be positive")
    base, rem = divmod(total, num_buckets)
    return [base + (1 if i < rem else 0) for i in range(num_buckets)]


@dataclasses.dataclass(frozen=True)
class DPSchedule:
    """Bucketed data-parallel gradient sync schedule."""
    num_buckets: int
    bucket_sizes: list[int]        # elements per bucket
    fwd_us: float                  # whole-model forward compute
    bwd_us_per_bucket: float       # backward compute per bucket
    bytes_per_element: float

    @property
    def bucket_bytes(self) -> list[int]:
        return [int(s * self.bytes_per_element) for s in self.bucket_sizes]


def dp_schedule(stats: ModelStats, num_buckets: int) -> DPSchedule:
    return DPSchedule(
        num_buckets=num_buckets,
        bucket_sizes=split_buckets(stats.model_size, num_buckets),
        fwd_us=stats.fwd_us,
        bwd_us_per_bucket=stats.bwd_us / num_buckets,
        bytes_per_element=stats.bytes_per_element,
    )


# --------------------------------------------------------------------- #
# FSDP / ZeRO-3
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FSDPSchedule:
    num_units: int
    sharding_factor: int
    num_replicas: int
    unit_sizes: list[int]          # full (unsharded) unit sizes, elements
    shard_size: int                # padded per-rank shard of one unit
    fwd_us_per_unit: float
    bwd_us_per_unit: float
    bytes_per_element: float

    @property
    def padded_unit_size(self) -> int:
        return self.shard_size * self.sharding_factor


def fsdp_schedule(stats: ModelStats, num_units: int, world_size: int,
                  sharding_factor: int | None = None) -> FSDPSchedule:
    """World = sharding_factor x num_replicas (reference fsdp.cpp:217,258);
    shard sizes padded so every rank holds an equal slice (fsdp.cpp:251-255)."""
    sf = sharding_factor if sharding_factor is not None else world_size
    if world_size % sf != 0:
        raise ValueError(f"world_size {world_size} not divisible by "
                         f"sharding_factor {sf}")
    unit_sizes = split_buckets(stats.model_size, num_units)
    max_unit = max(unit_sizes)
    shard = math.ceil(max_unit / sf)
    return FSDPSchedule(
        num_units=num_units,
        sharding_factor=sf,
        num_replicas=world_size // sf,
        unit_sizes=unit_sizes,
        shard_size=shard,
        fwd_us_per_unit=stats.fwd_us / num_units,
        bwd_us_per_unit=stats.bwd_us / num_units,
        bytes_per_element=stats.bytes_per_element,
    )


# --------------------------------------------------------------------- #
# Rank grids (verification-only in the mesh world)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Grid3D:
    """3D process grid, fastest-varying axis LAST coordinate (tp/ep),
    matching the reference layout ``tp_id = rank % tp; stage_id =
    (rank/tp) % pp; dp_id = rank/(tp*pp)`` (hybrid_3d.cpp:283-285)."""
    dp: int
    pp: int
    tp: int

    @property
    def world_size(self) -> int:
        return self.dp * self.pp * self.tp

    def coords(self, rank: int) -> tuple[int, int, int]:
        tp_id = rank % self.tp
        pp_id = (rank // self.tp) % self.pp
        dp_id = rank // (self.tp * self.pp)
        return dp_id, pp_id, tp_id

    def rank(self, dp_id: int, pp_id: int, tp_id: int) -> int:
        return (dp_id * self.pp + pp_id) * self.tp + tp_id

    # Communicator "colors" — all ranks sharing a color form one group
    # (reference hybrid_3d.cpp:287-300).  Kept for parity verification.
    def dp_color(self, rank: int) -> int:
        _, pp_id, tp_id = self.coords(rank)
        return pp_id * self.tp + tp_id

    def pp_color(self, rank: int) -> int:
        dp_id, _, tp_id = self.coords(rank)
        return dp_id * self.tp + tp_id

    def tp_color(self, rank: int) -> int:
        dp_id, pp_id, _ = self.coords(rank)
        return dp_id * self.pp + pp_id


# --------------------------------------------------------------------- #
# Pipeline (GPipe) schedules
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    grid: Grid3D
    num_microbatches: int
    layers_per_stage: int
    pipe_msg_elems: int           # activations per microbatch hop
    dp_sync_elems: int            # per-stage gradient shard for DP allreduce
    tp_msg_elems: int             # per-microbatch TP allreduce (0 if tp==1)
    fwd_us_per_stage_mb: float    # stage compute per microbatch, forward
    bwd_us_per_stage_mb: float
    bytes_per_element: float

    @property
    def num_stages(self) -> int:
        return self.grid.pp


def pipeline_schedule(stats: ModelStats, card: ModelCard, *,
                      num_stages: int, num_microbatches: int,
                      dp: int = 1, tp: int = 1) -> PipelineSchedule:
    """DP+PP(+TP) schedule parameters.

    Invariants from the reference: layers divisible by stages and batch by
    microbatches (hybrid_2d.cpp:264-265); pipe message = seq_len x embed_dim
    x samples-per-microbatch activations, NOT divided by tp
    (hybrid_2d.cpp:244-247, hybrid_3d.cpp:319); DP allreduce =
    model/(num_stages*tp) (hybrid_2d.cpp:250, hybrid_3d.cpp:325); with TP,
    per-microbatch compute is divided by tp and the TP allreduce message is
    pipe_msg/tp (hybrid_3d.cpp:314-315, 322).
    """
    if card.num_layers % num_stages != 0:
        raise ValueError(f"{card.num_layers} layers not divisible by "
                         f"{num_stages} stages")
    if stats.batch_size % num_microbatches != 0:
        raise ValueError(f"batch {stats.batch_size} not divisible by "
                         f"{num_microbatches} microbatches")
    samples_per_mb = stats.batch_size // num_microbatches
    pipe_msg = stats.seq_len * stats.embed_dim * samples_per_mb
    return PipelineSchedule(
        grid=Grid3D(dp=dp, pp=num_stages, tp=tp),
        num_microbatches=num_microbatches,
        layers_per_stage=card.num_layers // num_stages,
        pipe_msg_elems=pipe_msg,
        dp_sync_elems=stats.model_size // (num_stages * tp),
        tp_msg_elems=(pipe_msg // tp) if tp > 1 else 0,
        fwd_us_per_stage_mb=stats.fwd_us / (num_stages * num_microbatches * tp),
        bwd_us_per_stage_mb=stats.bwd_us / (num_stages * num_microbatches * tp),
        bytes_per_element=stats.bytes_per_element,
    )


# --------------------------------------------------------------------- #
# MoE / expert parallelism
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MoESchedule:
    pipe: PipelineSchedule
    num_expert_shards: int
    top_k: int
    a2a_elems: int                 # one all-to-all dispatch/combine message
    a2a_per_direction: int         # count of A2As per microbatch per direction
    nonexpert_sync_elems: int      # level-1 grad sync over the EP group
    expert_sync_elems: int         # level-2 expert-param stage shard over DP

    @property
    def grid(self) -> Grid3D:
        """The EP degree takes the fastest-varying axis (reference
        hybrid_3d_moe.cpp grid is identical in shape to hybrid_3d with EP
        in place of TP, SURVEY.md §2.1)."""
        return Grid3D(dp=self.pipe.grid.dp, pp=self.pipe.grid.pp,
                      tp=self.num_expert_shards)


def moe_schedule(stats: ModelStats, card: ModelCard, *,
                 num_stages: int, num_microbatches: int,
                 num_expert_shards: int, dp: int = 1) -> MoESchedule:
    """DP+PP+EP schedule.  A2A message = tokens_per_microbatch x top_k x
    embed_dim / num_expert_shards (reference hybrid_3d_moe.cpp:354-359,
    which hardcodes top_k=2 — here it comes from the card); two A2As
    (dispatch + combine) per MoE layer per direction (:161-165); gradient
    sync is two-level: non-expert params over the EP group then the
    expert-param stage shard over DP (:202-208; sizes :278,361-363: expert
    params = model_size - non_expert_size).  Unlike TP, EP does NOT divide
    the per-microbatch compute or the pipe message (hybrid_3d_moe.cpp:339-347)
    — experts are sharded, but each rank still computes its share of every
    token's top-k expert work."""
    if card.num_experts % num_expert_shards != 0:
        raise ValueError(f"{card.num_experts} experts not divisible by "
                         f"{num_expert_shards} shards")
    pipe = pipeline_schedule(stats, card, num_stages=num_stages,
                             num_microbatches=num_microbatches, dp=dp, tp=1)
    samples_per_mb = stats.batch_size // num_microbatches
    tokens_per_mb = samples_per_mb * stats.seq_len
    a2a = tokens_per_mb * card.top_k * stats.embed_dim // num_expert_shards
    layers_per_stage = card.num_layers // num_stages
    non_expert = stats.non_expert_size or card.non_expert_params()
    expert_params = stats.model_size - non_expert
    return MoESchedule(
        pipe=pipe,
        num_expert_shards=num_expert_shards,
        top_k=card.top_k,
        a2a_elems=a2a,
        a2a_per_direction=2 * layers_per_stage,
        nonexpert_sync_elems=non_expert // max(num_stages, 1),
        expert_sync_elems=expert_params // (num_stages * num_expert_shards),
    )


# --------------------------------------------------------------------- #
# Zero-bubble pipeline tick tables (rebuild extension; no reference
# counterpart — the reference models only GPipe, hybrid_2d.cpp:106-161)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ZBTables:
    """Per-tick op sets for the ZB-H1 schedule (Qi et al., "Zero Bubble
    Pipeline Parallelism"): backward is split into the input-grad half B
    (must propagate to the previous stage) and the weight-grad half W
    (local, no hop), and W ticks fill the drain bubble.  With the stat
    model's bwd = 2 x fwd (reference python/model_stats.py:140), F, B and
    W are equal one-unit ticks — the exact setting where ZB-H1 removes
    most of the 1F1B bubble.

    Each list has one entry per tick; entry = sorted list of stages doing
    that op in the tick.  Hops derive directly: a stage doing F sends up
    (except the last), a stage doing B sends down (except the first).
    """
    f_stages: list[list[int]]
    b_stages: list[list[int]]
    w_stages: list[list[int]]

    @property
    def ticks(self) -> int:
        return len(self.f_stages)

    def f_senders(self, num_stages: int) -> list[list[int]]:
        return [[s for s in tick if s < num_stages - 1]
                for tick in self.f_stages]

    def b_senders(self) -> list[list[int]]:
        return [[s for s in tick if s > 0] for tick in self.b_stages]


def zb_unit_ticks(tables: "ZBTables", bwd_units: float = 2.0) -> float:
    """Makespan of the tick-synchronous ZB table in FORWARD units, with
    the backward weight derived from the stats rather than hardcoded:
    F costs 1 unit, B and W each cost half a backward (bwd_units / 2).
    The engine is tick-synchronous, so each tick costs its largest
    resident op.  With the stat model's bwd = 2 x fwd (bwd_units == 2)
    every tick costs 1 and this equals ``tables.ticks``; a stats file
    with a different bwd/fwd ratio changes the weights instead of
    silently skewing cross-schedule comparisons."""
    half = bwd_units / 2.0
    total = 0.0
    for ft, bt, wt in zip(tables.f_stages, tables.b_stages,
                          tables.w_stages):
        total += max(1.0 if ft else 0.0, half if (bt or wt) else 0.0)
    return total


def zb_tables(num_stages: int, num_microbatches: int) -> ZBTables:
    """Tick-synchronous greedy construction of ZB-H1: every stage runs at
    most one unit op per tick with priority B > F > W.  Dependencies:
    F(k)@s needs F(k)@(s-1) done in an earlier tick (activation hop);
    B(k)@s needs F(k)@s locally and B(k)@(s+1) done earlier (grad hop);
    W(k)@s needs B(k)@s.  The B-first priority reproduces the 1F1B
    skeleton; W's slot into ticks that 1F1B leaves idle, which is the
    whole point of the schedule."""
    S, M = num_stages, num_microbatches
    if S <= 0 or M <= 0:
        raise ValueError("num_stages and num_microbatches must be positive")
    f_tick = [[-1] * M for _ in range(S)]   # tick F(k) ran at stage s
    b_tick = [[-1] * M for _ in range(S)]
    nf = [0] * S                            # next F/B/W index per stage
    nb = [0] * S
    nw = [0] * S
    f_stages: list[list[int]] = []
    b_stages: list[list[int]] = []
    w_stages: list[list[int]] = []
    while any(nw[s] < M for s in range(S)):
        t = len(f_stages)
        ft, bt, wt = [], [], []
        for s in range(S):
            # cross-stage deps compare tick indices STRICTLY below t, so a
            # hop never lands in the tick it was sent (stage s-1's F this
            # very tick must not enable stage s's F until the next tick)
            k = nb[s]
            if (k < nf[s]
                    and (s == S - 1
                         or 0 <= b_tick[s + 1][k] < t)):
                bt.append(s)
                b_tick[s][k] = t
                nb[s] += 1
                continue
            k = nf[s]
            if (k < M
                    and (s == 0 or 0 <= f_tick[s - 1][k] < t)):
                ft.append(s)
                f_tick[s][k] = t
                nf[s] += 1
                continue
            if nw[s] < nb[s]:
                wt.append(s)
                nw[s] += 1
        f_stages.append(ft)
        b_stages.append(bt)
        w_stages.append(wt)
        if len(f_stages) > 4 * (M + S):  # pragma: no cover - safety bound
            raise RuntimeError("zb_tables failed to converge")
    return ZBTables(f_stages, b_stages, w_stages)


# --------------------------------------------------------------------- #
# Sequence/context parallelism (rebuild extension, SURVEY.md §5.7)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SequenceSchedule:
    sp: int                        # sequence-parallel degree
    seq_per_rank: int
    kv_block_elems: int            # ring: one K+V block exchanged per hop
    a2a_elems: int                 # ulysses: one head<->seq reshard message
    num_ring_hops: int             # sp - 1 per attention layer
    attn_us_per_block: float       # compute per KV block per layer
    attn_time_source: str          # "ffn_stats" (1 - ffn_fwd/fwd from the
                                   # stat file) or "even_split_fallback"
                                   # (0.5 — stats lacked FFN timings);
                                   # emitted so analysis can tell which
                                   # path produced attn_us_per_block
    layers: int
    bytes_per_element: float


def sequence_schedule(stats: ModelStats, card: ModelCard, sp: int,
                      batch: int | None = None) -> SequenceSchedule:
    """Ring attention exchanges each rank's K,V block around a ring of
    ``sp`` devices ((sp-1) ppermute hops per layer), overlapping per-block
    attention compute; Ulysses does two all-to-alls per layer resharding
    heads<->sequence.  Message math: KV block = 2 x B x (N/sp) x kv_dim;
    Ulysses A2A = B x (N/sp) x d."""
    if card.seq_len % sp != 0:
        raise ValueError(f"seq_len {card.seq_len} not divisible by sp={sp}")
    b = batch if batch is not None else stats.batch_size
    n_local = card.seq_len // sp
    # attention time fraction of forward, split across sp^2 block pairs;
    # fall back to an even split when the stats file lacks FFN timings
    if stats.fwd_us > 0 and stats.ffn_fwd_us > 0:
        attn_frac = 1.0 - stats.ffn_fwd_us / stats.fwd_us
        attn_source = "ffn_stats"
    else:
        attn_frac = 0.5
        attn_source = "even_split_fallback"
    attn_us = stats.fwd_us * attn_frac / max(card.num_layers, 1) / (sp * sp)
    return SequenceSchedule(
        sp=sp,
        seq_per_rank=n_local,
        kv_block_elems=2 * b * n_local * card.kv_dim,
        a2a_elems=b * n_local * card.embed_dim,
        num_ring_hops=sp - 1,
        attn_us_per_block=attn_us,
        attn_time_source=attn_source,
        layers=card.num_layers,
        bytes_per_element=stats.bytes_per_element,
    )
