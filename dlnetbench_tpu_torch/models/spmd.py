"""The fully sharded training step: dp x pp x tp (+sp, +ep) (the JAX
package's ``models/spmd.py``).

The JAX package runs one ``shard_map`` program over a ``(dp, pp, tp)``
device mesh; here one process a rank runs its own copy of the step
over the process groups of ``parallel/mesh.make_grid_mesh`` (NCCL on
the cards, gloo on the CPU), holding only its own shards:

  dp  batch sharding; gradients summed over the dp group and divided
      by dp
  pp  GPipe: layers split into stages, microbatches streamed with
      ``ppermute``; stage s works on microbatch t - s at tick t
  tp  Megatron attention: column-parallel QKV, row-parallel output
      projection closed by ``psum_scatter``
  sp  the activations between blocks are sequence-sharded over tp:
      ``all_gather`` to enter attention (megatron), or ring / Ulysses
      attention on the shards (``ops/sequence_parallel.py``)
  ep  capacity-based top-k routing (``models/moe.py``), experts sharded
      over tp, ``all_to_all`` to dispatch and combine, or the fused
      per-peer loop (``ops/moe_dispatch.py``)

Backward is autograd through the collectives
(``parallel/collectives``'s differentiable forms, with the transposes
JAX applies under ``check_vma=False``), then every gradient is summed
over the dp group (divided by dp) and over each mesh axis its parameter
is replicated on.  Every rank must issue the same collectives in the
same order, so every stage runs every tick (idle ticks masked, as in
JAX: ``torch.where(stage == 0, emb, x_carry)`` and a masked loss), and
every rank builds a graph of the same structure, so autograd's order in
backward is the same on every rank of a group.

Layout.  The port holds a stage's layers as per-layer tensors
(``params["layers"]`` a list of dicts) where JAX stacks them ``[L, ...]``
and scans: a stacked tensor indexed per layer would cost a full-size
zero gradient per layer in backward, and its gradient would complete
only at the end of backward, so bucketed sync could overlap nothing.
``params_from_numpy`` converts JAX's global stacked tree into this
rank's shards (``param_specs``) and ``gather_params`` back.

Overlap.  ``tp_overlap="decomposed"`` runs the megatron QKV / output
projections and the vocab-parallel head as decomposed collective
matmuls (``ops/collective_matmul.py``, forward and backward);
``grad_sync="bucketed"`` issues each bucket's dp sum as soon as its
gradients are complete, from a post-accumulate-grad hook, in reverse
layer order (head and final norm first, the embedding last), and sums
over the replicated axes after backward.  JAX
chains its buckets with ``collectives.tie``; torch runs in issue order,
so the hooks' order is the chain and ``tie`` has no counterpart.
``make_train_step(variant=...)`` builds the compute-only / comm-only
legs of the A/B decomposition (``models/overlap_bench.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dlnetbench_tpu_torch import ops
from dlnetbench_tpu_torch.models import layers as Lyr
from dlnetbench_tpu_torch.ops import collective_matmul as CM
from dlnetbench_tpu_torch.ops import sequence_parallel as SP
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_TP

_F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# A/B decomposition variants of the train step: "compute" strips every
# collective (local shape-preserving stand-ins), "comm" strips the heavy
# math (``comm_stub``s with the same dataflow edges)
VARIANTS = ("full", "compute", "comm")

LAYER_KEYS = ("wq", "wk", "wv", "wo", "norm1", "norm2", "w_router",
              "w_gate", "w_up", "w_down")


def _agreed(values: tuple, device=None) -> tuple:
    """``values`` (ints) once every rank of the process group resolved
    the same; a ValueError on every rank, naming each rank's values,
    when one did not.  One all-gather, on ``device`` (by default the
    group backend's: the card for NCCL, the CPU for gloo); nothing
    without a group of two or more ranks."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() < 2:
        return values
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor(values, dtype=torch.int64,
                        device=torch.device(device))
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    rows = [tuple(int(v) for v in t.tolist()) for t in every]
    if any(r != rows[0] for r in rows):
        raise ValueError(
            f"resolve_tuned: the ranks resolved different "
            f"(tp_overlap_chunks, grad_bucket_layers): {rows} in rank "
            f"order — every rank must read one tuning DB "
            f"(DLNB_TUNING_DB_DIR) or none")
    return values


@dataclasses.dataclass(frozen=True)
class SpmdConfig:
    """The JAX package's ``SpmdConfig``, field for field (its comments
    there say what each knob does)."""
    vocab_size: int = 128
    embed_dim: int = 64
    num_heads: int = 4
    num_kv_heads: int = 4
    ff_dim: int = 128
    num_layers: int = 4          # total; split over pp
    seq_len: int = 32            # split over tp (sequence parallelism)
    num_experts: int = 4         # split over tp (expert parallelism)
    top_k: int = 2
    capacity_factor: float = 2.0
    batch: int = 8               # split over dp
    num_microbatches: int = 2
    lr: float = 0.1
    dtype: str = "float32"
    attention_impl: str = "auto"  # ops.attention: auto | xla (CPU only)
    mlp_int8: bool = False       # expert products through int8_dot_batched
    sp_mode: str = "megatron"    # megatron | ring | ulysses
    attention_window: int = 0
    attention_seg_avg: int = 0
    attention_seg_seed: int = 0
    tp_overlap: str = "none"     # none | decomposed
    tp_overlap_chunks: int | None = None
    grad_sync: str = "monolithic"  # monolithic | bucketed
    grad_bucket_layers: int | None = None
    moe_a2a: str = "monolithic"  # monolithic | decomposed
    moe_chunks: int = 1
    moe_drop_seed: int | None = None
    moe_group_tokens: int = 0
    moe_ffn_impl: str = "einsum"  # einsum | grouped (kernel K12)
    moe_ffn_quant: str = "none"   # none | int8 | float8 (grouped only)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def torch_dtype(self):
        return DTYPES[self.dtype]

    def resolve_tuned(self, dp: int, pp: int, tp: int,
                      device=None) -> "SpmdConfig":
        """Concrete overlap-grain and bucket-size knobs: explicit values
        pass through; a ``None`` field consults the tuning DB
        (``tuning.consult`` on ``device``'s chip, frozen after the first
        consult) and takes the frozen default (chunks 2, bucket 1) on a
        miss, so an empty DB is bit-identical to an untuned run.  A knob
        whose mode is off (``tp_overlap='none'``,
        ``grad_sync='monolithic'``) takes its default with no consult:
        the step does not depend on it.

        One process runs each rank, and ranks that resolved different
        grains would issue different collectives and hang the step.  So
        when a knob was consulted the ranks of the process group agree
        on the answer first (``_agreed``): a rank that resolved another
        value fails the build on every rank, loudly.  Returns self when
        nothing needed resolving."""
        chunks, bucket = self.tp_overlap_chunks, self.grad_bucket_layers
        if chunks is None or bucket is None:
            from dlnetbench_tpu_torch import tuning

            def positive(field):
                def check(cfg):
                    v = cfg.get(field)
                    if not isinstance(v, int) or v < 1:
                        raise ValueError(f"{field}={v!r} is not a "
                                         f"positive int")
                return check
            consulted = False
            if chunks is None:
                if self.tp_overlap != "decomposed":
                    chunks = 2   # inert knob: frozen default, no consult
                else:
                    chunks = tuning.consult(
                        "tp_overlap_chunks",
                        tuning.params.tp_overlap_chunks_key(
                            self.embed_dim, self.ff_dim, self.seq_len,
                            tp, self.dtype),
                        {"chunks": 2}, validate=positive("chunks"),
                        device=device)["chunks"]
                    consulted = True
            if bucket is None:
                if self.grad_sync != "bucketed":
                    bucket = 1   # inert knob: frozen default, no consult
                else:
                    bucket = tuning.consult(
                        "grad_bucket_layers",
                        tuning.params.grad_bucket_layers_key(
                            self.num_layers, dp, pp, self.embed_dim,
                            self.ff_dim),
                        {"layers": 1}, validate=positive("layers"),
                        device=device)["layers"]
                    consulted = True
            if consulted:
                chunks, bucket = _agreed((chunks, bucket), device)
        if (chunks, bucket) == (self.tp_overlap_chunks,
                                self.grad_bucket_layers):
            return self
        return dataclasses.replace(self, tp_overlap_chunks=chunks,
                                   grad_bucket_layers=bucket)

    @property
    def mask_spec(self):
        """The attention ``MaskSpec`` these knobs declare, or None for
        dense causal."""
        from dlnetbench_tpu_torch.ops.attention_mask import MaskSpec
        return MaskSpec.from_knobs(self.attention_window,
                                   self.attention_seg_avg,
                                   self.attention_seg_seed)

    def ring_hop_stats(self, tp: int) -> dict:
        """Skipped-hop accounting of sp_mode='ring' on a tp-wide ring."""
        from dlnetbench_tpu_torch.ops import attention_mask as amask
        frac = amask.ring_skipped_hop_fraction(self.mask_spec,
                                               self.seq_len, tp)
        return {"ring_hops": tp * tp,
                "ring_skipped_hop_fraction": round(frac, 6)}

    def validate(self, dp: int, pp: int, tp: int) -> None:
        heads_sharded = self.sp_mode in ("megatron", "ulysses")
        checks = [
            (self.sp_mode in ("megatron", "ring", "ulysses"),
             f"unknown sp_mode {self.sp_mode!r}"),
            (self.tp_overlap in ("none", "decomposed"),
             f"unknown tp_overlap {self.tp_overlap!r}"),
            (self.tp_overlap_chunks is None or self.tp_overlap_chunks >= 1,
             "tp_overlap_chunks < 1"),
            (self.grad_sync in ("monolithic", "bucketed"),
             f"unknown grad_sync {self.grad_sync!r}"),
            (self.grad_bucket_layers is None or
             self.grad_bucket_layers >= 1, "grad_bucket_layers < 1"),
            (self.attention_window >= 0, "attention_window < 0"),
            (self.attention_seg_avg >= 0, "attention_seg_avg < 0"),
            (self.moe_a2a in ("monolithic", "decomposed"),
             f"unknown moe_a2a {self.moe_a2a!r}"),
            (self.moe_chunks >= 1, "moe_chunks < 1"),
            (self.moe_group_tokens >= 0, "moe_group_tokens < 0"),
            (self.moe_group_tokens == 0
             or (self.seq_len // tp) % self.moe_group_tokens == 0,
             f"moe_group_tokens {self.moe_group_tokens} must divide "
             f"the sequence shard {self.seq_len // tp} (groups may "
             f"not straddle shard boundaries)"),
            (self.moe_ffn_impl in ("einsum", "grouped"),
             f"unknown moe_ffn_impl {self.moe_ffn_impl!r}"),
            (self.moe_ffn_quant in ("none", "int8", "float8"),
             f"unknown moe_ffn_quant {self.moe_ffn_quant!r}"),
            (self.moe_ffn_quant == "none"
             or self.moe_ffn_impl == "grouped",
             "moe_ffn_quant requires moe_ffn_impl='grouped' (the "
             "fused recipes live in the grouped kernel)"),
            (not (self.mlp_int8 and self.moe_ffn_impl == "grouped"),
             "mlp_int8 and moe_ffn_impl='grouped' are two quant "
             "recipes on one matmul — pick one"),
            (self.num_layers % pp == 0, "layers % pp != 0"),
            (self.batch % (dp * self.num_microbatches) == 0,
             "batch % (dp*microbatches) != 0"),
            (self.seq_len % tp == 0, "seq_len % tp != 0 (sp sharding)"),
            (not heads_sharded or self.num_heads % tp == 0,
             "heads % tp != 0"),
            (not heads_sharded or self.num_kv_heads % tp == 0,
             "kv_heads % tp != 0"),
            (self.num_experts % tp == 0, "experts % tp != 0 (ep sharding)"),
            (self.vocab_size % tp == 0, "vocab % tp != 0 (parallel head)"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"SpmdConfig invalid for mesh "
                                 f"({dp},{pp},{tp}): {what}")


# --------------------------------------------------------------------- #
# Parameters: global shapes, their specs, and this rank's shards
# --------------------------------------------------------------------- #
def init_params(cfg: SpmdConfig, *, seed: int = 0, device="cpu") -> dict:
    """The global parameter tree in the JAX package's layout (layers
    stacked ``[L, ...]``) from a seeded ``torch.Generator`` on
    ``device`` (the draws differ from ``jax.random``'s)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, dh = cfg.embed_dim, cfg.head_dim
    dkv = cfg.num_kv_heads * dh
    h, nl, v, e = cfg.ff_dim, cfg.num_layers, cfg.vocab_size, \
        cfg.num_experts
    dt = cfg.torch_dtype
    s_d, s_h = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h)

    def dense(shape, scale):
        return Lyr.init_dense(gen, shape, scale, dt, device)

    return {
        "embed": dense((v, d), 1.0),
        "layers": {
            "wq": dense((nl, d, d), s_d),
            "wk": dense((nl, d, dkv), s_d),
            "wv": dense((nl, d, dkv), s_d),
            "wo": dense((nl, d, d), s_d),
            "norm1": torch.ones((nl, d), dtype=dt, device=device),
            "norm2": torch.ones((nl, d), dtype=dt, device=device),
            "w_router": dense((nl, d, e), s_d),
            "w_gate": dense((nl, e, d, h), s_d),
            "w_up": dense((nl, e, d, h), s_d),
            "w_down": dense((nl, e, h, d), s_h),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "head": dense((d, v), s_d),
    }


def param_specs(sp_mode: str = "megatron") -> dict:
    """The mesh axis each dim of each global leaf is sharded over (None:
    replicated), JAX's ``PartitionSpec``s: layers over pp, Megatron TP
    on q/k/v/o (megatron mode; ring and Ulysses replicate the attention
    weights), experts over tp, the vocab head over tp."""
    if sp_mode == "megatron":
        wq = wk = wv = (AXIS_PP, None, AXIS_TP)    # column parallel
        wo = (AXIS_PP, AXIS_TP, None)              # row parallel
    else:
        wq = wk = wv = wo = (AXIS_PP, None, None)
    return {
        "embed": (),
        "layers": {
            "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "norm1": (AXIS_PP, None),
            "norm2": (AXIS_PP, None),
            "w_router": (AXIS_PP, None, None),
            "w_gate": (AXIS_PP, AXIS_TP, None, None),
            "w_up": (AXIS_PP, AXIS_TP, None, None),
            "w_down": (AXIS_PP, AXIS_TP, None, None),
        },
        "final_norm": (),
        "head": (None, AXIS_TP),
    }


def _replicated_axes(spec: tuple) -> tuple:
    """Mesh axes besides dp that a leaf is replicated across: its
    gradient is summed over exactly these."""
    return tuple(a for a in (AXIS_PP, AXIS_TP) if a not in spec)


def _slices(spec: tuple, shape, mesh) -> tuple:
    """This rank's index along each dim of a global leaf."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        n = mesh.axes[axis]
        c = mesh.coords[list(mesh.axes).index(axis)]
        size = shape[dim] // n
        out.append(slice(c * size, (c + 1) * size))
    return tuple(out)


def shard_params(global_tree: dict, mesh, cfg: SpmdConfig) -> dict:
    """This rank's shards of a global tree (tensors, JAX's stacked
    layout), as the port's layout: per-layer dicts for the stage's
    layers, every leaf contiguous on ``mesh.device``."""
    specs = param_specs(cfg.sp_mode)

    def take(t, spec):
        return t[_slices(spec, t.shape, mesh)].contiguous().to(mesh.device)

    local = {k: take(global_tree[k], specs[k])
             for k in ("embed", "final_norm", "head")}
    stacked = {k: take(global_tree["layers"][k], specs["layers"][k])
               for k in LAYER_KEYS}
    n_loc = cfg.num_layers // mesh.axes[AXIS_PP]
    local["layers"] = [{k: stacked[k][i].clone() for k in LAYER_KEYS}
                       for i in range(n_loc)]
    return local


def params_from_numpy(tree: dict, mesh, cfg: SpmdConfig) -> dict:
    """The JAX package's global parameter tree, handed over as numpy
    arrays -> this rank's shards in the port's layout."""
    dt = cfg.torch_dtype

    def conv(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)

    glob = {k: conv(tree[k]) for k in ("embed", "final_norm", "head")}
    glob["layers"] = {k: conv(tree["layers"][k]) for k in LAYER_KEYS}
    return shard_params(glob, mesh, cfg)


def gather_params(params: dict, mesh, cfg: SpmdConfig) -> dict:
    """Every rank's shards assembled into the global tree in JAX's
    stacked layout, as f32 numpy arrays (on every rank)."""
    specs = param_specs(cfg.sp_mode)

    def host(t):
        return t.detach().to(_F32).cpu().numpy()

    mine = {k: host(params[k]) for k in ("embed", "final_norm", "head")}
    mine["layers"] = {k: np.stack([host(lp[k]) for lp in params["layers"]])
                      for k in LAYER_KEYS}
    pieces = multihost.all_ranks((mesh.coords, mine))
    axes = list(mesh.axes)

    def place(key, spec, get):
        shape = list(get(pieces[0][1]).shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] *= mesh.axes[axis]
        out = np.zeros(shape, np.float32)
        for coords, tree in pieces:
            part = get(tree)
            idx = []
            for dim, axis in enumerate(spec):
                if axis is None:
                    idx.append(slice(None))
                else:
                    c = coords[axes.index(axis)]
                    n = part.shape[dim]
                    idx.append(slice(c * n, (c + 1) * n))
            out[tuple(idx)] = part
        return out

    out = {k: place(k, specs[k], lambda t, k=k: t[k])
           for k in ("embed", "final_norm", "head")}
    out["layers"] = {k: place(k, specs["layers"][k],
                              lambda t, k=k: t["layers"][k])
                     for k in LAYER_KEYS}
    return out


def _leaves_with_specs(params: dict, sp_mode: str) -> list:
    """``(tensor, spec)`` for every leaf of a local tree (a per-layer
    leaf has its stack's spec: sharded over pp, its layer is this
    stage's alone)."""
    specs = param_specs(sp_mode)
    out = [(params[k], specs[k]) for k in ("embed", "final_norm", "head")]
    for lp in params["layers"]:
        out += [(lp[k], specs["layers"][k]) for k in LAYER_KEYS]
    return out


# --------------------------------------------------------------------- #
# The per-rank forward
# --------------------------------------------------------------------- #
def _local_a2a(x, tp: int, split: int, concat: int):
    """Shape-equivalent local stand-in for a tiled all_to_all (compute
    variant: same output shape, no wire traffic)."""
    return torch.cat(x.chunk(tp, dim=split), dim=concat)


class _Ctx:
    """What a step's forward reads besides the parameters."""

    def __init__(self, cfg, mesh, comm_on, compute_on):
        self.cfg, self.comm_on, self.compute_on = cfg, comm_on, compute_on
        self.dp, self.pp, self.tp = (mesh.axes[a]
                                     for a in (AXIS_DP, AXIS_PP, AXIS_TP))
        self.dp_idx, self.stage, self.tp_idx = mesh.coords
        self.g_dp, self.g_pp, self.g_tp = (mesh.groups[a]
                                           for a in (AXIS_DP, AXIS_PP,
                                                     AXIS_TP))
        self.device = mesh.device


def _moe_block(c: _Ctx, y, lp, gids):
    """y ``[mb, S/tp, d]`` local tokens; experts sharded over tp (EP).
    ``gids`` ``[mb, S/tp]``: the global token ids, the seeded drop
    priority's domain."""
    from dlnetbench_tpu_torch.models import moe as MoE
    from dlnetbench_tpu_torch.ops import moe_dispatch as MD
    cfg, tp = c.cfg, c.tp
    mb, s_loc, d = y.shape
    t = mb * s_loc
    x2 = y.reshape(t, d)
    quant = None if cfg.moe_ffn_quant == "none" else cfg.moe_ffn_quant
    routing = None
    if c.compute_on:
        routing, _, _ = MoE.route(
            x2, lp["w_router"], cfg.num_experts, cfg.top_k,
            cfg.capacity_factor, drop_seed=cfg.moe_drop_seed,
            group_tokens=cfg.moe_group_tokens, gids=gids.reshape(t))
        ein = routing.buffers(x2).to(_F32)
    else:   # comm variant: dispatch stubbed, buffer shapes preserved
        g = cfg.moe_group_tokens or t
        c_total = (t // g) * MoE.group_capacity(
            g, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
        ein = CM.comm_stub((cfg.num_experts, c_total, d), _F32, x2,
                           lp["w_router"])
    if cfg.moe_a2a == "decomposed" and tp > 1:
        out = MD.a2a_expert_ffn(
            ein.to(cfg.torch_dtype), lp["w_gate"], lp["w_up"],
            lp["w_down"], c.g_tp, chunks=cfg.moe_chunks,
            fake_compute=not c.compute_on, fake_comm=not c.comm_on,
            ffn_impl=cfg.moe_ffn_impl, quant=quant, mlp_int8=cfg.mlp_int8)
    else:
        # EP all-to-all: [E, C, d] -> [E/tp, C*tp, d]
        if tp > 1:
            ein = (col.all_to_all(ein, c.g_tp, split=0, concat=1)
                   if c.comm_on else _local_a2a(ein, tp, 0, 1))
        ein = ein.to(cfg.torch_dtype)
        if not c.compute_on:
            out = CM.comm_stub(ein.shape, _F32, ein, lp["w_gate"],
                               lp["w_up"], lp["w_down"])
        else:
            out = MoE.expert_ffn(ein, lp["w_gate"], lp["w_up"],
                                 lp["w_down"], impl=cfg.moe_ffn_impl,
                                 quant=quant, mlp_int8=cfg.mlp_int8)
        if tp > 1:  # combine all-to-all (the reverse reshard)
            out = (col.all_to_all(out, c.g_tp, split=1, concat=0)
                   if c.comm_on else _local_a2a(out, tp, 1, 0))
    if c.compute_on:
        y2 = routing.combine(out)
    else:
        y2 = CM.comm_stub((t, d), _F32, out)
    return y2.reshape(mb, s_loc, d).to(y.dtype)


def _stage_block(c: _Ctx, x, lp, positions, gids):
    """One decoder block under TP+SP; x ``[mb, S/tp, d]``
    sequence-sharded.  ``positions``: the full ``[S]`` in megatron mode
    (rope follows the gather), this shard's global slice otherwise."""
    cfg, tp = c.cfg, c.tp
    mb, s_loc, d = x.shape
    dh = cfg.head_dim
    decomposed = cfg.tp_overlap == "decomposed"
    comm_on, compute_on = c.comm_on, c.compute_on

    y = Lyr.rmsnorm(x, lp["norm1"])
    if cfg.sp_mode == "megatron" and tp > 1:
        h_loc = cfg.num_heads // tp
        hkv_loc = cfg.num_kv_heads // tp
        qw, kvw = h_loc * dh, hkv_loc * dh
        if decomposed:
            # the gather rides the QKV projection (one fused weight,
            # concatenated once a step by the caller)
            qkv = CM.all_gather_matmul(
                y, lp["w_qkv"], c.g_tp, gather_axis=1,
                chunks=cfg.tp_overlap_chunks,
                fake_compute=not compute_on, fake_comm=not comm_on)
            s_full = qkv.shape[1]
            # the slices are strided views: the flash kernels take
            # contiguous operands
            q = qkv[..., :qw].reshape(mb, s_full, h_loc, dh)
            k = qkv[..., qw:qw + kvw].reshape(mb, s_full, hkv_loc, dh)
            v = qkv[..., qw + kvw:].reshape(mb, s_full, hkv_loc,
                                            dh).contiguous()
        else:
            y = (col.all_gather(y, c.g_tp, dim=1) if comm_on
                 else torch.cat([y] * tp, dim=1))
            s_full = y.shape[1]
            if compute_on:
                q = (y @ lp["wq"]).reshape(mb, s_full, h_loc, dh)
                k = (y @ lp["wk"]).reshape(mb, s_full, hkv_loc, dh)
                v = (y @ lp["wv"]).reshape(mb, s_full, hkv_loc, dh)
            else:
                q = CM.comm_stub((mb, s_full, h_loc, dh), y.dtype, y,
                                 lp["wq"])
                k = CM.comm_stub((mb, s_full, hkv_loc, dh), y.dtype, y,
                                 lp["wk"])
                v = CM.comm_stub((mb, s_full, hkv_loc, dh), y.dtype, y,
                                 lp["wv"])
        if compute_on:
            q, k = Lyr.rope(q, k, positions)
            att = ops.attention(q, k, v, causal=True,
                                impl=cfg.attention_impl,
                                mask=cfg.mask_spec).reshape(
                mb, s_full, d // tp)
        else:
            att = CM.comm_stub((mb, s_full, d // tp), q.dtype, q, k, v)
        if decomposed:
            out = CM.matmul_reduce_scatter(
                att, lp["wo"], c.g_tp, scatter_axis=1,
                chunks=cfg.tp_overlap_chunks,
                fake_compute=not compute_on, fake_comm=not comm_on)
        else:
            out = (att @ lp["wo"] if compute_on
                   else CM.comm_stub((mb, s_full, d), att.dtype, att,
                                     lp["wo"]))          # partial sums
            out = (col.psum_scatter(out, c.g_tp, dim=1) if comm_on
                   else out[:, :s_loc])
    elif not compute_on:
        # comm variant at tp == 1: the block has no collectives
        out = CM.comm_stub((mb, s_loc, d), x.dtype, y, lp["wq"], lp["wo"])
    else:
        # the sequence stays sharded: this shard with all heads
        q = (y @ lp["wq"]).reshape(mb, s_loc, cfg.num_heads, dh)
        k = (y @ lp["wk"]).reshape(mb, s_loc, cfg.num_kv_heads, dh)
        v = (y @ lp["wv"]).reshape(mb, s_loc, cfg.num_kv_heads, dh)
        q, k = Lyr.rope(q, k, positions)
        if tp > 1 and cfg.sp_mode == "ring":
            att = SP.ring_attention(q, k, v, c.g_tp, causal=True,
                                    spec=cfg.mask_spec)
        elif tp > 1 and cfg.sp_mode == "ulysses":
            att = SP.ulysses_attention(q, k, v, c.g_tp, causal=True,
                                       impl=cfg.attention_impl,
                                       spec=cfg.mask_spec)
        else:
            att = ops.attention(q, k, v, causal=True,
                                impl=cfg.attention_impl,
                                mask=cfg.mask_spec)
        out = att.reshape(mb, s_loc, d) @ lp["wo"]
    x = x + out
    y = Lyr.rmsnorm(x, lp["norm2"])
    return x + _moe_block(c, y, lp, gids)


def _vocab_parallel_ce(c: _Ctx, logits_loc, targets):
    """Megatron vocab-parallel cross entropy: ``logits_loc`` ``[...,
    V/tp]`` this rank's vocab shard of the logits of every (gathered)
    token; the normalizer and the target logit are assembled with pmax
    / psum over tp, and every rank returns the same value."""
    v_loc = logits_loc.shape[-1]
    lg = logits_loc.to(_F32)
    m = lg.detach().amax(dim=-1)       # the shift carries no gradient
    gmax = col.pmax(m, c.g_tp) if c.comm_on else m
    sumexp = torch.exp(lg - gmax[..., None]).sum(dim=-1)
    denom = col.psum(sumexp, c.g_tp) if c.comm_on else sumexp
    local_t = targets.long() - c.tp_idx * v_loc
    in_range = (local_t >= 0) & (local_t < v_loc)
    tval = lg.gather(-1, local_t.clamp(0, v_loc - 1)[..., None])[..., 0]
    tval = torch.where(in_range, tval, 0.0)
    if c.comm_on:
        tval = col.psum(tval, c.g_tp)
    return (torch.log(denom) + gmax - tval).mean()


def _local_loss(c: _Ctx, params: dict, tokens: torch.Tensor):
    """This rank's pipeline forward over its dp rows of the global
    ``tokens`` ``[B, S+1]``: the loss of its last-stage microbatches,
    1/tp of it on each tp rank (zero on the other stages)."""
    cfg, tp, pp = c.cfg, c.tp, c.pp
    m = cfg.num_microbatches
    mb_size = cfg.batch // (c.dp * m)
    s_loc = cfg.seq_len // tp
    rows = cfg.batch // c.dp
    tokens_loc = tokens[c.dp_idx * rows:(c.dp_idx + 1) * rows]
    inputs = tokens_loc[:, :-1].reshape(m, mb_size, cfg.seq_len)
    targets = tokens_loc[:, 1:].reshape(m, mb_size, cfg.seq_len)
    dev = c.device
    if cfg.sp_mode == "megatron":
        positions = torch.arange(cfg.seq_len, device=dev)
    else:
        positions = c.tp_idx * s_loc + torch.arange(s_loc, device=dev)

    layers = params["layers"]
    if cfg.tp_overlap == "decomposed" and cfg.sp_mode == "megatron" \
            and tp > 1:
        # one fused column-parallel weight a layer, concatenated once a
        # step (autograd splits its gradient back)
        layers = [{**lp, "w_qkv": torch.cat([lp["wq"], lp["wk"],
                                             lp["wv"]], dim=-1)}
                  for lp in layers]

    flag = {b: torch.tensor(b, device=dev) for b in (False, True)}
    first = flag[c.stage == 0]
    ticks = m + pp - 1
    x_carry = torch.zeros((mb_size, s_loc, cfg.embed_dim),
                          dtype=cfg.torch_dtype, device=dev)
    loss_sum = torch.zeros((), dtype=_F32, device=dev)
    ar = torch.arange(mb_size, dtype=torch.int64, device=dev)
    sr = torch.arange(s_loc, dtype=torch.int64, device=dev)
    for t in range(ticks):
        mb_me = t - c.stage                       # my microbatch this tick
        mb_c = min(max(mb_me, 0), m - 1)
        counts = 0 <= mb_me < m and c.stage == pp - 1
        inp = inputs[mb_c]
        inp_loc = inp[:, c.tp_idx * s_loc:(c.tp_idx + 1) * s_loc]
        emb = params["embed"][inp_loc]            # [mb, S/tp, d]
        x = torch.where(first, emb, x_carry)
        # global token ids of this (microbatch, sequence shard) block:
        # the same token has the same id on every mesh shape
        rws = c.dp_idx * rows + mb_c * mb_size + ar
        gids = rws[:, None] * cfg.seq_len + c.tp_idx * s_loc + sr[None, :]
        for lp in layers:
            x = _stage_block(c, x, lp, positions, gids)
        x_out = x
        xh = Lyr.rmsnorm(x_out, params["final_norm"])
        tgt = targets[mb_c]
        if tp > 1:
            # every rank scores all tokens against its vocab shard
            if cfg.tp_overlap == "decomposed":
                logits_loc = CM.all_gather_matmul(
                    xh, params["head"], c.g_tp, gather_axis=1,
                    chunks=cfg.tp_overlap_chunks,
                    fake_compute=not c.compute_on,
                    fake_comm=not c.comm_on, out_dtype=_F32)
            else:
                xh = (col.all_gather(xh, c.g_tp, dim=1) if c.comm_on
                      else torch.cat([xh] * tp, dim=1))
                if c.compute_on:
                    logits_loc = Lyr.dot_f32(
                        xh.reshape(-1, xh.shape[-1]),
                        params["head"]).reshape(*xh.shape[:-1], -1)
                else:
                    logits_loc = CM.comm_stub(
                        xh.shape[:-1] + (params["head"].shape[-1],),
                        _F32, xh, params["head"])
            # each tp rank seeds 1/tp: the psum transposes in the loss
            # deliver exactly 1 in total
            mb_loss = _vocab_parallel_ce(c, logits_loc, tgt) / tp
        else:
            logits = Lyr.dot_f32(xh.reshape(-1, xh.shape[-1]),
                                 params["head"])
            mb_loss = Lyr.cross_entropy(logits, tgt.reshape(-1))
        loss_sum = loss_sum + torch.where(flag[counts], mb_loss, 0.0)
        # stream the activations to the next stage (the last tick's hop
        # would feed nothing)
        if pp > 1 and c.comm_on and t < ticks - 1:
            x_carry = col.ppermute(x_out, c.g_pp,
                                   [(i, i + 1) for i in range(pp - 1)])
        else:
            x_carry = x_out
    # the LOCAL loss (last stage only; 1/tp a tp rank), not summed here:
    # summing inside the differentiated function would scale every
    # gradient by the axis size
    return loss_sum / m


# --------------------------------------------------------------------- #
# Gradient sync
# --------------------------------------------------------------------- #
class _Sync:
    """The gradient sync of one step: a leaf's gradient summed over dp
    and divided by dp, then summed over each axis it is replicated on
    (JAX's ``sync_leaf``).  A bucket's gradients are flattened into one
    buffer ordered by replicated axes, so each axis takes one call a
    bucket.  ``bucket`` issues the buffer's dp sum asynchronously (from
    a post-accumulate-grad hook under bucketed sync, so it runs beside
    the rest of backward); ``finish`` waits for it, divides, and sums
    over the replicated axes."""

    def __init__(self, c: _Ctx):
        self.c = c
        self.done = []       # (leaves, flat, slices, pending dp handle)

    def bucket(self, items: list) -> None:
        """``items``: (leaf, spec) with every gradient complete."""
        items = sorted(items, key=lambda it: _replicated_axes(it[1]))
        flat = torch.cat([(it[0].grad if it[0].grad is not None
                           else torch.zeros_like(it[0])).reshape(-1)
                          for it in items])
        slices, off = [], 0
        for leaf, spec in items:
            slices.append((off, leaf.numel(), _replicated_axes(spec)))
            off += leaf.numel()
        handle = None
        if self.c.dp > 1:
            handle = col.allreduce(flat, group=self.c.g_dp, async_op=True)
        self.done.append(([it[0] for it in items], flat, slices, handle))

    def finish(self) -> dict:
        """Wait for every bucket; returns {id(leaf): synced gradient}."""
        c = self.c
        groups = {AXIS_PP: (c.pp, c.g_pp), AXIS_TP: (c.tp, c.g_tp)}
        out = {}
        for leaves, flat, slices, handle in self.done:
            if handle is not None:
                handle.wait()
                flat.div_(c.dp)
            spans = {}
            for off, n, rep in slices:
                if rep:
                    lo, hi = spans.get(rep, (off, off))
                    spans[rep] = (min(lo, off), max(hi, off + n))
            for rep, (lo, hi) in spans.items():
                for axis in rep:
                    size, group = groups[axis]
                    if size > 1:
                        col.allreduce(flat[lo:hi], group=group)
            for leaf, (off, n, _) in zip(leaves, slices):
                out[id(leaf)] = flat[off:off + n].view_as(leaf)
        return out


def _buckets(params: dict, cfg: SpmdConfig, pp: int) -> list:
    """Bucketed sync's order: the head and final norm (complete first in
    backward), the layer groups last to first, the embedding last."""
    specs = param_specs(cfg.sp_mode)
    out = [[(params["head"], specs["head"]),
            (params["final_norm"], specs["final_norm"])]]
    n_loc = cfg.num_layers // pp
    step_l = min(cfg.grad_bucket_layers, n_loc)
    bounds = list(range(0, n_loc, step_l)) + [n_loc]
    for b in reversed(range(len(bounds) - 1)):
        out.append([(lp[k], specs["layers"][k])
                    for lp in params["layers"][bounds[b]:bounds[b + 1]]
                    for k in LAYER_KEYS])
    out.append([(params["embed"], specs["embed"])])
    return out


def _hook_buckets(sync: _Sync, buckets: list) -> tuple:
    """A post-accumulate-grad hook on every leaf; a bucket syncs when its
    last leaf's gradient is complete.  Returns the hooks and ``rest()``,
    which syncs, after backward, the buckets holding a leaf that got no
    gradient (the comm variant's unused weights: zeros)."""
    handles, left = [], []
    for b, items in enumerate(buckets):
        left.append(len(items))

        def hook(_p, items=items, b=b):
            left[b] -= 1
            if left[b] == 0:
                sync.bucket(items)
        handles += [leaf.register_post_accumulate_grad_hook(hook)
                    for leaf, _ in items]

    def rest():
        for b, items in enumerate(buckets):
            if left[b] > 0:
                left[b] = 0
                sync.bucket(items)
    return handles, rest


def _map_tree(params: dict, fn) -> dict:
    out = {k: fn(params[k]) for k in ("embed", "final_norm", "head")}
    out["layers"] = [{k: fn(v) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def make_train_step(mesh, cfg: SpmdConfig, variant: str = "full"):
    """``step(params, tokens) -> (new_params, loss)`` for this rank:
    ``params`` its shards (``shard_params`` / ``params_from_numpy``),
    ``tokens`` the global ``[B, S+1]`` batch (every rank passes the
    same; each takes its dp rows).  One SGD step at ``cfg.lr``; the
    loss is the global mean, the same on every rank (the compute
    variant returns the rank's local loss).  ``params`` are not
    modified."""
    dp, pp, tp = (mesh.axes[a] for a in (AXIS_DP, AXIS_PP, AXIS_TP))
    cfg = cfg.resolve_tuned(dp, pp, tp, mesh.device)
    cfg.validate(dp, pp, tp)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    comm_on = variant != "compute"
    compute_on = variant != "comm"
    if variant != "full" and cfg.sp_mode != "megatron":
        raise ValueError(
            "A/B decomposition variants are defined for sp_mode='megatron' "
            "(ring/ulysses interleave comm and compute inside "
            "ops/sequence_parallel.py, where the split has no meaning)")
    c = _Ctx(cfg, mesh, comm_on, compute_on)

    def step(params, tokens):
        leaves = _map_tree(params,
                           lambda t: t.detach().requires_grad_(True))
        pairs = _leaves_with_specs(leaves, cfg.sp_mode)
        sync = _Sync(c)
        hooks, rest = [], None
        if comm_on and cfg.grad_sync == "bucketed":
            hooks, rest = _hook_buckets(sync, _buckets(leaves, cfg, pp))
        try:
            loss = _local_loss(c, leaves, tokens.to(mesh.device))
            loss.backward()
        finally:
            for h in hooks:
                h.remove()
        if comm_on:
            if rest is not None:
                rest()
            else:
                sync.bucket(pairs)
            synced = sync.finish()
            grads = {id(p): synced[id(p)] for p, _ in pairs}
            # the loss for reporting: the last stage's shares summed,
            # the mean over dp
            loss = loss.detach().clone()
            col.allreduce(loss, group=multihost.world_group())
            loss = loss / dp
        else:
            grads = {id(p): p.grad if p.grad is not None
                     else torch.zeros_like(p) for p, _ in pairs}
            loss = loss.detach()
        with torch.no_grad():
            new = _map_tree(leaves, lambda p: (
                p - cfg.lr * grads[id(p)].to(p.dtype)).detach())
        return new, loss

    return step


def factor_mesh(n_devices: int) -> tuple[int, int, int]:
    """(dp, pp, tp) for an n-rank run: prefer 2-way pp and tp."""
    tp = 2 if n_devices % 2 == 0 else 1
    pp = 2 if n_devices % (2 * tp) == 0 else 1
    dp = n_devices // (pp * tp)
    return dp, pp, tp


_MESHES: dict = {}


def grid_mesh(dp: int, pp: int, tp: int, device):
    """``make_grid_mesh(dp, pp, tp, device)``, made once per process
    group (its groups are collective to make).  The cache holds the
    default group it was made under, so a later group never takes a
    torn-down one's place under the same ``id``."""
    import torch.distributed as dist

    from dlnetbench_tpu_torch.parallel.mesh import make_grid_mesh
    pg = dist.distributed_c10d._get_default_group()
    key = (dp, pp, tp, str(device), id(pg))
    if key not in _MESHES:
        _MESHES[key] = (pg, make_grid_mesh(dp, pp, tp, torch.device(device)))
    return _MESHES[key][1]


def build(n_devices: int | None = None, cfg: SpmdConfig | None = None,
          device=None, seed: int = 0, platform: str = "cuda"):
    """``(mesh, cfg, step, params, tokens)`` over the process group
    (``n_devices`` must be its size; at world 1 one is made when none is
    up): the factored mesh, this rank's shards of ``init_params(seed)``
    on ``device`` (by default this rank's device of ``platform``: its
    card unless the caller asks for the CPU), and seeded global
    tokens."""
    if device is None:
        device = multihost.initialize(platform)
    n = n_devices or multihost.world_size()
    if n != multihost.world_size():
        raise ValueError(f"build({n}) needs a world of {n} ranks, have "
                         f"{multihost.world_size()}: start it with torchrun "
                         f"--nproc_per_node {n}")
    device = torch.device(device)
    mesh = grid_mesh(*factor_mesh(n), device)
    cfg = cfg or SpmdConfig()
    step = make_train_step(mesh, cfg)
    params = shard_params(init_params(cfg, seed=seed, device=device),
                          mesh, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (cfg.batch, cfg.seq_len + 1),
                           generator=gen, device=device)
    return mesh, cfg, step, params, tokens


def run_one_rank(cfg: SpmdConfig, platform: str, *, seed: int = 0,
                 steps: int = 1) -> tuple[list, dict]:
    """``steps`` steps of ``cfg`` on mesh ``(1, 1, 1)`` under a one-rank
    group of ``platform``'s backend (made here and torn down after when
    none is up), from ``init_params(seed)`` drawn on the CPU and seeded
    CPU tokens, so a card run and a CPU run start from the same numbers.
    Returns the losses and the updated global tree (numpy, JAX's
    layout)."""
    import torch.distributed as dist
    owned = not dist.is_initialized()
    device = multihost.initialize(platform)
    try:
        mesh = grid_mesh(1, 1, 1, device)
        params = shard_params(init_params(cfg, seed=seed), mesh, cfg)
        gen = torch.Generator()
        gen.manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab_size,
                               (cfg.batch, cfg.seq_len + 1), generator=gen)
        step = make_train_step(mesh, cfg)
        losses = []
        for _ in range(steps):
            params, loss = step(params, tokens)
            losses.append(float(loss))
        return losses, gather_params(params, mesh, cfg)
    finally:
        if owned:
            multihost.shutdown()
