"""Process groups in the shape of the JAX package's device meshes
(``parallel/mesh.py`` there).

A JAX mesh names axes over devices and a collective takes an axis name;
here each axis is the ``torch.distributed`` group of the ranks that
share every other coordinate, and a collective takes this rank's group
for that axis.  Coordinates are laid out with the last axis fastest, as
the JAX mesh's reshape lays out devices: in the FSDP mesh
``(replica, shard)`` rank ``r`` sits at ``(r // S, r % S)``, so a ``tp``
group is S consecutive ranks and a ``dp`` group every S-th rank.  A
group's ranks ascend with the axis coordinate, so a rank's place in its
group is its coordinate on that axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.core.schedule import Grid3D
from dlnetbench_tpu_torch.parallel import multihost

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_TP = "tp"   # also the expert (EP) axis of the MoE proxy
AXIS_SP = "sp"
AXIS_FLAT = "x"


@dataclasses.dataclass
class Mesh:
    """This rank's view of a rank grid: axis sizes (outermost first),
    its coordinates and its group along each axis (``None`` for the
    default group)."""
    axes: dict
    coords: tuple
    groups: dict
    device: torch.device
    rank: int

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n


def _coords(rank: int, shape: tuple) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def make_flat_mesh(device: torch.device) -> Mesh:
    """One axis over every rank: the default group (MPI_COMM_WORLD)."""
    world, r = multihost.world_size(), multihost.rank()
    return Mesh(axes={AXIS_FLAT: world}, coords=(r,),
                groups={AXIS_FLAT: None},
                device=device, rank=r)


def make_fsdp_mesh(num_replicas: int, sharding_factor: int,
                   device: torch.device) -> Mesh:
    """``(dp, tp) = (num_replicas, sharding_factor)``: the reference's
    inter-replica ``allreduce_comm`` and intra-shard ``unit_comm``
    (fsdp.cpp:257-265)."""
    return _make_mesh({AXIS_DP: num_replicas, AXIS_TP: sharding_factor},
                      device)


def make_grid_mesh(dp: int, pp: int, tp: int,
                   device: torch.device) -> Mesh:
    """``(dp, pp, tp)`` with tp fastest: rank ``(d*pp + p)*tp + t`` sits
    at ``(d, p, t)``, the reference's grid (hybrid_3d.cpp:283-285).  The
    pp groups are warmed (see ``_warm``)."""
    mesh = _make_mesh({AXIS_DP: dp, AXIS_PP: pp, AXIS_TP: tp}, device)
    _warm(mesh.groups[AXIS_PP], device)
    return mesh


def mesh_from_grid(grid: Grid3D, device: torch.device) -> Mesh:
    return make_grid_mesh(grid.dp, grid.pp, grid.tp, device)


def make_sp_mesh(sp: int, dp: int, device: torch.device) -> Mesh:
    """``(dp, sp)`` with sp fastest, for the sequence-parallel proxies;
    the sp groups are warmed (see ``_warm``)."""
    mesh = _make_mesh({AXIS_DP: dp, AXIS_SP: sp}, device)
    _warm(mesh.groups[AXIS_SP], device)
    return mesh


def second_group(mesh: Mesh, axis: str):
    """A second group over the ranks of this rank's ``axis`` group, with
    a communicator of its own: NCCL runs one group's calls one after
    another, so the pipeline's backward hops take this one to run beside
    the forward hops.  Made on every rank, in the same order, and
    warmed."""
    shape = tuple(mesh.axes.values())
    k = list(mesh.axes).index(axis)
    mine = None
    for ranks in _axis_ranks(shape, k):
        g = dist.new_group(ranks)
        if mesh.rank in ranks:
            mine = g
    _warm(mine, mesh.device)
    return mine


def _axis_ranks(shape: tuple, k: int) -> list:
    """The rank lists of axis ``k``'s groups: the ranks that share every
    other coordinate, in ascending order (the axis coordinate), the
    groups in the order of the other coordinates."""
    grid = torch.arange(math.prod(shape)).reshape(shape)
    return grid.movedim(k, -1).reshape(-1, shape[k]).tolist()


def _make_mesh(axes: dict, device: torch.device) -> Mesh:
    """Every axis's groups, made on every rank in the same order (axes in
    order, groups in ``_axis_ranks`` order), as ``new_group``
    requires."""
    world, r = multihost.world_size(), multihost.rank()
    shape = tuple(axes.values())
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"have {world}")
    groups = {}
    for k, name in enumerate(axes):
        for ranks in _axis_ranks(shape, k):
            g = _group(ranks, world)
            if r in ranks:
                groups[name] = g
    return Mesh(axes=dict(axes), coords=_coords(r, shape), groups=groups,
                device=device, rank=r)


def _group(ranks: list, world: int):
    """A group over ``ranks``; the default group when that is all of
    them (no second communicator over the same ranks)."""
    if len(ranks) == world:
        return None
    return dist.new_group(ranks)


def _warm(group, device: torch.device) -> None:
    """One allreduce on ``group`` before its first hop: NCCL's
    ``batch_isend_irecv`` needs every rank of a group in its first call
    on that group, and a hop holds only some.  Not counted in
    ``collectives.COUNTS``."""
    dist.all_reduce(torch.zeros(1, device=device), group=group)


def describe_mesh(mesh: Mesh) -> dict:
    """The record header's mesh block, in the JAX package's keys."""
    hosts = multihost.host_metadata(mesh.device)
    cuda = mesh.device.type == "cuda"
    return {
        "axes": dict(mesh.axes),
        "num_devices": mesh.size,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": (torch.cuda.get_device_name(mesh.device) if cuda
                        else "cpu"),
        "num_hosts": len({h["hostname"] for h in hosts}),
        # gloo between CPU processes moves loopback bytes: its bandwidth
        # is never a fabric number
        "fabric": "real" if cuda else "virtual",
        "devices": [{"id": h["process"], "process": h["process"],
                     "hostname": h["hostname"]} for h in hosts],
    }
