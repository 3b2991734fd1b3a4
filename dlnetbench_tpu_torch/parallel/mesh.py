"""Process groups in the shape of the JAX package's device meshes
(``parallel/mesh.py`` there).

A JAX mesh names axes over devices and a collective takes an axis name;
here each axis is the ``torch.distributed`` group of the ranks that
share every other coordinate, and a collective takes this rank's group
for that axis.  Coordinates are laid out with the last axis fastest, as
the JAX mesh's reshape lays out devices: in the FSDP mesh
``(replica, shard)`` rank ``r`` sits at ``(r // S, r % S)``, so a ``tp``
group is S consecutive ranks and a ``dp`` group every S-th rank.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.parallel import multihost

AXIS_DP = "dp"
AXIS_TP = "tp"
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
    (fsdp.cpp:257-265).  Every rank creates every group, in the same
    order, as ``torch.distributed.new_group`` requires."""
    world, r = multihost.world_size(), multihost.rank()
    if num_replicas * sharding_factor != world:
        raise ValueError(f"mesh ({num_replicas}, {sharding_factor}) needs "
                         f"{num_replicas * sharding_factor} ranks, have "
                         f"{world}")
    groups = {}
    for rep in range(num_replicas):
        ranks = list(range(rep * sharding_factor,
                           (rep + 1) * sharding_factor))
        g = _group(ranks, world)
        if r in ranks:
            groups[AXIS_TP] = g
    for sh in range(sharding_factor):
        ranks = list(range(sh, world, sharding_factor))
        g = _group(ranks, world)
        if r in ranks:
            groups[AXIS_DP] = g
    return Mesh(axes={AXIS_DP: num_replicas, AXIS_TP: sharding_factor},
                coords=_coords(r, (num_replicas, sharding_factor)),
                groups={AXIS_DP: groups[AXIS_DP],
                        AXIS_TP: groups[AXIS_TP]},
                device=device, rank=r)


def _group(ranks: list, world: int):
    """A group over ``ranks``; the default group when that is all of
    them (no second communicator over the same ranks)."""
    if len(ranks) == world:
        return None
    return dist.new_group(ranks)


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
