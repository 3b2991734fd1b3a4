"""Bringing up ``torch.distributed`` — the counterpart of the JAX
package's ``parallel/multihost.py`` (``jax.distributed.initialize``).

One process per rank, started by a launcher (``torchrun
--nproc_per_node N``) that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  The backend is
NCCL on the card (each rank takes ``cuda:LOCAL_RANK``) and gloo on the
CPU.  A process started without a launcher is world 1: it brings up a
one-rank group on a free loopback port, so the proxies run the same
collectives at every world size.

A degraded run (``faults/policy.py``: a fault plan's shrink) goes on
over the ranks left standing.  ``subworld(ranks, group)`` makes them
the world for the code inside it: ``world_size``, ``rank``,
``barrier``, ``all_ranks`` and the meshes' default group
(``world_group``) are then theirs, so a proxy builds over the
survivors as it builds over a whole world.  Groups made inside a
sub-world, and the sub-world's own group, are made by their members
alone (``use_local_synchronization``): their names come from their
ranks, so the default group's numbering stays in step on every rank,
the ranks left out included.  ``host_metadata`` names every rank by its
rank in the default group.
"""
from __future__ import annotations

import contextlib
import os
import socket

import torch
import torch.distributed as dist

from dlnetbench_tpu_torch.ops.common import resolve_device
from dlnetbench_tpu_torch.utils.net import free_port


PORT_ATTEMPTS = 5

# NCCL's flight recorder (torch's c10d trace buffer, 2000 entries unless
# the environment says otherwise) records every collective at its issue:
# with it the one-card MoE proxy step's 512 all-to-alls took 54.1-82.0
# ms of host time to issue on an H100, without it 58.0-60.2 ms
# (``host_probe``, PERF.md §6).  The port keeps its own flight recorder
# (metrics/telemetry.py), so a run turns NCCL's off unless its
# environment sizes the buffer.
NCCL_TRACE_VARS = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")


def quiet_nccl_trace(env=os.environ) -> None:
    """Size NCCL's trace buffer to 0 unless ``env`` sizes it; read
    when the process's first NCCL group is made."""
    if not any(v in env for v in NCCL_TRACE_VARS):
        env["TORCH_NCCL_TRACE_BUFFER_SIZE"] = "0"


def initialize(platform: str = "cuda") -> torch.device:
    """Join (or, at world 1, create) the default process group; returns
    this rank's device.  Raises when ``cuda`` is asked for without a
    card, and when ``WORLD_SIZE > 1`` comes without the launcher's
    rendezvous address."""
    env = os.environ
    device = resolve_device(platform)
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    local = int(env.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} but only {torch.cuda.device_count()} "
                f"CUDA card(s) are visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        quiet_nccl_trace()
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group is already up; "
                f"platform {platform!r} needs {backend}")
        return device
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        dist.init_process_group(backend, init_method=init,
                                world_size=world, rank=rank)
        return device
    if world != 1:
        raise RuntimeError(
            f"WORLD_SIZE={world} without MASTER_ADDR/MASTER_PORT: start "
            f"the ranks with torchrun --nproc_per_node {world}")
    # a one-rank group's store on a free port: another process can take
    # the port before the store binds it, so that failure tries a new one
    for attempt in range(1, PORT_ATTEMPTS + 1):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{free_port()}",
                world_size=1, rank=0)
            return device
        except RuntimeError as e:
            if "EADDRINUSE" not in str(e) or attempt == PORT_ATTEMPTS:
                raise


def shutdown() -> None:
    """Tear the default process group down (no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# the active sub-world: (its default-group ranks, their group), or None
_SUBWORLD: tuple[list, object] | None = None


@contextlib.contextmanager
def subworld(ranks: list, group):
    """Inside: the default group's ranks ``ranks`` and their ``group``
    (``local_group(ranks)``) stand for the world.  Only those ranks may
    enter, and sub-worlds do not nest."""
    global _SUBWORLD
    ranks = sorted(ranks)
    if dist.get_rank() not in ranks:
        raise ValueError(f"rank {dist.get_rank()} is not in the "
                         f"sub-world {ranks}")
    if _SUBWORLD is not None:
        raise RuntimeError("a sub-world is already active")
    _SUBWORLD = (ranks, group)
    try:
        yield
    finally:
        _SUBWORLD = None


def world_group():
    """The group collectives over the whole world take: None (the
    default group) outside a sub-world, the sub-world's inside."""
    return _SUBWORLD[1] if _SUBWORLD is not None else None


def local_group(ranks: list, backend: str | None = None):
    """A group over the default-group ranks ``ranks``, made by those
    ranks alone; None on any other rank, which need not call it."""
    return dist.new_group(ranks, backend=backend,
                          use_local_synchronization=True)


def new_group(ranks: list):
    """A group over the world ranks ``ranks`` (``rank()``'s numbering).
    Outside a sub-world every rank of the default group makes it;
    inside one only its members do (the ranks out of the run make
    nothing)."""
    if _SUBWORLD is not None:
        return local_group([_SUBWORLD[0][r] for r in ranks])
    return dist.new_group(ranks)


def rank() -> int:
    if _SUBWORLD is not None:
        return _SUBWORLD[0].index(dist.get_rank())
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    if _SUBWORLD is not None:
        return len(_SUBWORLD[0])
    return dist.get_world_size() if dist.is_initialized() else 1


def launcher_world() -> int:
    """The world's size before or after joining it: the group's when one
    is up, else the launcher's ``WORLD_SIZE`` (1 without a launcher)."""
    if dist.is_initialized():
        return world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def barrier(device: torch.device | None = None) -> None:
    """Every rank of the world rendezvous (MPI_Barrier); a no-op
    without a group."""
    if not dist.is_initialized():
        return
    group = world_group()
    if device is not None and device.type == "cuda":
        dist.barrier(group=group, device_ids=[device.index])
    else:
        dist.barrier(group=group)


def all_ranks(obj) -> list:
    """``obj`` from every rank of the world, in rank order
    (``all_gather_object``); ``[obj]`` without a group."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=world_group())
    return out


def host_metadata(device: torch.device | None = None) -> list[dict]:
    """One record per rank of the world: its rank in the default group,
    hostname and local device."""
    local = {"process": dist.get_rank() if dist.is_initialized() else 0,
             "hostname": socket.gethostname(),
             "local_device_ids": [device.index or 0]
             if device is not None and device.type == "cuda" else []}
    return all_ranks(local)
