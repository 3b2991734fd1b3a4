"""ASCII topology graph of the ranks' cards (the JAX package's
``utils/topology.py``).

Counterpart of the reference's switch-tree visualizer (reference
cpp/netcommunicators.hpp:79-290), which allgathers each rank's switch
path and draws switch -> node -> process.  Here every rank contributes
one row, gathered with ``multihost.all_ranks``, with the JAX package's
keys — ``id`` (the global rank), ``process`` (the host's index, in the
order the ranks first name it), ``slice`` (0: one fabric), ``coords``
(none on a GPU), ``core`` (None), ``kind`` (the torch device name) —
plus ``hostname``, ``device`` (``cuda:i`` or ``cpu``), the card's PCI
bus id and ``peers``, the cards of its host it can reach peer-to-peer
(``torch.cuda.can_device_access_peer``: over NVLink on an NVSwitch
host).  The tree is the JAX package's:

    fabric
    └── slice (NVLink domain)
        └── host
            └── rank  id=.. cuda:i bus=.. peers=..
"""
from __future__ import annotations

import socket
from collections import defaultdict


def rank_row(device) -> dict:
    """This rank's row (``process`` is filled in by ``gather_rows``)."""
    import torch

    from dlnetbench_tpu_torch.parallel import multihost
    row = {"id": multihost.rank(), "process": 0, "slice": 0, "coords": (),
           "core": None, "hostname": socket.gethostname()}
    if device is not None and device.type == "cuda":
        i = device.index or 0
        props = torch.cuda.get_device_properties(i)
        row["kind"] = props.name
        row["device"] = f"cuda:{i}"
        if hasattr(props, "pci_bus_id"):
            row["pci_bus_id"] = (f"{props.pci_domain_id:04x}:"
                                 f"{props.pci_bus_id:02x}:"
                                 f"{props.pci_device_id:02x}.0")
        row["peers"] = [j for j in range(torch.cuda.device_count())
                        if j != i and torch.cuda.can_device_access_peer(i, j)]
    else:
        row["kind"] = "cpu"
        row["device"] = "cpu"
    return row


def gather_rows(device) -> list[dict]:
    """Every rank's row, in rank order, each host numbered by the order
    in which the ranks first name it."""
    from dlnetbench_tpu_torch.parallel import multihost
    rows = multihost.all_ranks(rank_row(device))
    hosts: dict[str, int] = {}
    for r in rows:
        r["process"] = hosts.setdefault(r["hostname"], len(hosts))
    return rows


def build_topology(rows: list[dict]) -> dict:
    """Nested dict: slice -> host (process) -> [rows], sorted by id."""
    tree: dict = defaultdict(lambda: defaultdict(list))
    for r in rows:
        tree[r["slice"]][r["process"]].append(r)
    return {s: {p: sorted(devs, key=lambda r: r["id"])
                for p, devs in sorted(hosts.items())}
            for s, hosts in sorted(tree.items())}


def format_topology(rows: list[dict]) -> str:
    tree = build_topology(rows)
    n_slices = len(tree)
    n_hosts = sum(len(h) for h in tree.values())
    n_ranks = sum(len(d) for h in tree.values() for d in h.values())
    any_dev = next(iter(next(iter(tree.values())).values()))[0]
    lines = [
        f"fabric: {n_ranks} x {any_dev['kind']} "
        f"({n_hosts} host{'s' if n_hosts != 1 else ''}, "
        f"{n_slices} slice{'s' if n_slices != 1 else ''}"
        f"{', network-linked' if n_slices > 1 else ''})",
    ]
    for si, (s, hosts) in enumerate(tree.items()):
        s_last = si == len(tree) - 1
        s_bar = "└──" if s_last else "├──"
        domain = ("NVLink domain" if len(hosts) == 1
                  else "NVLink within a host, network between hosts")
        lines.append(f"{s_bar} slice {s}  [{domain}, {len(hosts)} "
                     f"host(s)]")
        s_pad = "    " if s_last else "│   "
        for hi, (p, devs) in enumerate(hosts.items()):
            h_last = hi == len(hosts) - 1
            h_bar = "└──" if h_last else "├──"
            name = devs[0].get("hostname")
            lines.append(f"{s_pad}{h_bar} host {p}"
                         + (f" {name}" if name else "")
                         + f"  ({len(devs)} rank(s))")
            h_pad = s_pad + ("    " if h_last else "│   ")
            for di, r in enumerate(devs):
                d_bar = "└──" if di == len(devs) - 1 else "├──"
                extra = ""
                if r.get("device"):
                    extra += f"  {r['device']}"
                if r.get("pci_bus_id"):
                    extra += f"  bus={r['pci_bus_id']}"
                if r.get("peers"):
                    extra += "  peers=cuda:" + ",".join(map(str, r["peers"]))
                if r["coords"]:
                    extra += f"  coords={r['coords']}"
                if r["core"] is not None:
                    extra += f"  core={r['core']}"
                lines.append(f"{h_pad}{d_bar} rank id={r['id']}{extra}")
    return "\n".join(lines)


def print_topology(rows: list[dict], stream=None) -> None:
    import sys
    print(format_topology(rows), file=stream or sys.stdout)
