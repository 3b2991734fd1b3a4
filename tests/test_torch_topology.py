"""The port's topology graph (``dlnetbench_tpu_torch/utils/topology.py``)
against the JAX package's ``utils/topology.py``: the same rows give the
same tree; the drawing names the GPU fabric; a world-1 CPU run gathers
its one row."""
from __future__ import annotations

import types

from dlnetbench_tpu.utils import topology as J_topo
from dlnetbench_tpu_torch.utils import topology as T_topo


def _fake_dev(id, process=0, slice_index=0, coords=None, core=None,
              kind="TPU v5p"):
    return types.SimpleNamespace(id=id, process_index=process,
                                 slice_index=slice_index, coords=coords,
                                 core_on_chip=core, device_kind=kind)


FAKE_SETS = {
    "multislice": [
        _fake_dev(0, process=0, slice_index=0, coords=(0, 0, 0), core=0),
        _fake_dev(1, process=0, slice_index=0, coords=(1, 0, 0), core=0),
        _fake_dev(2, process=1, slice_index=0, coords=(0, 1, 0), core=0),
        _fake_dev(3, process=2, slice_index=1, coords=(0, 0, 0), core=0)],
    "unsorted": [_fake_dev(3, process=1), _fake_dev(0, process=0),
                 _fake_dev(2, process=1), _fake_dev(1, process=0)],
}


def test_build_topology_equals_jax_on_its_rows():
    for devs in FAKE_SETS.values():
        rows = [J_topo._device_row(d) for d in devs]
        assert T_topo.build_topology(rows) == J_topo.build_topology(devs)
    tree = T_topo.build_topology(
        [J_topo._device_row(d) for d in FAKE_SETS["unsorted"]])
    assert list(tree[0]) == [0, 1]
    assert [d["id"] for d in tree[0][1]] == [2, 3]


def _gpu_rows(hosts: int = 1) -> list[dict]:
    return [{"id": r, "process": r // 4 if hosts > 1 else 0, "slice": 0,
             "coords": (), "core": None, "kind": "NVIDIA H100 80GB HBM3",
             "hostname": f"node{r // 4 if hosts > 1 else 0}",
             "device": f"cuda:{r % 4}",
             "pci_bus_id": f"0000:{0x18 + r % 4:02x}:00.0",
             "peers": [j for j in range(4) if j != r % 4]}
            for r in range(4 * hosts)]


def test_format_names_the_gpu_fabric():
    out = T_topo.format_topology(_gpu_rows())
    assert out.splitlines()[0] == \
        "fabric: 4 x NVIDIA H100 80GB HBM3 (1 host, 1 slice)"
    assert "[NVLink domain, 1 host(s)]" in out and "ICI" not in out
    assert "host 0 node0  (4 rank(s))" in out
    assert out.count("rank id=") == 4
    assert "rank id=1  cuda:1  bus=0000:19:00.0  peers=cuda:0,2,3" in out
    two = T_topo.format_topology(_gpu_rows(hosts=2))
    assert "(2 hosts, 1 slice)" in two
    assert "NVLink within a host, network between hosts" in two
    # JAX's multi-slice rows draw as JAX draws them, coords and cores
    multi = T_topo.format_topology(
        [J_topo._device_row(d) for d in FAKE_SETS["multislice"]])
    assert "2 slices, network-linked" in multi and "3 hosts" in multi
    assert "coords=(1, 0, 0)  core=0" in multi


def test_world1_cpu_gathers_its_one_row(monkeypatch):
    import torch
    monkeypatch.setattr(T_topo.socket, "gethostname", lambda: "box")
    rows = T_topo.gather_rows(torch.device("cpu"))
    assert rows == [{"id": 0, "process": 0, "slice": 0, "coords": (),
                     "core": None, "hostname": "box", "kind": "cpu",
                     "device": "cpu"}]
    assert T_topo.format_topology(rows).count("rank id=0  cpu") == 1
