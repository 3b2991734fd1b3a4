"""The native tier's nccl fabric on the CPU, through its host double
(``--nccl_impl host``: rank threads, host memory, a rendezvous per
communicator, reached only by that flag).

``nccl_selftest`` checks every operation at every dtype over the world
and a split communicator against a host reference, and prints a digest
of every result; the same operations on the shm fabric must give the
same digest at worlds 1, 2, 4 and 8 (the alltoall built from grouped
send/recv, RingShift, slot Isend/Irecv included).  The seven proxies'
records on the double equal shm's in everything but the fabric's own
stamps.  Then the refusals: ``--backend nccl`` on a CPU-flavour build,
duplicate ``--devices``, fault events the fabric cannot honour, the host
double across processes, and ``--nccl_impl`` that does not exist."""
from __future__ import annotations

import json
import subprocess
from pathlib import Path

import pytest

from dlnetbench_tpu_torch.utils import native_build

REPO = Path(__file__).resolve().parent.parent
SMALL = ("--time_scale", "0.0001", "--size_scale", "0.00001", "--runs", "2",
         "--warmup", "1", "--no_topology", "--base_path", str(REPO))
HOST = ("--backend", "nccl", "--nccl_impl", "host")
# the fields each fabric's describe() writes: everything else in a
# record's global block is the proxy's and must agree across fabrics
NCCL_STAMPS = {"backend", "nccl_impl", "nccl_version", "nccl_library",
               "device", "devices", "transport", "p2p_transport",
               "compute_mode", "h2d_copies", "d2h_copies", "timed_copies",
               "twins",
               "late_twins", "burn_launches", "burn_iters"}
SHM_STAMPS = {"backend", "device", "compute_mode", "transport"}


@pytest.fixture(scope="module")
def port_bin():
    return native_build.native_bin(REPO, flavour="cpu")


def _run(binary: Path, *args, timeout=60):
    return subprocess.run([str(binary), *map(str, args)], capture_output=True,
                          text=True, timeout=timeout)


def _json(out) -> dict:
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_selftest_host_double_equals_shm(port_bin, world):
    host = _json(_run(port_bin / "nccl_selftest", "--world", world,
                      "--nccl_impl", "host"))
    shm = _json(_run(port_bin / "nccl_selftest", "--world", world,
                     "--backend", "shm"))
    assert host["ok"] and shm["ok"], (host["failures"], shm["failures"])
    assert host["failures"] == []
    assert host["checks"] == shm["checks"] > 0
    assert host["digest"] == shm["digest"]
    assert host["nccl_impl"] == "host" and host["nccl_version"] == "host"


def _shape(rec: dict, stamps: set) -> dict:
    rows = [{k: (len(v) if isinstance(v, list) else v)
             for k, v in row.items() if k not in ("hostname", "summary")}
            for row in rec["ranks"]]
    return {"section": rec["section"], "num_runs": rec["num_runs"],
            "global": {k: v for k, v in rec["global"].items()
                       if k not in stamps},
            "ranks": rows}


PROXIES = [
    ("dp", ("--num_buckets", 4), "gpt2_l_16_bfloat16", 4),
    ("fsdp", ("--num_units", 4, "--sharding_factor", 2),
     "llama3_8b_16_bfloat16", 4),
    ("hybrid_2d", ("--num_stages", 4, "--num_microbatches", 4,
                   "--schedule", "1f1b"), "llama3_8b_16_bfloat16", 4),
    ("hybrid_3d", ("--num_stages", 2, "--num_microbatches", 4, "--tp", 2),
     "llama3_8b_16_bfloat16", 4),
    ("hybrid_3d_moe", ("--num_stages", 2, "--num_microbatches", 4,
                       "--num_expert_shards", 2), "mixtral_8x7b_16_bfloat16",
     4),
    ("ring_attention", ("--sp", 4, "--max_layers", 2),
     "llama3_8b_16_bfloat16", 4),
    ("ulysses", ("--sp", 4, "--max_layers", 2), "llama3_8b_16_bfloat16", 4),
]


@pytest.mark.parametrize("name,extra,model,world", PROXIES,
                         ids=[p[0] for p in PROXIES])
def test_proxy_on_host_double_equals_shm(port_bin, name, extra, model, world):
    args = ("--model", model, "--world", world, *extra, *SMALL)
    mine = _json(_run(port_bin / name, *args, *HOST))
    shm = _json(_run(port_bin / name, *args))
    g = mine["global"]
    # a record from the double can never claim the card
    assert g["backend"] == "nccl" and g["nccl_impl"] == "host"
    assert g["compute_mode"] == "host_sleep"
    assert g["transport"] == "host" and g["p2p_transport"] == "host"
    assert g["device"] == "cpu" and mine["mesh"]["platform"] == "host"
    # twins are made in the warm-up: nothing copied while timing
    assert g["timed_copies"] == 0 and g["twins"] > 0
    assert _shape(mine, NCCL_STAMPS) == _shape(shm, SHM_STAMPS)
    from dlnetbench_tpu_torch.metrics.parser import validate_record
    validate_record(mine)


def test_backend_nccl_refused_on_cpu_build(port_bin):
    out = _run(port_bin / "dp", "--model", "gpt2_l_16_bfloat16", "--world",
               1, "--num_buckets", 1, *SMALL, "--backend", "nccl")
    assert out.returncode != 0 and out.stdout == ""
    assert "CPU-flavour build" in out.stderr
    probe = _run(port_bin / "nccl_probe")
    assert probe.returncode != 0
    rep = json.loads(probe.stdout)
    assert rep["available"] is False and "CPU-flavour" in rep["reason"]


@pytest.mark.parametrize("flags,needle", [
    (("--devices", "0,0"), "duplicate"),
    (("--fault", '{"events":[{"kind":"drop","ranks":[0],"iteration":0,'
                 '"rate":0.2}]}', "--fault_policy", "retry"),
     "event kind 'drop' is not supported on --backend nccl"),
    (("--fault", '{"events":[{"kind":"crash","ranks":[1],'
                 '"iteration":1}]}'),
     "event kind 'crash' is not supported on --backend nccl"),
    (("--procs", 2, "--coordinator", "127.0.0.1:1"),
     "--nccl_impl host is one process"),
    (("--nccl_impl", "fake"), "unknown --nccl_impl"),
])
def test_refusals(port_bin, flags, needle):
    args = ["--model", "gpt2_l_16_bfloat16", "--world", 2,
            "--num_buckets", 1, *SMALL, *HOST]
    out = _run(port_bin / "dp", *args, *flags)
    assert out.returncode != 0 and out.stdout == ""
    assert needle in out.stderr, out.stderr


def test_collective_delay_applies_on_nccl(port_bin):
    """Delay events apply as on the JAX package's PJRT fabric: a
    collective-scoped straggler is accounted on its rank."""
    plan = ('{"events":[{"kind":"delay","ranks":[1],"iteration":0,'
            '"magnitude_us":2000,"where":"collective"}]}')
    rec = _json(_run(port_bin / "dp", "--model", "gpt2_l_16_bfloat16",
                     "--world", 2, "--num_buckets", 2, *SMALL, *HOST,
                     "--fault", plan))
    rows = {r["rank"]: r for r in rec["ranks"]}
    assert rows[1]["fault_injected_delay_us"] > 0
    assert rows[0]["fault_injected_delay_us"] == 0.0
    assert rec["global"]["fault_policy"] == "fail_fast"


@pytest.mark.parametrize("field", ["burn_ns_per_iter", "burn_fixed_ns",
                                   "burn_requested_us", "burn_device_us"])
def test_card_burn_fields_merge_across_processes(port_bin, field):
    """On the card each process of a --procs run books its own ranks'
    burn calibration and totals, so its records differ there and still
    merge (process 0's values kept)."""
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    rec = _json(_run(port_bin / "dp", "--model", "gpt2_l_16_bfloat16",
                     "--world", 2, "--num_buckets", 2, *SMALL, *HOST))
    parts = []
    for p, row in enumerate(rec["ranks"]):
        part = json.loads(json.dumps(rec))
        part["ranks"] = [{**row, "process_index": p}]
        part["process"] = p
        part["global"][field] = 1000.0 + p
        parts.append(part)
    merged = merge_records(parts)
    assert [r["rank"] for r in merged["ranks"]] == [0, 1]
    assert merged["global"][field] == 1000.0


def test_probe_on_host_double(port_bin):
    rep = _json(_run(port_bin / "nccl_probe", "--nccl_impl", "host"))
    assert rep["available"] is True and rep["nccl_impl"] == "host"
    assert "burn" not in rep  # no card, no burn kernel


def test_build_tree_and_flavours(port_bin):
    """The tree lands under build/native/<hash>/cpu, the hash covers the
    sources, and asking for it again builds nothing."""
    assert port_bin.parent.name == "cpu"
    assert port_bin.parents[2] == REPO / "build" / "native"
    assert port_bin.parent.parent.name == native_build.digest("cpu")
    again = native_build.native_bin(REPO, flavour="cpu")
    assert again == port_bin and native_build.LAST_BUILD_SECONDS == 0.0
    with pytest.raises(ValueError):
        native_build.native_bin(REPO, flavour="tpu")
