"""The port's bottleneck attribution (``dlnetbench_tpu_torch/analysis/
attribution.py``) and hardware presets against the JAX package's, on
the CPU.

Every public function gets the same inputs on both sides — the JAX
fixtures ``tests/data/record_*.jsonl``, every line of the root
``BENCH_r01-05.json`` captures, and seeded synthetic kernels, lines and
records on the JAX package's TPU presets — and the blocks, the rendered
``explain`` text and the exit codes must be equal.  Where the
vocabulary differs by design (a card's compute is ``sm``, NCCL inside a
host ``nvlink``, across hosts ``network``, one device alone ``local`` ->
``host``) the cases assert the port's words."""
from __future__ import annotations

import copy
import io
import json
from pathlib import Path

import numpy as np
import pytest

from dlnetbench_tpu.analysis import attribution as J
from dlnetbench_tpu.core import hardware as J_hw
from dlnetbench_tpu_torch.analysis import attribution as T
from dlnetbench_tpu_torch.core import hardware as T_hw

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
FIXTURES = sorted(p.name for p in DATA.glob("record_*.jsonl"))
BENCH = sorted(p.name for p in REPO.glob("BENCH_r0*.json"))
TPU_KEYS = ("tpu_v4", "tpu_v5e", "tpu_v5p", "tpu_v6e")
H100 = T_hw.HARDWARE["h100_sxm"]


def _records(name: str) -> list[dict]:
    return [json.loads(t) for t in (DATA / name).read_text().splitlines()
            if t.strip()]


def _assert_fractions(block: dict) -> None:
    assert set(block["fractions"]) == set(T.RESOURCES)
    assert abs(sum(block["fractions"].values()) - 1.0) <= 2e-4
    assert block["bound"] in T.BOUNDS


# ------------------------------------------------------------- presets
@pytest.mark.parametrize("key", [*TPU_KEYS, "b200"])
def test_jax_presets_copied_as_data(key):
    j, t = J_hw.HARDWARE[key], T_hw.HARDWARE[key]
    for field in ("name", "peak_flops", "hbm_bandwidth", "hbm_capacity",
                  "ici_bandwidth", "num_ici_links"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.compute_unit == ("mxu" if key.startswith("tpu") else "sm")
    assert t.nvlink_bandwidth == 0.0


def test_h100_presets_nvlink_and_compute_unit():
    assert H100.nvlink_bandwidth == 450e9          # 900 GB/s, both ways
    assert T_hw.HARDWARE["h100_pcie"].nvlink_bandwidth == 0.0
    assert {T_hw.HARDWARE[k].compute_unit
            for k in ("h100_sxm", "h100_pcie")} == {"sm"}
    assert T_hw.BYTES_PER_ELEMENT == J_hw.BYTES_PER_ELEMENT


@pytest.mark.parametrize("kind", [
    "TPU v5 lite", "TPU v5p", "TPU v4", "TPU v6 lite", "TPU v5", "cpu",
    "host", "process-rank", "", None, "NVIDIA H100 80GB HBM3"])
def test_hw_key_for_device_kind_equals_jax(kind):
    assert T_hw.hw_key_for_device_kind(kind) == \
        J_hw.hw_key_for_device_kind(kind)


@pytest.mark.parametrize("kind,want", [
    ("NVIDIA H100 80GB HBM3", "h100_sxm"), ("NVIDIA H100 PCIe", "h100_pcie"),
    ("TPU v5 lite", "tpu_v5e"), ("cpu", None), ("host", None), (None, None),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_hw_key_for_device_reads_either_packages_kind(kind, want):
    assert T_hw.hw_key_for_device(kind) == want
    # a CPU is never priced against a card
    assert T_hw.hw_key_for_device_name("cpu") is None


# ----------------------------------------------------- transport words
JAX_TRANSPORTS = ["ici", "ici+dcn", "dcn", "tcp", "tcp:ethernet",
                  "tcp:loopback", "shm", "host", "host+tcp",
                  "virtual-host", "unknown", "", None]


@pytest.mark.parametrize("transport", JAX_TRANSPORTS)
def test_comm_resource_and_peak_equal_jax_on_jax_transports(transport):
    assert T.comm_resource(transport) == J.comm_resource(transport)
    for key in (*TPU_KEYS, None):
        assert T.transport_peak_bytes_s(
            transport, T_hw.HARDWARE.get(key)) == J.transport_peak_bytes_s(
            transport, J_hw.HARDWARE.get(key))


@pytest.mark.parametrize("transport,word,peak", [
    ("nccl", "nvlink", 450e9), ("nccl+network", "network", 12.5e9),
    ("local", "host", None), ("virtual-host", "host", None),
    ("gloo", "host", None)])
def test_the_ports_transport_words(transport, word, peak):
    assert T.comm_resource(transport) == word
    assert T.transport_peak_bytes_s(transport, H100) == peak
    if word == "nvlink":
        # a card without NVLink has no wire to compare against
        assert T.transport_peak_bytes_s(
            transport, T_hw.HARDWARE["h100_pcie"]) is None
        assert T.transport_peak_bytes_s(transport, None) is None
    assert T.NETWORK_PEAK_BYTES_S == J.DCN_PEAK_BYTES_S == \
        T.DCN_PEAK_BYTES_S


# -------------------------------------------------------- the kernels
KERNEL_CASES = [  # (frac of the compute peak, flops, bytes, dtype)
    (0.9, 1e12, 1e6, "bfloat16"), (0.3, 1e12, 1e6, "bfloat16"),
    (1.3, 1e12, 1e6, "bfloat16"), (0.5, 1e6, 1e9, "bfloat16"),
    (0.7, 4e12, 3e9, "int8"), (0.6, 4e12, 2e9, "float8"),
    (0.8, 1e12, 1e6, "float32"), (0.8, 1e12, 1e6, "nvfp4")]


@pytest.mark.parametrize("key", TPU_KEYS)
@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
def test_attribute_kernel_equals_jax_on_tpu_presets(key, case):
    frac, flops, nbytes, dtype = KERNEL_CASES[case]
    jhw, thw = J_hw.HARDWARE[key], T_hw.HARDWARE[key]
    t = flops / jhw.peak("bfloat16") / frac
    for kw in ({}, {"faulted": True}, {"comm_us": 0.4 * t * 1e6,
                                       "transport": "ici"},
               {"peak_flops": 2 * jhw.peak("bfloat16"),
                "extra_inputs": {"k": 1}}):
        assert T.attribute_kernel(t, flops, nbytes, thw, dtype, **kw) == \
            J.attribute_kernel(t, flops, nbytes, jhw, dtype, **kw)


def test_attribute_kernel_on_a_card_speaks_sm():
    flops = 1e12
    t = flops / H100.peak("bfloat16") / 0.9
    block = T.attribute_kernel(t, flops, 1e6, H100, "bfloat16")
    _assert_fractions(block)
    assert block["bound"] == "sm" and set(block["achieved"]) == {"sm",
                                                                  "hbm"}
    assert block["achieved"]["sm"]["frac"] == pytest.approx(0.9, abs=1e-3)
    assert block["achieved"]["sm"]["peak_tflops"] == 989.0
    assert block["inputs"]["hw"] == "NVIDIA H100 SXM"
    # memory-bound and comm-bound on NVLink
    nb = 1e9
    block = T.attribute_kernel(nb / H100.hbm_bandwidth / 0.9, 1e6, nb, H100,
                               "bfloat16")
    assert block["bound"] == "hbm"
    block = T.attribute_kernel(t, flops, 1e6, H100, "bfloat16",
                               comm_us=0.95 * t * 1e6, transport="nccl")
    assert block["bound"] == "nvlink"


# ------------------------------------------------------- bench lines
def _bench_lines() -> list[tuple[str, dict]]:
    out = []
    for name in BENCH:
        lines, _ = J._artifact_items(REPO / name)
        out += [(f"{name}:{i}", ln) for i, ln in enumerate(lines)]
    return out


BENCH_LINES = _bench_lines()


@pytest.mark.parametrize("name", BENCH)
def test_load_artifact_and_items_equal(name):
    assert T.load_artifact(REPO / name) == J.load_artifact(REPO / name)
    assert T._artifact_items(REPO / name) == J._artifact_items(REPO / name)


@pytest.mark.parametrize("idx", range(len(BENCH_LINES)),
                         ids=[k for k, _ in BENCH_LINES])
def test_attribute_line_equals_jax_on_every_bench_line(idx):
    line = BENCH_LINES[idx][1]
    assert T.attribute_line(line) == J.attribute_line(line)
    stripped = {k: v for k, v in line.items() if k != "attribution"}
    assert T.attribute_line(stripped) == J.attribute_line(stripped)


@pytest.mark.parametrize("seed", range(4))
def test_attribute_line_on_synthetic_lines(seed):
    rng = np.random.default_rng(seed)
    for key in (*TPU_KEYS, "b200"):
        for prefix in ("llama step", "fp8 swiglu", "int8 matmul"):
            line = {"metric": f"{prefix} ({key}, x)", "unit": "ms",
                    "value": float(rng.uniform(1, 500)),
                    "tflops_achieved": float(rng.uniform(1, 400)),
                    "vs_baseline": float(rng.uniform(0.1, 1.2))}
            if key == "b200":
                # a card: the port's word is sm where JAX says mxu
                t, j = T.attribute_line(line), J.attribute_line(line)
                if j is None:           # no int8 peak on the b200 preset
                    assert t is None
                    continue
                assert t["bound"] == ("sm" if j["bound"] == "mxu"
                                      else j["bound"])
                assert t["fractions"] == j["fractions"]
                continue
            assert T.attribute_line(line) == J.attribute_line(line)


def test_attribute_line_reads_the_ports_h100_metric():
    peak = H100.peak("bfloat16")
    line = {"metric": "llama3_8b-shaped 4L train step, B=2 S=6144, NVIDIA "
                      "H100 80GB HBM3 (h100_sxm)", "unit": "ms",
            "value": 500.0, "tflops_achieved": 0.6 * peak / 1e12,
            "vs_baseline": 0.7}
    block = T.attribute_line(line)
    _assert_fractions(block)
    assert block["bound"] == "sm"
    assert block["achieved"]["sm"]["frac"] == pytest.approx(0.6)
    assert block["fractions"]["hbm"] == pytest.approx(0.1, abs=1e-4)
    assert J.attribute_line(line) is None          # JAX knows no card
    assert T.attribute_line({**line, "metric": "x (h100_pcie)"})[
        "inputs"]["hw"] == "NVIDIA H100 PCIe"


# ---------------------------------------------- measured decompositions
@pytest.mark.parametrize("seed", range(4))
def test_decomposition_and_serving_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    full = list(1.0 + rng.random(5))
    comp = [f * float(rng.uniform(0.2, 1.1)) for f in full]
    comm = list(rng.random(5))
    for transport in ("ici", "ici+dcn", "virtual-host", None):
        for acc in (False, True):
            assert T.attribute_decomposition(full, comp, comm, transport,
                                             acc) == \
                J.attribute_decomposition(full, comp, comm, transport, acc)
    assert T.attribute_decomposition([], comp) is None
    got = T.attribute_decomposition(full, comp, comm, "nccl", True,
                                    unit="sm")
    want = J.attribute_decomposition(full, comp, comm, "ici", True)
    words = {"mxu": "sm", "ici": "nvlink"}
    assert got["bound"] == words.get(want["bound"], want["bound"])
    assert got["fractions"] == want["fractions"]
    c, f, i = (float(v) for v in rng.uniform(1, 20, 3))
    assert T.straggler_block(c, f, i) == J.straggler_block(c, f, i)
    assert T.straggler_block(c, 0.0, i) is None
    dl = {"host_dispatch_us": {"total": float(rng.uniform(1, 99))},
          "sync_h2d_us": {"total": 3.0}, "sync_d2h_us": {"total": 4.0},
          "dispatches": 7, "device_us": {"total": 900.0},
          "decode_device_us": {"total": 700.0}, "device_steps": 20,
          "steps_per_dispatch": 4.0}
    assert T.serving_host_us(dl, 2.5) == J.serving_host_us(dl, 2.5)
    one = {**dl, "steps_per_dispatch": 1.0,
           "decode_device_us": {"total": 1100.0}}
    for a, b in ((one, dl), (dl, one), ({}, dl)):
        assert T.dispatch_decomposition(a, b) == \
            J.dispatch_decomposition(a, b)


# ------------------------------------------------------------ records
@pytest.mark.parametrize("name", FIXTURES)
def test_attribute_record_equals_jax_on_fixtures(name):
    for rec in _records(name):
        assert T.attribute_record(rec) == J.attribute_record(rec)
        bare = copy.deepcopy(rec)
        bare["global"].pop("attribution", None)
        assert T.attribute_record(bare) == J.attribute_record(bare)
        assert T.attribute_serving(bare) == J.attribute_serving(bare)


def tpu_record(seed: int, *, world: int = 4, hosts: int = 1,
               kind: str = "TPU v5 lite", platform: str = "tpu") -> dict:
    """A seeded single-controller record on a TPU mesh with the XLA
    cost analysis, the comm model, a profile and a checkpoint stall."""
    rng = np.random.default_rng(seed)
    runtimes = list(1000 + 500 * rng.random(4))
    comp = [r * float(rng.uniform(0.5, 0.95)) for r in runtimes]
    row = {"runtimes": runtimes, "compute_time": comp,
           "barrier_time": [r - c for r, c in zip(runtimes, comp)],
           "comm_time": list(100 + 50 * rng.random(4))}
    return {
        "section": "dp", "version": 2, "process": 0,
        "global": {
            "proxy": "dp", "model": "m", "world_size": world,
            "buffer_dtype": ["bfloat16", "float32", "int8"][seed % 3],
            "aot": {"full": {"cost_analysis": {
                "flops": float(rng.uniform(1e9, 1e12)),
                "bytes_accessed": float(rng.uniform(1e6, 1e10))}}},
            "comm_model": {"comm_time": [
                {"kind": "allreduce", "group": world,
                 "bytes": int(rng.integers(1e6, 1e9))}]},
            "profile": {"allreduce": {"total_us": 50.0, "count": 2},
                        "fusion": {"total_us": 80.0, "count": 9}},
            "checkpoint_stall_ms": 1.5, "checkpoint_every": 4,
            "host_rtt_us": 75.0},
        "mesh": {"platform": platform, "device_kind": kind,
                 "num_hosts": hosts, "num_devices": world},
        "num_runs": 4, "warmup_times": [1.0],
        "ranks": [{"rank": r, "process_index": 0, **row}
                  for r in range(world)]}


@pytest.mark.parametrize("seed", range(6))
def test_attribute_record_equals_jax_on_seeded_tpu_records(seed):
    for kind in ("TPU v5 lite", "TPU v5p", "TPU v4"):
        for hosts in (1, 2):
            rec = tpu_record(seed, hosts=hosts, kind=kind)
            assert T.attribute_record(rec) == J.attribute_record(rec)
            rec["global"]["fault_plan"] = {"events": [{"kind": "delay"}]}
            assert T.attribute_record(rec) == J.attribute_record(rec)
            rec["global"]["device_top_ops"] = [{"op": "a", "total_us": 1}]
            assert T.attribute_record(rec) == J.attribute_record(rec)


def card_record(world: int = 4, hosts: int = 1, platform: str = "gpu",
                kind: str = "NVIDIA H100 80GB HBM3", seed: int = 0) -> dict:
    rec = tpu_record(seed, world=world, hosts=hosts, kind=kind,
                     platform=platform)
    del rec["global"]["aot"]            # the port's records carry none
    from dlnetbench_tpu_torch.metrics.emit import transport_label
    rec["global"]["transport"] = transport_label(rec["mesh"])
    return rec


def test_a_card_record_is_priced_from_its_measured_compute_leg():
    rec = card_record()
    for row in rec["ranks"]:
        row["compute_time"] = [0.9 * r for r in row["runtimes"]]
        row["barrier_time"] = [0.05 * r for r in row["runtimes"]]
    block = T.attribute_record(rec)
    _assert_fractions(block)
    assert block["bound"] == "sm"
    assert block["inputs"]["compute_basis"] == "measured"
    assert block["inputs"]["hw"] == "h100_sxm"
    comm = block["achieved"]["comm"]
    assert comm["transport"] == "nccl" and comm["peak_GBps"] == 450.0
    assert comm["frac"] == pytest.approx(comm["rate_GBps"] / 450.0,
                                         abs=1e-4)
    # exposed comm binds: NVLink inside a host, the network across hosts
    for hosts, word in ((1, "nvlink"), (2, "network")):
        rec = card_record(hosts=hosts)
        for row in rec["ranks"]:
            row["compute_time"] = [0.3 * r for r in row["runtimes"]]
            row["barrier_time"] = [0.6 * r for r in row["runtimes"]]
        assert T.attribute_record(rec)["bound"] == word


def test_world1_card_and_cpu_records():
    rec = card_record(world=1)
    assert rec["global"]["transport"] == "local"
    block = T.attribute_record(rec)
    assert block["inputs"]["transport"] == "local"
    assert "comm" not in block.get("achieved", {})
    cpu = card_record(world=1, platform="cpu", kind="cpu")
    for row in cpu["ranks"]:
        row["compute_time"] = list(row["runtimes"])
    block = T.attribute_record(cpu)
    assert block["bound"] == "host" and block["inputs"]["hw"] is None


def test_a_card_serving_record_speaks_sm():
    rec = _records("record_sampling.jsonl")[0]
    rec["global"].pop("attribution", None)
    want = J.attribute_serving(rec)
    rec["mesh"].update(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    srv = rec["global"]["serving"]
    srv["decode_loop"]["device_us"]["total"] = 0.8 * srv["wall_s"] * 1e6
    got = T.attribute_serving(rec)
    _assert_fractions(got)
    assert got["bound"] == "sm" and want["bound"] == "host"
    assert got["inputs"]["compute_basis"] == "measured"


# ------------------------------------------------------------- explain
def _explain(mod, path, **kw) -> tuple[int, str]:
    buf = io.StringIO()
    rc = mod.explain(path, out=buf, **kw)
    return rc, buf.getvalue()


@pytest.mark.parametrize("name", [*BENCH, *FIXTURES])
def test_explain_renders_the_same_text(name):
    path = (REPO / name) if name in BENCH else (DATA / name)
    for top in (0, 2):
        assert _explain(T, path, top=top) == _explain(J, path, top=top)


def test_explain_cli_and_empty_artifact_equal(tmp_path, capsys):
    for mod in (J, T):
        assert mod.main(["explain", str(REPO / "BENCH_r05.json")]) == 0
    j_out, t_out = capsys.readouterr().out.split("== bottleneck")[1:]
    assert j_out == t_out
    empty = tmp_path / "e.jsonl"
    empty.write_text("\n")
    assert _explain(T, empty) == _explain(J, empty)
    assert _explain(T, empty)[0] == 1


def test_explain_speaks_the_ports_words(tmp_path):
    rec = card_record()
    for row in rec["ranks"]:
        row["compute_time"] = [0.3 * r for r in row["runtimes"]]
        row["barrier_time"] = [0.6 * r for r in row["runtimes"]]
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    rc, text = _explain(T, path)
    assert rc == 0
    assert "bound: NVLINK" in text
    assert "communication-bound: exposed NVLINK time" in text
    rec = card_record()
    for row in rec["ranks"]:
        row["compute_time"] = list(row["runtimes"])
    path.write_text(json.dumps(rec) + "\n")
    assert "compute-bound: the SMs are the binding resource" in \
        _explain(T, path)[1]
