"""The observability channels on a CUDA card: ``torch.profiler`` traces
of the burn's CUDA graphs and of NCCL's collectives at world 1, each
device event given the kind of the collective that launched it
(``metrics/profiling.py``), and ``cli dp`` / ``cli ulysses`` with
``--profile --trace-out --telemetry``.

What NCCL launches at one rank: an in-place allreduce nothing at all
(its one-rank path returns without work), an allgather, reduce-scatter
or all-to-all a copy, a ``batch_isend_irecv`` hop to the rank itself
one ``ncclDevKernel_SendRecv`` kernel.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU path is held against the JAX package in
tests/test_torch_observability.py."""
from __future__ import annotations

import json

import pytest
import torch

from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch.metrics import profiling
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.proxies import burn as burnlib

GPT2 = ["--model", "gpt2_l_16_bfloat16"]
TINY = ["--size_scale", "1e-5", "--time_scale", "2e-4", "-w", "1", "-r",
        "3", "--buffer_dtype", "bfloat16"]
COPIES = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUPTI's device trace, the burn's "
                    "CUDA graphs and NCCL run only there (the CPU path is "
                    "tested against JAX in "
                    "tests/test_torch_observability.py)")
    return torch.device("cuda")


@pytest.fixture
def nccl_world1(cuda_device):
    """A one-rank NCCL group on the card, torn down after the case."""
    device = multihost.initialize("cuda")
    yield device
    multihost.shutdown()


@pytest.mark.cuda
def test_burn_graph_kernels_are_kernel_events(cuda_device, tmp_path):
    """CUPTI reports each kernel of a replayed CUDA graph as a kernel
    event whose correlation is the ``cudaGraphLaunch``'s;
    ``device_events`` folds each launch into one event spanning its
    kernels."""
    burner = burnlib.Burner(cuda_device)
    iters = burnlib.CHUNK + 37
    burner(iters)                                  # capture both graphs
    events = profiling.trace_step(lambda: burner(iters), cuda_device,
                                  trace_dir=tmp_path)
    raw = profiling.load_trace_events(tmp_path / "step.trace.json")
    launches = {e["args"]["correlation"] for e in raw
                if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e["name"]}
    assert len(launches) == 2                      # CHUNK, then 37
    in_graphs = [e for e in raw if e.get("cat") == "kernel"
                 and e["args"].get("correlation") in launches]
    per_iter = len(in_graphs) / iters
    assert per_iter >= 3 and per_iter == int(per_iter)
    assert any("gemm" in e["name"].lower() for e in in_graphs)
    graphs = [e for e in events if e["name"].startswith("cudaGraphLaunch")]
    assert sorted(e["args"]["kernels"] for e in graphs) == sorted(
        [int(per_iter) * 37, int(per_iter) * burnlib.CHUNK])
    for e in graphs:
        assert 0 < e["args"]["busy_us"] <= e["dur"] + 1e-3
        assert "kind" not in e["args"]


@pytest.mark.cuda
def test_collectives_carry_their_kind_on_card(nccl_world1):
    """One step of every collective on a comm stream at world 1: each
    kind's device work carries its kind (SendRecv's too, which serves
    both the all-to-all and the hops), one event a call, and the
    in-place allreduce launches none."""
    dev = nccl_world1
    n = 1 << 20
    x = torch.ones(n, dtype=torch.bfloat16, device=dev)
    outs = {k: torch.empty_like(x) for k in ("a2a", "ring", "ag", "rs")}
    burner = burnlib.Burner(dev)

    def step():
        comm = col.CommStream(dev)
        burner(64)
        comm.issue(col.allreduce, x)
        comm.issue(col.alltoall, outs["a2a"], x)
        comm.issue(col.ring_shift, outs["ring"], x)
        comm.issue(col.allgather, outs["ag"], x)
        comm.issue(col.reduce_scatter, outs["rs"], x)
        comm.wait_all()

    step()
    torch.cuda.synchronize()
    events = profiling.trace_step(step, dev)
    stats = profiling.collective_stats(events)
    assert "allreduce" not in stats               # NCCL's one-rank no-op
    for kind in ("alltoall", "permute", "allgather", "reduce_scatter"):
        assert stats[kind]["count"] == 1, (kind, stats)
        assert stats[kind]["total_us"] > 0
    sendrecv = [e for e in events if "SendRecv" in e["name"]]
    assert sendrecv and {e["args"]["kind"] for e in sendrecv} <= {
        "permute", "alltoall"}
    assert any(e["args"]["kind"] == "permute" for e in sendrecv)
    assert all(e.get("cat") in COPIES for e in events)


@pytest.mark.cuda
def test_cli_dp_profile_trace_telemetry_on_card(cuda_device, tmp_path):
    out, trace = tmp_path / "rec.jsonl", tmp_path / "t.json"
    assert cli.main(["dp", *GPT2, "--num_buckets", "4", *TINY,
                     "--profile", "--trace-out", str(trace), "--telemetry",
                     "--out", str(out)]) == 0
    g = json.loads(out.read_text())["global"]
    # the burn's graph launches are the step's device time; the
    # one-rank in-place allreduces launch nothing
    assert g["profile"]["other"]["count"] >= 2
    assert "allreduce" not in g["profile"]
    assert any(op["op"].startswith("cudaGraphLaunch")
               for op in g["device_top_ops"])
    assert g["telemetry"]["recorded"] == 1 + 3
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["args"]["name"] for e in events if e.get("ph") == "M"
             and e["name"] == "process_name"}
    assert "rank 0 (cuda:0)" in names
    host = {e["name"] for e in events if e.get("pid") == 0
            and e.get("ph") == "X"}
    assert {"build", "compile", "calibrate", "warmup", "timed", "fence",
            "profile"} <= host
    assert any(e.get("cat") == "kernel" and e.get("pid") == 1
               for e in events)


@pytest.mark.cuda
def test_cli_ulysses_profile_counts_its_alltoalls(cuda_device, tmp_path):
    """4 all-to-alls a layer, 2 layers: the profile counts 8 alltoall
    device events in the profiled step, each SendRecv or copy the
    all-to-all launched tagged alltoall."""
    out = tmp_path / "rec.jsonl"
    assert cli.main(["ulysses", *GPT2, "--sp", "1", "--max_layers", "2",
                     *TINY, "--profile", "--out", str(out)]) == 0
    g = json.loads(out.read_text())["global"]
    assert g["profile"]["alltoall"]["count"] == 8
    assert "permute" not in g["profile"]
