"""The port's profiler channel (``dlnetbench_tpu_torch/metrics/
profiling.py``) against the JAX package's ``metrics/profiling.py``, and
the proxy commands' observability flags end to end:

* ``classify_op``, ``collective_stats`` and ``top_device_ops`` equal
  JAX's on JAX's names and event lists; the stack's own names (c10d,
  gloo, NCCL) map to their kinds;
* ``device_events`` on synthetic ``torch.profiler`` traces: the CPU's
  top-level ops of the step thread, the card's kernels, copies and
  folded graph launches, each collective's kind linked through its
  ``dlnb:<kind>`` annotation;
* a real profiled step at world 1 on gloo;
* with no observability flag, a ``cli dp`` record on scripted clocks is
  byte for byte the parent tree's (``PARENT_RECORD``) but for the record
  pipeline's gathered mark and attribution stamp (``RECORD_ADDITIONS``);
* four spawned gloo ranks run ``cli dp --num_buckets 2 --profile
  --trace-out --telemetry --platform cpu``: the profile's counts equal
  the collective counters over the profiled step summed over ranks, the
  trace holds the host phases and every rank's kind-tagged events, the
  telemetry block holds warmup + chains, and the record loads through
  the JAX parser.

The four ranks run ``_gloo_worker`` in spawned processes, which import
this module: jax and the JAX package are imported inside the tests
only, never at module level."""
from __future__ import annotations

import gzip
import json
import multiprocessing
import os
import pickle
import types

import pytest
import torch

from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch.metrics import profiling as T_prof
from dlnetbench_tpu_torch.utils.net import free_port

MODEL = "gpt2_l_16_bfloat16"
WORLD = 4
E2E_WARMUP, E2E_RUNS = 1, 2

# JAX's op names (tests/test_profiling.py, tests/test_attribution.py),
# then this stack's
JAX_NAMES = ["all-reduce.3", "psum.7", "reduce-scatter.2", "psum-scatter.1",
             "all-gather.5", "all-to-all", "collective-permute.9",
             "fusion.12", "end: psum.7", "all-reduce.1", "end: all-reduce.1",
             "$profiler.py:226 trace", "PjitFunction(<lambda>)", "fusion.1",
             "broadcast_multiply_fusion", "", "$x.py:1 f", "dot.4", "dce",
             "algsimp", "ParseArguments", "call", "send-done.1",
             "recv.4", "ppermute"]
TORCH_NAMES = {
    "c10d::allreduce_": "allreduce", "c10d::alltoall_base_": "alltoall",
    "c10d::_allgather_base_": "allgather",
    "c10d::_reduce_scatter_base_": "reduce_scatter",
    "c10d::send": "send_recv", "c10d::recv_": "send_recv",
    "gloo:all_reduce": "allreduce", "gloo:all_to_all": "alltoall",
    "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage"
    "<4096ul>)": "allreduce",
    "ncclDevKernel_AllGather_RING_LL(x)": "allgather",
    "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(x)": "reduce_scatter",
    "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)": "send_recv",
    "aten::addmm_": None, "Memcpy DtoD (Device -> Device)": None,
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8": None,
}


def test_classify_op_equals_jax_and_maps_this_stacks_names():
    from dlnetbench_tpu.metrics import profiling as J_prof
    for name in JAX_NAMES:
        assert T_prof.classify_op(name) == J_prof.classify_op(name), name
    for name, kind in TORCH_NAMES.items():
        assert T_prof.classify_op(name) == kind, name


# JAX's device-event lists (tests/test_profiling.py and
# tests/test_attribution.py)
JAX_LISTS = [
    [{"ph": "X", "name": "psum.7", "dur": 10.0},
     {"ph": "X", "name": "psum.7", "dur": 30.0},
     {"ph": "X", "name": "all-gather.1", "dur": 5.0},
     {"ph": "X", "name": "broadcast_multiply_fusion", "dur": 99.0}],
    [{"name": "fusion.12", "dur": 300.0},
     {"name": "all-reduce.1", "dur": 100.0},
     {"name": "end: all-reduce.1", "dur": 100.0},
     {"name": "$profiler.py:226 trace", "dur": 9e9},
     {"name": "PjitFunction(<lambda>)", "dur": 5e6}],
    [{"name": "fusion.1", "dur": 10.0}, {"name": "fusion.1", "dur": 20.0},
     {"name": "all-reduce.2", "dur": 25.0},
     {"name": "end: all-reduce.2", "dur": 25.0}, {"name": "", "dur": 99.0}],
    [{"name": "dot.4", "dur": 50.0, "_thread": "tf_XLATfrtCpuClient/-123"},
     {"name": "all-reduce.1", "dur": 10.0, "_thread": "tf_XLAEigen/-456"},
     {"name": "dce", "dur": 9e4, "_thread": "python"},
     {"name": "algsimp", "dur": 8e4, "_thread": "python"},
     {"name": "ParseArguments", "dur": 7e4, "_thread": "python"},
     {"name": "call", "dur": 55.0,
      "_thread": "tf_XLATfrtCpuClient/-123"}],
    [{"name": "$x.py:1 f", "dur": 9.0}],
]


@pytest.mark.parametrize("events", JAX_LISTS)
def test_stats_and_top_ops_equal_jax(events):
    from dlnetbench_tpu.metrics import profiling as J_prof
    assert T_prof.collective_stats(events) == \
        J_prof.collective_stats(events)
    for k in (0, 2, 5):
        assert T_prof.top_device_ops(events, k=k) == \
            J_prof.top_device_ops(events, k=k)


def test_load_trace_events_annotates_thread_names(tmp_path):
    trace = {"traceEvents": [
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
         "args": {"name": "thread 2 (python)"}},
        {"ph": "X", "pid": 1, "tid": 2, "name": "aten::mm",
         "cat": "cpu_op", "ts": 0.0, "dur": 5.0},
        {"ph": "X", "pid": 1, "tid": 3, "name": "fusion.1",
         "ts": 1.0, "dur": 2.0},
        {"ph": "i", "pid": 1, "tid": 3, "name": "mark", "ts": 1.0},
    ]}
    p = tmp_path / "sub" / "w.123.pt.trace.json.gz"
    p.parent.mkdir()
    with gzip.open(p, "wt") as f:
        json.dump(trace, f)
    for src in (p, tmp_path):                  # the file, or its dir
        events = T_prof.load_trace_events(src)
        by_name = {e["name"]: e for e in events}
        assert set(by_name) == {"aten::mm", "fusion.1"}
        assert by_name["aten::mm"]["_thread"] == "thread 2 (python)"
        assert "_thread" not in by_name["fusion.1"]


def _x(name, cat, ts, dur, tid=5, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 5, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args}


def test_device_events_cpu_takes_the_step_threads_top_level_ops():
    events = [
        _x("ProfilerStep#1", "user_annotation", 0, 100),
        _x("aten::copy_", "cpu_op", 1, 4),
        _x("aten::empty", "cpu_op", 2, 1),                   # nested
        _x("dlnb:allreduce", "user_annotation", 10, 10),
        _x("c10d::allreduce_", "cpu_op", 11, 5),
        _x("aten::add_", "cpu_op", 12, 1),                   # nested
        _x("dlnb:permute", "user_annotation", 30, 10),
        _x("aten::copy_", "cpu_op", 31, 3),                  # a self hop
        _x("c10d::alltoall_base_", "cpu_op", 50, 5),         # unannotated
        _x("gloo:all_reduce", "user_annotation", 13, 2, tid=9),
        _x("aten::mul", "cpu_op", 13, 2, tid=9),             # other thread
    ]
    got = T_prof.device_events(events, "cpu")
    assert [(e["name"], e["args"].get("kind")) for e in got] == [
        ("aten::copy_", None), ("c10d::allreduce_", "allreduce"),
        ("aten::copy_", "permute"), ("c10d::alltoall_base_", None)]
    assert all(e["args"]["device_op"] for e in got)
    stats = T_prof.collective_stats(got)
    assert {k: v["count"] for k, v in stats.items()} == {
        "allreduce": 1, "alltoall": 1, "other": 1, "permute": 1}
    assert stats["permute"]["total_us"] == 3.0
    # the raw trace's cpu ops are host events to the stats
    assert T_prof.collective_stats(events) == {}


def test_device_events_cuda_links_kernels_to_their_collective():
    events = [
        _x("cudaGraphLaunch", "cuda_runtime", 0, 2, correlation=1),
        *[_x("gemm", "kernel", 10 + 5 * i, 4, tid=7, correlation=1,
             stream=7) for i in range(3)],
        _x("dlnb:alltoall", "user_annotation", 3, 4),
        _x("cuLaunchKernelEx", "cuda_driver", 4, 1, correlation=2),
        _x("ncclDevKernel_SendRecv(x)", "kernel", 40, 8, tid=13,
           correlation=2),
        _x("dlnb:permute", "user_annotation", 8, 4),
        _x("cuLaunchKernelEx", "cuda_driver", 9, 1, correlation=3),
        _x("ncclDevKernel_SendRecv(x)", "kernel", 50, 8, tid=13,
           correlation=3),
        _x("dlnb:allgather", "user_annotation", 14, 4),
        _x("cudaMemcpyAsync", "cuda_runtime", 15, 1, correlation=4),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60, 3, tid=13,
           correlation=4),
        _x("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "kernel", 70, 2,
           tid=13, correlation=5),                       # no launch seen
        _x("nccl:all_to_all", "gpu_user_annotation", 40, 8, tid=13),
        _x("c10d::alltoall_base_", "cpu_op", 3, 4),
    ]
    got = T_prof.device_events(events, "cuda")
    assert [(e["name"], e["args"].get("kind")) for e in got] == [
        ("cudaGraphLaunch (3 kernels)", None),
        ("ncclDevKernel_SendRecv(x)", "alltoall"),
        ("ncclDevKernel_SendRecv(x)", "permute"),
        ("Memcpy DtoD (Device -> Device)", "allgather"),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", None)]
    graph = got[0]
    assert (graph["ts"], graph["dur"], graph["tid"]) == (10.0, 14.0, 7)
    assert graph["args"]["kernels"] == 3 and graph["args"]["busy_us"] == 12
    stats = T_prof.collective_stats(got)
    assert {k: v["count"] for k, v in stats.items()} == {
        "allgather": 1, "allreduce": 1, "alltoall": 1, "other": 1,
        "permute": 1}
    assert T_prof.top_device_ops(got, k=2) == [
        {"op": "ncclDevKernel_SendRecv(x)", "total_us": 16.0, "count": 2},
        {"op": "cudaGraphLaunch (3 kernels)", "total_us": 14.0, "count": 1}]
    with pytest.raises(ValueError):
        T_prof.device_events(events, "tpu")


def test_profiled_step_on_gloo_world1_links_every_kind():
    """One real step of the port's collectives under ``trace_step`` at
    world 1 on gloo: each call is one device op of its kind, and the
    ``profile`` span brackets the recorded step."""
    from dlnetbench_tpu_torch.metrics import spans
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    device = multihost.initialize("cpu")
    try:
        x = torch.arange(8, dtype=torch.float32)
        outs = [torch.empty(8) for _ in range(4)]

        def step():
            comm = col.CommStream(device)
            torch.tanh(x)
            comm.issue(col.allreduce, x)
            comm.issue(col.alltoall, outs[0], x)
            comm.issue(col.ring_shift, outs[1], x)
            comm.issue(col.allgather, outs[2], x)
            comm.issue(col.reduce_scatter, outs[3], x)
            comm.wait_all()

        tracer = spans.enable()
        events = T_prof.trace_step(step, device, span_attrs={"proxy": "t"})
        spans.disable()
    finally:
        multihost.shutdown()
    stats = T_prof.collective_stats(events)
    assert {k: v["count"] for k, v in stats.items() if k != "other"} == {
        "allreduce": 1, "alltoall": 1, "permute": 1, "allgather": 1,
        "reduce_scatter": 1}
    assert [(s["name"], s.get("attrs")) for s in tracer.spans
            if s["name"] == "profile"] == [("profile", {"proxy": "t"})]


def test_recorded_step_is_padded_inside_the_profiler_step(monkeypatch):
    """The recorded step has ``WINDOW_PAD_S`` of idle host time on each
    side inside the profiler's active step (a device record whose
    converted timestamp falls outside that step is dropped)."""
    import time

    from dlnetbench_tpu_torch.metrics import spans
    order = []
    real_sleep = time.sleep

    def sleep(s):
        order.append(("sleep", s))
        real_sleep(0)
    monkeypatch.setattr(time, "sleep", sleep)
    x = torch.arange(8, dtype=torch.float32)
    tracer = spans.enable()
    try:
        events = T_prof.trace_step(lambda: order.append("step") or
                                   torch.tanh(x), torch.device("cpu"))
    finally:
        spans.disable()
    pad = ("sleep", T_prof.WINDOW_PAD_S)
    assert order == ["step", pad, "step", pad]
    assert T_prof.WINDOW_PAD_S >= 0.01
    assert events
    assert [s["name"] for s in tracer.spans] == ["profile"]


# ------------------------------------------- the record, byte for byte
# cli dp at world 1 on the CPU, written by the parent tree (commit
# 2a52e65) with the clocks of utils/timing.py and core/executor.py
# scripted (1.25 ms a read), the burn's calibration seeded, no energy
# sampler and a fixed hostname (_scripted_dp)
PARENT_RECORD = (
    '{"section": "dp", "version": 2, "process": 0, "global": {"proxy": "d'
    'p", "model": "gpt2_l_16_bfloat16", "world_size": 1, "num_buckets": 2'
    ', "bucket_bytes": [15468, 15468], "schedule_bucket_bytes": [77352192'
    '0, 773521920], "fwd_us": 2.657755, "bwd_us_per_bucket": 2.6577555, "'
    'burn_ns_per_iter": 250000.0, "comm_model": {"comm_time": [{"kind": "'
    'allreduce", "group": 1, "bytes": 30936}]}, "size_scale": 1e-05, "tim'
    'e_scale": 0.0001, "compile_ms": {"full": 1.25, "compute": 1.25, "com'
    'm": 1.25}, "aot": {"full": {}, "compute": {}, "comm": {}}, "buffer_d'
    'type": "float32", "reps_per_fence": 1, "host_rtt_us": 1250.0, "trans'
    'port": "local"}, "mesh": {"axes": {"x": 1}, "num_devices": 1, "platf'
    'orm": "cpu", "device_kind": "cpu", "num_hosts": 1, "fabric": "virtua'
    'l"}, "num_runs": 2, "warmup_times": [1250.0000000272848], "ranks": ['
    '{"rank": 0, "device_id": 0, "process_index": 0, "hostname": "fixedho'
    'st", "burn": {"ns_per_iter": 250000.0, "iters": 3, "planned_us": 750'
    '.0}, "runtimes": [1250.0000000272848, 1250.0000000272848], "compute_'
    'time": [1250.0000000272848, 1249.999999913598], "barrier_time": [0.0'
    ', 1.1368683772161603e-07], "comm_time": [1249.999999913598, 1250.000'
    '0000272848], "overlap_fraction": [1.0, 1.0], "summary": {"runtimes":'
    ' {"value": 1250.0, "best": 1250.0, "band": [1250.0, 1250.0], "n": 2}'
    ', "compute_time": {"value": 1250.0, "best": 1250.0, "band": [1250.0,'
    ' 1250.0], "n": 2}, "barrier_time": {"value": 0.0, "best": 0.0, "band'
    '": [0.0, 0.0], "n": 2}, "comm_time": {"value": 1250.0, "best": 1250.'
    '0, "band": [1250.0, 1250.0], "n": 2}, "overlap_fraction": {"value": '
    '1.0, "best": 1.0, "band": [1.0, 1.0], "n": 2}}}]}\n')


def _scripted_dp(monkeypatch, tmp_path, *extra) -> str:
    import socket
    import time

    from dlnetbench_tpu_torch.core import executor
    from dlnetbench_tpu_torch.metrics import energy
    from dlnetbench_tpu_torch.proxies import burn
    from dlnetbench_tpu_torch.utils import timing
    reads = iter(range(1, 10 ** 6))
    clock = types.SimpleNamespace(
        perf_counter=lambda: 1000.0 + 0.00125 * next(reads),
        monotonic=time.monotonic, sleep=time.sleep, time=time.time)
    monkeypatch.setattr(timing, "time", clock)
    monkeypatch.setattr(executor, "time", clock)
    monkeypatch.setattr(energy, "detect_sampler", lambda device=None: None)
    monkeypatch.setattr(socket, "gethostname", lambda: "fixedhost")
    monkeypatch.setitem(burn._CAL_CACHE, ((256, 256), "bfloat16", "cpu"),
                        burn.BurnCalibration(ns_per_iter=2.5e5,
                                             shape=(256, 256),
                                             dtype="bfloat16",
                                             device_kind="cpu"))
    monkeypatch.delenv("DLNB_TELEMETRY", raising=False)
    out = tmp_path / "r.jsonl"
    assert cli.main(["dp", "--model", MODEL, "--num_buckets", "2",
                     "--platform", "cpu", "-r", "2", "-w", "1",
                     "--size_scale", "1e-5", "--time_scale", "1e-4",
                     *extra, "--out", str(out)]) == 0
    return out.read_text()


# what the record pipeline adds to the parent tree's record: the mesh
# header's gathered mark and the attribution stamp, the last keys of
# their blocks (scripted clocks: compute is the whole runtime on a CPU)
RECORD_ADDITIONS = {
    "gathered": True,
    "attribution": {
        "fractions": {"compute": 1.0, "hbm": 0.0, "comm_exposed": 0.0,
                      "host": 0.0},
        "bound": "host",
        "inputs": {"source": "timers", "hw": None, "host_rtt_us": 1250.0,
                   "time_us": 1250.0, "compute_basis": "measured",
                   "transport": "local"}},
}


def _without_additions(text: str) -> str:
    """The record's line with ``RECORD_ADDITIONS`` checked and taken
    out, every other byte as written."""
    rec = json.loads(text)
    assert list(rec["mesh"])[-1] == "gathered"
    assert list(rec["global"])[-1] == "attribution"
    assert rec["mesh"].pop("gathered") == RECORD_ADDITIONS["gathered"]
    assert rec["global"].pop("attribution") == \
        RECORD_ADDITIONS["attribution"]
    return json.dumps(rec) + "\n"


def test_record_without_flags_is_the_parent_trees(monkeypatch, tmp_path):
    assert _without_additions(_scripted_dp(monkeypatch, tmp_path)) == \
        PARENT_RECORD
    # the topology graph prints to stderr and changes no byte
    (tmp_path / "b").mkdir()
    assert _without_additions(_scripted_dp(monkeypatch, tmp_path / "b",
                                           "--no_topology")) == PARENT_RECORD


# ----------------------------------------------- four gloo ranks, e2e
def _gloo_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank: ``cli dp`` with every observability flag; the
    collective counters over the profiled step (the last step
    ``trace_step`` runs) pickled for the test."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from dlnetbench_tpu_torch.parallel import collectives as col
    traced, seen = T_prof.trace_step, []

    def counted_trace_step(fn, device, **kw):
        def counted():
            before = col.counts()
            fn()
            seen.append({k: v - before[k] for k, v in col.counts().items()})
        return traced(counted, device, **kw)

    T_prof.trace_step = counted_trace_step
    rc = cli.main(["dp", "--model", MODEL, "--num_buckets", "2",
                   "--platform", "cpu", "-w", str(E2E_WARMUP), "-r",
                   str(E2E_RUNS), "--size_scale", "1e-5", "--time_scale",
                   "1e-4", "--profile", "--trace-out",
                   os.path.join(out_dir, "trace.json"), "--telemetry",
                   "--flight-dir", os.path.join(out_dir, "flight"),
                   "--out", os.path.join(out_dir, "dp.jsonl")])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"rc": rc, "profiled": seen[-1], "steps": len(seen)}, f)


@pytest.fixture(scope="module")
def gloo_e2e(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs4")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"gloo ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert [r["rc"] for r in ranks] == [0] * WORLD
    return ranks, out


def test_e2e_profile_counts_equal_the_call_counters(gloo_e2e):
    ranks, out = gloo_e2e
    assert all(r["steps"] == 2 for r in ranks)     # warming + recorded
    profile = json.loads((out / "dp.jsonl").read_text())["global"]["profile"]
    counted = {k: sum(r["profiled"][k] for r in ranks)
               for k in ranks[0]["profiled"]}
    assert counted["allreduce"] == WORLD * 2
    assert {k: v["count"] for k, v in profile.items() if k != "other"} == {
        k: v for k, v in counted.items() if v}
    assert profile["other"]["count"] > 0           # the burn's ops


def test_e2e_trace_holds_host_phases_and_every_ranks_kinds(gloo_e2e):
    _, out = gloo_e2e
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    host = {e["name"] for e in events if e.get("pid") == 0
            and e.get("ph") == "X"}
    assert {"build", "warmup", "timed", "fence", "profile",
            "calibrate"} <= host
    labels = {e["pid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e["name"] == "process_name"}
    for r in range(WORLD):
        assert labels[1 + r] == f"rank {r} (cpu)"
        kinds = [e["args"].get("kind") for e in events
                 if e.get("pid") == 1 + r and e.get("ph") == "X"]
        assert kinds.count("allreduce") == 2, r
    assert any(e.get("ph") == "C" and e["name"] == "step_wall_us"
               for e in events)                    # the flight ring


def test_e2e_telemetry_and_the_jax_parser(gloo_e2e):
    from dlnetbench_tpu.metrics.parser import get_metrics_dataframe
    _, out = gloo_e2e
    rec = json.loads((out / "dp.jsonl").read_text())
    tele = rec["global"]["telemetry"]
    assert tele["recorded"] == E2E_WARMUP + E2E_RUNS
    assert [s["phase"] for s in tele["last"]] == \
        ["warmup"] + ["timed"] * E2E_RUNS
    assert [s["step"] for s in tele["last"]] == list(
        range(E2E_WARMUP + E2E_RUNS))
    assert all("compute_us" in s for s in tele["last"][E2E_WARMUP:])
    df = get_metrics_dataframe(out / "dp.jsonl", "dp")
    assert len(df) == WORLD * E2E_RUNS
    assert sorted(df["rank"].unique()) == list(range(WORLD))
    assert df["runtime"].notna().all()
