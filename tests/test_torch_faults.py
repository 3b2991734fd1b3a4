"""The port's fault layer against the JAX package's, on the CPU: the
injector's sleeps and triggers (recorded, never slept), ``check_config``
and the CLI's usage errors, ``run_faulted`` at world 1 (fail_fast,
retry, the checkpoint pathway), the collectives' fault hook, and one
spawn of four gloo ranks running ``cli dp`` under ``shrink`` and under
``preempt`` + restore + ``rejoin`` (with stall npz saves and with async
dcp saves), and ``cli fsdp`` under the latter, against JAX's CLI on
four virtual devices.

The four ranks run ``_gloo_worker`` in spawned processes, which import
this module: jax and the JAX package are imported inside the tests and
fixtures only."""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import threading
import time
from pathlib import Path

import pytest
import torch

from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch.faults import inject as T_inject
from dlnetbench_tpu_torch.faults import policy as T_policy
from dlnetbench_tpu_torch.faults.plan import FaultEvent, FaultPlan
from dlnetbench_tpu_torch.utils.net import free_port

MODEL = "gpt2_l_16_bfloat16"
WORLD = 4
FLAGS = ["--model", MODEL, "--platform", "cpu", "--size_scale", "1e-5",
         "--time_scale", "2e-4", "--no_topology", "-w", "1", "-r", "8"]
CLI_BASE = ["dp", "--num_buckets", "2", *FLAGS]
SHRINK = {"policy": "shrink",
          "events": [{"kind": "crash", "ranks": [2], "iteration": 5}]}
# a grace window no save fits: the drain is refused on every tier
PREEMPT = {"policy": "shrink",
           "events": [{"kind": "preempt", "ranks": [2], "iteration": 5,
                       "magnitude_us": 0.001},
                      {"kind": "rejoin", "ranks": [2], "iteration": 8}]}
CKPT = ["--checkpoint_every", "2", "--checkpoint_mode", "stall"]


# ------------------------------------------------------------ injector
@pytest.fixture
def no_sleep(monkeypatch):
    """Every sleep (``time.sleep``; the port injector's ``wait``)
    recorded in µs instead of slept."""
    slept = []
    monkeypatch.setattr(time, "sleep", lambda s: slept.append(s * 1e6))
    monkeypatch.setattr(T_inject, "wait", lambda s: slept.append(s * 1e6))
    return slept


def _jax_inject():
    from dlnetbench_tpu.faults import inject
    from dlnetbench_tpu.faults import plan
    return inject, plan


def _both(plan_dict: dict):
    inject, plan = _jax_inject()
    return (FaultPlan.from_dict(plan_dict),
            plan.FaultPlan.from_dict(plan_dict), inject)


def _steps(inj, n: int) -> list:
    return [round(inj.before_step(), 6) for _ in range(n)]


PLANS = {
    "delay_window": {"events": [{"kind": "delay", "ranks": [1],
                                 "iteration": 1, "until": 3,
                                 "magnitude_us": 1000.0}]},
    "jitter_seeded": {"events": [
        {"kind": "jitter", "iteration": 0, "magnitude_us": 500.0,
         "seed": 7},
        {"kind": "jitter", "ranks": [2], "iteration": 2,
         "magnitude_us": 300.0, "seed": 7},
        {"kind": "delay", "ranks": [0, 3], "iteration": 4, "until": 6,
         "magnitude_us": 250.0}]},
}


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("rank", [None, 0, 1, 2, 3])
def test_injector_sleeps_equal_jax(name, rank, no_sleep):
    """Each rank's sleep sequence (and the whole-plan view's) equals
    the JAX injector's for the same view: seeded jitter draws one
    stream per event, windows open and close at the same steps."""
    plan, jplan, inject = _both(PLANS[name])
    mine = T_inject.FaultInjector(plan, world=WORLD, rank=rank)
    theirs = inject.FaultInjector(jplan, world=WORLD, rank=rank)
    assert _steps(mine, 8) == _steps(theirs, 8)
    assert mine.injected_delay_us == pytest.approx(theirs.injected_delay_us)
    assert mine.iteration == theirs.iteration == 8
    n = len(no_sleep)
    assert n % 2 == 0 and no_sleep[:n // 2] == pytest.approx(no_sleep[n // 2:])


@pytest.mark.parametrize("k", [1, 3])
def test_injector_chain_window_equals_jax(k, no_sleep):
    """``before_chain(k)``: a fence chain of k steps applies each rep's
    faults; the per-chain totals equal JAX's."""
    plan, jplan, inject = _both(PLANS["jitter_seeded"])
    mine = T_inject.FaultInjector(plan, world=WORLD, rank=2)
    theirs = inject.FaultInjector(jplan, world=WORLD, rank=2)
    got = [mine.before_chain(k) for _ in range(4)]
    want = [theirs.before_chain(k) for _ in range(4)]
    assert got == pytest.approx(want)


def test_parallel_stragglers_gate_on_max_not_sum(no_sleep):
    """Delays on DIFFERENT ranks in one step: the port's ranks sleep in
    parallel, so the world's injected delay — the largest any rank
    slept, which the record stamps — is ``delay_per_step_us`` (the
    max), where JAX's single controller sleeps them one after another
    (the sum).  A known difference, shown here."""
    d = {"events": [{"kind": "delay", "ranks": [1], "magnitude_us": 100.0},
                    {"kind": "delay", "ranks": [2], "magnitude_us": 100.0},
                    {"kind": "delay", "magnitude_us": 10.0}]}
    plan, jplan, inject = _both(d)
    ranks = [T_inject.FaultInjector(plan, world=WORLD, rank=r)
             for r in range(WORLD)]
    for inj in ranks:
        _steps(inj, 3)
    world_us = max(inj.injected_delay_us for inj in ranks)
    assert world_us == pytest.approx(3 * plan.delay_per_step_us())
    assert plan.delay_per_step_us() == jplan.delay_per_step_us() == 110.0
    controller = inject.FaultInjector(jplan, world=WORLD)
    _steps(controller, 3)
    assert controller.injected_delay_us == pytest.approx(3 * 210.0)
    # a plan whose delays target one rank (or all): the two agree
    one = {"events": [{"kind": "delay", "ranks": [1], "magnitude_us": 70.0}]}
    plan, jplan, inject = _both(one)
    ranks = [T_inject.FaultInjector(plan, world=WORLD, rank=r)
             for r in range(WORLD)]
    for inj in ranks:
        _steps(inj, 2)
    controller = inject.FaultInjector(jplan, world=WORLD)
    _steps(controller, 2)
    assert max(i.injected_delay_us for i in ranks) \
        == controller.injected_delay_us == 140.0



@pytest.mark.parametrize("seconds", [0.0005, 0.004])
def test_injector_wait_sleeps_short_of_the_deadline_then_spins(
        seconds, monkeypatch):
    """``wait`` hands ``time.sleep`` all but ``SPIN_S`` of a delay
    (nothing of a shorter one) and returns no earlier than the
    deadline: a late wake of the sleep lands inside the spin."""
    slept, real = [], time.sleep
    monkeypatch.setattr(time, "sleep", lambda s: (slept.append(s), real(s)))
    t0 = time.perf_counter()
    T_inject.wait(seconds)
    assert time.perf_counter() - t0 >= seconds
    spin = T_inject.SPIN_S
    assert slept == ([] if seconds <= spin
                     else [pytest.approx(seconds - spin)])


TRIGGERS = {
    "crash": ({"policy": "shrink", "events": [
        {"kind": "delay", "ranks": [3], "magnitude_us": 50.0},
        {"kind": "crash", "ranks": [2, 3], "iteration": 3}]},
        "RankFailure"),
    "preempt": ({"policy": "shrink", "events": [
        {"kind": "preempt", "ranks": [1], "iteration": 2,
         "magnitude_us": 5000.0},
        {"kind": "rejoin", "ranks": [1], "iteration": 5}]},
        "RankPreempted"),
    "partition": ({"events": [{"kind": "partition", "group": [0, 1],
                               "iteration": 4}]}, "RankFailure"),
}


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_triggers_fire_on_every_rank_as_jax_controller(name, no_sleep):
    """Crash, preempt and partition triggers fire on EVERY rank at the
    same step, naming the victim JAX's single controller names."""
    d, cls = TRIGGERS[name]
    plan, jplan, inject = _both(d)
    controller = inject.FaultInjector(jplan, world=WORLD)
    with pytest.raises(getattr(inject, cls)) as want:
        for _ in range(10):
            controller.before_step()
    for r in range(WORLD):
        mine = T_inject.FaultInjector(plan, world=WORLD, rank=r)
        with pytest.raises(getattr(T_inject, cls)) as got:
            for _ in range(10):
                mine.before_step()
        assert (got.value.rank, got.value.iteration) == \
            (want.value.rank, want.value.iteration)
        assert str(got.value) == str(want.value)
        assert mine.iteration == controller.iteration
        assert getattr(got.value, "grace_us", None) == \
            getattr(want.value, "grace_us", None)


def test_partition_with_rank0_needs_the_world():
    plan = FaultPlan.from_dict({"events": [
        {"kind": "partition", "group": [0, 1], "iteration": 0}]})
    with pytest.raises(ValueError, match="complement"):
        T_inject.FaultInjector(plan).before_step()


def test_collectives_fault_hook_fires_per_call():
    """The hook runs at every collective wrapper call with its name and
    group — per execution, the wrappers being eager — and clears."""
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    calls = []
    owned = not torch.distributed.is_initialized()
    multihost.initialize("cpu")
    col.set_fault_hook(lambda op, group: calls.append((op, group)))
    try:
        x = torch.ones(4)
        out = torch.empty(4)
        col.allreduce(x)
        col.allreduce(x)
        col.allgather(out, x)
        col.reduce_scatter(torch.empty(4), x)
        col.alltoall(torch.empty(4), x)
        col.ring_shift(torch.empty(4), x)
        assert [c[0] for c in calls] == ["allreduce", "allreduce",
                                         "allgather", "reduce_scatter",
                                         "alltoall", "ring_shift"]
        assert all(g is None for _, g in calls)
    finally:
        col.set_fault_hook(None)
        if owned:
            multihost.shutdown()
    col._maybe_fault("allreduce", None)
    assert len(calls) == 6


# ------------------------------------------------ check_config and CLI
class _Cfg:
    def __init__(self, **kw):
        self.warmup, self.runs = kw.get("warmup", 1), kw.get("runs", 8)
        self.reps_per_fence = kw.get("reps_per_fence", 1)
        self.min_exectime_s = kw.get("min_exectime_s", 0.0)


CONFIG_CASES = [
    (SHRINK, {"reps_per_fence": 4}),
    (SHRINK, {"min_exectime_s": 1.0}),
    ({"policy": "retry", "events": [{"kind": "crash", "iteration": 0}]},
     {}),
    ({"policy": "shrink", "events": [
        {"kind": "preempt", "ranks": [2], "iteration": 4},
        {"kind": "rejoin", "ranks": [2], "iteration": 5}]}, {}),
    ({"policy": "fail_fast", "events": [{"kind": "crash",
                                         "iteration": 0}]}, {}),
    (PREEMPT, {"warmup": 6}),
    (PREEMPT, {}),
]


@pytest.mark.parametrize("i", range(len(CONFIG_CASES)))
def test_check_config_messages_equal_jax(i):
    d, kw = CONFIG_CASES[i]
    plan, jplan, _ = _both(d)

    def outcome(p):
        try:
            p.check_config(_Cfg(**kw))
            return None
        except ValueError as e:
            return str(e)

    assert outcome(plan) == outcome(jplan)


USAGE = [
    ["--checkpoint_dir", "CK"],
    ["--fault", json.dumps(SHRINK), "--checkpoint_dir", "CK",
     "--checkpoint_every", "0"],
    ["--fault", '{"events":[{"kind":"meteor"}]}'],
    ["--fault", "{not json"],
    ["--fault", json.dumps(SHRINK), "-k", "4"],
    ["--fault", json.dumps({"events": [{"kind": "crash",
                                        "iteration": 0}]}),
     "--fault_policy", "retry"],
    ["--fault", json.dumps({"events": [{"kind": "preempt", "ranks": [1],
                                        "iteration": 3}]}),
     "--fault_policy", "retry"],
    ["--fault", "@/nonexistent/plan.json"],
]


def _usage_error(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    return err.split("error: ", 1)[1]


@pytest.mark.parametrize("i", range(len(USAGE)))
def test_cli_usage_errors_equal_jax(i, capsys, tmp_path):
    """The proxy commands' fault and checkpoint usage errors carry the
    JAX CLI's messages, before any build."""
    from dlnetbench_tpu import cli as jax_cli
    argv = [a.replace("CK", str(tmp_path / "ck")) for a in USAGE[i]]
    got = _usage_error(cli.main, [*CLI_BASE, *argv], capsys)
    want = _usage_error(jax_cli.main, [*CLI_BASE, "-d", "1", *argv],
                        capsys)
    assert got == want


@pytest.mark.parametrize("proxy", ["fsdp", "hybrid_2d", "ulysses"])
def test_every_proxy_command_takes_the_fault_flags(proxy, capsys):
    argv = {"fsdp": ["fsdp", "--num_units", "2"],
            "hybrid_2d": ["hybrid_2d", "--num_stages", "1",
                          "--num_microbatches", "2"],
            "ulysses": ["ulysses", "--sp", "1"]}[proxy]
    err = _usage_error(cli.main, [*argv, "--model", MODEL, "--platform",
                                  "cpu", "--checkpoint_dir", "x"], capsys)
    assert err.startswith("--checkpoint_dir prices checkpointing")


def test_cli_refuses_orbax_by_name(capsys):
    err = _usage_error(cli.main, [*CLI_BASE, "--fault", json.dumps(SHRINK),
                                  "--checkpoint_dir", "x",
                                  "--checkpoint_backend", "orbax"], capsys)
    assert "'dcp'" in err and "orbax" in err


# --------------------------------------------- run_faulted at world 1
@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo group for the module's world-1 runs."""
    from dlnetbench_tpu_torch.parallel import multihost
    owned = not torch.distributed.is_initialized()
    device = multihost.initialize("cpu")
    yield device
    if owned:
        multihost.shutdown()


def _port_bundle(device, cfg):
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp
    return dp.build(load_model_stats(MODEL), 2, cfg, make_flat_mesh(device))


def _jax_bundle(cfg, n=1):
    import jax

    from dlnetbench_tpu.core.model_stats import load_model_stats
    from dlnetbench_tpu.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu.proxies import dp
    return dp.build(load_model_stats(MODEL), 2, cfg,
                    mesh=make_flat_mesh(devices=jax.devices()[:n]))


def _cfgs(**kw):
    from dlnetbench_tpu.proxies.base import ProxyConfig as JCfg
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    base = dict(warmup=1, runs=6, size_scale=1e-5, time_scale=2e-4, **kw)
    return ProxyConfig(**base), JCfg(measure_energy=False,
                                     measure_comm_only=False, **base)


FAULT_KEYS = ("fault_plan", "fault_policy", "fault_retries",
              "fault_iteration", "degraded_world", "checkpoint_every",
              "checkpoint_mode", "checkpoint_saves", "lost_steps",
              "checkpoint_state_bytes", "world_size")

WORLD1 = {
    "fail_fast_delay": ({"events": [{"kind": "delay", "ranks": [0],
                                     "iteration": 3,
                                     "magnitude_us": 2000.0}]}, None),
    "retry": ({"policy": "retry", "events": [
        {"kind": "crash", "ranks": [0], "iteration": 3}]}, None),
    "retry_ckpt_npz": ({"policy": "retry", "events": [
        {"kind": "crash", "ranks": [0], "iteration": 4}]}, "npz"),
}


@pytest.mark.parametrize("name", sorted(WORLD1))
def test_run_faulted_world1_equals_jax(name, world1, tmp_path, no_sleep):
    """fail_fast (delays ride the samples and the fault_delay_us
    timer), retry (same world, one retry) and the checkpoint pathway
    at world 1: every fault global equal to JAX's but measured
    times."""
    from dlnetbench_tpu.faults import policy as J_policy
    d, backend = WORLD1[name]
    cfg, jcfg = _cfgs()
    plan, jplan, _ = _both(d)
    kw, jkw = {}, {}
    if backend:
        kw["checkpoint"] = T_policy.CheckpointPolicy(
            dir=tmp_path / "p", every=2, mode="stall", backend=backend)
        jkw["checkpoint"] = J_policy.CheckpointPolicy(
            dir=tmp_path / "j", every=2, mode="stall", backend=backend)
    got = T_policy.run_faulted("dp", _port_bundle(world1, cfg), cfg, plan,
                               **kw)
    want = J_policy.run_faulted("dp", _jax_bundle(jcfg), jcfg, jplan,
                                **jkw)
    for k in FAULT_KEYS:
        assert got.global_meta.get(k) == want.global_meta.get(k), k
    assert got.global_meta["fault_injected_delay_us"] \
        == want.global_meta["fault_injected_delay_us"]
    assert got.num_runs == want.num_runs == cfg.runs
    assert got.timers_us["fault_delay_us"] == want.timers_us["fault_delay_us"]
    assert len(got.timers_us["runtimes"]) == cfg.runs
    for k in ("detection_ms", "recovery_ms", "restore_ms"):
        assert (k in got.global_meta) == (k in want.global_meta), k
    if backend:
        assert sorted(os.listdir(tmp_path / "p")) \
            == sorted(os.listdir(tmp_path / "j"))


def test_crash_fail_fast_propagates(world1):
    cfg, _ = _cfgs()
    plan = FaultPlan.from_dict({"events": [{"kind": "crash", "ranks": [0],
                                            "iteration": 2}]})
    with pytest.raises(T_inject.RankFailure, match="rank 0"):
        T_policy.run_faulted("dp", _port_bundle(world1, cfg), cfg, plan)


def test_checkpoint_policy_requires_declared_state(world1, tmp_path):
    cfg, _ = _cfgs()
    plan = FaultPlan.from_dict(SHRINK)
    bundle = dataclasses.replace(_port_bundle(world1, cfg), state=None)
    with pytest.raises(ValueError, match="checkpointable state"):
        T_policy.run_faulted("dp", bundle, cfg, plan, rebuild=lambda s: s,
                             checkpoint=T_policy.CheckpointPolicy(
                                 dir=tmp_path / "ck"))


def test_dp_state_is_jax_shaped(world1):
    """dp declares its state as JAX's does: {grads: [...], burn_state}."""
    from dlnetbench_tpu_torch.utils.checkpoint import flatten
    cfg, jcfg = _cfgs()
    got, want = _port_bundle(world1, cfg).state, _jax_bundle(jcfg).state
    assert sorted(got) == sorted(want) == ["burn_state", "grads"]
    import jax
    leaves = flatten(got)
    jleaves = jax.tree.leaves(want)
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape)
                                                for a in jleaves]
    assert [str(t.dtype).removeprefix("torch.") for t in leaves] \
        == [str(a.dtype) for a in jleaves]


# ------------------------------------------------------- four ranks
# the FSDP run's survivors build groups of their own (the mesh's dp
# axis), which the bystander does not make: the rejoin's full-world
# build must still name its groups alike on every rank.  The async dcp
# preempt drains at the eviction while the saves after steps 1 and 3
# are still on the writer thread (held there), whose collectives share
# the drain's group.
RUNS = {
    "shrink": [*CLI_BASE, "--fault", json.dumps(SHRINK), "--checkpoint_dir",
               "{d}/ck_s", *CKPT, "--checkpoint_backend", "dcp"],
    "preempt": [*CLI_BASE, "--fault", json.dumps(PREEMPT),
                "--checkpoint_dir", "{d}/ck_p", *CKPT,
                "--checkpoint_backend", "npz"],
    "preempt_async": [*CLI_BASE, "--fault", json.dumps(PREEMPT),
                      "--checkpoint_dir", "{d}/ck_a", "--checkpoint_every",
                      "2", "--checkpoint_mode", "async",
                      "--checkpoint_backend", "dcp"],
    "fsdp_preempt": ["fsdp", "--num_units", "4", *FLAGS, "--fault",
                     json.dumps(PREEMPT)],
}


WRITER_HOLD_S = 0.3


def _held_on_the_writer(save, rank: int):
    """``save`` held ``WRITER_HOLD_S`` when the async writer thread of a
    rank but rank 0 calls it: the async run's periodic saves are still
    in flight when the eviction's drain decides, rank 0's writer inside
    dcp's collectives on the group the drain's broadcast takes."""
    def held(*args, **kwargs):
        if rank and threading.current_thread().name == "ckpt-writer":
            time.sleep(WRITER_HOLD_S)
        return save(*args, **kwargs)
    return held


def _gloo_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the 4-process world: ``cli dp`` under each fault
    run, rank 0 appending the records."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.utils import checkpoint
    multihost.initialize("cpu")
    dcp_save = checkpoint._dcp_save
    try:
        for key, argv in RUNS.items():
            argv = [a.replace("{d}", out_dir) for a in argv]
            checkpoint._dcp_save = (_held_on_the_writer(dcp_save, rank)
                                    if key == "preempt_async" else dcp_save)
            cli.main([*argv, "--out", str(Path(out_dir) / f"{key}.jsonl")])
    finally:
        checkpoint._dcp_save = dcp_save
        multihost.shutdown()


@pytest.fixture(scope="module")
def gloo_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("faults4")
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
    return {k: json.loads((out / f"{k}.jsonl").read_text())
            for k in RUNS}, out


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    from dlnetbench_tpu import cli as jax_cli
    out = tmp_path_factory.mktemp("faults_jax")
    recs = {}
    for key, argv in RUNS.items():
        argv = [a.replace("{d}", str(out)).replace("dcp", "npz")
                for a in argv]
        path = out / f"{key}.jsonl"
        assert jax_cli.main([*argv, "-d", str(WORLD), "--out",
                             str(path)]) == 0
        recs[key] = json.loads(path.read_text())
    return recs


GLOBALS = ("fault_plan", "fault_policy", "degraded_world",
           "fault_iteration", "fault_retries", "lost_steps",
           "fault_rejoin_step", "checkpoint_saves", "checkpoint_every",
           "checkpoint_mode", "checkpoint_drain_saved",
           "goodput_useful_steps", "world_size", "fault_injected_delay_us")


@pytest.mark.parametrize("key", sorted(RUNS))
def test_four_rank_fault_globals_equal_jax(gloo_records, jax_records, key):
    got, want = gloo_records[0][key], jax_records[key]
    assert got["section"] == want["section"]
    for k in GLOBALS:
        assert got["global"].get(k) == want["global"].get(k), k
    for k in ("detection_ms", "recovery_ms", "restore_ms", "rejoin_ms",
              "goodput", "checkpoint_ms", "checkpoint_stall_ms"):
        assert (k in got["global"]) == (k in want["global"]), k
    assert got["num_runs"] == want["num_runs"] == 8
    assert [r["rank"] for r in got["ranks"]] \
        == [r["rank"] for r in want["ranks"]]
    for row in got["ranks"]:
        assert len(row["runtimes"]) == got["num_runs"]


def test_shrink_leaves_the_dead_rank_out(gloo_records):
    rec = gloo_records[0]["shrink"]
    assert [r["rank"] for r in rec["ranks"]] == [0, 1, 3]
    assert [r["process_index"] for r in rec["ranks"]] == [0, 1, 3]
    assert rec["global"]["checkpoint_backend"] == "dcp"
    assert rec["mesh"]["num_devices"] == 3


def test_rejoined_rank_row_says_whose_samples_it_carries(gloo_records):
    rec = gloo_records[0]["preempt"]
    assert "degraded_world" not in rec["global"]
    rows = {r["rank"]: r for r in rec["ranks"]}
    # seg1: 4 runs; seg2 (rank 2 out): 1 run, from rank 0's timers
    assert rows[2]["fault"] == {"absent_runs": [4, 5], "runs_from_rank": 0}
    assert rows[2]["runtimes"][4] == rows[0]["runtimes"][4]
    assert all("fault" not in rows[r] for r in (0, 1, 3))
    # each rank kept its own npz files, JAX's layout under rank<r>/
    ck = gloo_records[1] / "ck_p"
    assert sorted(os.listdir(ck)) == [f"rank{r}" for r in range(WORLD)]
    assert sorted(os.listdir(ck / "rank0")) == ["11.npz", "7.npz", "9.npz"]


@pytest.mark.parametrize("key", sorted(RUNS))
def test_four_rank_records_load_through_both_pipelines(gloo_records,
                                                       jax_records, key):
    """Both records load through the port's parser, merge and goodput
    fit, and the port's through JAX's parser."""
    from dlnetbench_tpu.metrics.parser import \
        records_to_dataframe as jax_frame
    from dlnetbench_tpu_torch.analysis import goodput
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe
    got = gloo_records[0][key]
    for rec in (got, jax_records[key]):
        df = records_to_dataframe([rec])
        assert len(df) == len(rec["ranks"]) * rec["num_runs"]
    assert len(jax_frame([got])) == len(got["ranks"]) * 8
    merged = merge_records([got])
    assert [r["rank"] for r in merged["ranks"]] \
        == [r["rank"] for r in got["ranks"]]
    if key in ("preempt", "preempt_async"):  # checkpointed + rejoin
        assert goodput._goodput_records([got, jax_records[key]]) \
            == [got, jax_records[key]]
        model = goodput.fit_costs([got])
        assert model is not None


def test_proxy_summary_prints_the_fault_columns(gloo_records, capsys):
    """``proxy_summary`` on a faulted record: its fault globals, the
    surviving ranks and the amplification (none for a crash)."""
    from dlnetbench_tpu_torch import proxy_summary
    out = gloo_records[1]
    assert proxy_summary.main([str(out / "shrink.jsonl")]) == 0
    line = json.loads(capsys.readouterr().out)
    g = gloo_records[0]["shrink"]["global"]
    assert line["fault"]["degraded_world"] == [0, 1, 3]
    assert line["fault"]["ranks"] == [0, 1, 3]
    assert line["fault"]["straggler_amp"] is None
    for k in ("recovery_ms", "restore_ms", "lost_steps",
              "checkpoint_saves"):
        assert line["fault"][k] == g[k], k
