"""The resilience layer on a CUDA card: the step watchdog firing while
the host waits on the device, snapshot checkpoints of card tensors
restored bit for bit (npz and dcp, stall and async), a faulted DP run at
world 1 (NCCL) with its delay inside the timed window and a crash under
``retry``, and the bench's 8-bit chain products against their plain
versions.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU path is held against the JAX package in
tests/test_torch_faults.py, tests/test_torch_checkpoint.py,
tests/test_torch_watchdog.py and tests/test_torch_bench_lines.py."""
from __future__ import annotations

import json
import statistics

import pytest
import torch

from dlnetbench_tpu_torch.faults.plan import FaultPlan
from dlnetbench_tpu_torch.utils import checkpoint as ckpt
from dlnetbench_tpu_torch.utils.watchdog import StepWatchdog

# ~1 s of device time at the H100's clocks (1.98 GHz boost)
SPIN_CYCLES = 2_000_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device waits, NCCL and the "
                    "card's 8-bit products run only there (the CPU path "
                    "is tested against JAX in tests/test_torch_faults.py "
                    "and its siblings)")
    return torch.device("cuda")


@pytest.fixture
def world1(cuda_device):
    """A one-rank NCCL group (owned: torn down after)."""
    from dlnetbench_tpu_torch.parallel import multihost
    owned = not torch.distributed.is_initialized()
    device = multihost.initialize("cuda")
    yield device
    if owned:
        multihost.shutdown()


@pytest.mark.cuda
def test_watchdog_fires_while_the_host_waits_on_the_card(cuda_device,
                                                         tmp_path):
    """A synchronize releases the interpreter lock: the timer thread
    fires during a device spin that outlasts the deadline, once, and the
    flight recorder dumps flight_stall.json."""
    from dlnetbench_tpu_torch.metrics import telemetry
    fired = []
    telemetry.enable(capacity=16, dump_dir=tmp_path)
    try:
        telemetry.record_step("proxy", step=0, step_wall_us=1000.0)
        wd = StepWatchdog(0.1, name="device_spin",
                          on_stall=lambda n, e: fired.append(e))
        with wd:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
    finally:
        telemetry.disable()
    assert wd.stalls == 1 and len(fired) == 1 and fired[0] >= 0.1
    dump = json.loads((tmp_path / "flight_stall.json").read_text())
    assert dump["detail"]["section"] == "device_spin"


def _card_state(device):
    g = torch.Generator(device=device).manual_seed(5)
    return {"grads": [torch.randn(1000, generator=g, device=device),
                      torch.randn(77, generator=g, device=device)],
            "burn_state": torch.randn(64, 64, generator=g,
                                      device=device).to(torch.bfloat16),
            "act": torch.randn(300, generator=g,
                               device=device).to(torch.float8_e4m3fn)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.element_size() == 1 else \
        t.view(torch.int16) if t.element_size() == 2 else t


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stall", "async"])
@pytest.mark.parametrize("backend", ["npz", "dcp"])
def test_snapshot_restores_the_card_state_bit_exact(cuda_device, tmp_path,
                                                    backend, mode):
    """The state at the saved step, not after: later in-place updates on
    the card are not in the snapshot; the restore lands on the card with
    the template's dtypes, bit for bit."""
    live = _card_state(cuda_device)
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", live, every=1,
                                   mode=mode, backend=backend)
    sc.on_step(0)
    at0 = [t.clone() for t in ckpt.flatten(live)]
    live["burn_state"].mul_(2)
    live["grads"][0].add_(1)
    sc.wait()
    restored, step = sc.restore(live)
    assert step == 0 and sc.saves == 1
    for got, want in zip(ckpt.flatten(restored), at0):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_fault_delay_lands_in_the_timed_window(world1):
    """A delay plan's sleep inflates the timed DP step by the delay (the
    card idles under the host's sleep) and fills the fault_delay_us
    timer; the compute leg stays clean."""
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.faults.inject import FaultInjector
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig, run_proxy
    cfg = ProxyConfig(warmup=1, runs=6, size_scale=1e-3, time_scale=1e-3)
    bundle = dp.build(load_model_stats("llama3_8b_16_bfloat16"), 2, cfg,
                      make_flat_mesh(world1))
    plan = FaultPlan.from_dict({"events": [
        {"kind": "delay", "iteration": 4, "magnitude_us": 20000.0}]})
    res = run_proxy("dp", bundle, ProxyConfig(
        warmup=1, runs=6, fault_injector=FaultInjector(plan)))
    assert res.timers_us["fault_delay_us"] == [0.0] * 3 + [20000.0] * 3
    rt = res.timers_us["runtimes"]
    inflation = statistics.median(rt[3:]) - statistics.median(rt[:3])
    assert abs(inflation - 20000.0) <= 2000.0
    comp = res.timers_us["compute_time"]
    assert max(comp) < 0.5 * min(rt[3:])


@pytest.mark.cuda
def test_crash_under_retry_finishes_on_the_card(world1, tmp_path):
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.faults.policy import (CheckpointPolicy,
                                                    run_faulted)
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    cfg = ProxyConfig(warmup=1, runs=6, size_scale=1e-3, time_scale=1e-3)
    bundle = dp.build(load_model_stats("llama3_8b_16_bfloat16"), 2, cfg,
                      make_flat_mesh(world1))
    plan = FaultPlan.from_dict({"policy": "retry", "events": [
        {"kind": "crash", "ranks": [0], "iteration": 5}]})
    res = run_faulted("dp", bundle, cfg, plan,
                      checkpoint=CheckpointPolicy(dir=tmp_path / "ck",
                                                  every=2, mode="async"))
    g = res.global_meta
    assert g["fault_retries"] == 1 and g["fault_iteration"] == 5
    assert res.num_runs == 6 and len(res.timers_us["runtimes"]) == 6
    # steps 0-4, then 6-8 after the retry: saves after 1, 3 and 7
    assert g["checkpoint_saves"] == 3 and g["checkpoint_backend"] == "dcp"
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) \
        == ["1", "3", "7"]


@pytest.mark.cuda
def test_int8_chain_product_is_exact_on_the_card(cuda_device):
    """The int8 line's ``torch._int_mm`` product equals the exact
    integer sum."""
    from dlnetbench_tpu_torch.ops import int8
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randint(-127, 128, (256, 1024), generator=g,
                      device=cuda_device, dtype=torch.int8)
    w = torch.randint(-127, 128, (1024, 512), generator=g,
                      device=cuda_device, dtype=torch.int8)
    got = int8.int32_product(a, w.t().contiguous().t())
    want = a.cpu().to(torch.int64) @ w.cpu().to(torch.int64)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu().to(torch.int64), want)


@pytest.mark.cuda
def test_e4m3_chain_dot_on_the_card_matches_its_plain_version(cuda_device):
    """The 8-bit lines' composed e4m3 product (``torch._scaled_mm``,
    unit scales, f32 out, the JAX epilogue) against the same recipe's
    plain CPU version: every row within 2^-6 of its max-abs (the two
    sum the same e4m3 products in f32 in another order, then round to
    bf16)."""
    from dlnetbench_tpu_torch import bench
    g = torch.Generator().manual_seed(2)
    x = torch.randn(256, 512, generator=g).to(torch.bfloat16)
    w = (torch.randn(512, 384, generator=g) * 0.02).to(torch.bfloat16)
    got = bench._e4m3_chain_dot(w.to(cuda_device))(x.to(cuda_device))
    want = bench._e4m3_chain_dot(w)(x)
    got, want = got.float().cpu(), want.float()
    row_max = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-6)
    assert ((got - want).abs() <= 2.0 ** -6 * row_max).all()
