"""The proxies' device path on a CUDA card: the burn's captured CUDA
graphs against its eager chain, NCCL's collectives at world 1 for each
buffer dtype, and the DP and FSDP proxies at world 1 (NCCL) through
``cli.main`` at a tiny size.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py`` (``chip_smoke.py`` runs it so).  Every case
takes the ``cuda_device`` fixture, which skips where no card is
visible; the CPU path is held against the JAX package in
tests/test_torch_proxies.py."""
from __future__ import annotations

import json

import pytest
import torch

from dlnetbench_tpu_torch import cli
from dlnetbench_tpu_torch.parallel import collectives as col
from dlnetbench_tpu_torch.parallel import multihost
from dlnetbench_tpu_torch.proxies import burn as burnlib

TINY = ["--size_scale", "1e-5", "--time_scale", "2e-4", "-w", "1", "-r",
        "3", "--buffer_dtype", "bfloat16"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the burn's CUDA graphs and NCCL run "
                    "only there (the CPU path is tested against JAX in "
                    "tests/test_torch_proxies.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, burnlib.CHUNK + 37])
def test_graph_burn_is_bitwise_the_eager_burn(cuda_device, iters):
    graphed, eager = burnlib.Burner(cuda_device), burnlib.Burner(cuda_device)
    graphed(iters)
    eager.eager(iters)
    torch.cuda.synchronize()
    assert torch.equal(graphed.state, eager.state)
    # and the eager chain on the card against the CPU's, same rounding
    # points (f32 sums in another order): within 2^-6 of the max-abs
    cpu = burnlib.Burner("cpu")
    cpu.eager(iters)
    ref = cpu.state.float()
    err = float((eager.state.cpu().float() - ref).abs().max())
    assert err <= 2.0 ** -6 * float(ref.abs().max())


@pytest.mark.cuda
def test_calibration_maps_time_to_iterations_on_card(cuda_device):
    cal = burnlib.calibrate(burnlib.Burner(cuda_device))
    assert cal.device_kind == torch.cuda.get_device_name(cuda_device)
    assert 0 < cal.ns_per_iter < 1e6
    assert cal.iters_for_us(cal.us_for_iters(1000)) == 1000


@pytest.mark.cuda
@pytest.mark.parametrize("proxy,extra,per_step", [
    ("dp", ["--num_buckets", "4"], {"allreduce": 4}),
    ("fsdp", ["--num_units", "4"], {"allgather": 7, "reduce_scatter": 4}),
])
def test_proxy_world1_on_card(cuda_device, tmp_path, proxy, extra,
                              per_step):
    out = tmp_path / "rec.jsonl"
    col.reset_counts()
    assert cli.main([proxy, "--model", "gpt2_l_16_bfloat16", *extra, *TINY,
                     "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    g, row = rec["global"], rec["ranks"][0]
    assert g["world_size"] == 1 and rec["mesh"]["platform"] == "gpu"
    assert rec["mesh"]["device_kind"] == torch.cuda.get_device_name(0)
    for t in ("runtimes", "compute_time", "barrier_time", "comm_time"):
        assert len(row[t]) == 3 and all(v >= 0 for v in row[t]), t
    # full: build + 1 warmup + 3 runs; comm-only and the FSDP variant
    # holding each kind: build + 1 warm + 3 runs
    calls = 5 + 5 + (5 if proxy == "fsdp" else 0)
    assert {k: v for k, v in col.counts().items() if v} == {
        k: v * calls for k, v in per_step.items()}


@pytest.fixture
def nccl_world1(cuda_device):
    """A one-rank NCCL group on the card, torn down after the case."""
    device = multihost.initialize("cuda")
    yield device
    multihost.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(cli.BUFFER_DTYPES))
def test_nccl_collectives_per_buffer_dtype(nccl_world1, name):
    """Every --buffer_dtype NCCL takes (float8 is e4m3) through
    allreduce, allgather and reduce-scatter at world 1, against JAX's
    psum, all_gather(tiled) and psum_scatter(tiled) over one device,
    which return their input: integers in [-16, 16], exact in every
    dtype."""
    dtype = getattr(torch, cli.BUFFER_DTYPES[name])
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(-16, 17, (4096,), generator=gen).to(dtype)
    ar = x.to(nccl_world1)
    ag = torch.empty_like(ar)
    rs = torch.empty_like(ar)
    col.allreduce(ar)
    col.allgather(ag, x.to(nccl_world1))
    col.reduce_scatter(rs, x.to(nccl_world1))
    torch.cuda.synchronize()
    for got in (ar, ag, rs):
        assert got.dtype == dtype
        assert torch.equal(got.cpu().float(), x.float())


@pytest.mark.cuda
@pytest.mark.parametrize("proxy,extra", [
    ("dp", ["--num_buckets", "2"]),
    ("fsdp", ["--num_units", "2"]),
])
def test_float8_buffers_on_card(cuda_device, tmp_path, proxy, extra):
    """--buffer_dtype float8 runs on NCCL with e4m3 buffers: half the
    bf16 run's bytes, the dtype named in the record."""
    recs = {}
    for name in ("bfloat16", "float8"):
        out = tmp_path / f"{name}.jsonl"
        flags = [a if a != "bfloat16" else name for a in TINY]
        assert cli.main([proxy, "--model", "gpt2_l_16_bfloat16", *extra,
                         *flags, "--out", str(out)]) == 0
        recs[name] = json.loads(out.read_text())["global"]
    assert recs["float8"]["buffer_dtype"] == "float8"
    key = "bucket_bytes" if proxy == "dp" else "shard_bytes"
    half = ([b // 2 for b in recs["bfloat16"][key]] if proxy == "dp"
            else recs["bfloat16"][key] // 2)
    assert recs["float8"][key] == half
