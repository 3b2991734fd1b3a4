"""The native tier's card flavour on a CUDA card: the build (``nvcc``
for the burn kernel, the C++ binaries against the CUDA runtime), the
NCCL it loads (torch's, the same version), ``nccl_selftest`` at world 1
(at world 2 too where two cards are visible), the burn kernel against
the port's torch chain from the same state (and wrong chains missing
it), burns that land where asked, the burn's start beside held SMs, a dp
run with no host/device copy in its timed runs, and ``--backend nccl``
refusing a missing ``$DLNB_NCCL_LIB`` by name.

This file imports neither jax nor the JAX package, so it runs on the
card machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_card*.py``.  Every case takes the ``cuda_device``
fixture, which skips where no card is visible; the tier's CPU runs are
in tests/test_torch_native.py and tests/test_torch_native_nccl.py."""
from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.utils import native_build

REPO = Path(__file__).resolve().parent.parent
# the burn state after a few iterations, kernel against the torch chain
# (summation order differs; bf16 state): max-abs within BURN_TOL of the
# chain's own max-abs.  The check's state (nccl_probe's check_state) is
# positive and rank one with a first product of order one: its chain
# reaches BURN_BENT after 1 iteration and stays a normal number, at least
# BURN_FLOOR, after 8.
BURN_TOL, BURN_BENT, BURN_FLOOR = 2.0 ** -6, 0.5, 1e-30
# chains from the same state that the bar must tell from the right one
WRONG_CHAINS = {
    "no tanh": lambda x: (x @ x / 256).clamp(-1, 1),
    "transposed": lambda x: torch.tanh(x.T @ x / 256),
    "scale 1/128": lambda x: torch.tanh(x @ x / 128),
    "zeros": lambda x: torch.zeros_like(x),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the nccl fabric and the burn "
                    "kernel run on the card only (the host double is "
                    "tested in tests/test_torch_native_nccl.py)")
    return torch.device("cuda")


@pytest.fixture
def card_bin(cuda_device):
    return native_build.native_bin(REPO, flavour="cuda")


def _run(binary: Path, *args, env=None, timeout=300):
    return subprocess.run([str(binary), *map(str, args)], capture_output=True,
                          text=True, timeout=timeout,
                          env=env or native_build.nccl_env())


def _json(out) -> dict:
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_card_build_loads_torchs_nccl(card_bin):
    rep = _json(_run(card_bin / "nccl_probe"))
    assert rep["available"] is True and rep["nccl_impl"] == "real"
    want = ".".join(map(str, torch.cuda.nccl.version()))
    assert rep["nccl_version"] == want
    assert rep["device_count"] == torch.cuda.device_count()
    assert rep["cards"][0]["name"] == torch.cuda.get_device_name(0)
    assert rep["burn"]["ns_per_iter"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_nccl_selftest_on_the_card(card_bin, world):
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    rep = _json(_run(card_bin / "nccl_selftest", "--world", world))
    assert rep["ok"] and rep["failures"] == [] and rep["checks"] > 0
    assert rep["nccl_impl"] == "real"


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 2, 8])
def test_burn_kernel_against_the_torch_chain(card_bin, tmp_path, iters):
    from dlnetbench_tpu_torch.proxies.burn import Burner
    out = tmp_path / "burn.bin"
    rep = _json(_run(card_bin / "nccl_probe", "--burn-check", iters,
                     "--seed", 7, "--out", out))
    assert rep["burn"]["check_launches"] == 1
    raw = np.fromfile(out, dtype=np.uint16).astype(np.int16)
    init = torch.from_numpy(raw[:65536]).view(torch.bfloat16)
    fin = torch.from_numpy(raw[65536:]).view(torch.bfloat16)
    b = Burner("cuda")
    b.state.copy_(init.reshape(256, 256).cuda())
    b.eager(iters)
    err = (b.state.float() - fin.reshape(256, 256).cuda().float()).abs()
    scale = b.state.float().abs().max().item()
    assert err.max().item() <= BURN_TOL * scale
    assert init.float().min().item() > 0
    assert scale >= (BURN_BENT if iters == 1 else BURN_FLOOR)
    for name, step in WRONG_CHAINS.items():
        x = init.reshape(256, 256).cuda().float()
        for _ in range(iters):
            x = step(x).to(torch.bfloat16).float()
        miss = (x - b.state.float()).abs().max().item()
        assert miss > BURN_TOL * scale, name


@pytest.mark.cuda
def test_a_short_burn_lands_where_asked(card_bin):
    """Burns shorter than the chain's lead (pod_study's gpt2_l asks 0.7
    and 2.7 us at its default time scale), a few iterations long and 20
    ms long take the time asked on the card, by the burn's clock."""
    rep = _json(_run(card_bin / "nccl_probe", "--burn-ms",
                     "0.0007,0.0027,0.05,20"))
    for row in rep["burn"]["requests"]:
        assert abs(row["clock_ms"] / row["requested_ms"] - 1) <= 0.05, row
    assert rep["burn"]["cluster"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [32, 100])
def test_burn_start_beside_held_sms(card_bin, sms):
    """The burn's cluster needs its SMs free in one GPC at once: beside 32
    SMs held for 1 ms by another stream (NCCL's channels hold up to 32
    CTAs) it starts before they are released; beside 100 it may wait for
    them, and the probe reports when it started."""
    rep = _json(_run(card_bin / "nccl_probe", "--hold-sms", sms))
    (row,) = rep["burn"]["holds"]
    assert row["sms"] == sms and row["started"] == sms
    assert 0 <= row["wait_end_us"] <= row["start_delay_us"]
    if sms == 32:
        assert row["start_delay_us"] < row["hold_us"], row


@pytest.mark.cuda
def test_no_copy_in_a_timed_run(card_bin):
    rec = _json(_run(card_bin / "dp", "--model", "gpt2_l_16_bfloat16",
                     "--world", 1, "--num_buckets", 4, "--backend", "nccl",
                     "--size_scale", "0.1", "--time_scale", "0.1",
                     "--runs", 3, "--warmup", 1, "--no_topology",
                     "--base_path", REPO))
    g = rec["global"]
    assert g["backend"] == "nccl" and g["compute_mode"] == "device_burn"
    assert g["transport"] == "local" and g["device"] == "cuda"
    assert g["timed_copies"] == 0 and g["late_twins"] == 0
    # the 4 buckets' grads and sums, twinned once, zeroed on the card
    # (the host never wrote them)
    assert g["twins"] == 8 and g["h2d_copies"] == 0
    assert g["burn_launches"] > 0
    assert abs(g["burn_device_us"] / g["burn_requested_us"] - 1) <= 0.05


@pytest.mark.cuda
def test_missing_nccl_library_is_named(card_bin, tmp_path):
    missing = tmp_path / "no" / "libnccl.so.2"
    env = {**os.environ, "DLNB_NCCL_LIB": str(missing)}
    out = _run(card_bin / "dp", "--model", "gpt2_l_16_bfloat16", "--world",
               1, "--num_buckets", 1, "--backend", "nccl", "--runs", 1,
               "--no_topology", "--base_path", REPO, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert str(missing) in out.stderr
