"""The port's SPMD train step against the JAX package's on mesh ``(2, 1,
2)`` (dp x tp: the dp gradient sum and the tp collectives together), the
cases and bars of ``tests/test_torch_spmd.py``; and the SPMD
crash-and-resume of ``utils/checkpoint.train_with_checkpointing`` on the
same four gloo ranks (the JAX package's
``tests/test_checkpoint.py::test_spmd_crash_resume_matches_uninterrupted``):
2 steps with a save after each, a "crash", a resume from the latest
save and 2 more, against 4 uninterrupted steps — losses within 1e-5
relative and every leaf within 1e-5, for npz and dcp."""
from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_spmd import (BASE, LAYER_KEYS, STEP_CASES, check_step,
                             jax_step, numpy_params, numpy_tokens,
                             spawn_world, spmd_worker)

MESH = (2, 1, 2)
CKPT_KW = dict(BASE)
CKPT_BACKENDS = ("npz", "dcp")


def ckpt_extra(rank: int, out_dir: str) -> dict:
    """On every rank: 4 straight steps, then for each backend 2 steps
    with saves, a fresh loop resuming from the latest save and 2 more;
    the global trees are gathered on every rank."""
    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.utils import checkpoint as ckpt
    del rank
    mesh = spmd.grid_mesh(*MESH, torch.device("cpu"))
    cfg = spmd.SpmdConfig(**CKPT_KW)
    step = spmd.make_train_step(mesh, cfg)
    tokens = torch.from_numpy(numpy_tokens(CKPT_KW)).long()
    p0 = spmd.params_from_numpy(numpy_params(CKPT_KW), mesh, cfg)
    p_ref, ref_losses = p0, []
    for _ in range(4):
        p_ref, loss = step(p_ref, tokens)
        ref_losses.append(float(loss))
    out = {"ckpt_ref": (ref_losses, spmd.gather_params(p_ref, mesh, cfg))}
    for backend in CKPT_BACKENDS:
        d = Path(out_dir) / f"ckpt_{backend}"
        _, l1, s1 = ckpt.train_with_checkpointing(
            step, p0, tokens, num_steps=2, ckpt_dir=d, save_every=1,
            backend=backend)
        # "crash": a fresh loop from the initial weights resumes
        p2, l2, s2 = ckpt.train_with_checkpointing(
            step, p0, tokens, num_steps=4, ckpt_dir=d, save_every=1,
            backend=backend)
        out[f"ckpt_{backend}"] = (s1, s2, l1 + l2,
                                  spmd.gather_params(p2, mesh, cfg))
    return out


@pytest.fixture(scope="module")
def torch_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("spmd212")
    try:
        return spawn_world(out, spmd_worker, (MESH, STEP_CASES, ckpt_extra))
    finally:
        for backend in CKPT_BACKENDS:
            shutil.rmtree(out / f"ckpt_{backend}", ignore_errors=True)


@pytest.mark.parametrize("label", list(STEP_CASES))
def test_step_equals_jax(torch_steps, eight_devices, label):
    kw, variant = STEP_CASES[label]
    check_step(label, kw, torch_steps[label], jax_step(MESH, kw, variant))


@pytest.mark.parametrize("backend", CKPT_BACKENDS)
def test_spmd_crash_resume_matches_uninterrupted(torch_steps, backend):
    ref_losses, ref_tree = torch_steps["ckpt_ref"]
    s1, s2, losses, tree = torch_steps[f"ckpt_{backend}"]
    assert s1 == 0 and s2 == 2 and len(losses) == 4
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    assert ref_losses[-1] < ref_losses[0]
    for key in ("embed", "final_norm", "head", *LAYER_KEYS):
        a = tree["layers"][key] if key in LAYER_KEYS else tree[key]
        b = ref_tree["layers"][key] if key in LAYER_KEYS else ref_tree[key]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)
