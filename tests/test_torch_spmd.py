"""The port's SPMD train step (``models/spmd.py``) against the JAX
package's, on the CPU: four gloo processes on mesh ``(1, 2, 2)`` against
``shard_map`` on four virtual devices, the same numpy weights and
tokens, one f32 step per configuration — the loss within 1e-5 relative,
every updated leaf within 1e-5 of its max-abs (JAX's 1e-4 where the
decomposed ring sums differ in order), and each leaf's update (new -
old) within 1e-3 of its own max-abs, which a gradient scaled by a mesh
axis would break.  Also the three A/B variants' leaf shapes.

The four ranks run ``spmd_worker`` in spawned processes, which import
this module: jax and the JAX package are imported inside the tests and
fixtures only, never at module level.  ``tests/test_torch_spmd_dp.py``
runs the same cases on mesh ``(2, 1, 2)``."""
from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.utils.net import free_port

WORLD = 4
BASE = dict(num_layers=2, capacity_factor=8.0)
FINITE = dict(num_layers=2, capacity_factor=1.0, moe_drop_seed=11,
              moe_group_tokens=8)
LAYER_KEYS = ("wq", "wk", "wv", "wo", "norm1", "norm2", "w_router",
              "w_gate", "w_up", "w_down")

# label -> (config knobs, variant); every mesh runs these
STEP_CASES = {
    "megatron": (dict(BASE), "full"),
    "ring+bucketed": (dict(BASE, sp_mode="ring", grad_sync="bucketed"),
                      "full"),
    "ulysses+decomposed_head": (dict(BASE, sp_mode="ulysses",
                                     tp_overlap="decomposed"), "full"),
    "decomposed+bucketed": (dict(BASE, tp_overlap="decomposed",
                                 grad_sync="bucketed"), "full"),
    "mlp_int8+finite": (dict(FINITE, mlp_int8=True), "full"),
    "grouped+a2a_decomposed+finite": (dict(FINITE, moe_ffn_impl="grouped",
                                           moe_a2a="decomposed",
                                           moe_chunks=2), "full"),
}
# extra cases of one mesh: masks and the A/B variants
MASK_CASES = {
    "ring+window": (dict(BASE, sp_mode="ring", attention_window=8), "full"),
    "megatron+segments": (dict(BASE, attention_seg_avg=12,
                               attention_seg_seed=4), "full"),
}
VARIANT_CASES = {
    "variant=compute": (dict(BASE, tp_overlap="decomposed"), "compute"),
    "variant=comm": (dict(BASE, tp_overlap="decomposed"), "comm"),
}
DECOMPOSED_TOL = 1e-4   # JAX's dryrun bar for the ring-ordered sums
TOL = 1e-5


def numpy_params(cfg_kw: dict, seed: int = 0) -> dict:
    """Seeded global weights in the JAX package's stacked layout."""
    from dlnetbench_tpu_torch.models.spmd import SpmdConfig
    cfg = SpmdConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    d, dh = cfg.embed_dim, cfg.head_dim
    dkv = cfg.num_kv_heads * dh
    h, nl, v, e = cfg.ff_dim, cfg.num_layers, cfg.vocab_size, \
        cfg.num_experts

    def dense(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    s_d, s_h = 1 / math.sqrt(d), 1 / math.sqrt(h)
    return {
        "embed": dense((v, d), 1.0),
        "layers": {
            "wq": dense((nl, d, d), s_d), "wk": dense((nl, d, dkv), s_d),
            "wv": dense((nl, d, dkv), s_d), "wo": dense((nl, d, d), s_d),
            "norm1": 1 + dense((nl, d), 0.1),
            "norm2": 1 + dense((nl, d), 0.1),
            "w_router": dense((nl, d, e), s_d),
            "w_gate": dense((nl, e, d, h), s_d),
            "w_up": dense((nl, e, d, h), s_d),
            "w_down": dense((nl, e, h, d), s_h),
        },
        "final_norm": 1 + dense((d,), 0.1),
        "head": dense((d, v), s_d),
    }


def numpy_tokens(cfg_kw: dict, seed: int = 1) -> np.ndarray:
    from dlnetbench_tpu_torch.models.spmd import SpmdConfig
    cfg = SpmdConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size,
                        (cfg.batch, cfg.seq_len + 1)).astype(np.int32)


def run_step_cases(mesh_shape, cases: dict) -> dict:
    """On every rank: each case's one step; rank 0's result per case is
    ``(loss, global updated tree)``."""
    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.parallel import multihost
    out = {}
    for label, (kw, variant) in cases.items():
        mesh = spmd.grid_mesh(*mesh_shape, torch.device("cpu"))
        cfg = spmd.SpmdConfig(**kw)
        params = spmd.params_from_numpy(numpy_params(kw), mesh, cfg)
        step = spmd.make_train_step(mesh, cfg, variant)
        tokens = torch.from_numpy(numpy_tokens(kw)).long()
        new, loss = step(params, tokens)
        if variant == "full":
            out[label] = (float(loss), spmd.gather_params(new, mesh, cfg))
        else:
            shapes = {k: tuple(new[k].shape)
                      for k in ("embed", "final_norm", "head")}
            shapes["layers"] = [{k: tuple(v.shape) for k, v in lp.items()}
                                for lp in new["layers"]]
            out[label] = (float(loss), multihost.all_ranks(shapes))
    return out


def spmd_worker(rank: int, port: int, out_dir: str, mesh_shape,
                cases: dict, extra=None) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from dlnetbench_tpu_torch import ops
    from dlnetbench_tpu_torch.parallel import multihost
    attention = ops.attention

    def contiguous_attention(q, k, v, *args, **kw):
        # the card's flash kernels refuse strided operands, which the
        # CPU's plain version would take
        assert all(t.is_contiguous() for t in (q, k, v)), \
            "ops.attention got a strided operand"
        return attention(q, k, v, *args, **kw)

    ops.attention = contiguous_attention
    multihost.initialize("cpu")
    res = run_step_cases(mesh_shape, cases)
    if extra is not None:
        res.update(extra(rank, out_dir))
    if rank == 0:
        with open(Path(out_dir) / "rank0.pkl", "wb") as f:
            pickle.dump(res, f)
    finished(rank, out_dir)
    multihost.shutdown()


def finished(rank: int, out_dir: str) -> None:
    """A rank's last collective is done: what the world computed is
    complete, whatever the group's teardown does after."""
    (Path(out_dir) / f"rank{rank}.done").touch()


def _guarded(target, rank: int, port: int, out_dir: str, *args) -> None:
    """``target``'s rank, its traceback kept in ``rank<r>.err``."""
    import traceback
    try:
        target(rank, port, out_dir, *args)
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise


# the store's port was taken between free_port() and its bind
PORT_TAKEN = ("EADDRINUSE", "Address already in use")


def spawn_world(out: Path, target, args: tuple, timeout: float = 300):
    """Run ``target(rank, port, str(out), *args)`` on four spawned ranks;
    returns rank 0's pickle.  A world whose store lost its port to
    another process is started once more on a new one."""
    ctx = multiprocessing.get_context("spawn")
    for attempt in (1, 2):
        port = free_port()
        procs = [ctx.Process(target=_guarded,
                             args=(target, r, port, str(out), *args))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=timeout)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        assert not alive, f"gloo ranks {alive} did not finish"
        errs = [f.read_text() for f in sorted(out.glob("rank*.err"))]
        for f in out.glob("rank*.err"):
            f.unlink()
        done = sorted(f.name for f in out.glob("rank*.done"))
        for f in out.glob("rank*.done"):
            f.unlink()
        if attempt == 1 and any(w in e for e in errs for w in PORT_TAKEN):
            continue
        codes = [p.exitcode for p in procs]
        if codes != [0] * WORLD and len(done) == WORLD and not errs:
            # every rank finished its last collective and raised nothing:
            # the group's teardown at exit failed, not the computation
            warnings.warn(f"gloo ranks exited {codes} after finishing")
            break
        assert codes == [0] * WORLD, "\n".join(errs)[-4000:]
        break
    with open(out / "rank0.pkl", "rb") as f:
        return pickle.load(f)


def jax_step(mesh_shape, kw: dict, variant: str = "full"):
    """The JAX package's step on four virtual devices: (loss, updated
    global tree as numpy)."""
    import jax
    import jax.numpy as jnp

    from dlnetbench_tpu.models import spmd as J
    from dlnetbench_tpu.parallel.mesh import make_grid_mesh
    dp, pp, tp = mesh_shape
    mesh = make_grid_mesh(dp=dp, pp=pp, tp=tp, devices=jax.devices()[:WORLD])
    cfg = J.SpmdConfig(**kw)
    step = J.make_train_step(mesh, cfg, variant=variant)
    params = jax.tree.map(jnp.asarray, numpy_params(kw))
    new, loss = step(params, jnp.asarray(numpy_tokens(kw)))
    return float(loss), jax.tree.map(np.asarray, new)


def check_step(label: str, kw: dict, got, want) -> None:
    (tl, tree), (jl, jtree) = got, want
    tol = DECOMPOSED_TOL if (kw.get("tp_overlap") == "decomposed"
                             or kw.get("moe_a2a") == "decomposed") else TOL
    assert math.isfinite(tl) and abs(tl - jl) <= TOL * abs(jl), \
        f"{label}: loss {tl} vs JAX {jl}"
    start = numpy_params(kw)
    for key in ("embed", "final_norm", "head", *LAYER_KEYS):
        if key in LAYER_KEYS:
            a, b, p0 = tree["layers"][key], jtree["layers"][key], \
                start["layers"][key]
        else:
            a, b, p0 = tree[key], jtree[key], start[key]
        assert a.shape == b.shape, f"{label} {key}: {a.shape} vs {b.shape}"
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, \
            f"{label} {key}: {err:.3e} of max-abs {scale:.3e} (bar {tol})"
        upd_t, upd_j = a - p0, b - p0
        uscale = float(np.abs(upd_j).max())
        uerr = float(np.abs(upd_t - upd_j).max())
        assert uerr <= 1e-3 * uscale + 1e-7, \
            f"{label} {key}: update off by {uerr:.3e} of {uscale:.3e}"


@pytest.fixture(scope="module")
def torch_steps(tmp_path_factory):
    cases = {**STEP_CASES, **MASK_CASES, **VARIANT_CASES}
    return spawn_world(tmp_path_factory.mktemp("spmd122"), spmd_worker,
                       ((1, 2, 2), cases))


@pytest.mark.parametrize("label", [*STEP_CASES, *MASK_CASES])
def test_step_equals_jax(torch_steps, eight_devices, label):
    kw, variant = {**STEP_CASES, **MASK_CASES}[label]
    check_step(label, kw, torch_steps[label], jax_step((1, 2, 2), kw,
                                                       variant))


@pytest.mark.parametrize("variant", ["compute", "comm"])
def test_variants_leaf_shapes_equal_jax(torch_steps, eight_devices,
                                        variant):
    """The A/B legs keep every leaf's shape (the port's per-layer leaves
    stacked back against JAX's ``[L, ...]``); their values are wrong by
    construction and only their wall time is read."""
    import jax

    from dlnetbench_tpu.models import spmd as J
    kw, _ = VARIANT_CASES[f"variant={variant}"]
    loss, per_rank = torch_steps[f"variant={variant}"]
    assert math.isfinite(loss)
    _, jtree = jax_step((1, 2, 2), kw, variant)
    specs = J.param_specs(kw.get("sp_mode", "megatron"))
    mesh_axes = {"dp": 1, "pp": 2, "tp": 2}
    for shapes in per_rank:
        for key in ("embed", "final_norm", "head"):
            want = list(jtree[key].shape)
            for dim, ax in enumerate(specs[key]):
                if ax is not None:
                    want[dim] //= mesh_axes[ax]
            assert list(shapes[key]) == want, key
        assert len(shapes["layers"]) == 1      # 2 layers over 2 stages
        for key in LAYER_KEYS:
            want = list(jtree["layers"][key].shape)
            for dim, ax in enumerate(specs["layers"][key]):
                if ax is not None:
                    want[dim] //= mesh_axes[ax]
            assert list(shapes["layers"][0][key]) == want[1:], key
