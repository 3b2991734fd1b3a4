"""The port's checkpoint / resume (``utils/checkpoint.py``) against the
JAX package's: both backends (``dcp`` in orbax's seat, ``npz`` in JAX's
layout), npz files restoring bit for bit across the two packages in
both directions (bfloat16 and e4m3 included), the crash-resume loop,
and the in-loop SnapshotCheckpointer (counterparts of the JAX
package's tests/test_checkpoint.py; its SPMD case waits for the port's
``models/spmd.py``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dlnetbench_tpu_torch.utils import checkpoint as ckpt

BACKENDS = ["npz", "dcp"]


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


def _state():
    return {"w": torch.arange(64.0).reshape(8, 8),
            "b": torch.ones((16,), dtype=torch.float32)}


def _equal(a, b) -> None:
    for x, y in zip(ckpt.flatten(a), ckpt.flatten(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           else x, y.view(torch.uint8)
                           if y.element_size() == 1 else y)


def test_save_restore_roundtrip(tmp_path, backend):
    params = {"w": torch.arange(8.0).reshape(2, 4), "b": torch.ones(3)}
    ckpt.save_checkpoint(tmp_path / "c", 5, params, backend=backend)
    assert ckpt.latest_step(tmp_path / "c") == 5
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    restored, step = ckpt.restore_checkpoint(tmp_path / "c", template)
    assert step == 5
    _equal(params, restored)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "int8",
                                   "float32"])
def test_roundtrips_bit_exact(tmp_path, backend, dtype):
    """dtypes numpy cannot serialize (bfloat16, e4m3) round-trip through
    their bit patterns."""
    t = torch.linspace(-3, 3, 16).to(getattr(torch, dtype))
    ckpt.save_checkpoint(tmp_path / "c", 0, {"w": t}, backend=backend)
    restored, _ = ckpt.restore_checkpoint(tmp_path / "c", {"w": t})
    assert restored["w"].dtype == t.dtype
    _equal({"w": t}, restored)


def test_flatten_order_is_jax_tree_order():
    import jax
    tree = {"z": [1, 2], "a": {"c": 3, "b": (4, 5)}, "m": None, "k": 6}
    assert ckpt.flatten(tree) == jax.tree.leaves(tree)
    back = ckpt.unflatten(tree, ckpt.flatten(tree))
    assert back == tree and list(back) == list(tree)


# -------------------------------------------- npz across the packages
def _mixed_numpy():
    rng = np.random.default_rng(3)
    return {"grads": [rng.standard_normal(24).astype(np.float32),
                      rng.standard_normal(10).astype(np.float32)],
            "burn_state": rng.standard_normal((4, 4)).astype(np.float32),
            "act": rng.standard_normal(12).astype(np.float32),
            "q": rng.integers(-127, 128, 9).astype(np.int8)}


def _jax_state(h):
    import jax.numpy as jnp
    return {"grads": [jnp.asarray(g) for g in h["grads"]],
            "burn_state": jnp.asarray(h["burn_state"]).astype(jnp.bfloat16),
            "act": jnp.asarray(h["act"]).astype(jnp.float8_e4m3fn),
            "q": jnp.asarray(h["q"])}


def _port_state(h):
    return {"grads": [torch.from_numpy(g) for g in h["grads"]],
            "burn_state": torch.from_numpy(h["burn_state"]).to(
                torch.bfloat16),
            "act": torch.from_numpy(h["act"]).to(torch.float8_e4m3fn),
            "q": torch.from_numpy(h["q"])}


def _bits_of_jax(state) -> list:
    import jax
    out = []
    for leaf in jax.tree.leaves(state):
        a = np.asarray(leaf)
        out.append(a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "V"
                   else a)
    return out


def _bits_of_port(state) -> list:
    return [ckpt.to_host(t) for t in ckpt.flatten(state)]


def test_npz_written_by_jax_restores_bit_exact_here(tmp_path):
    from dlnetbench_tpu.utils import checkpoint as jckpt
    h = _mixed_numpy()
    js = _jax_state(h)
    jckpt.save_checkpoint(tmp_path / "c", 7, js, backend="npz")
    restored, step = ckpt.restore_checkpoint(tmp_path / "c", _port_state(h))
    assert step == 7
    assert restored["burn_state"].dtype == torch.bfloat16
    assert restored["act"].dtype == torch.float8_e4m3fn
    for a, b in zip(_bits_of_port(restored), _bits_of_jax(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_npz_written_here_restores_bit_exact_in_jax(tmp_path):
    import jax.numpy as jnp

    from dlnetbench_tpu.utils import checkpoint as jckpt
    h = _mixed_numpy()
    ps = _port_state(h)
    ckpt.save_checkpoint(tmp_path / "c", 4, ps, backend="npz")
    restored, step = jckpt.restore_checkpoint(tmp_path / "c",
                                              _jax_state(h))
    assert step == 4 and jckpt.latest_step(tmp_path / "c") == 4
    assert restored["burn_state"].dtype == jnp.bfloat16
    assert restored["act"].dtype == jnp.float8_e4m3fn
    for a, b in zip(_bits_of_jax(restored), _bits_of_port(ps)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_npz_layout_equals_jax_byte_for_byte_in_arrays(tmp_path):
    """Same file names, array names, dtypes and values as the JAX
    package writes for the same state (keep pruning included)."""
    from dlnetbench_tpu.utils import checkpoint as jckpt
    h = _mixed_numpy()
    for s in range(4):
        ckpt.save_checkpoint(tmp_path / "p", s, _port_state(h), keep=2,
                             backend="npz")
        jckpt.save_checkpoint(tmp_path / "j", s, _jax_state(h), keep=2,
                              backend="npz")
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) \
        == ["2.npz", "3.npz"]
    with np.load(tmp_path / "p" / "3.npz") as a, \
            np.load(tmp_path / "j" / "3.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------- layouts
def test_dual_layout_dir_prefers_newest_across_backends(tmp_path):
    """A directory holding both layouts: latest and the default restore
    take the max across them; an explicit step routes to its layout."""
    params = {"w": torch.arange(4.0)}
    d = tmp_path / "c"
    ckpt.save_checkpoint(d, 2, params, backend="npz")
    newer = {"w": torch.arange(4.0) + 10.0}
    ckpt.save_checkpoint(d, 4, newer, backend="dcp")
    assert ckpt.latest_step(d) == 4
    template = {"w": torch.zeros(4)}
    restored, step = ckpt.restore_checkpoint(d, template)
    assert step == 4 and torch.equal(restored["w"], newer["w"])
    restored2, step2 = ckpt.restore_checkpoint(d, template, step=2)
    assert step2 == 2 and torch.equal(restored2["w"], params["w"])


def test_latest_step_empty(tmp_path):
    assert ckpt.latest_step(tmp_path / "nope") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "nope2", {})


def test_unknown_backend_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ckpt.save_checkpoint(tmp_path / "c", 0, {"w": torch.ones(2)},
                             backend="pickle")


def test_orbax_refused_by_name(tmp_path):
    with pytest.raises(ValueError, match="'dcp'"):
        ckpt.save_checkpoint(tmp_path / "c", 0, {"w": torch.ones(2)},
                             backend="orbax")
    assert ckpt.resolve_backend("auto") == "dcp"


def test_keep_limit_prunes_old_steps(tmp_path, backend):
    params = {"w": torch.ones((2,))}
    for s in range(5):
        ckpt.save_checkpoint(tmp_path / "c", s, params, keep=2,
                             backend=backend)
    assert ckpt.latest_step(tmp_path / "c") == 4
    steps_on_disk = sorted(int(p.name.removesuffix(".npz"))
                           for p in (tmp_path / "c").iterdir()
                           if p.name.removesuffix(".npz").isdigit())
    assert steps_on_disk == [3, 4]
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 0"):
        ckpt.restore_checkpoint(tmp_path / "c", params, step=0)


def test_crash_resume_loop(tmp_path, backend):
    """4 steps straight vs 2 -> 'crash' -> resume -> 2 more agree
    exactly."""
    def step(params, batch):
        p = params["w"] - 0.1 * batch
        return {"w": p}, float(torch.sum(p))

    batch = torch.ones((4,))
    p0 = {"w": torch.zeros((4,))}
    p_ref, ref_losses = p0, []
    for _ in range(4):
        p_ref, loss = step(p_ref, batch)
        ref_losses.append(loss)
    d = tmp_path / "run"
    _, losses1, start1 = ckpt.train_with_checkpointing(
        step, p0, batch, num_steps=2, ckpt_dir=d, save_every=1,
        backend=backend)
    assert start1 == 0 and len(losses1) == 2
    p2, losses2, start2 = ckpt.train_with_checkpointing(
        step, p0, batch, num_steps=4, ckpt_dir=d, save_every=1,
        backend=backend)
    assert start2 == 2 and len(losses2) == 2
    assert losses1 + losses2 == pytest.approx(ref_losses)
    assert torch.equal(p_ref["w"], p2["w"])


def test_crash_resume_loop_equals_jax(tmp_path):
    """The same loop in both packages from one numpy start: the same
    losses, the same resumed step, the same final state."""
    import jax.numpy as jnp

    from dlnetbench_tpu.utils import checkpoint as jckpt
    w0 = np.linspace(-1, 1, 6).astype(np.float32)

    def tstep(params, batch):
        p = params["w"] * 0.5 - batch
        return {"w": p}, float(torch.sum(p))

    def jstep(params, batch):
        p = params["w"] * 0.5 - batch
        return {"w": p}, float(jnp.sum(p))

    for n in (2, 5):
        tp, tl, ts = ckpt.train_with_checkpointing(
            tstep, {"w": torch.from_numpy(w0)}, torch.ones(6), num_steps=n,
            ckpt_dir=tmp_path / "t", save_every=2, backend="npz")
        jp, jl, js = jckpt.train_with_checkpointing(
            jstep, {"w": jnp.asarray(w0)}, jnp.ones(6), num_steps=n,
            ckpt_dir=tmp_path / "j", save_every=2, backend="npz")
        assert ts == js and tl == pytest.approx(jl, rel=0, abs=0)
        np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))


# ---------------------------------------------- SnapshotCheckpointer
def test_snapshot_periodic_saves_and_costs(tmp_path, backend):
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=2,
                                   mode="stall", backend=backend)
    for step in range(6):
        sc.on_step(step)
    assert sc.saves == 3  # steps 1, 3, 5
    assert sc.last_saved_step == 5
    assert len(sc.checkpoint_ms) == 3
    assert sc.state_bytes == 64 * 4 + 16 * 4  # f32 leaves
    stats = sc.stats()
    assert stats["checkpoint_saves"] == 3
    assert stats["checkpoint_backend"] == backend
    assert stats["checkpoint_ms"] > 0
    assert stats["checkpoint_stall_ms"] >= stats["checkpoint_ms"] * 0.5


def test_snapshot_async_completion_gates_lost_work(tmp_path, backend):
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=1,
                                   mode="async", backend=backend)
    for step in range(4):
        sc.on_step(step)
    sc.wait()
    assert sc.last_saved_step == 3
    assert sc.lost_steps(6) == 2
    assert sc.lost_steps(4) == 0
    restored, step = ckpt.restore_checkpoint(tmp_path / "c", _state())
    assert step == 3
    _equal(_state(), restored)


@pytest.mark.parametrize("mode", ["stall", "async"])
def test_snapshot_restores_the_state_at_the_saved_step(tmp_path, backend,
                                                       mode, monkeypatch):
    """The snapshot is taken at the save: updates of the live state in
    place after it are not in it, even while the async write is still
    queued (the writer is held until the update is done)."""
    import threading
    updated = threading.Event()
    name = "_npz_save" if backend == "npz" else "_dcp_save"
    write = getattr(ckpt, name)

    def held(*a, **k):
        assert updated.wait(5.0)
        return write(*a, **k)

    if mode == "async":
        monkeypatch.setattr(ckpt, name, held)
    else:
        updated.set()
    live = _state()
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", live, every=1,
                                   mode=mode, backend=backend)
    sc.on_step(0)
    at0 = {k: v.clone() for k, v in live.items()}
    live["w"].add_(1.0)
    live["b"].mul_(3.0)
    updated.set()
    sc.wait()
    restored, step = sc.restore(_state())
    assert step == 0
    _equal(at0, restored)


def test_snapshot_lost_steps_without_any_save(tmp_path):
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=8,
                                   mode="stall", backend="npz")
    assert sc.last_saved_step is None
    assert sc.lost_steps(5) == 5


def test_snapshot_drain_save_respects_grace_budget(tmp_path, backend):
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=1,
                                   mode="stall", backend=backend)
    sc.on_step(0)
    assert not sc.save_now(3, budget_us=0.001)
    assert sc.last_saved_step == 0
    assert sc.save_now(3, budget_us=60_000_000.0)
    assert sc.last_saved_step == 3


def test_latest_step_refuses_unreadable_orbax_layout(tmp_path):
    """A step directory without dcp's metadata (an orbax-layout
    checkpoint of the JAX package) must not pass for no checkpoint."""
    d = tmp_path / "c"
    (d / "3").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="orbax-layout"):
        ckpt.latest_step(d)
    e = tmp_path / "empty"
    e.mkdir()
    assert ckpt.latest_step(e) is None


def test_snapshot_drain_save_attempts_when_uncalibrated(tmp_path):
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=8,
                                   mode="stall", backend="npz")
    assert sc.save_now(3, budget_us=60_000_000.0)
    assert sc.last_saved_step == 3


def test_snapshot_drain_save_cut_off_rolls_back(tmp_path, backend):
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=1,
                                   mode="stall", backend=backend)
    assert not sc.save_now(3, budget_us=0.001)
    assert sc.last_saved_step is None
    assert ckpt.latest_step(tmp_path / "c") is None
    sc.on_step(0)
    assert sc.last_saved_step == 0
    sc.checkpoint_ms.clear()  # force the attempt past the up-front gate
    assert not sc.save_now(5, budget_us=0.001)
    assert sc.last_saved_step == 0
    assert ckpt.latest_step(tmp_path / "c") == 0


def test_drain_rollback_keeps_a_periodic_save_of_the_same_step(
        tmp_path, backend):
    """A drain at the step the last periodic save landed (a preempt
    right after a save step) that overruns its grace rolls back to that
    periodic save, which stays on disk and restores: the rollback must
    not delete the checkpoint the pointer goes back to."""
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=2,
                                   mode="stall", backend=backend)
    sc.on_step(3)
    assert sc.last_saved_step == 3
    sc.checkpoint_ms.clear()  # force the attempt past the up-front gate
    assert not sc.save_now(3, budget_us=0.001)
    assert sc.last_saved_step == 3
    assert ckpt.latest_step(tmp_path / "c") == 3
    _, step = sc.restore(_state())
    assert step == 3


def test_snapshot_rejects_bad_config(tmp_path):
    with pytest.raises(ValueError, match="interval"):
        ckpt.SnapshotCheckpointer(tmp_path, _state(), every=0)
    with pytest.raises(ValueError, match="mode"):
        ckpt.SnapshotCheckpointer(tmp_path, _state(), every=1,
                                  mode="lazy")


def test_snapshot_writer_failure_surfaces(tmp_path, monkeypatch):
    """A failed async write is re-raised by wait(), never reported as
    fewer saves."""
    sc = ckpt.SnapshotCheckpointer(tmp_path / "c", _state(), every=1,
                                   mode="async", backend="npz")

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_npz_save", broken)
    sc.on_step(0)
    with pytest.raises(OSError, match="disk full"):
        sc.wait()
    assert sc.saves == 0
