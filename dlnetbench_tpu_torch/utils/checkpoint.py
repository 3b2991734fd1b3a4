"""Checkpoint / resume (the JAX package's ``utils/checkpoint.py``).

Save and restore of a state — a pytree of tensors: dicts (keys in
sorted order), lists and tuples — with two backends behind one API:

  * ``dcp`` — ``torch.distributed.checkpoint``, in the seat the JAX
    package gives orbax: one ``<step>/`` directory per save, written
    by every rank of the process group (a plain tensor is taken as
    replicated: one copy is written) and published by renaming it
    from ``<step>.tmp/`` once complete.
  * ``npz`` — the JAX package's layout exactly: the state flattened in
    JAX's order, gathered to the host and written as one
    ``<step>.npz`` (arrays ``a0``, ``a1``, ...; bfloat16 and e4m3 as
    their ``u2`` / ``u1`` bit patterns) through tmp + fsync + rename,
    pruned to the newest ``keep``.  A file written by either package
    restores bit for bit in the other.  At world > 1 each rank keeps
    its own files under ``rank<r>/``.

``backend="auto"`` resolves to ``dcp``; ``orbax`` is the JAX package's
and is refused by name.

``train_with_checkpointing`` is the crash-safe loop: it resumes from
the latest step if a checkpoint exists, saves every ``save_every``
steps, and is idempotent.  ``SnapshotCheckpointer`` is the in-loop
form ``faults/policy.py`` wires into faulted runs: periodic saves every
K steps with the durable write ON the timed path (``mode="stall"``) or
on a writer thread (``mode="async"``: only the device-to-host snapshot
stays in the step), every cost measured, and a drain save for
preemption grace windows.  At world > 1 its ``dcp`` saves and its
decisions run over a gloo group of its own, never on the step's
communicator, and the main thread issues a collective on that group
only once the writer thread has drained.
"""
from __future__ import annotations

import os
import queue
import shutil
import statistics
import threading
import time
from pathlib import Path

import numpy as np
import torch

BACKENDS = ("dcp", "npz")
# torch dtype -> (an integer type of its width that torch and numpy
# share, the unsigned type whose bits npz stores): numpy has no
# bfloat16 or e4m3
_BITS = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
         torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8),
         torch.float8_e5m2: (torch.uint8, np.uint8, np.uint8)}
_DCP_META = ".metadata"


def resolve_backend(backend: str) -> str:
    """The backend ``backend`` names: ``auto`` is dcp, which ships with
    torch (the JAX package's auto falls back to npz when orbax, an
    extra, is missing)."""
    if backend == "auto":
        return "dcp"
    if backend == "orbax":
        raise ValueError(
            "checkpoint backend 'orbax' is the JAX package's; the port "
            "writes torch.distributed.checkpoint in its seat — use "
            "'dcp' (or 'npz', 'auto')")
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         f"(one of {BACKENDS} or 'auto')")
    return backend


# ------------------------------------------------------------ pytrees
def flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order: a dict's
    values by sorted key, a list's or tuple's in order; None is an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(template, leaves: list):
    """``template``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (a copy on the CPU too: a later
    in-place update of ``t`` must not reach it); bfloat16 / e4m3 as
    their bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _BITS:
        view, _, bits = _BITS[t.dtype]
        return t.view(view).numpy().view(bits)
    return t.numpy()


def from_host(h: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``h`` as a tensor of ``like``'s dtype, on ``like``'s device: a
    bit pattern of the same width is viewed, anything else cast (the
    JAX package's ``_cast``)."""
    if like.dtype in _BITS:
        _, np_view, bits = _BITS[like.dtype]
        if h.dtype.kind in "ui" \
                and h.dtype.itemsize == np.dtype(bits).itemsize:
            t = torch.from_numpy(np.ascontiguousarray(h).view(np_view))
            return t.view(like.dtype).to(like.device)
        h = np.asarray(h, np.float32)
    return torch.from_numpy(np.array(h)).to(like.dtype).to(like.device)


# ------------------------------------------------------------ npz tier
def _npz_path(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"{step}.npz"


def _npz_steps(ckpt_dir: Path) -> list[int]:
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.stem) for p in ckpt_dir.glob("*.npz")
                  if p.stem.isdigit())


def _npz_save(ckpt_dir: Path, step: int, host_leaves: list,
              keep: int) -> None:
    """Write host arrays as ``<step>.npz`` atomically and prune to the
    newest ``keep`` steps (tmp + fsync + rename: a torn write is never
    visible as a checkpoint)."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = _npz_path(ckpt_dir, step)
    tmp = final.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"a{i}": leaf for i, leaf in
                       enumerate(host_leaves)})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    for old in _npz_steps(ckpt_dir)[:-keep] if keep > 0 else []:
        _npz_path(ckpt_dir, old).unlink(missing_ok=True)


def _npz_restore(ckpt_dir: Path, step: int, template):
    with np.load(_npz_path(ckpt_dir, step)) as z:
        host = [z[f"a{i}"] for i in range(len(z.files))]
    leaves = flatten(template)
    if len(host) != len(leaves):
        raise ValueError(
            f"checkpoint {_npz_path(ckpt_dir, step)} holds {len(host)} "
            f"arrays but the template has {len(leaves)} leaves")
    return unflatten(template, [from_host(h, t)
                                for h, t in zip(host, leaves)])


# ------------------------------------------------------------ dcp tier
def _is_step_dir(p: Path) -> bool:
    return p.is_dir() and p.name.isdigit()


def _dcp_steps(ckpt_dir: Path) -> list[int]:
    """Step directories holding a completed dcp save; a step directory
    without dcp's metadata (another library's layout) is refused."""
    if not ckpt_dir.exists():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        if not _is_step_dir(p):
            continue
        if not (p / _DCP_META).exists():
            raise RuntimeError(
                f"{ckpt_dir} holds a step directory {p.name}/ without "
                f"torch.distributed.checkpoint metadata (an orbax-layout "
                f"checkpoint of the JAX package?); the port reads dcp "
                f"and npz checkpoints only")
        steps.append(int(p.name))
    return sorted(steps)


def _rank0(group) -> bool:
    import torch.distributed as dist
    if not dist.is_initialized():
        return True
    return dist.get_rank(group) == 0 if group is not None \
        else dist.get_rank() == 0


def _rank_prefix() -> str:
    """The keys' prefix of this rank's leaves in a dcp save of
    ``train_with_checkpointing``: ``r<rank>.`` at world > 1, where each
    rank's leaves may be its own shards (the SPMD step's), so each
    rank's are written and read apart; none at world 1."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        return f"r{dist.get_rank()}."
    return ""


def _dcp_save(ckpt_dir: Path, step: int, leaves: list, keep: int,
              group=None, prefix: str = "") -> None:
    """Every rank of ``group`` (the default group when None; no group
    at all when none is up) writes into ``<step>.tmp/``, then its
    first rank publishes it as ``<step>/`` and prunes; the ranks meet
    after, so none reads a half-published step."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / str(step)
    tmp = ckpt_dir / f"{step}.tmp"
    lead = _rank0(group)
    up = dist.is_initialized()
    if lead and tmp.exists():
        shutil.rmtree(tmp)
    if up:
        dist.barrier(group=group)
    dcp.save({f"{prefix}a{i}": t for i, t in enumerate(leaves)},
             checkpoint_id=str(tmp), process_group=group, no_dist=not up)
    if lead:
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in _dcp_steps(ckpt_dir)[:-keep] if keep > 0 else []:
            shutil.rmtree(ckpt_dir / str(old), ignore_errors=True)
    if up:
        dist.barrier(group=group)


def _dcp_restore(ckpt_dir: Path, step: int, template, group=None,
                 prefix: str = ""):
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    leaves = flatten(template)
    out = [torch.empty_like(t, device="cpu") for t in leaves]
    dcp.load({f"{prefix}a{i}": t for i, t in enumerate(out)},
             checkpoint_id=str(ckpt_dir / str(step)), process_group=group,
             no_dist=not dist.is_initialized())
    return unflatten(template, [o.to(t.device)
                                for o, t in zip(out, leaves)])


def _dcp_delete(ckpt_dir: Path, step: int, group=None) -> None:
    import torch.distributed as dist
    if _rank0(group):
        shutil.rmtree(ckpt_dir / str(step), ignore_errors=True)
    if dist.is_initialized():
        dist.barrier(group=group)


# ------------------------------------------------------------ the API
def save_checkpoint(ckpt_dir: Path | str, step: int, state,
                    keep: int = 3, backend: str = "auto") -> None:
    """Save ``state`` as the checkpoint for ``step``; blocks until
    durable.  ``dcp`` is collective over the default group when one is
    up."""
    _save(Path(ckpt_dir), step, state, keep, backend, prefix="")


def _save(d: Path, step: int, state, keep: int, backend: str,
          prefix: str) -> None:
    leaves = flatten(state)
    if resolve_backend(backend) == "npz":
        _npz_save(d, step, [to_host(t) for t in leaves], keep)
        return
    _dcp_save(d, step, [t.detach().cpu() for t in leaves], keep,
              prefix=prefix)


def latest_step(ckpt_dir: Path | str) -> int | None:
    """Most recent checkpointed step across both layouts, or None.
    Read-only: never creates the directory."""
    d = Path(ckpt_dir)
    steps = _npz_steps(d) + _dcp_steps(d)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: Path | str, template,
                       step: int | None = None, group=None):
    """Restore the state saved at ``step`` (default: the latest across
    both layouts) as ``template``'s structure, dtypes and devices;
    returns ``(state, step)``.  The layout is read from the disk."""
    return _restore(ckpt_dir, template, step, group, prefix="")


def _restore(ckpt_dir: Path | str, template, step: int | None, group,
             prefix: str):
    d = Path(ckpt_dir)
    if not d.exists():
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if step in _npz_steps(d):
        return _npz_restore(d, step, template), step
    if step in _dcp_steps(d):
        return _dcp_restore(d, step, template, group, prefix), step
    raise FileNotFoundError(
        f"no checkpoint for step {step} under {ckpt_dir} "
        f"(available: {sorted(_npz_steps(d) + _dcp_steps(d))})")


def train_with_checkpointing(step_fn, params, batch, *, num_steps: int,
                             ckpt_dir: Path | str, save_every: int = 1,
                             keep: int = 3, log=None,
                             backend: str = "auto"):
    """Crash-safe training loop: resume -> step -> periodic save.

    ``step_fn(params, batch) -> (params, loss)``.  Returns (params,
    losses, start_step): ``start_step`` > 0 means a checkpoint was
    resumed and ``losses`` covers only the steps executed now.  At
    world > 1 every rank runs the loop and keeps its own leaves apart
    (they may be its own shards, as the SPMD step's are): npz under
    ``rank<r>/``, dcp under keys prefixed ``r<rank>.``."""
    backend = resolve_backend(backend)
    if backend == "npz":
        ckpt_dir = _rank_dir(ckpt_dir)
    prefix = _rank_prefix()
    start = 0
    existing = latest_step(ckpt_dir)
    if existing is not None:
        params, _ = _restore(ckpt_dir, params, existing, None, prefix)
        start = existing + 1  # the saved step already completed
        if log:
            log(f"resumed from step {existing}")
    losses = []
    for step in range(start, num_steps):
        params, loss = step_fn(params, batch)
        losses.append(loss)  # no host read inside the loop
        if (step + 1) % save_every == 0 or step == num_steps - 1:
            _save(Path(ckpt_dir), step, params, keep, backend, prefix)
    return params, [float(v) for v in losses], start


def _rank_dir(ckpt_dir: Path | str) -> Path:
    """Where this process's checkpoints live: ``ckpt_dir`` at world 1
    (the JAX package's layout), ``ckpt_dir/rank<r>`` for an npz save
    of a rank of a larger world."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        return Path(ckpt_dir) / f"rank{dist.get_rank()}"
    return Path(ckpt_dir)


class SnapshotCheckpointer:
    """Periodic in-loop checkpointing with measured cost — the piece
    ``faults/policy.py`` wires into faulted runs.

    ``state`` is the pytree to snapshot; ``every`` the save period in
    harness steps (plan units: warmup included).  Two modes:

      * ``stall`` — the whole save (device-to-host copy + durable
        write) runs inline, on the timed path: every sample lands in
        ``checkpoint_ms`` AND inflates the step it rode.
      * ``async`` — only the host snapshot stays in the step (``stall``
        samples); the durable write moves to one writer thread.
        ``last_saved_step`` advances only when the write COMPLETES.

    ``save_now`` is the preemption drain: it attempts a final
    synchronous save unless the measured median save cost says the
    grace budget cannot fit it, and unpublishes a write whose realized
    cost overran the budget.

    At world > 1 (a process group of several ranks is up) every rank
    holds one and calls it at the same steps: ``dcp`` saves are
    collective over ``group`` — a gloo group over the ranks in the run,
    made here over the whole default group unless given, never the
    step's communicator — and the drain's two decisions are rank 0's,
    broadcast (after the writer has drained), so the ranks decide as
    one.  ``npz`` writes each rank's
    own files (under ``rank<r>/``).
    """

    MODES = ("stall", "async")

    def __init__(self, ckpt_dir: Path | str, state, *, every: int,
                 mode: str = "async", backend: str = "auto",
                 keep: int = 3, watchdog=None, group=None):
        if every < 1:
            raise ValueError("checkpoint interval must be >= 1 step")
        if mode not in self.MODES:
            raise ValueError(f"checkpoint mode {mode!r} not in "
                             f"{self.MODES}")
        import torch.distributed as dist
        self.backend = resolve_backend(backend)
        self.every = int(every)
        self.mode = mode
        self.keep = keep
        self.watchdog = watchdog
        self.ckpt_dir = (Path(ckpt_dir) if self.backend == "dcp"
                         else _rank_dir(ckpt_dir))
        if group is None and dist.is_initialized():
            group = dist.new_group(backend="gloo")
        self.group = group
        self._leaves = flatten(state)
        self.state_bytes = int(sum(t.numel() * t.element_size()
                                   for t in self._leaves))
        # measured costs (ms): total per completed save / in-step part
        self.checkpoint_ms: list[float] = []
        self.stall_ms: list[float] = []
        self.saves = 0
        self._lock = threading.Lock()
        self._last_saved_step: int | None = None
        self._q: queue.Queue | None = None
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    def set_group(self, group) -> None:
        """Save over another gloo group from here on (a degraded run's
        survivors; the whole world again at a rejoin).  Drains the
        writer first."""
        self.wait()
        self.group = group

    # ---- loop hooks --------------------------------------------------
    def on_step(self, step: int) -> None:
        """Call after harness step ``step`` (plan units) completed;
        saves when the period elapses."""
        if (step + 1) % self.every == 0:
            self._save(step)

    def _decide(self, value: bool) -> bool:
        """Rank 0's ``value`` on every rank of the group."""
        import torch.distributed as dist
        if self.group is None or dist.get_world_size(self.group) == 1:
            return value
        box = [value]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return bool(box[0])

    def save_now(self, step: int, budget_us: float | None = None) -> bool:
        """Drain save for a preemption grace window; returns whether the
        save LANDED.  Refused up front when the measured median save
        cost does not fit the budget (with no completed save to price
        from it is attempted); a write whose realized cost overran the
        budget is rolled back — the eviction closed the window first,
        and atomic publication means it was never a checkpoint.  The
        attempt's cost is kept: the time was spent."""
        if budget_us is not None:
            with self._lock:
                known = sorted(self.checkpoint_ms)
            fits = not (known and known[len(known) // 2] * 1e3 > budget_us)
        # drain any in-flight async write FIRST: a periodic save landing
        # mid-drain cannot be erased by the rollback below, and a dcp
        # write's collectives on ``group`` end before the broadcast
        self.wait()
        if budget_us is not None and not self._decide(fits):
            return False
        prev_last = self.last_saved_step
        t0 = time.monotonic()
        self._save(step, force_sync=True)
        if budget_us is not None and self._decide(
                (time.monotonic() - t0) * 1e6 > budget_us):
            self._discard(step, prev_last)
            return False
        return True

    def _discard(self, step: int, prev_last: int | None) -> None:
        """Unpublish the save for ``step`` and restore the last-saved
        pointer: restore-from-latest and the lost-work count treat it
        as never having happened.  A drain of a step that a periodic
        save had already landed (``prev_last == step``) rewrote the same
        state: that earlier checkpoint still stands and stays on disk."""
        if step != prev_last:
            if self.backend == "npz":
                _npz_path(self.ckpt_dir, step).unlink(missing_ok=True)
            else:
                _dcp_delete(self.ckpt_dir, step, self.group)
        with self._lock:
            if self._last_saved_step == step:
                self._last_saved_step = prev_last
            self.saves -= 1

    def _snapshot(self) -> list:
        """The device-to-host copy (synchronizing the device)."""
        if self.backend == "npz":
            return [to_host(t) for t in self._leaves]
        return [t.detach().to("cpu", copy=True) for t in self._leaves]

    def _save(self, step: int, force_sync: bool = False) -> None:
        t0 = time.monotonic()
        host = self._snapshot()
        snap_ms = (time.monotonic() - t0) * 1e3
        if self.mode == "stall" or force_sync:
            self._write(step, host, t0)
            self.stall_ms.append((time.monotonic() - t0) * 1e3)
        else:
            self.stall_ms.append(snap_ms)
            self._ensure_writer()
            self._q.put((step, host, t0))

    def _write(self, step: int, host_leaves: list, t0: float) -> None:
        if self.backend == "npz":
            _npz_save(self.ckpt_dir, step, host_leaves, self.keep)
        else:
            _dcp_save(self.ckpt_dir, step, host_leaves, self.keep,
                      self.group)
        total_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self.checkpoint_ms.append(total_ms)
            self.saves += 1
            if self._last_saved_step is None or \
                    step > self._last_saved_step:
                self._last_saved_step = step
        if self.watchdog is not None:
            self.watchdog.checkpoint_saved(step)

    def _ensure_writer(self) -> None:
        if self._writer is not None:
            return
        self._q = queue.Queue()

        def run():
            while True:
                item = self._q.get()
                if item is None:
                    return
                try:
                    self._write(*item)
                except BaseException as e:  # surfaced by wait()
                    self._writer_error = e
                finally:
                    self._q.task_done()

        self._writer = threading.Thread(target=run, daemon=True,
                                        name="ckpt-writer")
        self._writer.start()

    def restore(self, template, step: int | None = None):
        """``restore_checkpoint`` from this checkpointer's directory
        (over its group for ``dcp``)."""
        return restore_checkpoint(self.ckpt_dir, template, step=step,
                                  group=self.group)

    # ---- accounting --------------------------------------------------
    @property
    def last_saved_step(self) -> int | None:
        with self._lock:
            return self._last_saved_step

    def lost_steps(self, failure_iteration: int) -> int:
        """Completed steps a restore-from-latest would redo: steps past
        the last COMPLETED save when step ``failure_iteration`` failed
        to run."""
        last = self.last_saved_step
        if last is None:
            return max(0, failure_iteration)
        return max(0, failure_iteration - (last + 1))

    def wait(self) -> None:
        """Drain the async writer (idempotent); re-raises a writer
        failure instead of silently reporting fewer saves."""
        if self._writer is not None:
            self._q.join()
            self._q.put(None)
            self._writer.join()
            self._writer = None
            self._q = None
        if self._writer_error is not None:
            e, self._writer_error = self._writer_error, None
            raise e

    def stats(self) -> dict:
        """Record-ready cost summary (medians; the per-sample arrays
        stay on the object)."""
        with self._lock:
            ck = list(self.checkpoint_ms)
            st = list(self.stall_ms)
            out = {
                "checkpoint_every": self.every,
                "checkpoint_mode": self.mode,
                "checkpoint_backend": self.backend,
                "checkpoint_saves": self.saves,
                "checkpoint_state_bytes": self.state_bytes,
            }
        if ck:
            out["checkpoint_ms"] = round(statistics.median(ck), 3)
        if st:
            out["checkpoint_stall_ms"] = round(statistics.median(st), 3)
        return out
