"""Stall detection for training and benchmark loops (the JAX package's
``utils/watchdog.py``).

A hung collective hangs the job until the scheduler kills it, and with
asynchronous launches the host often sits in a fence with no signal.
``StepWatchdog`` is the tripwire: arm it around each step (or wrap the
step function) and a daemon timer fires ``on_stall`` if the section
outlives its deadline — by default a diagnostic on stderr naming the
section, the elapsed time, the last progress made, the open spans, the
flight ring's trend and the last completed checkpoint, once per arming.
On a stall it also fires the flight recorder's ``stall`` trigger, which
dumps the ring as ``flight_stall.json``.

The timer thread fires while the main thread waits on the card: a CUDA
synchronize or event wait releases the interpreter lock.

The watchdog observes; it does not kill.  Recovery policy belongs to
the caller.
"""
from __future__ import annotations

import sys
import threading
import time


class StepWatchdog:
    """Deadline monitor for repeated sections.

    >>> wd = StepWatchdog(deadline_s=300, name="train_step")
    >>> for batch in data:
    ...     with wd:
    ...         params, loss = step(params, batch)

    or ``step = wd.wrap(step)``.  ``stalls`` counts deadline overruns.
    """

    def __init__(self, deadline_s: float, on_stall=None, name: str = "step"):
        self.deadline_s = float(deadline_s)
        self.name = name
        self.stalls = 0
        self._on_stall = on_stall or self._default_on_stall
        # per-thread stack of armed timers: nested sections and a shared
        # watchdog across threads each disarm exactly their own timer
        self._local = threading.local()
        self._stall_lock = threading.Lock()
        # last-progress heartbeats: key -> monotonic stamp of the most
        # recent beat; the key with a stale age is where progress stopped
        self._beats: dict[str, float] = {}
        self._beats_lock = threading.Lock()
        # every thread's open span stack at the most recent stall
        self.last_stall_spans: list[str] = []
        # the flight ring's last-K samples at the stall ([] when
        # telemetry is off): how the run trended into it
        self.last_stall_telemetry: list[dict] = []
        self.stall_telemetry_k = 8
        # the last COMPLETED checkpoint (SnapshotCheckpointer calls
        # checkpoint_saved): how much work a kill would lose
        self._ckpt_step: int | None = None
        self._ckpt_at: float | None = None

    def _default_on_stall(self, name: str, elapsed_s: float) -> None:
        ages = self.heartbeat_ages()
        where = ""
        if ages:
            # the MOST RECENT beat is the last progress made; the hang
            # sits just past it
            last = min(ages, key=ages.get)
            where = (f"; last progress: {last!r} {ages[last]:.1f}s ago "
                     f"(heartbeats: "
                     + ", ".join(f"{k}={v:.1f}s" for k, v in
                                 sorted(ages.items())) + ")")
        stack = ""
        if self.last_stall_spans:
            stack = ("; active spans: "
                     + " | ".join(self.last_stall_spans))
        trend = ""
        if self.last_stall_telemetry:
            walls = [s.get("step_wall_us") for s in
                     self.last_stall_telemetry
                     if isinstance(s.get("step_wall_us"), (int, float))]
            trend = (f"; telemetry trend: last "
                     f"{len(self.last_stall_telemetry)} ring samples")
            if walls:
                trend += (" (step walls us: "
                          + ", ".join(f"{w:.0f}" for w in walls) + ")")
        ckpt = ""
        age = self.last_checkpoint_age_s()
        if age is not None:
            ckpt = (f"; last completed checkpoint: step "
                    f"{self._ckpt_step} {age:.1f}s ago — a kill now "
                    f"loses the work since")
        print(f"[watchdog] section {name!r} exceeded its "
              f"{self.deadline_s:.1f}s "
              f"deadline ({elapsed_s:.1f}s elapsed) — likely a hung "
              f"collective or device stall{where}{stack}{trend}{ckpt}",
              file=sys.stderr, flush=True)

    # ---- checkpoint age: what would a kill lose? ---------------------
    def checkpoint_saved(self, step: int) -> None:
        """Record a COMPLETED checkpoint save (an in-flight async save
        must not call this — it would understate the loss)."""
        with self._beats_lock:
            self._ckpt_step = step
            self._ckpt_at = time.monotonic()

    def last_checkpoint_age_s(self) -> float | None:
        """Seconds since the last completed checkpoint save, or None."""
        with self._beats_lock:
            if self._ckpt_at is None:
                return None
            return time.monotonic() - self._ckpt_at

    # ---- heartbeats: where did progress stop? ------------------------
    def beat(self, key: str = "step") -> None:
        """Record progress for ``key`` (a rank, a phase, a chain)."""
        with self._beats_lock:
            self._beats[key] = time.monotonic()

    def heartbeat_ages(self) -> dict:
        """Seconds since each key's last beat, at call time."""
        now = time.monotonic()
        with self._beats_lock:
            return {k: now - t for k, t in self._beats.items()}

    def stamp(self, meta: dict,
              key: str = "watchdog_heartbeat_age_s") -> dict:
        """Write the heartbeat ages (rounded), the stall count and what
        the last stall captured into a record's global metadata."""
        meta[key] = {k: round(v, 3)
                     for k, v in sorted(self.heartbeat_ages().items())}
        meta["watchdog_stalls"] = self.stalls
        if self.last_stall_spans:
            meta["watchdog_stall_spans"] = list(self.last_stall_spans)
        if self.last_stall_telemetry:
            meta["watchdog_stall_telemetry"] = list(
                self.last_stall_telemetry)
        age = self.last_checkpoint_age_s()
        if age is not None:
            meta["last_checkpoint_age_s"] = round(age, 3)
            meta["last_checkpoint_step"] = self._ckpt_step
        return meta

    def _fire(self, armed_at: float) -> None:
        elapsed = time.monotonic() - armed_at
        with self._stall_lock:  # timer threads may fire concurrently
            self.stalls += 1
            from dlnetbench_tpu_torch.metrics import spans, telemetry
            self.last_stall_spans = [
                " > ".join(stack)
                for _, stack in sorted(spans.active_stacks().items())]
            rec = telemetry.current()
            if rec is not None:
                self.last_stall_telemetry = rec.last(
                    self.stall_telemetry_k)
                rec.trigger("stall", detail={
                    "section": self.name,
                    "deadline_s": self.deadline_s,
                    "elapsed_s": round(elapsed, 3),
                    "heartbeat_age_s": {
                        k: round(v, 3)
                        for k, v in self.heartbeat_ages().items()},
                    "spans": list(self.last_stall_spans)})
        self._on_stall(self.name, elapsed)

    def __enter__(self) -> "StepWatchdog":
        armed_at = time.monotonic()
        timer = threading.Timer(self.deadline_s, self._fire, args=(armed_at,))
        timer.daemon = True
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(timer)
        timer.start()
        return self

    def __exit__(self, *exc) -> None:
        self._local.stack.pop().cancel()

    def wrap(self, fn):
        """Return ``fn`` with every call armed."""
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapped
