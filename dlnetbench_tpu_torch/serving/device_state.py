"""Device-resident decode-loop state and its priced host<->device sync
(the JAX package's ``serving/device_state.py``).

The engine keeps the host-side scheduling state (queue, pending list,
page free-list, per-request stamps); everything the fused decode loop
needs per step lives here on the engine's device between syncs, packed
into ONE ``[6, slots]`` int32 carry (``decode.STATE_*`` rows) plus the
block tables and, when speculative, the per-slot ngram table.  The host
mirrors are numpy arrays; the carries are torch tensors.

The sync contract (every crossing is a recorded timer):

* ``flush()``  — host -> device: upload the host mirrors a mutation
  touched, at admission boundaries only.  Priced into ``sync_h2d_us``.
* ``rebind()`` — a loop program returned updated carries: the device
  tensors move forward and the host mirrors go STALE.  No transfer.
* ``pull()``   — device -> host: refresh the mirrors from the device
  carries.  Required before mutating a stale mirror (``admit`` /
  ``evict`` on stale state raise ``SyncContractError``).  Priced into
  ``sync_d2h_us``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from dlnetbench_tpu_torch.serving.decode import (STATE_GRAMMAR, STATE_LAST,
                                                 STATE_LIMIT, STATE_POS,
                                                 STATE_REM, STATE_ROWS,
                                                 STATE_UID)


class SyncContractError(RuntimeError):
    """A host mirror was mutated while stale: the next flush would
    overwrite device-advanced slot state with stale host values."""


class DeviceDecodeState:
    """Slot state for the fused decode loop, mirrored on the host.

    Loop carries (rebound from a loop program's leading outputs): the
    packed ``state`` tensor, plus ``ngram_table`` when speculative.
    Operand (uploaded at flush, read-only in the loop):
    ``block_tables``."""

    def __init__(self, slots: int, max_pages_per_seq: int,
                 vocab: int | None = None, device="cpu"):
        self.slots = slots
        self.device = torch.device(device)
        self.state = np.zeros((STATE_ROWS, slots), np.int32)
        self.block_tables = np.zeros((slots, max_pages_per_seq),
                                     np.int32)
        self.ngram_table = (np.zeros((slots, vocab), np.int32)
                            if vocab else None)
        self._dev: dict[str, torch.Tensor] = {}
        # per-field dirty tracking: an evict touches one int of the
        # packed state and must not re-upload the block tables or a
        # [slots, vocab] ngram table beside it
        self._dirty: set = set(self.carry_fields) | {"block_tables"}
        self.stale = False
        self.sync_h2d_us: list[float] = []
        self.sync_d2h_us: list[float] = []

    @property
    def carry_fields(self) -> tuple[str, ...]:
        """The loop-carried fields, in the loop programs' order."""
        return (("state", "ngram_table")
                if self.ngram_table is not None else ("state",))

    # ---- host-side mutation (admission boundaries) -------------------
    def _require_fresh(self, what: str) -> None:
        if self.stale:
            raise SyncContractError(
                f"device_state: {what} on STALE host mirrors — the "
                f"device advanced since the last pull(); sync first or "
                f"the next flush clobbers device state")

    def admit(self, slot: int, *, last_token: int, position: int,
              remaining: int, seq_limit: int, block_row,
              ngram_row=None, uid: int = 0,
              grammar_state: int = 0) -> None:
        """A slot enters the decode phase: seed its state.
        ``remaining`` is the output still owed (``> 0`` is the active
        bit), ``seq_limit`` the prompt+output reservation no write may
        pass, ``uid`` the request id sampled draws key by and
        ``grammar_state`` the automaton state after the first token."""
        self._require_fresh("admit")
        self.state[STATE_LAST, slot] = last_token
        self.state[STATE_POS, slot] = position
        self.state[STATE_REM, slot] = remaining
        self.state[STATE_LIMIT, slot] = seq_limit
        self.state[STATE_UID, slot] = uid
        self.state[STATE_GRAMMAR, slot] = grammar_state
        self.block_tables[slot, :] = block_row
        self._dirty |= {"state", "block_tables"}
        if self.ngram_table is not None:
            self.ngram_table[slot, :] = (
                0 if ngram_row is None else ngram_row)
            self._dirty.add("ngram_table")

    def evict(self, slot: int) -> None:
        """Host-forced removal (a drain).  A slot that ran its budget
        down stopped itself on the device and needs no evict."""
        self._require_fresh("evict")
        self.state[STATE_REM, slot] = 0
        self._dirty.add("state")

    # ---- the sync points (each priced) -------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of ``arr`` on the device.  On a card through pinned
        memory and a non-blocking copy: the caching host allocator keeps
        the pinned block until the copy ran, so the mirror may change
        right after."""
        t = torch.from_numpy(arr.copy())
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def flush(self) -> None:
        """Host -> device, priced; only the fields a mutation touched."""
        if not self._dirty:
            return
        t0 = time.perf_counter()
        for name in sorted(self._dirty):
            self._dev[name] = self._upload(getattr(self, name))
        self.sync_h2d_us.append((time.perf_counter() - t0) * 1e6)
        self._dirty = set()
        self.stale = False

    def carries(self) -> tuple:
        """The loop-carried device tensors, flushing a pending
        mutation first."""
        self.flush()
        return tuple(self._dev[name] for name in self.carry_fields)

    def block_tables_device(self) -> torch.Tensor:
        self.flush()
        return self._dev["block_tables"]

    def rebind(self, new_carries: tuple) -> None:
        """Adopt a loop program's updated carries (no transfer); the
        host mirrors go stale until the next pull."""
        names = self.carry_fields
        if len(new_carries) != len(names):
            raise ValueError(
                f"device_state: rebind got {len(new_carries)} carries, "
                f"expected {len(names)} ({names})")
        for name, arr in zip(names, new_carries):
            self._dev[name] = arr
        self.stale = True

    def pull(self) -> None:
        """Device -> host, priced: refresh the mirrors so the host may
        mutate again."""
        if not self.stale:
            return
        t0 = time.perf_counter()
        for name in self.carry_fields:
            np.copyto(getattr(self, name), self._dev[name].cpu().numpy())
        self.sync_d2h_us.append((time.perf_counter() - t0) * 1e6)
        self.stale = False

    def sync_total_us(self) -> float:
        """Both channels' running total (the engine excludes in-step
        sync time from ``host_dispatch_us`` with it)."""
        return sum(self.sync_h2d_us) + sum(self.sync_d2h_us)

    # ---- inspection ---------------------------------------------------
    def host_view(self) -> dict:
        """Copies of the host mirrors (``pull()`` first if stale)."""
        out = {
            "last_tokens": self.state[STATE_LAST].copy(),
            "positions": self.state[STATE_POS].copy(),
            "remaining": self.state[STATE_REM].copy(),
            "seq_limits": self.state[STATE_LIMIT].copy(),
            "uids": self.state[STATE_UID].copy(),
            "grammar_states": self.state[STATE_GRAMMAR].copy(),
            "active": (self.state[STATE_REM] > 0).copy(),
            "block_tables": self.block_tables.copy(),
        }
        if self.ngram_table is not None:
            out["ngram_table"] = self.ngram_table.copy()
        return out

    def sync_stats(self) -> dict:
        return {
            "sync_h2d_us": {"total": round(sum(self.sync_h2d_us), 1),
                            "n": len(self.sync_h2d_us)},
            "sync_d2h_us": {"total": round(sum(self.sync_d2h_us), 1),
                            "n": len(self.sync_d2h_us)},
        }
