"""TuningDB: the persistent per-(op, shape, chip) tuned-config store (the
JAX package's ``tuning/db.py``, record for record).

JSON-lines file (``tuning_db.jsonl``) in the directory
``DLNB_TUNING_DB_DIR`` points at.  One record per line:

    {"schema": 1, "op": "quantized_matmul",
     "key": "fmt=float8,k=4096,n=14336,t=12288,xdtype=bfloat16",
     "hw": "h100_sxm", "config": {"cluster": 2},
     "band": {"value": ..., "best": ..., "band": [lo, hi], "n": N},
     "meta": {"seed": 0, "rounds": 3, ...}}

* ``key`` is the canonical shape/dtype key (``params.canonical_key``:
  sorted ``k=v`` pairs, dtypes spelled as the JAX package spells them),
  ``hw`` the chip key (``params.hw_key``: ``h100_sxm`` on an H100 SXM
  card, ``cpu`` for a CPU tensor).
* ``band`` is the winner's measured stat band (``metrics/stats.py``):
  a tuned config ships with the evidence that elected it.
* ``schema`` rides every record; a record of a newer schema than this
  build's is refused.

The file format, the schema number and the writer's protocol are the
JAX package's, so a DB written by either package loads in the other.
Writes are whole-file atomic renames (a ``.tmp.<pid>`` sibling, then
``os.replace``), serialized by a lock-directory claim with bounded
retries that steals a lock older than ``STALE_LOCK_S`` (a crashed
writer's).  A torn line is skipped with a note on stderr; the other
records stay usable.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

SCHEMA_VERSION = 1
DB_FILENAME = "tuning_db.jsonl"

# a lock older than this is a crashed writer's leftover: steal it
STALE_LOCK_S = 30.0


class TuningDB:
    """The store.  ``root`` is a directory; the records live in
    ``root/tuning_db.jsonl``."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.path = self.root / DB_FILENAME

    # ------------------------------------------------------------ read
    def load(self) -> dict[tuple[str, str, str], dict]:
        """All records keyed by ``(op, key, hw)``.  Tolerates torn
        lines (skip + stderr note); refuses newer-schema records."""
        out: dict[tuple[str, str, str], dict] = {}
        if not self.path.exists():
            return out
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # torn/partial write (external truncation, a crashed
                    # non-atomic writer): the damaged line is lost, the
                    # rest of the DB must stay usable — a tuning store
                    # that bricks on one bad line costs every future
                    # run its warm start
                    print(f"tuning db {self.path}:{lineno}: skipping "
                          f"torn/unparseable record", file=sys.stderr)
                    continue
                sv = int(rec.get("schema", 0))
                if sv > SCHEMA_VERSION:
                    raise ValueError(
                        f"{self.path}:{lineno}: tuning record schema {sv} "
                        f"is newer than this build's {SCHEMA_VERSION} — "
                        f"refusing to guess at a future format; regenerate "
                        f"the DB or upgrade the harness")
                try:
                    out[(rec["op"], rec["key"], rec["hw"])] = rec
                except KeyError:
                    print(f"tuning db {self.path}:{lineno}: skipping "
                          f"record missing op/key/hw", file=sys.stderr)
        return out

    def get(self, op: str, key: str, hw: str) -> dict | None:
        return self.load().get((op, key, hw))

    # ----------------------------------------------------------- write
    @staticmethod
    def _claim(lock, attempts: int = 8, wait_s: float = 0.05,
               stale_s: float = STALE_LOCK_S) -> None:
        """Claim the writer lock (a directory — mkdir is atomic on every
        filesystem we run on).  Mirrors ``native_build._claim``'s shape:
        bounded retries, each restarting the whole mkdir/stat sequence,
        with a diagnostic RuntimeError once exhausted.  A lock whose
        mtime is older than ``stale_s`` belongs to a crashed writer and
        is stolen."""
        last_exc: OSError | None = None
        for _ in range(attempts):
            try:
                lock.mkdir()
                return
            except FileExistsError as e:
                last_exc = e
            try:
                age = time.time() - lock.stat().st_mtime
            except FileNotFoundError:
                # the holder released between our mkdir and stat —
                # restart the claim immediately
                continue
            if age > stale_s:
                # crashed writer: steal (rmdir races with a concurrent
                # stealer are fine — whoever's mkdir wins next round)
                with contextlib.suppress(OSError):
                    lock.rmdir()
                continue
            time.sleep(wait_s)
        raise RuntimeError(
            f"could not claim tuning-db lock {lock} after {attempts} "
            f"attempts (concurrent writers kept holding it)") from last_exc

    def put(self, op: str, key: str, hw: str, config: dict,
            band: dict | None = None, meta: dict | None = None,
            attempts: int = 8) -> dict:
        """Insert/replace one record under the writer lock, committing
        via atomic rename (a reader never observes a half-written
        file).  Returns the committed record."""
        self.root.mkdir(parents=True, exist_ok=True)
        rec = {"schema": SCHEMA_VERSION, "op": op, "key": key, "hw": hw,
               "config": dict(config)}
        if band is not None:
            rec["band"] = band
        if meta is not None:
            rec["meta"] = meta
        lock = self.root / (DB_FILENAME + ".lock")
        self._claim(lock, attempts=attempts)
        try:
            records = self.load()
            records[(op, key, hw)] = rec
            tmp = self.path.with_name(f"{self.path.name}.tmp.{os.getpid()}")
            tmp.write_text("".join(json.dumps(r) + "\n"
                                   for r in records.values()))
            os.replace(tmp, self.path)
        finally:
            with contextlib.suppress(OSError):
                lock.rmdir()
        return rec
