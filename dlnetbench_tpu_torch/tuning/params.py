"""The consult layer every tunable site goes through (the JAX package's
``tuning/params.py``).

* **Disabled by default.**  With ``DLNB_TUNING_DB_DIR`` unset every
  ``consult`` returns its caller's default and logs nothing: an untuned
  run is the run of a build without the tuner.
* **Frozen after the first consult.**  The first consult of an ``(op,
  key, hw)`` is cached for the life of the process; later consults see
  the same answer even if the file changed.  A sweep over tuned values
  takes a fresh process per DB state, as in the JAX package.
* **Explicit values win.**  Sites consult only when the caller passed no
  explicit value (``cluster=None``, ``pages_per_compute_block=None``,
  ``tp_overlap_chunks=None``).
* **Every consult is logged** (hit or miss) into a process-wide map that
  ``metrics/emit`` stamps into ``global.tuning`` (``provenance``).
* **Validated on a hit.**  A site's ``validate`` refuses a DB config its
  kernel cannot take, with the JAX package's message shape; a kernel
  never falls back to another config or to its plain version.

The chip key is the device's: a site consults with the device its
tensors are on (``hw_key(device)``), so a record tuned on the CPU never
answers a consult on the card, nor a card record one on the CPU.  The
key functions spell torch dtypes as the JAX package spells its dtypes
(``dtype_name``: ``torch.bfloat16`` -> ``bfloat16``), so a record written
by either package, or by either tune CLI, keys the same.
"""
from __future__ import annotations

import functools
import os
import threading

import torch

from dlnetbench_tpu_torch.tuning.db import TuningDB

ENV_DB_DIR = "DLNB_TUNING_DB_DIR"

_lock = threading.Lock()
# (op, key, hw) -> frozen consult entry (process lifetime)
_CACHE: dict[tuple[str, str, str], dict] = {}
# "op|key" -> provenance entry (what emit stamps)
_LOG: dict[str, dict] = {}


def db_dir() -> str | None:
    """The opted-in DB directory, or None (tuning disabled)."""
    return os.environ.get(ENV_DB_DIR) or None


def enabled() -> bool:
    return db_dir() is not None


def canonical_key(**parts) -> str:
    """Sorted ``k=v`` comma-join: one spelling per shape key, whoever
    builds it (consult site or tune CLI)."""
    return ",".join(f"{k}={parts[k]}" for k in sorted(parts))


def dtype_name(dtype) -> str:
    """A dtype as the JAX package's keys spell it (``str`` of a jnp
    dtype): ``torch.bfloat16`` -> ``bfloat16``, ``torch.float32`` ->
    ``float32``; a string passes through."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


@functools.lru_cache(maxsize=None)
def _card_key(index: int) -> str:
    from dlnetbench_tpu_torch.core.hardware import hw_key_for_device_name
    name = torch.cuda.get_device_name(index)
    return (hw_key_for_device_name(name)
            or name.strip().lower().replace(" ", "_"))


def hw_key(device=None) -> str:
    """The chip key of ``device`` (a ``torch.device`` or its string): the
    roofline preset key of a card (``h100_sxm`` for "NVIDIA H100 80GB
    HBM3"; another card's name, lower-cased, when it has no preset) and
    the device type otherwise (``cpu``).  None: the current card when
    there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return _card_key(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def consult(op: str, key: str, default: dict, validate=None,
            device=None) -> dict:
    """The tuned config for ``(op, key)`` on ``device``'s chip
    (``hw_key``), or ``default``.

    ``default`` comes back (copied) when tuning is disabled or the DB has
    no entry; on a hit the DB's config is overlaid on the default
    (unknown DB keys ride along, missing ones keep their default).
    ``validate(config)`` runs on hit configs and raises ``ValueError`` on
    one the site cannot take."""
    if not enabled():
        return dict(default)
    hw = hw_key(device)
    ck = (op, key, hw)
    with _lock:
        ent = _CACHE.get(ck)
        if ent is None:
            db = TuningDB(db_dir())
            rec = db.get(op, key, hw)
            if rec is not None:
                ent = {"config": {**default, **rec.get("config", {})},
                       "hit": True, "db_path": str(db.path)}
                if rec.get("band") is not None:
                    ent["tuned_band"] = rec["band"]
            else:
                ent = {"config": dict(default), "hit": False,
                       "db_path": str(db.path)}
            _CACHE[ck] = ent
            _LOG[f"{op}|{key}"] = ent
    cfg = dict(ent["config"])
    if validate is not None and ent["hit"]:
        try:
            validate(cfg)
        except ValueError as e:
            raise ValueError(
                f"tuning db entry for ({op!r}, {key!r}, {hw!r}) is "
                f"inapplicable: {e} — re-tune or remove the record "
                f"({ent['db_path']})") from e
    return cfg


def provenance() -> dict | None:
    """The ``global.tuning`` block: ``{db_dir, hits, misses, sites}``
    over every consult this process made, or None when none happened
    (a record of an untuned run carries no block)."""
    with _lock:
        if not _LOG:
            return None
        hits = sum(1 for e in _LOG.values() if e["hit"])
        sites = {k: {kk: e[kk] for kk in
                     ("config", "hit", "tuned_band", "db_path") if kk in e}
                 for k, e in sorted(_LOG.items())}
    return {"db_dir": db_dir(), "hits": hits,
            "misses": len(sites) - hits, "sites": sites}


def reset(clear_env: bool = False) -> None:
    """Drop the frozen consult cache and the log (tests, and the tune
    CLI, which re-consults what it just committed)."""
    with _lock:
        _CACHE.clear()
        _LOG.clear()
    if clear_env:
        os.environ.pop(ENV_DB_DIR, None)


# ------------------------------------------------------ key functions
# One spelling per op: the consult sites AND the tune CLI build their
# keys through these, so a committed record can never miss on a
# formatting mismatch.

def quantized_matmul_key(t: int, k: int, n: int, fmt: str,
                         xdtype) -> str:
    return canonical_key(t=t, k=k, n=n, fmt=fmt,
                         xdtype=dtype_name(xdtype))


def flash_fwd_key(b: int, s: int, hq: int, hkv: int, dh: int,
                  causal: bool, dtype) -> str:
    return canonical_key(b=b, s=s, hq=hq, hkv=hkv, dh=dh,
                         causal=bool(causal), dtype=dtype_name(dtype))


def flash_bwd_key(b: int, s: int, hq: int, hkv: int, dh: int,
                  causal: bool, dtype) -> str:
    # same fields as fwd (the kernels share shapes) but a distinct op
    # name keys the record — fwd and bwd optima need not coincide
    return flash_fwd_key(b, s, hq, hkv, dh, causal, dtype)


def splash_key(b: int, s: int, hq: int, hkv: int, dh: int,
               mask_label: str, dtype) -> str:
    """Block-sparse (splash) attention blocks — ops "splash_fwd" and
    "splash_bwd" share the key shape.  The MASK rides in the key (the
    ``MaskSpec.label()`` spelling): sparsity changes which blocks even
    run, so a window(1024) optimum must never answer a segment-mask
    consult, and neither may a dense flash record."""
    return canonical_key(b=b, s=s, hq=hq, hkv=hkv, dh=dh,
                         mask=mask_label, dtype=dtype_name(dtype))


def paged_attention_key(pages_per_seq: int, page_size: int, b: int,
                        hq: int, hkv: int, dh: int) -> str:
    return canonical_key(pages_per_seq=pages_per_seq,
                         page_size=page_size, b=b, hq=hq, hkv=hkv, dh=dh)


def paged_attention_quant_key(pages_per_seq: int, page_size: int,
                              b: int, hq: int, hkv: int, dh: int,
                              fmt: str) -> str:
    """The QUANTIZED paged-attention decode kernel
    (ops/paged_attention_quant, op name "paged_attention_quant") —
    same geometry fields as the dense kernel plus the quant format:
    in-prologue dequant changes the kernel's arithmetic intensity, so
    a dense optimum must never answer a quantized consult and int8/fp8
    optima are distinct records."""
    return canonical_key(pages_per_seq=pages_per_seq,
                         page_size=page_size, b=b, hq=hq, hkv=hkv,
                         dh=dh, fmt=fmt)


def grouped_ffn_key(e: int, c: int, d: int, h: int, fmt: str,
                    xdtype) -> str:
    """One product of the grouped expert FFN (ops/grouped_matmul.py, op
    name "grouped_ffn") — keyed by the dispatch-buffer geometry
    (experts x capacity x contraction d x output h) plus the quant
    format ("none" for master-dtype): in-prologue quant
    changes the kernel's arithmetic intensity, so bf16 optima must
    never answer int8/fp8 consults."""
    return canonical_key(e=e, c=c, d=d, h=h, fmt=fmt,
                         xdtype=dtype_name(xdtype))


def tp_overlap_chunks_key(embed: int, ff: int, seq: int, tp: int,
                          dtype: str) -> str:
    return canonical_key(embed=embed, ff=ff, seq=seq, tp=tp,
                         dtype=dtype_name(dtype))


def grad_bucket_layers_key(num_layers: int, dp: int, pp: int,
                           embed: int, ff: int) -> str:
    return canonical_key(num_layers=num_layers, dp=dp, pp=pp,
                         embed=embed, ff=ff)
