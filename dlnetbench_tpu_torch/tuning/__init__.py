"""The persistent seeded autotuner of the card's kernel knobs and the SPMD
tier's grains (the JAX package's ``tuning/``).

* ``db``     — ``TuningDB``: the per-(op, canonical shape key, chip)
  JSON-lines store, schema-versioned, atomic-rename writes, a bounded
  lock claim for concurrent writers; it lives where
  ``DLNB_TUNING_DB_DIR`` points.
* ``search`` — the splitmix64-seeded measure/prune/commit search:
  K-chained fence timing, band-aware pruning, the winner committed with
  its measured band.
* ``params`` — ``consult``, what the tunable sites call: disabled by
  default (an untuned run is bit-identical to a build without the
  tuner), frozen after the first consult per key, explicit values
  winning, every consult logged for ``global.tuning``.

The sites and what their configs mean on the card:

* ``quantized_matmul`` (K11) and ``grouped_ffn`` (K12): ``{"cluster":
  c}``, the blocks along N of a thread-block cluster that share one
  quantized x stage (1, 2 or 4; 8-bit only — K12 in bf16 and f32 has the
  one config ``{"cluster": 1}``);
* ``paged_attention`` / ``paged_attention_quant`` (K1/K2):
  ``{"pages_per_compute_block": p}``, the pages one split of a slot's
  sequence takes;
* ``flash_fwd`` / ``flash_bwd`` / ``splash_fwd`` / ``splash_bwd``
  (K3-K8): the JAX package's block fields, which on the card can only
  name the one tile each kernel is compiled for;
* ``tp_overlap_chunks`` / ``grad_bucket_layers`` (``models/spmd``):
  agreed across the ranks of the process group.

CLI: ``python -m dlnetbench_tpu_torch.tuning tune --op ... --db DIR``
runs the seeded search on this device and commits; ``show`` lists the
DB.
"""
from dlnetbench_tpu_torch.tuning.db import (DB_FILENAME, SCHEMA_VERSION,
                                            TuningDB)
from dlnetbench_tpu_torch.tuning.params import (ENV_DB_DIR, canonical_key,
                                                consult, db_dir, enabled,
                                                hw_key, provenance, reset)
from dlnetbench_tpu_torch.tuning.search import (run_search, seeded_order,
                                                tune_and_commit)

__all__ = [
    "DB_FILENAME", "SCHEMA_VERSION", "TuningDB",
    "ENV_DB_DIR", "canonical_key", "consult", "db_dir", "enabled",
    "hw_key", "provenance", "reset",
    "run_search", "seeded_order", "tune_and_commit",
]
