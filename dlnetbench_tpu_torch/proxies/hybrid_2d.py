"""DP+PP proxy (GPipe; 1F1B and ZB-H1 as options) — reference
cpp/hybrid_parallel/hybrid_2d.cpp, the JAX package's
``proxies/hybrid_2d.py``.  A thin wrapper over the pipeline engine
(``proxies.pipeline_common``)."""
from __future__ import annotations

from dlnetbench_tpu_torch.proxies import pipeline_common


def build(stats, card, cfg, device, *, num_stages, num_microbatches, dp=0,
          **kw):
    return pipeline_common.build(
        stats, card, cfg, device, mode="2d", num_stages=num_stages,
        num_microbatches=num_microbatches, dp=dp, **kw)
