"""DP+PP+TP proxy (Megatron 1D TP on the pipeline) — reference
cpp/hybrid_parallel/hybrid_3d.cpp, the JAX package's
``proxies/hybrid_3d.py``.  A thin wrapper over the pipeline engine
(``proxies.pipeline_common``)."""
from __future__ import annotations

from dlnetbench_tpu_torch.proxies import pipeline_common


def build(stats, card, cfg, device, *, num_stages, num_microbatches, tp,
          dp=0, **kw):
    return pipeline_common.build(
        stats, card, cfg, device, mode="3d", num_stages=num_stages,
        num_microbatches=num_microbatches, tp=tp, dp=dp, **kw)
