"""DP+PP+EP (MoE) proxy — reference cpp/hybrid_parallel/hybrid_3d_moe.cpp,
the JAX package's ``proxies/hybrid_3d_moe.py``.  A thin wrapper over the
pipeline engine (``proxies.pipeline_common``)."""
from __future__ import annotations

from dlnetbench_tpu_torch.proxies import pipeline_common


def build(stats, card, cfg, device, *, num_stages, num_microbatches,
          num_expert_shards, dp=0, **kw):
    if not card.is_moe:
        raise ValueError(f"{card.name} has no moe_params; the MoE proxy "
                         f"needs an MoE architecture card "
                         f"(reference hybrid_3d_moe.cpp Experts field)")
    return pipeline_common.build(
        stats, card, cfg, device, mode="moe", num_stages=num_stages,
        num_microbatches=num_microbatches,
        num_expert_shards=num_expert_shards, dp=dp, **kw)
