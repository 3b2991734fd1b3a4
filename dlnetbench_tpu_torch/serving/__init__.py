"""Serving tier: paged-KV decode under continuous batching, judged by
latency percentiles against an open-loop arrival plan.

* ``arrivals``  — ``ArrivalPlan``: the committable JSON traffic schema
  (seeded splitmix64 draws, the JAX package's streams);
* ``kv_cache``  — the page allocator, the device pools, quantized page
  writes and the decode-attention dispatch to kernels K1/K2;
* ``decode``    — the single-token decode step and the chunked prefill;
* ``scheduler`` — the continuous-batching engine and ``run_serving``;
* ``requeue``   — the crash-shrink arc every runner shares;
* ``disagg``    — disaggregated prefill/decode over two replicas and
  the page-migration channel (``ops/page_migration.py``);
* ``router``, ``fleet`` — N replicas behind a seeded router, with the
  autoscaler;
* ``metrics``   — TTFT/TPOT/goodput and the schema-v2 record shape.
"""
