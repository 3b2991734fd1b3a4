"""dlnetbench_tpu_torch — the PyTorch/CUDA port of ``dlnetbench_tpu``.

The JAX package beside this one is the reference; this package grows
slice by slice until it does what the reference does, on an NVIDIA
Hopper card.  Module names follow the JAX package so that each piece
has an obvious counterpart.  Nothing here imports ``jax`` or
``dlnetbench_tpu``: what the port needs from the reference it keeps as
its own copy (the model cards under ``data/models`` included).

Slice 1 — the serving path of ``cli serve`` (classic one-token-per-step
greedy decode over a paged KV cache); slice 2 — the headline training
step (forward, backward, SGD) and the flagship forward; slices 3–9 —
the MLP recipes, MoE, masks and the kernels' Hopper redesigns; slice
10 — the proxy spine and the DP and FSDP proxies:

  core/      model cards, hardware presets, the roofline model, stats
             files (``data/model_stats``: H100 rooflines), the schedule
             algebra, build-time warming of step programs
  models/    the dense gated transformer's layers, config, weights,
             forward and loss; the bench train step
  ops/       hand-written Hopper kernels (``csrc/*.cu``: paged decode
             attention, flash attention forward/dq/dk-dv), their build,
             wrappers with launch counters, the plain PyTorch version
             beside each kernel, and the ``attention`` dispatcher
  serving/   arrival plans, the paged KV cache, prefill/decode programs,
             the continuous-batching engine and its metrics
  metrics/   sample summaries, overlap, energy (NVML first) and
             schema-v2 record emission
  parallel/  ``torch.distributed`` bring-up, process groups in the
             JAX meshes' shape, collectives on a comm stream, buffers
  proxies/   the harness (``run_proxy``), the calibrated burn (CUDA
             graphs), the DP and FSDP proxies
  utils/     timing, a free loopback port
  stats_gen.py  ``python -m dlnetbench_tpu_torch.stats_gen``
  bench.py   ``python -m dlnetbench_tpu_torch.bench`` (headline line)
  entry.py   ``entry()``, the flagship forward
  cli.py     ``python -m dlnetbench_tpu_torch.cli
             dp|fsdp|serve|train ...``

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``;
with no card and no explicit ``cpu`` it raises.  On a CUDA tensor each
kernel wrapper launches its kernel or raises; on a CPU tensor it runs
the kernel's plain version (the CPU tests rely on this).
"""
