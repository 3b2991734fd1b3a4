"""The repo's end-to-end studies on the port's own modules
(``python -m dlnetbench_tpu_torch.examples.dp_bucket_study`` and
``.pod_study``: the proxy grid, ``--serving``, ``--kv_density``,
``--fault``); not ported: ``congestion_study.py`` and ``pod_study.py``'s
``--tier native`` / ``--backend pjrt-hier`` / ``--procs`` /
``--congest``, which drive the C++ ``native/`` binaries (not ported:
their device backend is XLA's PJRT), and ``xla_knob_study.py``, a sweep
of XLA compiler flags, which eager PyTorch does not have."""
