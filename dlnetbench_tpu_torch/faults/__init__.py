"""Fault injection and elastic degradation (the JAX package's
``faults/``): the plan (``plan.py``, the schedule a record's
``global.fault_plan`` carries), the step-boundary injector
(``inject.py``) and the degradation policies around ``run_proxy``
(``policy.py``: fail_fast, retry, shrink, checkpointing, preempt and
rejoin)."""
