"""Fault plans as data (``plan.py``): the schedule a record's
``global.fault_plan`` carries, read by the analysis layer."""
