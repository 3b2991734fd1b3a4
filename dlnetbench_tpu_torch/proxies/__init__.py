"""The record carrier shared by every workload (``ProxyResult``)."""
