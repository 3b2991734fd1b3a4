"""The proxy harness (``base.run_proxy``, ``ProxyResult``), the
calibrated burn and the reference's DP and FSDP proxies."""
