"""RWKV6 WKV recurrence (counterpart of ``repro.kernels.wkv``)."""
