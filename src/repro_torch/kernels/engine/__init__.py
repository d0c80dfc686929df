"""Fused GLM gradient of the execution engine (counterpart of ``repro.kernels.engine``)."""
