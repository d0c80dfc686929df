"""Strider page decode (counterpart of ``repro.kernels.strider``)."""
