"""Synthetic training tables (counterpart of ``repro.data``)."""
