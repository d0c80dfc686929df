"""Serving layer (counterpart of ``repro.serve``): so far only the host-side
admission policy, which the query executor reuses."""
