"""Serving layer (counterpart of ``repro.serve``): the continuous-batching
``BatchedServer`` (``serving``), its block pool (``kv_pool``), admission
policy (``scheduler``, which the query executor reuses too), metrics and
fault plans."""
