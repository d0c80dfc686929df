"""The roofline of a dry-run cell on the H100 (counterpart of
``repro.roofline``): ``analysis`` (the three terms), ``collectives`` (wire
bytes from the mesh layer's collective log) and ``report`` (the generated
tables)."""
