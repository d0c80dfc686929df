"""Block-table paged decode attention (counterpart of
``repro.kernels.paged_attn``): the Hopper kernel B5 and its gather oracle.

``ops.paged_attention`` is the public entry point; ``ref.paged_attn_ref`` is
the plain gather version the kernel is held against.
"""
