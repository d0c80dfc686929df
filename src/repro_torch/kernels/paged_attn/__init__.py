"""Block-table paged decode attention (counterpart of
``repro.kernels.paged_attn``): the Hopper kernel B5 and its gather oracle.

``ops.paged_attention`` is the public entry point and ``ops.paged_latent_attention``
its absorbed-MLA form over the latent pools c and kr; ``ref.paged_attn_ref``
and ``ref.paged_latent_attn_ref`` are the plain gather versions the kernel is
held against.
"""
