"""Distribution layer (counterpart of ``repro.dist``): so far only the
fallback registry of ``meshes``; meshes and sharding wait for ROADMAP A19."""
