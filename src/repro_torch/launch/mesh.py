"""Thin re-export shim (counterpart of ``repro.launch.mesh``): the mesh
constructors live in ``repro_torch.dist.meshes``, since the dist layer owns
everything mesh-shaped. Import from there in new code."""
from repro_torch.dist.meshes import (  # noqa: F401
    make_host_mesh,
    make_mesh,
    make_production_mesh,
)

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh"]
