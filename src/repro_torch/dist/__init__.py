"""Distributed execution layer: logical-axis sharding over device meshes
(counterpart of ``repro.dist``). The rest of the port programs against
*logical* axis names (``"batch"``, ``"tuples"``, ``"features"``, ...); this
package owns the rule tables that resolve them onto mesh axes, the
placements, the mesh constructors and the collectives. See
``repro_torch.dist.meshes``."""
from repro_torch.dist import meshes  # noqa: F401

__all__ = ["meshes"]
