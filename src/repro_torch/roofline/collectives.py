"""Collective byte totals from the port's own collective log (counterpart of
``repro.roofline.hlo``, which parses the compiled per-device HLO; the port
has no HLO, and its mesh layer totals the collectives it issues instead:
``dist.meshes.COLLECTIVE_TOTALS``, calls and bytes a kind and group size).

Each event is priced in ring-algorithm wire bytes per device, with the
reference's factors for the five kinds it names:

  all-gather:          (g-1)/g * out_bytes
  all-reduce:        2*(g-1)/g * bytes
  reduce-scatter:      (g-1)   * out_bytes     (= (g-1)/g * in_bytes)
  all-to-all:          (g-1)/g * bytes
  collective-permute:            bytes

and one of its own for the kind the port issues besides all-reduce:

  broadcast:           (g-1)/g * bytes

So a tensor made whole from its g slices by g broadcasts, one slice each
(``meshes.whole``, ``meshes.full_tensor``), costs g * (out/g) * (g-1)/g =
(g-1)/g * out_bytes a device: exactly the all-gather it stands for.
"""
from __future__ import annotations

from collections.abc import Mapping

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


def wire_bytes(kind: str, nbytes: int, group_size: int) -> float:
    """The ring-algorithm bytes one device sends for one collective of
    ``kind`` whose result is ``nbytes`` over a group of ``group_size``
    (each formula in the reference's order of operations)."""
    b, g = nbytes, max(int(group_size), 1)
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return b * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if kind == "reduce-scatter":
        return float(b) * (g - 1)
    if kind == "collective-permute":
        return float(b)
    raise ValueError(f"unknown collective kind {kind!r}; known: {KINDS}")


def collective_stats(events) -> dict:
    """Per-device collective byte totals of ``events``, in the reference's
    form: ``by_kind`` (``count``, ``result_bytes``, ``wire_bytes`` a kind),
    ``total_result_bytes`` and ``total_wire_bytes``. ``events`` is either
    (kind, result bytes, group size) triples, one a collective, or the mesh
    layer's totals ``{(kind, group size): (calls, result bytes)}``: every
    factor above is linear in bytes, so a total prices as its calls do."""
    if isinstance(events, Mapping):
        items = [(kind, nbytes, g, calls) for (kind, g), (calls, nbytes) in events.items()]
    else:
        items = [(kind, nbytes, g, 1) for kind, nbytes, g in events]
    by_kind: dict[str, dict] = {}
    total_result = 0
    total_wire = 0.0
    for kind, nbytes, group_size, calls in items:
        wire = wire_bytes(kind, nbytes, group_size)
        ent = by_kind.setdefault(kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        ent["count"] += calls
        ent["result_bytes"] += int(nbytes)
        ent["wire_bytes"] += wire
        total_result += int(nbytes)
        total_wire += wire
    return {
        "by_kind": by_kind,
        "total_result_bytes": total_result,
        "total_wire_bytes": total_wire,
    }
