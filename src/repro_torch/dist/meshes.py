"""Logical-axis sharding over ``torch.distributed``: rule tables, resolver,
meshes, placements and the few collectives the port makes (counterpart of
``repro.dist.meshes``, which it is held against).

Every parameter, activation, input and model tensor carries a tuple of
*logical* axis names (``("vocab", "embed")``, ``("pages", "tuples",
"features")``, ...). This module resolves those names onto the axes of a
device mesh:

  * ``resolve_spec(logical_axes, shape, mesh)`` -> ``PartitionSpec`` via a
    rule table, with greedy multi-axis assignment (``batch`` spreads over
    ``("pod", "data")``), no mesh axis used twice in one tensor, and a dim
    that does not divide its mesh axis left replicated with the drop
    recorded (``fallbacks()``), all as ``repro`` decides it.
  * ``named_sharding`` / ``tree_shardings`` / ``replicated`` -> the port's
    ``NamedSharding``: its mesh, its spec and the DTensor placements, one per
    mesh dim (``Shard(dim)`` on each mesh axis that the spec names).
  * ``device_put(x, sharding)`` -> a ``DTensor`` built from this rank's slice
    of ``x`` (``DTensor.from_local``): nothing is scattered, since gloo on
    CUDA tensors runs only ``all_reduce``, ``broadcast`` and ``barrier``.
    ``full_tensor`` makes a DTensor whole again by broadcasts.
  * ``shard_act(x, logical_axes, tag)`` -> the same object outside a mesh
    or where the spec resolves fully replicated, else ``x`` placed by its
    sharding. The port's model code runs on one card and leaves these
    activation cut points out.
  * ``use_mesh(mesh)`` installs the current mesh (the engine's sharded epoch
    mode reads it) and gives the block a fresh fallback log.
  * mesh constructors: ``make_mesh`` (a ``DeviceMesh`` over the ranks of the
    default process group, which the caller set up: the port never picks a
    backend for it), ``make_host_mesh`` and ``make_production_mesh``.
  * ``all_reduce`` / ``broadcast`` over the ranks of some mesh axes, counted
    in ``COLLECTIVES`` (and their bytes in ``COLLECTIVE_BYTES``, and both a
    kind and group size in ``COLLECTIVE_TOTALS``), and
    ``barrier`` (``BARRIERS``): the only collectives the port issues itself.
  * LM training on a mesh (``train.optimizer``): ``batch_rows`` (a rank's
    rows of every batch leaf over the data axes), ``whole`` (a weight whole
    on use), ``place`` / ``place_tree`` / ``zeros`` (placed from whole
    tensors or allocated as slices), ``region`` (the slice a rank holds),
    ``all_reduce_buckets`` (a fixed-order bucketed sum) and
    ``broadcast_regions`` (the ZeRO update's regions sent over the data
    axes).
  * Serving on a mesh (``serve.serving.BatchedServer(mesh=)``):
    ``place_serve`` (a cache leaf as a DTensor of this rank's own
    allocation, its slice and a landing row or block of its own),
    ``layer_view`` (one layer of it, no communication), ``gather_serve`` /
    ``write_back`` (a leaf made whole along some dims for one layer, then
    this rank's slice written back), ``split_axes``, ``join`` (the exact
    zero-padded sum of partial attention outputs) and ``agree`` (global
    rank 0's sampled tokens and clock reading, one broadcast a fused step).

``AbstractMesh(sizes, names)`` sizes a mesh without ranks, for the resolver
and the engine's path decision. ``repro``'s ``shard_map`` and its jax
version compatibility code have no counterpart: the engine's sharded epoch
calls the collectives itself (ROADMAP §A).

The fallback log also takes the decisions a caller made against what it was
asked for (a server that serves gather attention where the kernel was asked
for), which callers record with ``record_fallback``. The log and the current
mesh are per thread, as in ``repro``. The sharded server records its
``serve_cache`` decisions there (``BatchedServer.sharded_path``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import sys
import threading

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

Mesh = DeviceMesh


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them (the dim
    split over several axes, the first the major one), or None
    (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class AbstractMesh:
    """A mesh's axis names and sizes without ranks or devices:
    ``AbstractMesh((2, 4), ("data", "model"))``. ``.shape`` maps each axis
    name to its size."""

    def __init__(self, sizes, names):
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
        self.axis_names = names
        self.axis_sizes = sizes

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __eq__(self, other) -> bool:
        return isinstance(other, AbstractMesh) and (
            (self.axis_sizes, self.axis_names) == (other.axis_sizes, other.axis_names))

    def __hash__(self) -> int:
        return hash((self.axis_sizes, self.axis_names))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def is_mesh(mesh) -> bool:
    return isinstance(mesh, (DeviceMesh, AbstractMesh))


# ---------------------------------------------------------------------------
# Rule tables: logical axis -> mesh axis (str), joint axes (tuple), or None.
# Tuples are assigned greedily left-to-right, each axis subject to the
# divisibility check against the product accepted so far.
# ---------------------------------------------------------------------------
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    # data parallelism (pod spans the DCN boundary when present)
    "batch": ("pod", "data"),
    # engine thread dim: the strider-decoded tuple stream (paper's parallel
    # Striders feeding the multi-threaded execution engine)
    "tuples": ("pod", "data"),
    # heap pages streamed into the access engine: decode is page-parallel
    # (each rank's Strider decodes its local page range)
    "heap_pages": ("pod", "data"),
    # paged serving KV: the block pool spreads over the data axes (blocks are
    # the unit of placement, like heap pages for the Striders); the in-block
    # token dim never shards
    "kv_blocks": ("pod", "data"),
    # ZeRO-partitioned optimizer-state dim (train.optimizer.state_specs)
    "zero": ("pod", "data"),
    # tensor parallelism (Megatron TP pattern)
    "vocab": "model",
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "inner": "model",
}

# FSDP: params additionally shard their embed dim over the data axes
# (gathered on use), on top of the standard TP rules.
FSDP_PARAM_RULES: dict[str, str | tuple[str, ...] | None] = dict(
    DEFAULT_RULES, embed=("pod", "data")
)

# Engine model-axis sharding (wide GLMs / LRMF): the feature dim of GLM
# coefficient vectors, and of the decoded tuple stream feeding them, is
# partitioned over the mesh's model axis; LRMF factor matrices reuse the
# same "features" name for their item dim (rank stays replicated). Opt-in
# via Engine/solver.train(shard_model=True); DEFAULT_RULES keeps "features"
# unsharded so data-only meshes never pay feature collectives.
MODEL_SHARD_RULES: dict[str, str | tuple[str, ...] | None] = dict(
    DEFAULT_RULES, features="model", rank=None
)

# Serving KV/state caches: slots, the cache batch dim, spread over the data
# axes, heads/features over the model axis. The sequence dim stays
# rank-local on purpose: continuous batching writes every slot's row at its
# own position each step (a per-row scatter), so sharding kv_seq would turn
# each decode write into a cross-shard update. Explicit Nones document the
# dims that must remain replicated.
SERVE_CACHE_RULES: dict[str, str | tuple[str, ...] | None] = dict(
    DEFAULT_RULES,
    layers=None, kv_seq=None, seq=None, head_dim=None, lora=None,
    state=None, conv=None, embed=None, block=None,
)

# Kernel-path variant: the paged-attention kernel walks the whole block pool
# through a block table (any token may map any physical block), so the
# pool's block dim must stay replicated.
SERVE_KERNEL_CACHE_RULES: dict[str, str | tuple[str, ...] | None] = dict(
    SERVE_CACHE_RULES, kv_blocks=None,
)


# ---------------------------------------------------------------------------
# Current-mesh context + fallback bookkeeping (thread-local)
# ---------------------------------------------------------------------------
_STATE = threading.local()


def current_mesh():
    """The mesh installed by the innermost ``use_mesh``, or None."""
    return getattr(_STATE, "mesh", None)


def _fallback_log() -> list:
    log = getattr(_STATE, "fallbacks", None)
    if log is None:
        log = _STATE.fallbacks = []
    return log


def fallbacks() -> list[tuple[str | None, tuple[str, int], str]]:
    """Drops recorded since the current ``use_mesh`` was entered (or since
    ``clear_fallbacks``): ``(tensor_name, (logical_axis, dim), why)``."""
    return list(_fallback_log())


def clear_fallbacks() -> None:
    _fallback_log().clear()


def record_fallback(tensor_name, logical_axis, dim, why) -> None:
    """Record one fallback; an entry already in the log is not repeated.
    Callers that make their own decisions (the engine's sharded path, the
    server) land in the same ``fallbacks()`` report as the resolver."""
    entry = (tensor_name, (logical_axis, dim), why)
    log = _fallback_log()
    if entry not in log:
        log.append(entry)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the current mesh for ``shard_act`` and the engine's
    sharded epoch mode. Each block gets a fresh fallback log so it reports
    its own drops; the enclosing block's log is restored (not lost) on
    exit."""
    prev_mesh = current_mesh()
    prev_log = _fallback_log()
    _STATE.mesh = mesh
    _STATE.fallbacks = []
    try:
        yield mesh
    finally:
        _STATE.mesh = prev_mesh
        _STATE.fallbacks = prev_log


# ---------------------------------------------------------------------------
# Resolver
# ---------------------------------------------------------------------------
def _axis_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the port's meshes name their axes (make_mesh)")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one ``PartitionSpec`` entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_spec(
    logical_axes,
    shape,
    mesh,
    rules: dict | None = None,
    tensor_name: str | None = None,
) -> PartitionSpec:
    """Resolve logical axis names against ``mesh`` -> ``PartitionSpec``.

    Per dim, the rule table yields a mesh axis (or a tuple tried greedily
    left-to-right). An axis is assigned iff it exists in the mesh, has size
    > 1, was not already used by an earlier dim of this tensor, and the dim
    size is divisible by the accumulated shard count; a divisibility miss is
    recorded in ``fallbacks()`` and the dim stays (partially) replicated.
    """
    logical_axes = tuple(logical_axes)
    shape = tuple(shape)
    if len(logical_axes) != len(shape):
        raise ValueError(
            f"rank mismatch for {tensor_name or 'tensor'}: "
            f"axes {logical_axes} vs shape {shape}"
        )
    rules = DEFAULT_RULES if rules is None else rules
    sizes = _axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, (name, dim_size) in enumerate(zip(logical_axes, shape)):
        cand = rules.get(name)
        if cand is None:
            out.append(None)
            continue
        if isinstance(cand, str):
            cand = (cand,)
        picked: list[str] = []
        shards = 1
        for axis in cand:
            if axis not in sizes or sizes[axis] <= 1 or axis in used:
                continue  # absent/degenerate/taken: not a fallback, just n/a
            if dim_size % (shards * sizes[axis]) != 0:
                record_fallback(
                    tensor_name, name, dim,
                    f"dim {dim_size} not divisible by mesh axis "
                    f"'{axis}'={sizes[axis]} (x{shards} already assigned)",
                )
                continue
            picked.append(axis)
            shards *= sizes[axis]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return PartitionSpec(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement on ``mesh``: ``spec`` by tensor dim, and the same
    as DTensor ``placements``, one per mesh dim."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(_axis_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            for axis in entry_axes(entry):
                out[names.index(axis)] = Shard(dim)
        return tuple(out)

    @property
    def is_replicated(self) -> bool:
        return all(entry is None for entry in self.spec)


def named_sharding(
    logical_axes,
    shape,
    mesh,
    *,
    rules: dict | None = None,
    tensor_name: str | None = None,
) -> NamedSharding:
    """``NamedSharding`` for one tensor from its logical axes."""
    spec = resolve_spec(
        logical_axes, shape, mesh, rules=rules, tensor_name=tensor_name
    )
    return NamedSharding(mesh, spec)


def _is_spec(node) -> bool:
    return isinstance(node, tuple) and all(
        isinstance(e, (str, type(None))) for e in node
    )


def tree_shardings(specs, tree, mesh, rules: dict | None = None):
    """NamedShardings for a tree of dicts, lists and tuples: ``specs`` is a
    parallel tree whose leaves are logical-axis tuples (params, optimizer
    state, caches); ``tree`` holds tensors or anything with a ``.shape``.
    Key paths become the tensor names in the fallback report. Dict keys are
    walked in sorted order, as ``jax.tree_util`` walks them, so the report
    lists the drops in ``repro``'s order."""

    def walk(spec, leaf, path):
        if _is_spec(spec):
            return named_sharding(
                spec, tuple(leaf.shape), mesh, rules=rules,
                tensor_name="/".join(path) or None,
            )
        if spec is None:
            return None
        if isinstance(spec, dict):
            return {k: walk(spec[k], leaf[k], path + [str(k)]) for k in sorted(spec)}
        if isinstance(spec, (list, tuple)):
            return type(spec)(
                walk(s, l, path + [str(i)]) for i, (s, l) in enumerate(zip(spec, leaf))
            )
        raise TypeError(f"spec tree node {spec!r} at {'/'.join(path) or 'root'}")

    return walk(specs, tree, [])


def replicated(mesh) -> NamedSharding:
    """Fully-replicated NamedSharding (models, scalars)."""
    return NamedSharding(mesh, PartitionSpec())


def mesh_axis_size(mesh, *axis_names) -> int:
    """Product of the named axes present in ``mesh`` (missing axes count 1)."""
    sizes = _axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in axis_names)


def mesh_data_axes(mesh) -> tuple[str, ...]:
    """The mesh's non-degenerate data-parallel axes, in rule order: the axes
    the engine's sharded epoch splits the tuple stream over."""
    sizes = _axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)


# ---------------------------------------------------------------------------
# This rank's place on a DeviceMesh
# ---------------------------------------------------------------------------
def shard_index(mesh: DeviceMesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes`` taken together, the
    first axis the major one: the shard of a dim split over ``axes`` that
    this rank holds."""
    sizes = _axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for axis in entry_axes(axes):
        index = index * sizes[axis] + coord[axis]
        count *= sizes[axis]
    return index, count


def shard_range(length: int, mesh: DeviceMesh, axes) -> tuple[int, int]:
    """[start, stop) of this rank's shard of a dim of ``length`` split evenly
    over ``axes``."""
    index, count = shard_index(mesh, axes)
    if length % count:
        raise ValueError(f"dim {length} does not split evenly over {axes} ({count})")
    step = length // count
    return index * step, (index + 1) * step


def axis_ranks(mesh: DeviceMesh, axes) -> list[int]:
    """The global ranks of this rank's group over ``axes``: the ranks that
    share its coordinates on every other mesh axis, in shard-index order."""
    names = list(mesh.mesh_dim_names)
    axes = entry_axes(axes)
    coord = mesh.get_coordinate()
    grid = mesh.mesh.permute(
        [names.index(a) for a in names if a not in axes] + [names.index(a) for a in axes]
    )
    fixed = tuple(coord[names.index(a)] for a in names if a not in axes)
    return grid[fixed].reshape(-1).tolist()


_GROUPS: dict = {}  # (id(mesh), axes) -> (mesh, this rank's group)


def axis_group(mesh: DeviceMesh, axes):
    """This rank's process group over ``axes``, or None where they hold one
    rank. Groups over several axes are made on first use, by every rank in
    the same order (``new_group`` over each of the mesh's groups)."""
    sizes = _axis_sizes(mesh)
    axes = tuple(a for a in entry_axes(axes) if sizes.get(a, 1) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is None:
        names = list(mesh.mesh_dim_names)
        others = [names.index(a) for a in names if a not in axes]
        grid = mesh.mesh.permute(others + [names.index(a) for a in axes])
        grid = grid.reshape(-1, math.prod(sizes[a] for a in axes))
        mine = None
        for ranks in grid.tolist():
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        hit = _GROUPS[key] = (mesh, mine)
    return hit[1]


# ---------------------------------------------------------------------------
# The collectives the port issues: all_reduce and broadcast only (gloo on
# CUDA tensors runs nothing else), each counted
# ---------------------------------------------------------------------------
COLLECTIVES = {"all_reduce": 0, "broadcast": 0}
COLLECTIVE_BYTES = {"all_reduce": 0, "broadcast": 0}  # the bytes each rank passed in
# {(kind, group size): [calls, bytes]}: what roofline.collectives.collective_stats
# prices (a ring's wire bytes are linear in bytes for a kind and group size, so
# totals price as the calls would; its size stays that of the kinds and groups)
COLLECTIVE_TOTALS: dict[tuple[str, int], list[int]] = {}
BARRIERS = {"barrier": 0}
REDUCE_OPS = {"+": "SUM", "*": "PRODUCT", "max": "MAX"}  # the merge operators


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes, op: str = "+") -> torch.Tensor:
    """Reduce ``t`` in place over this rank's group on ``axes`` (no-op where
    the axes hold one rank). ``op`` is a merge operator: ``+``, ``*`` or
    ``max``."""
    group = axis_group(mesh, axes) if entry_axes(axes) else None
    if group is None:
        return t
    dist.all_reduce(t, op=getattr(dist.ReduceOp, REDUCE_OPS[op]), group=group)
    _count("all_reduce", t, dist.get_world_size(group))
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Broadcast ``t`` in place from global rank ``src`` over ``group``."""
    dist.broadcast(t, src=src, group=group)
    _count("broadcast", t, dist.get_world_size(group))
    return t


def _count(kind: str, t: torch.Tensor, group_size: int) -> None:
    nbytes = t.numel() * t.element_size()
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += nbytes
    tot = COLLECTIVE_TOTALS.setdefault((kind.replace("_", "-"), group_size), [0, 0])
    tot[0] += 1
    tot[1] += nbytes


def barrier() -> None:
    """Wait for every rank of the default group (counted in ``BARRIERS``)."""
    dist.barrier()
    BARRIERS["barrier"] += 1


def reset_collectives() -> None:
    for counts in (COLLECTIVES, COLLECTIVE_BYTES, BARRIERS):
        for k in counts:
            counts[k] = 0
    COLLECTIVE_TOTALS.clear()


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    if "torch.distributed.tensor" not in sys.modules:  # nothing made one yet
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_slices(shape, sharding: NamedSharding) -> tuple:
    """The slices of a tensor of ``shape`` that this rank holds under
    ``sharding``."""
    index = []
    for dim, entry in enumerate(sharding.spec):
        axes = entry_axes(entry)
        if not axes:
            index.append(slice(None))
            continue
        start, stop = shard_range(shape[dim], sharding.mesh, axes)
        index.append(slice(start, stop))
    return tuple(index)


def local_slice(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` under ``sharding``
    (contiguous; ``x`` itself where the spec is fully replicated)."""
    if sharding.is_replicated:
        return x
    return x[shard_slices(x.shape, sharding)].contiguous()


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides), with nothing allocated."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def from_local(local: torch.Tensor, sharding: NamedSharding, shape) -> torch.Tensor:
    """``local`` as this rank's part of a tensor of ``shape`` placed by
    ``sharding``: a DTensor where the spec shards a dim, else ``local``
    itself (the whole tensor, the same on every rank). No communication."""
    if sharding.is_replicated:
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def device_put(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (whole, the same on every rank) placed by ``sharding``: a
    DTensor built from this rank's slice. Nothing is sent."""
    from torch.distributed.tensor import DTensor

    if is_dtensor(x):
        x = full_tensor(x)
    return DTensor.from_local(local_slice(x, sharding), sharding.mesh, sharding.placements,
                              run_check=False, shape=x.shape, stride=contiguous_stride(x.shape))


def full_tensor(x, device=None):
    """The whole tensor of a DTensor on every rank (on ``device``, the local
    tensor's by default: ``"cpu"`` gathers through the host), from one
    broadcast per shard within the group of ranks that share this rank's
    coordinates on the replicated mesh dims (every such group holds all the
    shards); any other tensor as it is. Every rank of the mesh must call
    it, for the same tensors in the same order."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    mesh, placements, local = x.device_mesh, x.placements, x.to_local()
    device = local.device if device is None else torch.device(device)
    if mesh.size() == 1:
        return local.to(device)
    if mesh.size() != dist.get_world_size():
        raise ValueError("full_tensor needs a mesh over the whole process group")
    names = mesh.mesh_dim_names
    axes = tuple(n for n, p in zip(names, placements) if not isinstance(p, Replicate))
    group = axis_group(mesh, axes)
    out = torch.empty(x.shape, dtype=local.dtype, device=device)
    me = dist.get_rank()
    for rank in axis_ranks(mesh, axes):
        coord = _coord_of(mesh, rank)
        index = []
        for tdim in range(x.dim()):
            # the mesh dims that split this tensor dim, the first the major one
            index_in, count = 0, 1
            for d, p in enumerate(placements):
                if not isinstance(p, Replicate) and p.dim == tdim:
                    index_in, count = index_in * mesh.shape[d] + coord[d], count * mesh.shape[d]
            step = x.shape[tdim] // count
            index.append(slice(index_in * step, (index_in + 1) * step))
        if rank == me:
            part = local.to(device, copy=True)
        else:
            part = torch.empty(local.shape, dtype=local.dtype, device=device)
        if group is not None:
            broadcast(part, src=rank, group=group)
        out[tuple(index)] = part
    return out


def shard_act(x, logical_axes, tag: str | None = None, rules: dict | None = None):
    """``x`` placed by its resolved sharding under the current mesh; the
    same object when no mesh is installed, when the spec resolves fully
    replicated, or under an ``AbstractMesh`` (which has no ranks)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = resolve_spec(
        logical_axes, x.shape, mesh, rules=rules, tensor_name=tag
    )
    if all(s is None for s in spec) or not isinstance(mesh, DeviceMesh):
        return x
    sharding = NamedSharding(mesh, spec)
    if is_dtensor(x) and x.device_mesh is mesh and tuple(x.placements) == sharding.placements:
        return x
    return device_put(x, sharding)


# ---------------------------------------------------------------------------
# LM training on a mesh: the batch's rows, weights whole on use, placed
# trees, and the fixed-order buckets of the gradient sum and the region
# broadcast
# ---------------------------------------------------------------------------
BUCKET_BYTES = 256 << 20  # the largest flat buffer one collective carries


def is_multi_rank(mesh) -> bool:
    """Whether ``mesh`` has ranks to shard over: a ``DeviceMesh`` of more
    than one rank (None, an ``AbstractMesh`` and a one-rank mesh do not)."""
    return isinstance(mesh, DeviceMesh) and mesh.size() > 1


def batch_rows(batch: dict, mesh: DeviceMesh):
    """This rank's rows of every leaf of ``batch`` (leading dim ``batch``)
    and the mesh axes they were split over. A batch whose rows do not
    divide the data axes stays whole on every rank, with the drop recorded
    as the resolver records it, and the axes are then ``()``."""
    axes = None
    for key in sorted(batch):
        x = batch[key]
        spec = resolve_spec(("batch",) + (None,) * (x.dim() - 1), x.shape, mesh,
                            tensor_name=key)
        picked = entry_axes(spec[0])
        if axes is not None and picked != axes:
            raise ValueError(f"batch leaf {key!r} has {x.shape[0]} rows, not the "
                             "other leaves' count")
        axes = picked
    if not axes:
        return dict(batch), ()
    out = {}
    for key, x in batch.items():
        start, stop = shard_range(x.shape[0], mesh, axes)
        out[key] = x[start:stop]
    return out, axes


def whole(x, device=None):
    """The whole tensor of ``x`` on this rank: a DTensor that shards a dim
    gathered by ``full_tensor`` (every rank of the mesh must call it; onto
    ``device`` where given), a replicated one its local tensor, any other
    tensor itself."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    if all(isinstance(p, Replicate) for p in x.placements):
        return x.to_local()
    return full_tensor(x, device)


def local(x):
    """This rank's part of ``x``: a DTensor's local tensor (an alias, so an
    in-place update lands in ``x``), any other tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def place(x, sharding: NamedSharding):
    """``x`` (whole, the same on every rank; a DTensor is made whole first)
    placed by ``sharding`` with no communication: a DTensor of this rank's
    slice where the spec shards a dim, else the whole tensor itself."""
    x = whole(x)
    return from_local(local_slice(x, sharding), sharding, tuple(x.shape))


def zeros(shape, sharding: NamedSharding, dtype, device):
    """Zeros of ``shape`` placed by ``sharding``: only this rank's slice is
    allocated."""
    part = list(shape)
    for dim, sl in enumerate(shard_slices(shape, sharding)):
        part[dim] = len(range(*sl.indices(shape[dim])))
    return from_local(torch.zeros(part, dtype=dtype, device=device), sharding, tuple(shape))


def _walk_pair(tree, shardings, fn, path):
    if isinstance(tree, dict):
        if not isinstance(shardings, dict) or set(shardings) != set(tree):
            raise ValueError(f"shardings do not match the tree at {path or 'root'}: "
                             f"{sorted(tree)} vs {shardings!r:.80}")
        return {k: _walk_pair(v, shardings[k], fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if not isinstance(shardings, (list, tuple)) or len(shardings) != len(tree):
            raise ValueError(f"shardings do not match the tree at {path or 'root'}")
        out = [_walk_pair(v, shardings[i], fn, f"{path}/{i}") for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if not isinstance(shardings, NamedSharding):
        raise ValueError(f"shardings do not match the tree at {path or 'root'}: "
                         f"a leaf, and {type(shardings).__name__} where a NamedSharding goes")
    return fn(tree, shardings)


def check_tree_shardings(tree, shardings) -> None:
    """Raise ``ValueError`` unless ``shardings`` has ``tree``'s structure, a
    ``NamedSharding`` at every leaf."""
    _walk_pair(tree, shardings, lambda x, sh: None, "")


def place_tree(tree, shardings):
    """Each leaf of ``tree`` placed by the matching ``NamedSharding`` of
    ``shardings`` (``place``); the tree keeps its own key order. Raises
    ``ValueError`` where the two trees do not match."""
    return _walk_pair(tree, shardings, place, "")


def region(x, coord=None) -> tuple:
    """The slices of the whole tensor that the rank at mesh coordinate
    ``coord`` (this rank's by default) holds of ``x``: its shard of a
    DTensor (a dim split over several mesh dims, the first the major one,
    as ``full_tensor`` reads it), all of any other tensor."""
    if not is_dtensor(x):
        return tuple(slice(0, n) for n in x.shape)
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    coord = mesh.get_coordinate() if coord is None else coord
    out = []
    for tdim, n in enumerate(x.shape):
        index, count = 0, 1
        for d, p in enumerate(x.placements):
            if not isinstance(p, Replicate) and p.dim == tdim:
                index, count = index * mesh.shape[d] + coord[d], count * mesh.shape[d]
        step = n // count
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def _pieces(views, bucket_bytes):
    """``views`` in order, each one larger than a bucket split along its
    leading dim into pieces of at most ``bucket_bytes``."""
    for v in views:
        nbytes = v.numel() * v.element_size()
        if v.dim() == 0 or nbytes <= bucket_bytes:
            yield v
            continue
        row = nbytes // v.shape[0]
        yield from torch.split(v, max(1, bucket_bytes // max(row, 1)))


def _buckets(views, bucket_bytes):
    """Consecutive runs of ``_pieces(views)`` of one dtype and at most
    ``bucket_bytes`` together: the flat buffers of the collectives, the same
    on every rank."""
    run, size = [], 0
    for v in _pieces(views, bucket_bytes):
        nbytes = v.numel() * v.element_size()
        if run and (size + nbytes > bucket_bytes or v.dtype != run[0].dtype):
            yield run
            run, size = [], 0
        run.append(v)
        size += nbytes
    if run:
        yield run


def _unpack(flat, views):
    offset = 0
    for v in views:
        v.copy_(flat[offset:offset + v.numel()].view(v.shape))
        offset += v.numel()


def all_reduce_buckets(tensors, mesh: DeviceMesh, axes, bucket_bytes: int = BUCKET_BYTES):
    """Sum each of ``tensors`` in place over ``axes``, in fixed-order flat
    buckets of at most ``bucket_bytes`` (a lone contiguous piece is reduced
    where it lies). Every rank of the group gets the same bits."""
    if axis_group(mesh, axes) is None:
        return
    for run in _buckets(tensors, bucket_bytes):
        if len(run) == 1 and run[0].is_contiguous():
            all_reduce(run[0], mesh, axes)
            continue
        flat = torch.cat([v.reshape(-1) for v in run])
        all_reduce(flat, mesh, axes)
        _unpack(flat, run)


def _coord_of(mesh: DeviceMesh, rank: int) -> list[int]:
    return [int(i) for i in (mesh.mesh == rank).nonzero()[0]]


def broadcast_regions(pairs, mesh: DeviceMesh, axes, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Make whole, on every rank of this rank's group over ``axes``, the
    parts of targets that the group's ranks updated each on its own region.
    ``pairs`` holds (target, owner): the target a weight (a DTensor or a
    whole tensor), the owner a DTensor of the same shape (its moment) whose
    placement gives each rank's region of it. A region is sent by the first
    rank of the group that holds it, in fixed-order buckets, one broadcast
    each; pairs whose owner does not split the target over ``axes`` send
    nothing."""
    group = axis_group(mesh, axes)
    if group is None:
        return
    members = axis_ranks(mesh, axes)
    me = dist.get_rank()
    sends = {r: [] for r in members}
    for target, owner in pairs:
        mine = region(target)
        seen = set()
        for r in members:
            reg = region(owner, _coord_of(mesh, r))
            key = tuple((s.start, s.stop) for s in reg)
            if reg == mine or key in seen:
                continue
            seen.add(key)
            rel = tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(reg, mine))
            sends[r].append(local(target)[rel])
    for src in members:
        for run in _buckets(sends[src], bucket_bytes):
            if src == me:
                flat = torch.cat([v.reshape(-1) for v in run])
            else:
                flat = torch.empty(sum(v.numel() for v in run), dtype=run[0].dtype,
                                   device=run[0].device)
            broadcast(flat, src=src, group=group)
            if src != me:
                _unpack(flat, run)


# ---------------------------------------------------------------------------
# Serving on a mesh: cache leaves with a landing row of their own, a leaf
# made whole for one layer, the exact join, and the rank-0 step broadcast
# ---------------------------------------------------------------------------
def place_serve(x, sharding: NamedSharding, landing: bool):
    """The whole layer-stacked cache leaf ``x`` (dim 1 the slots or blocks,
    with a landing row or block after them when ``landing``) placed by
    ``sharding``, which was resolved on the shape without the landing: a
    DTensor whose shape is that logical one and whose local tensor is this
    rank's own contiguous allocation, its slice of the real rows followed,
    with ``landing``, by a landing row of its own (so a rank's gated-off
    writes stay on it). A replicated spec keeps ``x`` itself."""
    if sharding.is_replicated:
        return x
    shape = list(x.shape)
    shape[1] -= int(landing)
    index = shard_slices(shape, sharding)
    part = x[:, :shape[1]][index]
    if landing:
        part = torch.cat([part, x[(slice(None), slice(shape[1], shape[1] + 1)) + index[2:]]],
                         dim=1)
    return from_local(part.contiguous() if landing else part.clone(), sharding, tuple(shape))


def layer_view(x, i: int):
    """Layer ``i`` of a layer-stacked leaf: ``x[i]``; of a DTensor (placed
    by ``place_serve``), the DTensor of its local tensor's layer ``i``, its
    placements one dim lower. No communication."""
    if not is_dtensor(x):
        return x[i]
    from torch.distributed.tensor import DTensor, Shard

    placements = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in x.placements)
    shape = torch.Size(x.shape[1:])
    return DTensor.from_local(x.to_local()[i], x.device_mesh, placements, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def split_axes(x, dims=None) -> tuple[str, ...]:
    """The mesh axes that split ``x``'s tensor dims ``dims`` (every dim by
    default): () for a tensor that is not a DTensor."""
    if not is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    return tuple(names[d] for d, p in enumerate(x.placements)
                 if isinstance(p, Shard) and (dims is None or p.dim in dims))


def _real(x) -> tuple:
    """The slices of ``x``'s local tensor that hold its real rows (all of
    it but a landing row or block)."""
    return tuple(slice(0, s.stop - s.start) for s in region(x))


def gather_serve(x, dims=None):
    """A cache leaf placed by ``place_serve`` (one layer of it) made whole
    along its tensor dims ``dims`` (every dim it splits by default), from
    one broadcast per rank of the group over those dims' mesh axes, each
    rank's real rows; a landing row of zeros follows the rows of a leaf
    that has one (only the first dim may carry it, and it must be among
    the dims made whole). Every rank of the group calls it, for the same
    leaves in the same order. Returns (the tensor, this rank's slices of
    it), which ``write_back`` takes; where no such dim is split, the local
    tensor itself and None."""
    axes = split_axes(x, dims)
    if not axes:
        return local(x), None
    loc, mine, real = x.to_local(), region(x), _real(x)
    tdims = {p.dim for p in x.placements if p.is_shard() and (dims is None or p.dim in dims)}
    extra = loc.shape[0] - real[0].stop
    if extra and 0 not in tdims:
        raise ValueError("a landing row is made whole with its own dim")
    shape = [x.shape[t] + (extra if t == 0 else 0) if t in tdims else loc.shape[t]
             for t in range(x.dim())]
    out = torch.empty(shape, dtype=loc.dtype, device=loc.device)
    if extra:
        out[x.shape[0]:] = 0
    group, me = axis_group(x.device_mesh, axes), dist.get_rank()
    for rank in axis_ranks(x.device_mesh, axes):
        theirs = region(x, _coord_of(x.device_mesh, rank))
        part = (loc[real].contiguous() if rank == me
                else torch.empty(tuple(s.stop - s.start for s in theirs), dtype=loc.dtype,
                                 device=loc.device))
        broadcast(part, src=rank, group=group)
        out[tuple(theirs[t] if t in tdims else real[t] for t in range(x.dim()))] = part
    return out, tuple(mine[t] if t in tdims else real[t] for t in range(x.dim()))


def write_back(x, whole_x, own) -> None:
    """Copy this rank's slices ``own`` of ``whole_x`` (from ``gather_serve``)
    into the real rows of ``x``'s local tensor; nothing where ``own`` is
    None (``whole_x`` is that local tensor)."""
    if own is not None:
        x.to_local()[_real(x)] = whole_x[own]


def join(part: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The partial results of the ranks of the group over ``axes`` joined in
    place: ``part`` (f32) holds this rank's results at its own rows or heads
    and zeros elsewhere, and one ``all_reduce`` SUM adds them. Each element
    is one rank's value plus zeros, so the join rounds nothing."""
    if part.dtype != torch.float32:
        raise TypeError(f"the join sums f32 parts, got {part.dtype}")
    return all_reduce(part, mesh, axes) if axes else part


def agree(values, clock: float, src: int = 0):
    """Global rank ``src``'s int32 ``values`` (a host array) and ``clock``
    reading on every rank of the default group: one broadcast of one host
    tensor, the values followed by the reading's float64 bits. Returns (the
    values, the reading)."""
    import numpy as np

    values = np.asarray(values, np.int32)
    flat = np.concatenate([values.ravel(), np.asarray([clock], np.float64).view(np.int32)])
    t = torch.from_numpy(flat)
    broadcast(t, src=src)
    got = t.numpy()
    return got[:-2].reshape(values.shape), float(got[-2:].view(np.float64)[0])


# ---------------------------------------------------------------------------
# Mesh constructors
# ---------------------------------------------------------------------------
def _device_type(device) -> str:
    """``None`` means the card, as everywhere in the port; asking for a card
    that is not there raises."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return kind


def make_mesh(axis_shapes, axis_names, *, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the ranks
    of the default process group, in rank order. The caller sets the group
    up (``torch.distributed.init_process_group``, its backend its choice);
    the mesh's size must be the group's."""
    device_type = _device_type(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "torch.distributed.init_process_group first (make_host_mesh makes "
            "a one-rank group for a lone process)"
        )
    axis_shapes, axis_names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    n, world = math.prod(axis_shapes), dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {axis_shapes} needs {n} ranks; the group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(axis_shapes),
                      mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model). Multi-pod: 2x16x16 = 512
    ranks (pod, data, model); the pod axis carries pure data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {math.prod(shape)} "
            f"ranks; this process group has {world}"
        )
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_parallel: int = 1, *, device=None) -> DeviceMesh:
    """(world // mp, mp) named ("data", "model") over the default process
    group's ranks. A lone process with no group first makes a one-rank group
    (its backend torch's default), so it gets a (1, 1) mesh, as ``repro``
    does on one device."""
    _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    if n % mp:
        raise ValueError(f"model_parallel {mp} does not divide the {n} ranks")
    return make_mesh((n // mp, mp), ("data", "model"), device=device)


__all__ = [
    "AbstractMesh",
    "COLLECTIVES",
    "COLLECTIVE_TOTALS",
    "DEFAULT_RULES",
    "FSDP_PARAM_RULES",
    "MODEL_SHARD_RULES",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "SERVE_CACHE_RULES",
    "SERVE_KERNEL_CACHE_RULES",
    "BARRIERS",
    "BUCKET_BYTES",
    "COLLECTIVE_BYTES",
    "agree",
    "all_reduce",
    "all_reduce_buckets",
    "axis_group",
    "axis_ranks",
    "barrier",
    "batch_rows",
    "broadcast",
    "broadcast_regions",
    "check_tree_shardings",
    "clear_fallbacks",
    "contiguous_stride",
    "current_mesh",
    "device_put",
    "fallbacks",
    "entry_axes",
    "from_local",
    "full_tensor",
    "gather_serve",
    "join",
    "layer_view",
    "shard_slices",
    "is_dtensor",
    "is_mesh",
    "is_multi_rank",
    "local",
    "local_slice",
    "make_host_mesh",
    "make_mesh",
    "make_production_mesh",
    "mesh_axis_size",
    "mesh_data_axes",
    "named_sharding",
    "place",
    "place_serve",
    "place_tree",
    "record_fallback",
    "region",
    "replicated",
    "reset_collectives",
    "resolve_spec",
    "shard_act",
    "shard_index",
    "shard_range",
    "split_axes",
    "tree_shardings",
    "use_mesh",
    "whole",
    "write_back",
    "zeros",
]
