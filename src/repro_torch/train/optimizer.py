"""AdamW with gradient clipping and warmup, and the train step (counterpart
of ``repro.train.optimizer``, which it is held against).

The update is in place: parameters and moments are tensors the step
overwrites, where the reference returns new arrays. A leaf of more than
``UPDATE_PIECE`` elements is walked in pieces of at most that many along its
leading axis, so its temporaries are two pieces and not two copies of the
leaf (a 4 GB stacked matrix at minicpm3-4b's full width, where the training
state leaves 18 GB of the card); a smaller leaf is one piece. Nothing is read back to
the host: the step counter, the learning rate, the gradient norm and the clip
scale stay tensors on the parameters' device.

On a mesh (``meshes.current_mesh()`` a ``DeviceMesh`` of more than one
rank, read at each call) the step is an explicit data-parallel step, where
the reference's jitted step lets GSPMD place the collectives (ROADMAP §C):

  * each rank takes its rows of the batch over the data axes
    (``meshes.batch_rows``); a batch that does not divide them stays whole;
  * the weights that the model axis shards are made whole for the step
    (``meshes.whole``) and freed after it: forward and backward run on the
    whole weights and the rank's rows (no tensor-parallel compute);
  * every loss term divides by its count summed over the data axes (one
    ``all_reduce`` of the loss function's ``counts``, ``layers.global_counts``),
    so the ranks' losses sum to the global batch's mean: one ``all_reduce``;
  * the gradients are summed over the data axes in fixed-order flat buckets
    of at most ``meshes.BUCKET_BYTES``: every rank holds the global gradient,
    and the clip norm is the same bits everywhere;
  * each rank runs AdamW on its region only, its model slice of a weight
    intersected with its ``zero`` slice of the moments (``state_specs``,
    placed by ``adamw_init(param_specs=)``), then broadcasts the region over
    the data axes (``meshes.broadcast_regions``).

Only ``all_reduce`` and ``broadcast`` are issued; there are no float
atomics, and a second run gives the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.dist import meshes
from repro_torch.models.layers import global_counts
from repro_torch.models.params import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "float32"
    zero_sharding: bool = True


def adamw_init(params, cfg: OptConfig, param_specs=None, rules=None):
    """Zero moments and step counter, on the parameters' device (on
    ``"meta"``: shapes only). On a mesh the moments are placed by
    ``state_specs`` (``state_shardings``) under ``rules`` (the default
    table, or ``meshes.FSDP_PARAM_RULES``): each rank allocates its slice
    only. ``param_specs`` and ``rules`` are the port's own keywords:
    ``param_specs`` gives the weights' logical axes; without it every dim
    counts as unnamed."""
    dt = getattr(torch, cfg.state_dtype)
    device = meshes.local(next(leaves(params))).device
    mesh = meshes.current_mesh()
    if meshes.is_multi_rank(mesh):
        sh = state_shardings(params, cfg, mesh, param_specs, rules)
        zeros = lambda p, s: meshes.zeros(p.shape, s, dt, meshes.local(p).device)
        return {"mu": tree_map(zeros, params, sh["mu"]), "nu": tree_map(zeros, params, sh["nu"]),
                "step": torch.zeros((), dtype=torch.int32, device=device)}
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def unnamed_specs(params):
    """A logical spec of unnamed dims for every leaf of ``params``: what the
    weights resolve to without specs (replicated), and what ``state_specs``
    takes for pure data parallelism."""
    return tree_map(lambda p: (None,) * p.dim(), params)


def param_shardings(params, mesh, param_specs=None):
    """The weights' ``NamedSharding`` tree on ``mesh`` under the default
    rules; every leaf replicated without ``param_specs``."""
    specs = unnamed_specs(params) if param_specs is None else param_specs
    return meshes.tree_shardings(specs, params, mesh)


def state_shardings(params, cfg: OptConfig, mesh, param_specs=None, rules=None):
    """The optimizer state's ``NamedSharding`` tree on ``mesh``: the moments
    by ``state_specs`` (the ``zero`` axis on the data axes) under ``rules``
    (the default table when None), the step replicated."""
    specs = unnamed_specs(params) if param_specs is None else param_specs
    shapes = {"mu": params, "nu": params, "step": torch.empty(())}
    return meshes.tree_shardings(state_specs(specs, cfg, params), shapes, mesh, rules=rules)


def state_specs(param_specs, cfg: OptConfig, param_shapes=None):
    """Logical specs for optimizer state: param spec + zero-shard the largest
    replicated dim (rule 'zero' -> data axis)."""
    def is_spec(x):
        return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)

    def zshard(spec, shape):
        if not cfg.zero_sharding or not spec:
            return spec
        cand = [(dim, i) for i, (dim, name) in enumerate(zip(shape, spec))
                if name in (None, "embed", "seq", "layers")]
        if not cand:
            return spec
        _, idx = max(cand)
        out = list(spec)
        out[idx] = "zero"
        return tuple(out)

    def walk(spec, shapes):
        if is_spec(spec):
            return spec if shapes is None else zshard(spec, tuple(shapes.shape))
        if isinstance(spec, dict):
            return {k: walk(v, None if shapes is None else shapes[k]) for k, v in spec.items()}
        return [walk(v, None if shapes is None else shapes[i]) for i, v in enumerate(spec)]

    mapped = walk(param_specs, param_shapes)
    return {"mu": mapped, "nu": mapped, "step": ()}


def lr_at(step, cfg: OptConfig):
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


# elements of a leaf the update computes at a time (256 MB in f32)
UPDATE_PIECE = 1 << 26


def _f32(x):
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _pieces(n_elements: int, rows: int) -> int:
    """Rows of a leaf's leading axis in each piece of the update."""
    n = -(-n_elements // UPDATE_PIECE)
    return max(1, -(-rows // n))


# elements of a block of the gradient norm's first reduction
NORM_BLOCK = 1 << 12


def _leaf_norm(g):
    """A gradient's f32 norm, in two reductions: over blocks of NORM_BLOCK
    elements, then over the blocks' norms. In one reduction over a leaf of
    tens of millions of elements ``torch.linalg.vector_norm`` on the CPU
    adds each lane's squares one after another and ends 1e-3 to 1e-2 short
    of ``repro``'s ``sqrt(jnp.sum(jnp.square(g)))`` (ROADMAP §C); in blocks
    it is within 1e-6 of the float64 norm from a thousand elements to the
    largest leaves, on the card as on the CPU (``tools/grad_norm_forms.py``
    times both forms)."""
    flat = g.reshape(-1)
    whole = flat.numel() - flat.numel() % NORM_BLOCK
    blocks = torch.linalg.vector_norm(flat[:whole].view(whole // NORM_BLOCK, NORM_BLOCK), dim=1,
                                      dtype=torch.float32)
    rest = torch.linalg.vector_norm(flat[whole:], dtype=torch.float32).reshape(1)
    return torch.linalg.vector_norm(torch.cat([blocks, rest]))


def _region_views(p, g, mu, nu):
    """The part of a leaf this rank updates: the moments' region of the
    whole tensor (all of it where they are not placed), as views of the
    weight's local tensor and of the whole gradient, with the local
    moments."""
    if not (meshes.is_dtensor(mu) or meshes.is_dtensor(p)):
        return p, g, mu, nu
    held = meshes.region(p)
    if not meshes.is_dtensor(mu):  # whole moments of a placed weight: its slice of them
        return meshes.local(p), g[held], mu[held], nu[held]
    reg = meshes.region(mu)
    rel = tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(reg, held))
    return meshes.local(p)[rel], g[reg], meshes.local(mu), meshes.local(nu)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place on ``params`` and ``state``. Returns (params, state, {"grad_norm",
    "lr"}), the last two as device tensors. ``grads`` are whole tensors;
    where the moments are placed on a mesh, each rank updates its region of
    each weight and broadcasts it over the data axes."""
    step = state["step"] + 1
    lr = lr_at(step, cfg)
    flat_g = list(leaves(grads))
    gnorm = torch.linalg.vector_norm(torch.stack([_leaf_norm(g) for g in flat_g]))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    placed = []  # (weight, moment) pairs placed on a mesh
    for p, g, mu, nu in zip(leaves(params), flat_g, leaves(state["mu"]), leaves(state["nu"])):
        if meshes.is_dtensor(mu):
            placed.append((p, mu))
        leaf = _region_views(p, g, mu, nu)
        if leaf[0].dim() == 0:
            pieces = [leaf]
        else:
            rows = _pieces(leaf[0].numel(), leaf[0].shape[0])
            pieces = zip(*(torch.split(x, rows) for x in leaf))
        for p, g, mu, nu in pieces:
            g = _f32(g) * scale  # not in place: a gradient may be an expanded view
            mu32, nu32, p32 = _f32(mu), _f32(nu), _f32(p)
            mu32.mul_(b1).add_(g, alpha=1 - b1)
            nu32.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            delta = torch.div(nu32, c2).sqrt_().add_(cfg.eps)
            delta = torch.div(mu32, c1).div_(delta).add_(p32, alpha=cfg.weight_decay)
            p32.sub_(delta.mul_(lr))
            for x, x32 in ((mu, mu32), (nu, nu32), (p, p32)):
                if x32 is not x:
                    x.copy_(x32)
    if placed:
        # a region goes to the ranks that hold the same slice of the weight:
        # over the data axes that do not split the weight itself (all of
        # them, but where FSDP's rules shard it)
        mesh = placed[0][1].device_mesh
        data = meshes.mesh_data_axes(mesh)
        groups: dict[tuple, list] = {}
        for p, mu in placed:
            axes = tuple(a for a in data if a not in meshes.split_axes(p))
            groups.setdefault(axes, []).append((p, mu))
        for axes, pairs in groups.items():
            if axes:
                meshes.broadcast_regions(pairs, mesh, axes)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _microbatches(batch, n: int) -> list[dict]:
    """``batch`` split along its rows into ``n`` equal pieces (views)."""
    split = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def make_train_step(loss_fn, opt_cfg: OptConfig, compress=None, microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``compress`` optionally transforms gradients before the update (e.g. int8
    compression with error feedback — see grad_compress.py).

    ``microbatches`` > 1 splits the global batch and accumulates the
    gradients in f32 over the pieces: per-layer saved activations shrink by
    the microbatch factor while the gradient math is the same up to f32
    accumulation order. On a mesh each rank splits its own rows so, and
    sums the gradient over the data axes once. The parameters' leaves become
    autograd leaves (``requires_grad``) at the first step.
    """

    def _grads(params, batch):
        flat = list(leaves(params))
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        if microbatches <= 1:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, flat)
            return loss.detach(), grads
        loss_sum, gsum = None, None
        for piece in _microbatches(batch, microbatches):
            loss = loss_fn(params, piece)
            g = torch.autograd.grad(loss, flat)
            if gsum is None:
                loss_sum, gsum = loss.detach(), [_f32(x).clone() for x in g]
            else:
                loss_sum = loss_sum + loss.detach()
                for a, x in zip(gsum, g):
                    a.add_(_f32(x))
        inv = 1.0 / microbatches
        return loss_sum * inv, [g.mul_(inv) for g in gsum]

    def _mesh_grads(params, batch, mesh):
        """The loss of the global batch and its whole gradients, summed over
        the data axes the batch was split over."""
        rows, axes = meshes.batch_rows(batch, mesh)
        flat = [meshes.whole(p) for p in leaves(params)]
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        it = iter(flat)
        whole = tree_map(lambda _: next(it), params)
        counts_fn = getattr(loss_fn, "counts", None)
        ranks = meshes.mesh_axis_size(mesh, *axes)
        counts = None
        if counts_fn is not None and axes:
            local = counts_fn(rows)
            names = sorted(local)
            summed = torch.stack([local[k].to(torch.float32) for k in names])
            meshes.all_reduce(summed, mesh, axes)
            counts = dict(zip(names, summed.unbind()))
        pieces = [rows] if microbatches <= 1 else _microbatches(rows, microbatches)
        loss, grads = None, None
        for piece in pieces:
            with global_counts(counts) if counts is not None else contextlib.nullcontext():
                part = loss_fn(whole, piece)
            if counts is None and (axes or len(pieces) > 1):
                # a loss without counts is a mean over its rows: the ranks'
                # and the microbatches' equal shares weigh 1 / (ranks * pieces)
                part = part / (ranks * len(pieces))
            g = torch.autograd.grad(part, flat)
            if len(pieces) == 1:
                loss, grads = part, [x if x.is_contiguous() else x.contiguous() for x in g]
            elif grads is None:
                loss, grads = part.detach(), [_f32(x).clone() for x in g]
            else:
                loss = loss + part.detach()
                for a, x in zip(grads, g):
                    a.add_(_f32(x))
            del g
        del whole, flat
        loss = loss.detach()
        if axes:
            meshes.all_reduce_buckets(grads, mesh, axes)
            loss = loss.to(torch.float32).reshape(1).clone()
            meshes.all_reduce(loss, mesh, axes)
            loss = loss[0]
        return loss, grads

    def step(params, opt_state, batch, error_fb=None):
        mesh = meshes.current_mesh()
        if meshes.is_multi_rank(mesh):
            loss, flat_g = _mesh_grads(params, batch, mesh)
        else:
            loss, flat_g = _grads(params, batch)
        it = iter(flat_g)
        grads = tree_map(lambda _: next(it), params)
        if compress is not None:
            grads, error_fb = compress(grads, error_fb)
        params, opt_state, info = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, **info}
        if compress is not None:
            return params, opt_state, error_fb, metrics
        return params, opt_state, metrics

    return step
