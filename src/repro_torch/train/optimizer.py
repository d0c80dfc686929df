"""AdamW with gradient clipping and warmup, and the train step (counterpart
of ``repro.train.optimizer``, which it is held against).

The update is in place: parameters and moments are tensors the step
overwrites, where the reference returns new arrays. A leaf of more than
``UPDATE_PIECE`` elements is walked in pieces of at most that many along its
leading axis, so its temporaries are two pieces and not two copies of the
leaf (a 4 GB stacked matrix at minicpm3-4b's full width, where the training
state leaves 18 GB of the card); a smaller leaf is one piece. Nothing is read back to
the host: the step counter, the learning rate, the gradient norm and the clip
scale stay tensors on the parameters' device. ``state_specs`` is a copy of
the reference's logical-spec rule (the ZeRO 'zero' axis), kept for the
LM training on a mesh (ROADMAP A19b); nothing shards by it yet.
"""
from __future__ import annotations

import dataclasses

import torch

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


def adamw_init(params, cfg: OptConfig):
    dt = getattr(torch, cfg.state_dtype)
    device = next(leaves(params)).device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


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


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place on ``params`` and ``state``. Returns (params, state, {"grad_norm",
    "lr"}), the last two as device tensors."""
    step = state["step"] + 1
    lr = lr_at(step, cfg)
    flat_g = list(leaves(grads))
    gnorm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in flat_g]))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    for leaf in zip(leaves(params), flat_g, leaves(state["mu"]), leaves(state["nu"])):
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
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def make_train_step(loss_fn, opt_cfg: OptConfig, compress=None, microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``compress`` optionally transforms gradients before the update (e.g. int8
    compression with error feedback — see grad_compress.py).

    ``microbatches`` > 1 splits the global batch and accumulates the
    gradients in f32 over the pieces: per-layer saved activations shrink by
    the microbatch factor while the gradient math is the same up to f32
    accumulation order. The parameters' leaves become autograd leaves
    (``requires_grad``) at the first step.
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
        split = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                 for k, v in batch.items()}
        loss_sum, gsum = None, None
        for i in range(microbatches):
            loss = loss_fn(params, {k: v[i] for k, v in split.items()})
            g = torch.autograd.grad(loss, flat)
            if gsum is None:
                loss_sum, gsum = loss.detach(), [_f32(x).clone() for x in g]
            else:
                loss_sum = loss_sum + loss.detach()
                for a, x in zip(gsum, g):
                    a.add_(_f32(x))
        inv = 1.0 / microbatches
        return loss_sum * inv, [g.mul_(inv) for g in gsum]

    def step(params, opt_state, batch, error_fb=None):
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
