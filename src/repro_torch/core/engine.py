"""Multi-threaded execution engine (paper §5.2) on PyTorch, single device
(counterpart of ``repro.core.engine``, which it is held against).

A DAnA *thread* is one instance of the update rule's pre-merge function; the
engine maps threads over the merge coefficient (``torch.func.vmap``) and folds
their results with the merge operator (the tree bus). An epoch is a Python
loop over merge batches where ``repro`` scans under ``jit``. Nothing in the
loop reads a value back to the host, so the card runs the epoch from a queue
of launches and the caller joins it once.

GLM template matching: when the pre-merge graph is numerically identical to
``err(w.x, y) * x`` the engine swaps in the fused GLM gradient kernel
(``kernels/engine``), the specialized datapath an FPGA synthesis would produce
for that hDFG.

Device policy: ``make_engine`` and ``init_models`` take ``device=None``, which
means ``"cuda"``, and raise ``RuntimeError`` when there is no card. Callers ask
for the CPU with ``device="cpu"``; every kernel then runs its plain version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hdfg import HDFG
from repro_torch.core.torch_backend import MERGE_OPS, compile_hdfg
from repro_torch.core.translator import Partition
from repro_torch.db.page import PageLayout
from repro_torch.kernels.engine import ops as engine_ops
from repro_torch.kernels.strider import ops as strider_ops

GLM_TEMPLATES = ("linear", "logistic", "svm")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for a card that is not there raises:
    the entry points never carry on on the CPU unless asked to."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def default_metas(g: HDFG) -> list[float]:
    return [float(g.node(nid).attrs["value"]) for nid in g.meta_ids]


def init_models(
    g: HDFG, rng: np.random.Generator | None = None, scale: float = 0.0, device=None
) -> list[torch.Tensor]:
    """Zero models, or N(0, scale) draws from ``rng`` (the same numbers as
    ``repro.core.engine.init_models`` with the same generator state)."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    out = []
    for mid in g.model_ids:
        shape = g.node(mid).shape
        if scale:
            out.append(torch.as_tensor(
                np.asarray(rng.normal(0, scale, shape)), dtype=torch.float32
            ).to(device))
        else:
            out.append(torch.zeros(shape, dtype=torch.float32, device=device))
    return out


def models_from_numpy(models, device=None) -> list[torch.Tensor]:
    """Coefficient arrays (``repro``'s ``init_models`` output or a
    ``TrainResult.models``) -> f32 tensors on ``device``, so both packages
    can start from the same model."""
    device = resolve_device(device)
    return [torch.from_numpy(np.array(m, dtype=np.float32)).to(device) for m in models]


def batches_from_stream(feats, labels, mask, coef):
    """Pad a flat tuple stream to whole merge batches -> (nb, coef, ...) tensors.

    Pure shape math on the tensors' shapes: nothing is read back from the
    device."""
    n = feats.shape[0]
    nb = -(-n // coef)
    pad = nb * coef - n
    if pad:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return (
        feats.reshape(nb, coef, -1),
        labels.reshape(nb, coef),
        mask.reshape(nb, coef),
    )


def match_glm_template(g: HDFG, part: Partition) -> str | None:
    """Probabilistic structural matching of the pre-merge graph against the
    GLM gradient templates. Numerical verification on random samples is
    robust to algebraic rewrites in the user's DSL code. The probes run on
    the CPU in f32, drawn as ``repro`` draws them."""
    if g.merge_id is None or len(g.model_ids) != 1 or len(g.input_ids) != 1:
        return None
    w_shape = g.node(g.model_ids[0]).shape
    x_shape = g.node(g.input_ids[0]).shape
    if len(w_shape) != 1 or x_shape != w_shape:
        return None
    if g.node(g.merge_id).attrs["op"] != "+":
        return None
    pre_fn, _, _, _ = compile_hdfg(g, part)
    metas = default_metas(g)

    def templates(w, x, y):
        z = w @ x
        return {
            "linear": (z - y) * x,
            "logistic": (torch.sigmoid(z) - y) * x,
            "svm": torch.where(y * z < 1.0, -y, 0.0) * x,
        }

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    rng = np.random.default_rng(7)
    candidates = set(GLM_TEMPLATES)
    for trial in range(6):
        w = f32(rng.normal(0, 1, w_shape))
        x = f32(rng.normal(0, 1, x_shape))
        # alternate ±1 class labels with continuous targets: identities like
        # y*y == 1 hold on ±1 labels only, so probing non-±1 y rules out
        # graphs that would otherwise shadow the linear template
        if trial % 2 == 0:
            y = f32(rng.choice([-1.0, 1.0]))
        else:
            y = f32(rng.normal(0.0, 2.0))
        try:
            got = pre_fn([w], x, y, metas)
        except (RuntimeError, ValueError):
            return None
        if not isinstance(got, torch.Tensor) or tuple(got.shape) != w_shape:
            return None
        t = templates(w, x, y)
        candidates = {
            k for k in candidates
            if torch.allclose(got, t[k], rtol=1e-4, atol=1e-5)
        }
        if not candidates:
            return None
    return sorted(candidates)[0] if candidates else None


class _PinnedStager:
    """Carries page chunks to the card through two pinned host buffers.

    A pageable copy to the card waits for the card to drain the stream, a
    host join per chunk. Here each chunk is copied on the host into one of
    two pinned buffers, in turn, and sent with a non-blocking copy on the
    current stream. Before a buffer is refilled, the host waits for the
    event recorded after its last copy, which was queued two chunks earlier:
    the host runs at most two chunks ahead of the card, and the card keeps
    the queued chunks to work on while the host waits."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._sent: list[torch.cuda.Event | None] = [None, None]
        self._next = 0

    def __call__(self, pages: np.ndarray) -> torch.Tensor:
        i = self._next
        self._next ^= 1
        words = np.ascontiguousarray(pages, dtype=np.uint32).view(np.int32)
        buf = self._bufs[i]
        if buf is None or buf.numel() < words.size:
            # the old buffer goes back to the caching host allocator, which
            # holds it until the copy that used it has finished
            buf = self._bufs[i] = torch.empty(
                words.size, dtype=torch.int32, pin_memory=True
            )
        elif self._sent[i] is not None:
            self._sent[i].synchronize()
        host = buf[: words.size].view(words.shape)
        host.numpy()[...] = words
        dev = host.to(self.device, non_blocking=True)
        sent = self._sent[i] = torch.cuda.Event()
        sent.record(torch.cuda.current_stream(self.device))
        return dev


@dataclasses.dataclass
class Engine:
    g: HDFG
    part: Partition
    merge_op: str
    merge_coef: int
    metas: list[float]
    glm_template: str | None
    use_fused_kernel: bool
    device: torch.device

    def __post_init__(self):
        self._pre, self._post, self._conv, _ = compile_hdfg(self.g, self.part)
        self._stage = (
            _PinnedStager(self.device) if self.device.type == "cuda" else None
        )

    # -- one merge batch -------------------------------------------------------
    def _merge(self, vals, mask):
        m = mask.reshape(mask.shape + (1,) * (vals.dim() - 1)).to(vals.dtype)
        return MERGE_OPS[self.merge_op](vals, m, dim=0)

    def batch_step(self, models, xb, yb, mask):
        """One merge batch: the threads' merged update and the new models."""
        if self.use_fused_kernel:
            merged = engine_ops.glm_grad(xb, yb, models[0], mask, act=self.glm_template)
        else:
            vals = torch.func.vmap(
                lambda x, y: self._pre(models, x, y, self.metas)
            )(xb, yb)
            merged = self._merge(vals, mask)
        new_models = self._post(models, merged, self.metas)
        return new_models, merged

    # -- one epoch over a resident chunk (loop over batches) -------------------
    def run_epoch(self, models, X, Y, mask):
        """X: (n_batches, merge_coef, D) float32; mask marks live tuples.
        Returns the updated models and each batch's merged-gradient norm,
        all on the engine's device, with no host join."""
        merged = []
        for b in range(X.shape[0]):
            models, m = self.batch_step(models, X[b], Y[b], mask[b])
            merged.append(m)
        gnorms = torch.stack(merged).flatten(1).square().sum(1).sqrt()
        return models, gnorms

    # -- fused chunk executor (decode + reshape + epoch, no host join) ---------
    def run_chunk(self, models, pages, layout: PageLayout):
        """Strider decode + batch reshape + epoch loop over one resident page
        chunk, the paper's pipelined access-engine -> execution-engine
        datapath. ``pages`` is the (P, page_words) u32 array from the buffer
        pool. Nothing here reads the card back: the returned (models, gnorms)
        stay on the device for the caller to chain into the next chunk and
        join once per epoch."""
        if self._stage is not None:
            pages = self._stage(pages)
        else:
            pages = strider_ops.pages_tensor(pages)
        feats, labels, mask = strider_ops.decode_pages(pages, layout)
        t = feats.shape[0] * feats.shape[1]
        X, Y, M = batches_from_stream(
            feats.reshape(t, layout.n_features),
            labels.reshape(t),
            mask.reshape(t),
            self.merge_coef,
        )
        return self.run_epoch(models, X, Y, M)

    def converged(self, models, merged) -> bool:
        return bool(self._conv(models, merged, self.metas))

    # -- sequential oracle ------------------------------------------------------
    def sequential_epoch(self, models, X, Y):
        """Tuple-at-a-time SGD with batch = merge_coef via a plain loop, used
        to validate the threaded engine (identical for '+' merges)."""
        for b in range(X.shape[0]):
            xb, yb = X[b], Y[b]
            vals = [
                self._pre(models, xb[i], yb[i], self.metas)
                for i in range(xb.shape[0])
            ]
            merged = torch.stack(vals).sum(0) if self.merge_op == "+" else None
            models = self._post(models, merged, self.metas)
        return models


def make_engine(
    g: HDFG,
    part: Partition,
    merge_coef: int | None = None,
    metas: list[float] | None = None,
    use_fused_kernel: bool = True,
    mesh=None,
    shard_model: bool = False,
    device=None,
) -> Engine:
    if mesh is not None or shard_model:
        raise NotImplementedError(
            "sharded epochs (mesh=, shard_model=) wait for the port's "
            "distribution slice (ROADMAP A19)"
        )
    device = resolve_device(device)
    if g.merge_id is not None:
        op = g.node(g.merge_id).attrs["op"]
        coef = merge_coef or g.node(g.merge_id).attrs["coef"]
    else:
        op, coef = "+", merge_coef or 1
    tmpl = match_glm_template(g, part)
    return Engine(
        g=g,
        part=part,
        merge_op=op,
        merge_coef=coef,
        metas=metas if metas is not None else default_metas(g),
        glm_template=tmpl,
        use_fused_kernel=use_fused_kernel and tmpl is not None,
        device=device,
    )
