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
for that hDFG. When, besides, the post-merge update is affine,
``w <- a*w - b*merged`` (``match_sgd_update``), an epoch over a chunk is one
launch of the SGD kernel that walks the chunk's merge batches in order with
the model on chip, as ``repro`` runs the chunk as one device program. Other
graphs (LRMF, an update that is not affine) loop over the batches.

Device policy: ``make_engine`` and ``init_models`` take ``device=None``, which
means ``"cuda"``, and raise ``RuntimeError`` when there is no card. Callers ask
for the CPU with ``device="cpu"``; every kernel then runs its plain version.

Sharded epoch mode (``repro_torch.dist``): under an active
``meshes.use_mesh`` (or an Engine built with ``mesh=``) whose data axes hold
more than one rank, each rank takes its slice of every merge batch's tuples,
the threaded update runs data-parallel and the tree-bus merge is an
``all_reduce`` across ranks: the paper's parallel Striders feeding one merge
tree. ``sharded_path`` decides the path with ``repro``'s rules:

  * ``shard_map`` where the merge is a '+' fold and the thread dim divides
    the data axes: a GLM template takes ``glm_grad_sharded`` a batch (B2 on
    the rank's rows, one ``all_reduce``), other graphs the vmap thread path
    and one ``all_reduce``. With the model axis (``shard_model=True``, a GLM
    template, a feature dim that divides it) each rank also holds its
    feature slice of the batch and of w, in the row-parallel form.
  * ``gspmd`` otherwise (a merge that is not '+', a thread dim that does not
    divide, a generic graph on the model axis, or ``shard_impl="gspmd"``):
    the thread path on the rank's tuple slice (padded with dead rows to
    divide), the models whole, one ``all_reduce`` a batch with the merge's
    operator; the models are then placed by their declared logical axes
    (LRMF's factor matrix ``Shard(0)`` on ``model``).

``run_chunk`` on a mesh decodes the rank's own page range (B1) and makes the
chunk whole by broadcasts (``strider_ops.decode_page_range``) before each
rank takes its slices. Models come back as DTensors where the model axis
shards them, and whole, the same on every rank, elsewhere. The port issues
``all_reduce`` and ``broadcast`` only: gloo on CUDA tensors runs nothing
else. A mesh that offers no parallelism keeps the unsharded path.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.hdfg import HDFG
from repro_torch.core.torch_backend import MERGE_OPS, compile_hdfg
from repro_torch.core.translator import Partition
from repro_torch.db.page import PageLayout
from repro_torch.dist import meshes
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


def model_logical_axes(g: HDFG) -> tuple[tuple[str | None, ...], ...]:
    """Per-model logical sharding axes, as declared by the algorithm
    (``dana.model(..., axes=...)``). Undeclared models resolve replicated."""
    out = []
    for mid in g.model_ids:
        n = g.node(mid)
        axes = n.attrs.get("logical_axes")
        out.append(tuple(axes) if axes is not None else (None,) * len(n.shape))
    return tuple(out)


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


def match_sgd_update(g: HDFG, part: Partition, metas) -> tuple[float, float] | None:
    """(a, b) when the post-merge update of the single vector model is
    ``w <- a*w - b*merged`` (plain SGD; svm's L2 term folds into a), else
    None. Probes ``post_fn`` on the CPU in f32 with the engine's ``metas``:
    a from merged = 0, b from w = 0, then a*w - b*merged verified on random
    draws of both. a and b come back as the f32 values the graph computes."""
    if g.merge_id is None or len(g.model_ids) != 1 or len(g.new_model_ids) != 1:
        return None
    w_shape = g.node(g.model_ids[0]).shape
    if len(w_shape) != 1 or w_shape[0] < 1 or g.node(g.merge_id).shape != w_shape:
        return None
    if g.node(g.merge_id).attrs["op"] != "+":
        return None
    _, post_fn, _, _ = compile_hdfg(g, part)

    def post(w, merged):
        try:
            out = post_fn([w], merged, metas)
        except (RuntimeError, ValueError):
            return None
        if len(out) != 1 or not isinstance(out[0], torch.Tensor) \
                or tuple(out[0].shape) != w_shape:
            return None
        return out[0].to(torch.float32)

    ones, zeros = torch.ones(w_shape), torch.zeros(w_shape)
    at, bt = post(ones, zeros), post(zeros, ones)
    if at is None or bt is None:
        return None
    a, b = float(at[0]), -float(bt[0])
    if not (math.isfinite(a) and math.isfinite(b)
            and bool((at == at[0]).all()) and bool((bt == bt[0]).all())):
        return None
    rng = np.random.default_rng(11)
    for _ in range(4):
        w = torch.as_tensor(rng.normal(0, 1, w_shape), dtype=torch.float32)
        merged = torch.as_tensor(rng.normal(0, 16, w_shape), dtype=torch.float32)
        got = post(w, merged)
        if got is None or not torch.allclose(got, w * a - merged * b, rtol=1e-5, atol=1e-6):
            return None
    return a, b


class PinnedStager:
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
    fused_update: tuple[float, float] | None = None
    mesh: object = None  # a meshes.Mesh (DeviceMesh), an AbstractMesh or None
    shard_model: bool = False
    shard_impl: str = "auto"  # "auto" | "shard_map" | "gspmd"

    # logical axes of a (batches, merge_coef, D) epoch input
    BATCH_AXES = {
        "X": ("pages", "tuples", "features"),
        "Y": ("pages", "tuples"),
        "mask": ("pages", "tuples"),
    }

    def __post_init__(self):
        self._pre, self._post, self._conv, _ = compile_hdfg(self.g, self.part)
        self._stage = (
            PinnedStager(self.device) if self.device.type == "cuda" else None
        )
        self._model_axes = model_logical_axes(self.g)
        self._chunk_paths: dict = {}  # mesh -> the chunk's sharded path
        self.last_sharded_path: tuple | None = None  # introspection for tests

    # -- one merge batch -------------------------------------------------------
    def _merge(self, vals, mask):
        m = mask.reshape(mask.shape + (1,) * (vals.dim() - 1)).to(vals.dtype)
        return MERGE_OPS[self.merge_op](vals, m, dim=0)

    def _thread_merge(self, models, xb, yb, mask):
        """The vmap thread path: every tuple's pre-merge value, merged."""
        vals = torch.func.vmap(
            lambda x, y: self._pre(models, x, y, self.metas)
        )(xb, yb)
        return self._merge(vals, mask)

    def batch_step(self, models, xb, yb, mask):
        """One merge batch: the threads' merged update and the new models.
        Models a mesh shards are made whole first (every rank calls it)."""
        models = [meshes.full_tensor(m) for m in models]
        if self.use_fused_kernel:
            merged = engine_ops.glm_grad(xb, yb, models[0], mask, act=self.glm_template)
        else:
            merged = self._thread_merge(models, xb, yb, mask)
        new_models = self._post(models, merged, self.metas)
        return new_models, merged

    @property
    def chunk_kernel(self) -> bool:
        """Whether an epoch over a chunk is one launch of the SGD kernel."""
        return self.use_fused_kernel and self.fused_update is not None

    def _sgd_chunk(self, models, x, y, mask, coef):
        a, b = self.fused_update
        w, gnorms = engine_ops.glm_sgd_chunk(x, y, mask, models[0], coef,
                                             self.glm_template, a, b)
        return [w], gnorms

    # -- one epoch over a resident chunk --------------------------------------
    def run_epoch(self, models, X, Y, mask):
        """X: (n_batches, merge_coef, D) float32; mask marks live tuples.
        Returns the updated models and each batch's merged-gradient norm,
        all on the engine's device, with no host join. One SGD kernel
        launch when ``chunk_kernel``, else a loop over the batches.
        Dispatches to the sharded epoch only when an active mesh (via
        ``Engine.mesh`` or an enclosing ``meshes.use_mesh``) offers
        parallelism this engine can use; ``run_epoch_sharded`` stays
        callable on any mesh."""
        mesh = self._active_mesh()
        if mesh is not None:
            return self.run_epoch_sharded(models, X, Y, mask, mesh=mesh)
        return self._epoch(models, X, Y, mask)

    def _epoch(self, models, X, Y, mask):
        if self.chunk_kernel:
            return self._sgd_chunk(models, X.reshape(-1, X.shape[-1]), Y.reshape(-1),
                                   mask.reshape(-1), X.shape[1])
        merged = []
        for b in range(X.shape[0]):
            models, m = self.batch_step(models, X[b], Y[b], mask[b])
            merged.append(m)
        gnorms = torch.stack(merged).flatten(1).square().sum(1).sqrt()
        return models, gnorms

    # -- sharded epoch (data-parallel threads over the mesh) -------------------
    def _active_mesh(self):
        """The engine's mesh (or the ambient ``use_mesh`` one) iff it is a
        mesh of ranks that offers parallelism this engine can use: data axes
        of more than one rank, or a model axis of more than one when
        ``shard_model`` is on. None otherwise."""
        mesh = self.mesh if self.mesh is not None else meshes.current_mesh()
        if not isinstance(mesh, meshes.Mesh):
            return None
        if meshes.mesh_axis_size(mesh, "pod", "data") > 1:
            return mesh
        if self.shard_model and meshes.mesh_axis_size(mesh, "model") > 1:
            return mesh
        return None

    def _batch_rules(self):
        return meshes.MODEL_SHARD_RULES if self.shard_model else None

    def sharded_path(self, mesh, coef: int | None = None):
        """Decide how an epoch shards on ``mesh``, as ``repro`` decides it:
        ``("shard_map", data_axes, model_axis)``, the per-rank datapath with
        explicit ``all_reduce`` merges, or ``("gspmd", data_axes, None)``,
        the thread path on each rank's tuple slice with whole models.
        shard_map is taken whenever the merge is a '+' fold and the thread
        (merge-coefficient) dim divides the data axes; the model axis
        additionally needs a GLM template (row-parallel datapath) and a
        divisible feature dim. Drops are recorded in ``meshes.fallbacks()``."""
        data = meshes.mesh_data_axes(mesh)
        coef = self.merge_coef if coef is None else int(coef)
        want_model = (
            self.shard_model and meshes.mesh_axis_size(mesh, "model") > 1
        )
        if self.shard_impl == "gspmd":
            return "gspmd", data, None
        n_data = meshes.mesh_axis_size(mesh, *data) if data else 1
        if self.merge_op != "+":
            if self.shard_impl == "shard_map":
                raise ValueError(
                    f"shard_map datapath needs a '+' merge, got {self.merge_op!r}"
                )
            return "gspmd", data, None
        if coef % n_data != 0:
            meshes.record_fallback(
                "engine_batch", "tuples", 1,
                f"merge coef {coef} not divisible by data axes "
                f"{data}={n_data}; falling back to the GSPMD epoch",
            )
            if self.shard_impl == "shard_map":
                raise ValueError(
                    f"merge coef {coef} does not divide data axes {data}={n_data}"
                )
            return "gspmd", data, None
        model_axis = None
        if want_model:
            if self.glm_template is None or len(self.g.model_ids) != 1:
                if self.shard_impl == "shard_map":
                    raise ValueError(
                        "model-axis shard_map needs a single-model GLM "
                        "template (row-parallel datapath); generic graphs "
                        "model-shard via gspmd"
                    )
                # generic graphs (LRMF) model-shard via the gspmd path: whole
                # models through the thread path, placed by their declared
                # axes afterwards
                return "gspmd", data, None
            d = self.g.node(self.g.model_ids[0]).shape[0]
            m_size = meshes.mesh_axis_size(mesh, "model")
            if d % m_size != 0:
                meshes.record_fallback(
                    "engine_model", "features", 0,
                    f"feature dim {d} not divisible by mesh axis "
                    f"'model'={m_size}; model stays replicated",
                )
            else:
                model_axis = "model"
        return "shard_map", data, model_axis

    def _model_shardings(self, models, mesh):
        """Per-model NamedShardings from the declared logical axes, the one
        resolution every placement of the models reads."""
        return [
            meshes.named_sharding(
                axes, tuple(m.shape), mesh,
                rules=meshes.MODEL_SHARD_RULES, tensor_name="engine_model",
            )
            for m, axes in zip(models, self._model_axes)
        ]

    def _model_targets(self, models, mesh, model_axis=None):
        """Where a sharded run keeps the models: whole on every rank, or
        partitioned per the declared logical axes when the model axis is in
        play."""
        if model_axis is None and not self.shard_model:
            return [meshes.replicated(mesh)] * len(models)
        return self._model_shardings(models, mesh)

    @staticmethod
    def _local(m, sharding):
        """This rank's part of model ``m`` under ``sharding``: a DTensor
        already so placed gives its local tensor, anything else is made
        whole and sliced."""
        if meshes.is_dtensor(m):
            if m.device_mesh is sharding.mesh and tuple(m.placements) == sharding.placements:
                return m.to_local()
            m = meshes.full_tensor(m)
        return meshes.local_slice(m, sharding)

    def _place_models(self, models, mesh, model_axis=None):
        """Models placed for a sharded run: whole tensors (replicated), or
        DTensors partitioned per the declared logical axes when the model
        axis is in play."""
        return [
            meshes.from_local(self._local(m, sh), sh, tuple(m.shape))
            for m, sh in zip(models, self._model_targets(models, mesh, model_axis))
        ]

    def _batch_shardings(self, X, Y, mask, mesh):
        """Resolve an epoch input's placement (``BATCH_AXES``), as ``repro``
        places it: the resolution's drops land in ``fallbacks()``; each rank
        takes its slices by the decided path."""
        rules = self._batch_rules()
        for arr, key in ((X, "X"), (Y, "Y"), (mask, "mask")):
            meshes.named_sharding(self.BATCH_AXES[key][: arr.dim()], tuple(arr.shape), mesh,
                                  rules=rules, tensor_name=f"engine_{key}")

    def _shard_map_epoch(self, mesh, data_axes, model_axis, models, X, Y, mask):
        """The per-rank epoch (``repro``'s ``_shard_map_epoch``): each rank
        runs the datapath on its rows of every merge batch (and, with
        ``model_axis``, its feature slice of them and of w), and the merge
        is an ``all_reduce`` over the data axes. GLM templates take
        ``glm_grad_sharded`` (B2 on the card without the model axis), other
        graphs the vmap thread path. The gradient norms' model-axis sum is
        one ``all_reduce`` for the epoch. ``models`` are this rank's parts."""
        r0, r1 = meshes.shard_range(X.shape[1], mesh, data_axes)
        x = X[:, r0:r1]
        if model_axis is not None:
            c0, c1 = meshes.shard_range(X.shape[2], mesh, (model_axis,))
            x = x[..., c0:c1]
        x, y, m = x.contiguous(), Y[:, r0:r1].contiguous(), mask[:, r0:r1].contiguous()
        glm = self.glm_template is not None and (
            self.use_fused_kernel or model_axis is not None
        )
        squares = []
        for b in range(x.shape[0]):
            if glm:
                merged = engine_ops.glm_grad_sharded(
                    x[b], y[b], models[0], m[b], act=self.glm_template, mesh=mesh,
                    data_axes=data_axes, model_axis=model_axis,
                )
            else:
                merged = meshes.all_reduce(
                    self._thread_merge(models, x[b], y[b], m[b]), mesh, data_axes
                )
            models = self._post(models, merged, self.metas)
            squares.append(merged.square().sum())
        sq = torch.stack(squares)
        if model_axis is not None:
            meshes.all_reduce(sq, mesh, (model_axis,))
        return models, sq.sqrt()

    def _gspmd_epoch(self, mesh, data_axes, models, X, Y, mask):
        """The thread path on each rank's tuple slice of every merge batch
        (dead rows pad the batch to divide the data axes), the models whole,
        one ``all_reduce`` a batch with the merge's operator."""
        pad = -X.shape[1] % meshes.mesh_axis_size(mesh, *data_axes)
        if pad:
            X = torch.nn.functional.pad(X, (0, 0, 0, pad))
            Y = torch.nn.functional.pad(Y, (0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        r0, r1 = meshes.shard_range(X.shape[1], mesh, data_axes)
        x, y, m = (t[:, r0:r1].contiguous() for t in (X, Y, mask))
        squares = []
        for b in range(x.shape[0]):
            merged = meshes.all_reduce(self._thread_merge(models, x[b], y[b], m[b]),
                                       mesh, data_axes, op=self.merge_op)
            models = self._post(models, merged, self.metas)
            squares.append(merged.square().sum())
        return models, torch.stack(squares).sqrt()

    def _sharded_epoch(self, mesh, path, models, X, Y, mask):
        kind, data_axes, model_axis = path
        if kind == "shard_map":
            targets = self._model_targets(models, mesh, model_axis)
            local = [self._local(m, sh) for m, sh in zip(models, targets)]
            local, gnorms = self._shard_map_epoch(mesh, data_axes, model_axis, local,
                                                  X, Y, mask)
            return [meshes.from_local(t, sh, tuple(m.shape))
                    for t, sh, m in zip(local, targets, models)], gnorms
        whole = [meshes.full_tensor(m) for m in models]
        whole, gnorms = self._gspmd_epoch(mesh, data_axes, whole, X, Y, mask)
        return self._place_models(whole, mesh, model_axis), gnorms

    def run_epoch_sharded(self, models, X, Y, mask, mesh=None):
        """Epoch with the merge-coefficient (thread) dim split over the
        mesh's data axes (and, with ``shard_model``, the feature dim over the
        model axis): every rank holds the whole (X, Y, mask) and takes its
        slices, runs the per-rank datapath, and the '+' merge becomes an
        ``all_reduce``. Numerically ``run_epoch`` up to float summation
        order. Every rank of the mesh calls it."""
        mesh = mesh if mesh is not None else (
            self.mesh if self.mesh is not None else meshes.current_mesh()
        )
        if not isinstance(mesh, meshes.Mesh):
            return self._epoch(models, X, Y, mask)
        path = self.sharded_path(mesh, coef=X.shape[1])
        self.last_sharded_path = path
        self._batch_shardings(X, Y, mask, mesh)
        return self._sharded_epoch(mesh, path, models, X, Y, mask)

    # -- fused chunk executor (decode + reshape + epoch, no host join) ---------
    def run_chunk(self, models, pages, layout: PageLayout):
        """Strider decode + batch reshape + epoch loop over one resident page
        chunk, the paper's pipelined access-engine -> execution-engine
        datapath. ``pages`` is the (P, page_words) u32 array from the buffer
        pool. Nothing here reads the card back: the returned (models, gnorms)
        stay on the device for the caller to chain into the next chunk and
        join once per epoch. Under an active mesh each rank decodes its own
        page range and the epoch runs sharded (the collectives wait on the
        card)."""
        mesh = self._active_mesh()
        if mesh is not None:
            return self._run_chunk_sharded(models, pages, layout, mesh)
        if self._stage is not None:
            pages = self._stage(pages)
        else:
            pages = strider_ops.pages_tensor(pages)
        feats, labels, mask = strider_ops.decode_pages(pages, layout)
        t = feats.shape[0] * feats.shape[1]
        x, y, m = feats.reshape(t, layout.n_features), labels.reshape(t), mask.reshape(t)
        if self.chunk_kernel:
            # the kernel masks the ragged last batch itself: no padded copy
            return self._sgd_chunk(models, x, y, m, self.merge_coef)
        return self._epoch(models, *batches_from_stream(x, y, m, self.merge_coef))

    def _stage_pages(self, pages: np.ndarray) -> torch.Tensor:
        if self._stage is not None:
            return self._stage(pages)
        return strider_ops.pages_tensor(pages).to(self.device)

    def _run_chunk_sharded(self, models, pages, layout, mesh):
        path = self._chunk_paths.get(mesh)
        if path is None:  # decided once per mesh, as repro traces once
            path = self._chunk_paths[mesh] = self.sharded_path(mesh)
        self.last_sharded_path = path
        feats, labels, mask = strider_ops.decode_page_range(
            np.asarray(pages), layout, mesh, self._stage_pages, rules=self._batch_rules()
        )
        t = feats.shape[0] * feats.shape[1]
        X, Y, M = batches_from_stream(feats.reshape(t, layout.n_features),
                                      labels.reshape(t), mask.reshape(t), self.merge_coef)
        if path[0] == "gspmd":
            self._batch_shardings(X, Y, M, mesh)
        return self._sharded_epoch(mesh, path, models, X, Y, M)

    def converged(self, models, merged) -> bool:
        models = [meshes.full_tensor(m) for m in models]
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
    shard_impl: str = "auto",
) -> Engine:
    """``mesh``: a ``meshes.Mesh`` (its device type the engine's), an
    ``AbstractMesh`` (sizes only: never dispatched) or None, when an
    enclosing ``meshes.use_mesh`` may still shard the epochs.
    ``shard_model`` without a mesh builds an unsharded engine, as in
    ``repro``."""
    if shard_impl not in ("auto", "shard_map", "gspmd"):
        raise ValueError(f"unknown shard_impl {shard_impl!r}")
    if mesh is not None and not meshes.is_mesh(mesh):
        raise TypeError(
            f"mesh must be a meshes.Mesh (make_mesh, make_host_mesh) or a "
            f"meshes.AbstractMesh, not {type(mesh).__name__}"
        )
    device = resolve_device(device)
    if isinstance(mesh, meshes.Mesh) and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for an engine on {device}")
    if g.merge_id is not None:
        op = g.node(g.merge_id).attrs["op"]
        coef = merge_coef or g.node(g.merge_id).attrs["coef"]
    else:
        op, coef = "+", merge_coef or 1
    tmpl = match_glm_template(g, part)
    metas = metas if metas is not None else default_metas(g)
    return Engine(
        g=g,
        part=part,
        merge_op=op,
        merge_coef=coef,
        metas=metas,
        glm_template=tmpl,
        use_fused_kernel=use_fused_kernel and tmpl is not None,
        device=device,
        fused_update=match_sgd_update(g, part, metas) if tmpl is not None else None,
        mesh=mesh,
        shard_model=shard_model,
        shard_impl=shard_impl,
    )
