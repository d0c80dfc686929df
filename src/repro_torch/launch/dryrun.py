"""Multi-pod dry-run on meta tensors: run every (arch x shape x mesh) cell's
step at full size without a card (counterpart of ``repro.launch.dryrun``).

For each cell this starts ``torch.distributed`` on torch's ``fake`` backend
with 256 or 512 ranks (this process is rank 0; the other ranks are not
there, and a collective returns at once), builds the production mesh on it,
makes the parameters, optimizer state, inputs and caches on the ``meta``
device (shapes and types only: nothing is allocated and nothing is drawn),
places them by their logical-axis specs (``meshes.tree_shardings``), and
runs the port's own step on them:

  * train: ``optimizer.make_train_step`` on the mesh (each rank's rows,
    model-axis weights made whole on use, the gradient summed over the data
    axes, AdamW on the rank's ZeRO region);
  * prefill: ``model_zoo.prefill_fn`` on the rank's rows of the batch;
  * decode: ``model_zoo.decode_fn`` over caches placed as the sharded
    server places them (``meshes.place_serve``), the weights whole on every
    rank as ``BatchedServer(mesh=)`` holds them.

Serving steps take the weights in ``bfloat16``, as the reference's do. The
WKV recurrence runs a plain form, as the reference's dry-run lowers the jnp
``wkv_chunked``: a meta tensor never reaches a CUDA wrapper. It is
``WKV_IMPL``, ``kernels.wkv.ref.wkv_chunked_grouped``: the chunked function
in about a fortieth of the ops of the per-chunk form (``"plain"``), since a
step on meta tensors pays for each op: rwkv6-3b's train_4k on (16 x 16)
takes about an eighth of the per-chunk form's time so
(``tools/dryrun_wkv_forms.py`` times both). The two forms' flops agree
within 2e-5 and their temporaries within 2%; the grouped form's bytes
are 0.56 of the per-chunk form's, whose autograd
writes a whole-size gradient for every chunk it selects
(``select_backward``) and adds them up. Since nothing is allocated, the
dry-run takes no device argument.

It records, for rank 0:

  * ``cost.flops``: the count of ``torch.utils.flop_counter``'s table, what
    ``FlopCounterMode`` totals (matrix products, convolutions and
    attention; XLA's count in the reference also holds the elementwise
    ops);
  * ``cost.bytes_accessed``: each op's tensor inputs and outputs, views and
    collectives left out (``StepMeter``);
  * ``memory``: ``argument_bytes`` (the rank's local bytes of what the step
    is handed), ``alias_bytes`` (the part of them it updates in place),
    ``output_bytes`` (what it returns that is new) and ``temp_bytes`` (the
    peak of the storage it makes while it runs: the weights it makes whole,
    activations, gradients, buckets);
  * ``collectives``: wire bytes of each collective the mesh layer issued
    (``meshes.COLLECTIVE_TOTALS``, priced by ``roofline.collectives``);
  * ``fallbacks``: the resolver's drops (``meshes.fallbacks()``).

The port runs its layers eagerly, so the counts cover every layer: there is
no layer calibration (``calibration.real_counts`` keeps each layer kind's
count for the report).

Artifacts go to artifacts/torch/dryrun/<arch>__<shape>__<mesh>.json.

Usage:
  python -m repro_torch.launch.dryrun --arch rwkv6-3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import meshes
from repro_torch.models import model_zoo
from repro_torch.models.transformer import segments_for
from repro_torch.roofline.collectives import collective_stats
from repro_torch.serve.serving import _PER_SLOT_KEYS
from repro_torch.train import optimizer as opt_mod

ARTIFACT_DIR = os.path.join("artifacts", "torch", "dryrun")
WKV_IMPL = "grouped"  # the WKV form the steps run on meta (see above)


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def fake_group(world_size: int) -> None:
    """Make the default process group one of ``world_size`` ranks on torch's
    ``fake`` backend, this process rank 0 (a fake group of another size is
    replaced; a real group is left alone and refused)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs the fake backend; this process already "
                               f"has a {dist.get_backend()!r} process group")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def layer_counts(cfg) -> dict[str, int]:
    """Each layer kind's count (the reference's ``kind_counts``)."""
    if cfg.family == "encdec":
        return {"enc": cfg.enc_layers, "dec": cfg.n_layers}
    counts: dict[str, int] = {}
    for seg in segments_for(cfg):
        counts[seg.kind] = counts.get(seg.kind, 0) + seg.n_layers
    return counts


# ---------------------------------------------------------------------------
# What a step does on meta tensors
# ---------------------------------------------------------------------------
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The plain tensors of ``tree`` (an op's arguments or outputs: lists,
    tuples and dicts). A DTensor is a wrapper: its local tensor holds its
    storage, and the ops on that are counted where they run."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if type(x) is torch.Tensor or not meshes.is_dtensor(x):
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _meta_key(x):
    """A hashable stand-in for an op argument: a tensor by its metadata (a
    meta tensor holds nothing else), a container by its items, any other
    value with its type (2 and 2.0 give outputs of other types)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.storage_offset(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_meta_key(v) for v in x))
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in x.items())
    return (type(x), x)


def _fresh(out):
    if isinstance(out, torch.Tensor):
        return ("t", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_fresh(v) for v in out))
    return ("v", out)


def _rebuild(spec):
    tag = spec[0]
    if tag == "t":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device=spec[4])
    if tag == "v":
        return spec[1]
    return tag(_rebuild(v) for v in spec[1])


class StepMeter(TorchDispatchMode):
    """Counts what the aten ops run under it do: ``flops``, by the table of
    ``torch.utils.flop_counter`` that ``FlopCounterMode`` counts with
    (matrix products, convolutions and attention); ``bytes_accessed``, each
    op's tensor inputs and outputs (views and collectives left out); the
    storage they make, live and at its ``peak`` (a storage leaves the count
    when it is freed); and which of the ``arguments``' storages they write in
    place (``written``).

    On meta tensors it also propagates shapes by memo: an op that makes new
    tensors (no view, no in-place write, no output aliasing an input) runs
    once for each distinct metadata of its arguments, and a later call gets
    new empty tensors of the recorded sizes, strides and types. Meta kernels
    are mostly Python, and a model's layers repeat the same shapes."""

    def __init__(self, arguments):
        super().__init__()
        self.memo: dict = {}
        self._pure: dict = {}
        self.arg_bytes = {}
        for t in arguments:
            self.arg_bytes[_key(t)] = t.untyped_storage().nbytes()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = self.peak = 0
        self.written: set[int] = set()
        self._made: set[int] = set()

    def _free(self, key: int, nbytes: int) -> None:
        self._made.discard(key)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.arg_bytes or key in self._made:
            return
        self._made.add(key)
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, st.nbytes())

    def _run(self, func, args, kwargs):
        pure = self._pure.get(func)
        if pure is None:
            schema = func._schema
            pure = self._pure[func] = not (
                func.is_view or schema.is_mutable or func.namespace in _COMM_NAMESPACES
                or any(r.alias_info is not None for r in schema.returns))
        if not pure:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            spec = self.memo.get(key)
        except TypeError:  # an argument that does not hash
            return func(*args, **kwargs)
        if spec is not None:
            return _rebuild(spec)
        out = func(*args, **kwargs)
        if all(t.device.type == "meta" for t in _tensors(out)):
            self.memo[key] = _fresh(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.namespace in _COMM_NAMESPACES or func.is_view:
            return out
        outs = _tensors(out)
        self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        for j, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[j] if j < len(args) else kwargs.get(a.name)
            for t in _tensors(v):
                if _key(t) in self.arg_bytes:
                    self.written.add(_key(t))
        return out


def measure(fn, *args) -> dict:
    """Run ``fn(*args)`` once under a ``StepMeter``: its flops, bytes
    accessed, memory (argument, alias, output and temp bytes, each a storage
    counted once) and the seconds it took. ``args`` may hold DTensors,
    counted by their local tensors."""
    arguments = [meshes.local(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    t0 = time.perf_counter()
    with StepMeter(arguments) as meter:
        out = fn(*args)
        seen, output_bytes = set(), 0
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            t = meshes.local(t)
            if _key(t) not in meter.arg_bytes and _key(t) not in seen:
                seen.add(_key(t))
                output_bytes += t.untyped_storage().nbytes()
    seconds = time.perf_counter() - t0
    argument_bytes = sum(meter.arg_bytes.values())
    return {
        "seconds": seconds,
        "memory": {
            "argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(meter.peak),
            "alias_bytes": int(sum(meter.arg_bytes[k] for k in meter.written)),
        },
        "cost": {
            "flops": float(meter.flops),
            "bytes_accessed": float(meter.bytes_accessed),
        },
    }


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------
_INPUT_AXES = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "patches": ("batch", "seq", "embed"),
    "frames": ("batch", "seq", "embed"),
    "pos": (),
}


def _batch_sharding(inputs, mesh):
    """The inputs' shardings by their logical axes, as the reference
    resolves them (their drops land in the fallback log)."""
    return {k: meshes.named_sharding(_INPUT_AXES[k][: v.dim()], tuple(v.shape), mesh,
                                     tensor_name=k)
            for k, v in inputs.items()}


def _rows(batch, mesh):
    """This rank's rows of ``batch`` over the data axes of a mesh of ranks;
    the whole batch on any other mesh."""
    return meshes.batch_rows(batch, mesh)[0] if meshes.is_multi_rank(mesh) else batch


# cache leaves with no landing row: per-slot state and enc-dec's cross K/V
_NO_LANDING = _PER_SLOT_KEYS | {"xk", "xv"}


def _place_cache(cache, mesh):
    """Decode caches placed as the sharded server places them: each leaf by
    its logical axes, resolved on its shape without the landing row, as
    this rank's slice (``meshes.place_serve``). Enc-dec's cache is one
    layer-stacked dict."""
    if isinstance(cache, dict):
        return _place_cache([cache], mesh)[0]
    logical = [{k: torch.empty((c.shape[0], c.shape[1] - (k not in _NO_LANDING),
                                *c.shape[2:]), device="meta") for k, c in seg.items()}
               for seg in cache]
    shardings = meshes.tree_shardings(model_zoo.cache_specs(cache), logical, mesh)
    return [{k: meshes.place_serve(c, shardings[i][k], k not in _NO_LANDING)
             for k, c in seg.items()} for i, seg in enumerate(cache)]


def _lower_and_measure(cfg, shape, mesh, remat="full", microbatches=1, param_rules=None,
                       opt_overrides=None):
    """Build the cell's step on meta tensors placed on ``mesh`` (a mesh of
    the fake group, or a one-rank ``AbstractMesh``) and ``measure`` it; with
    its ``fallbacks`` and the ``collectives`` it issued."""
    meshes.reset_collectives()
    with meshes.use_mesh(mesh):
        params, specs = model_zoo.init_params(cfg, device="meta",
                                              dtype=getattr(torch, cfg.param_dtype))
        param_sh = meshes.tree_shardings(specs, params, mesh, rules=param_rules)
        inputs = model_zoo.input_specs(cfg, shape)
        _batch_sharding(inputs, mesh)
        if shape.kind == "train":
            params = meshes.place_tree(params, param_sh)
            ocfg = opt_mod.OptConfig(**(opt_overrides or {}))
            opt_state = opt_mod.adamw_init(params, ocfg, param_specs=specs, rules=param_rules)
            step = opt_mod.make_train_step(
                model_zoo.loss_fn(cfg, remat=remat, wkv_impl=WKV_IMPL), ocfg,
                microbatches=microbatches)
            m = measure(step, params, opt_state, inputs)
        elif shape.kind == "prefill":
            run = model_zoo.prefill_fn(cfg, remat="none", wkv_impl=WKV_IMPL)
            m = measure(lambda p, b: run(p, _rows(b, mesh)), params, inputs)
        else:
            cache = _place_cache(model_zoo.make_cache(cfg, shape.global_batch, shape.seq_len,
                                                      device="meta"), mesh)
            m = measure(model_zoo.decode_fn(cfg), params, inputs["tokens"], cache,
                        inputs["pos"])
        m["fallbacks"] = [{"tensor": t, "axis": a[0], "dim": a[1], "why": w}
                          for t, a, w in meshes.fallbacks()]
    m["collectives"] = collective_stats(meshes.COLLECTIVE_TOTALS)
    meshes.reset_collectives()
    return m


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    remat: str = "full",
    microbatches: int = 1,
    fsdp: bool = False,
    loss_chunk: int = 0,
    opt_overrides: dict | None = None,
    cfg_overrides: dict | None = None,
):
    """Returns the result record (also the perf experiments' entry point:
    callers vary remat / microbatching / FSDP / loss chunking / optimizer
    dtype / sharding rules and re-measure)."""
    cfg = get_config(arch)
    if loss_chunk:
        cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = model_zoo.SHAPES[shape_name]
    applicable, why = model_zoo.shape_applicable(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "kind": shape.kind,
        "remat": remat,
        "microbatches": microbatches,
        "fsdp": fsdp,
        "loss_chunk": loss_chunk,
    }
    if not applicable:
        rec.update(status="skipped", reason=why)
        return rec

    t0 = time.perf_counter()
    fake_group(512 if multi_pod else 256)
    mesh = meshes.make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec["n_devices"] = mesh.size()

    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")  # serving dtype

    param_rules = meshes.FSDP_PARAM_RULES if fsdp else None
    m = _lower_and_measure(cfg, shape, mesh, remat, microbatches, param_rules, opt_overrides)
    rec.update(
        status="ok",
        fallbacks=m["fallbacks"],
        lower_s=round(time.perf_counter() - t0, 2),
        compile_s=round(m["seconds"], 2),
        memory=m["memory"],
        cost=m["cost"],
        collectives={**m["collectives"],
                     "note": "every layer run: counted, not extrapolated"},
        calibration={"real_counts": layer_counts(cfg)},
        model={
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
        },
    )
    return rec


def run_and_save(arch, shape_name, mesh_kind, out_dir=ARTIFACT_DIR, **kw):
    multi = mesh_kind == "multi"
    try:
        rec = lower_cell(arch, shape_name, multi, **kw)
    except Exception as e:
        rec = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name(multi),
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape_name}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(model_zoo.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(model_zoo.SHAPES) if args.all or not args.shape else [args.shape]
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for mk in mesh_kinds:
                cells.append((a, s, mk))

    failures = 0
    for a, s, mk in cells:
        name = mesh_name(mk == "multi")
        path = os.path.join(args.out, f"{a}__{s}__{name}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
            if old.get("status") in ("ok", "skipped"):
                print(f"[cached] {a} {s} {name}: {old['status']}")
                continue
        rec = run_and_save(
            a, s, mk, out_dir=args.out, remat=args.remat,
            microbatches=args.microbatch, fsdp=args.fsdp,
            loss_chunk=args.loss_chunk,
            opt_overrides={"state_dtype": args.opt_dtype},
        )
        if rec["status"] == "ok":
            mem = rec["memory"]
            per_dev = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
            print(
                f"[ok] {a} {s} {rec['mesh']}: {rec['cost']['flops']:.3e} flops/dev, "
                f"{per_dev:.2f} GiB/dev (args+temp), "
                f"colls={rec['collectives']['total_wire_bytes']:.3e} B, "
                f"meta run {rec['compile_s']}s",
                flush=True,
            )
            print(f"     memory: {rec['memory']}")
            print(f"     cost:   {rec['cost']}")
        elif rec["status"] == "skipped":
            print(f"[skip] {a} {s} {rec['mesh']}: {rec['reason']}")
        else:
            failures += 1
            print(f"[FAIL] {a} {s} {rec['mesh']}: {rec['error']}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
