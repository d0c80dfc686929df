"""The port's logical-axis mesh layer (``repro_torch.dist.meshes``) against
``repro.dist.meshes``: rule precedence, FSDP rules, divisibility fallbacks and
their bookkeeping, ``use_mesh`` scoping, ``AbstractMesh``, ``shard_act``,
named and tree shardings, the mesh constructors and the launch shim; a sweep
holds ``resolve_spec`` and ``fallbacks()`` equal to ``repro``'s over rule
tables x logical axes x shapes x (pod, data, model) sizes; and the engine's
sharded epoch on the one-rank host mesh of a lone process (the multi-rank
runs are in ``test_torch_shard_engine.py``)."""
import argparse
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.dist import meshes as jmeshes
from repro_torch.dist import meshes

CPU = "cpu"


def abstract(*pairs):
    return meshes.AbstractMesh(tuple(s for _, s in pairs), tuple(n for n, _ in pairs))


def jabstract(sizes, names):
    return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))


# ------------------------------ resolver -------------------------------------
def test_default_rules_tensor_parallel_axes():
    mesh = abstract(("data", 2), ("model", 4))
    spec = meshes.resolve_spec(("vocab", "embed"), (128, 64), mesh)
    assert tuple(spec) == ("model", None)
    spec = meshes.resolve_spec(("batch", "seq", "ff"), (8, 16, 32), mesh)
    assert tuple(spec) == ("data", None, "model")
    assert isinstance(spec, meshes.PartitionSpec)


def test_rule_precedence_explicit_rules_override_defaults():
    mesh = abstract(("data", 2), ("model", 4))
    spec = meshes.resolve_spec(
        ("ff", "embed"), (32, 64), mesh, rules={"ff": "data", "embed": None}
    )
    assert tuple(spec) == ("data", None)
    spec = meshes.resolve_spec(("vocab",), (128,), mesh, rules={})
    assert tuple(spec) == (None,)


def test_fsdp_rules_shard_embed_over_data():
    mesh = abstract(("data", 2), ("model", 4))
    default = meshes.resolve_spec(("embed", "ff"), (64, 128), mesh)
    fsdp = meshes.resolve_spec(
        ("embed", "ff"), (64, 128), mesh, rules=meshes.FSDP_PARAM_RULES
    )
    assert tuple(default) == (None, "model")
    assert tuple(fsdp) == ("data", "model")


def test_multi_axis_batch_spans_pod_and_data():
    mesh = abstract(("pod", 2), ("data", 4), ("model", 2))
    spec = meshes.resolve_spec(("batch", "seq"), (16, 8), mesh)
    assert tuple(spec) == (("pod", "data"), None)


def test_partial_multi_axis_assignment_records_fallback():
    mesh = abstract(("pod", 2), ("data", 4), ("model", 2))
    meshes.clear_fallbacks()
    spec = meshes.resolve_spec(("batch",), (6,), mesh, tensor_name="tokens")
    assert tuple(spec) == ("pod",)
    assert any(
        t == "tokens" and ax == "batch" and dim == 0
        for t, (ax, dim), _ in meshes.fallbacks()
    )


def test_degenerate_and_missing_axes_are_not_fallbacks():
    mesh = abstract(("data", 1), ("model", 1))
    meshes.clear_fallbacks()
    spec = meshes.resolve_spec(("batch", "vocab", "ff"), (3, 5, 7), mesh)
    assert all(s is None for s in spec)
    assert meshes.fallbacks() == []


def test_no_mesh_axis_reused_within_one_tensor():
    mesh = abstract(("data", 2), ("model", 4))
    spec = meshes.resolve_spec(("vocab", "ff", "heads"), (8, 8, 8), mesh)
    assert [s for s in spec if s is not None] == ["model"]


def test_rank_mismatch_raises():
    mesh = abstract(("data", 2), ("model", 4))
    with pytest.raises(ValueError, match="rank mismatch"):
        meshes.resolve_spec(("vocab",), (8, 8), mesh, tensor_name="w")


# --------------------------- fallback bookkeeping -----------------------------
def test_use_mesh_scopes_fallback_log_and_restores_mesh():
    mesh = abstract(("data", 2), ("model", 4))
    meshes.clear_fallbacks()
    meshes.resolve_spec(("kv_heads",), (6,), mesh, tensor_name="outer")
    assert any(t == "outer" for t, _, _ in meshes.fallbacks())
    assert meshes.current_mesh() is None
    with meshes.use_mesh(mesh):
        assert meshes.current_mesh() is mesh
        assert meshes.fallbacks() == []
        meshes.resolve_spec(("kv_heads",), (6,), mesh, tensor_name="inner")
        recs = meshes.fallbacks()
        assert [t for t, _, _ in recs] == ["inner"]
        meshes.resolve_spec(("kv_heads",), (6,), mesh, tensor_name="inner")
        assert len(meshes.fallbacks()) == len(recs)
        with meshes.use_mesh(mesh):
            assert meshes.fallbacks() == []
        assert [t for t, _, _ in meshes.fallbacks()] == ["inner"]
    assert meshes.current_mesh() is None
    assert any(t == "outer" for t, _, _ in meshes.fallbacks())


def test_abstract_mesh_accepts_sizes_names_ctor():
    m = meshes.AbstractMesh((2, 4), ("data", "model"))
    assert dict(m.shape) == {"data": 2, "model": 4}
    assert m.axis_names == ("data", "model") and m.size == 8
    assert isinstance(m, meshes.AbstractMesh)  # a real type, not a factory
    assert m == meshes.AbstractMesh((2, 4), ("data", "model")) and len({m, abstract(
        ("data", 2), ("model", 4))}) == 1
    assert tuple(meshes.resolve_spec(("ff",), (8,), m)) == ("model",)
    with pytest.raises(ValueError):
        meshes.AbstractMesh((2,), ("data", "model"))


def test_record_fallback_joins_the_resolvers_log():
    meshes.clear_fallbacks()
    meshes.record_fallback("serve_attn", "kernel", 0, "why")
    meshes.record_fallback("serve_attn", "kernel", 0, "why")
    assert meshes.fallbacks() == [("serve_attn", ("kernel", 0), "why")]
    meshes.clear_fallbacks()


# --------------------------- the sweep against repro --------------------------
RULES = ("DEFAULT_RULES", "FSDP_PARAM_RULES", "MODEL_SHARD_RULES", "SERVE_CACHE_RULES",
         "SERVE_KERNEL_CACHE_RULES")
LOGICAL = (
    ("batch", "seq", "ff"), ("vocab", "embed"), ("embed", "ff"), ("heads", "kv_heads"),
    ("kv_blocks", "block", "kv_heads", "head_dim"), ("pages", "tuples", "features"),
    ("heap_pages", None), ("heap_pages", None, "features"), ("features", "rank"),
    ("zero",), ("experts", "embed", "inner"), (None, "batch"), ("batch", "zero"),
    ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), ("tuples", "features"),
)
DIMS = (1, 2, 6, 8, 12, 13, 16, 54, 64, 115, 256)
MESHES = ((None, 1, 1), (None, 8, 1), (None, 2, 4), (None, 4, 2), (None, 1, 4),
          (2, 4, 2), (2, 2, 2), (1, 3, 2), (2, 1, 1), (2, 8, 16))


def _mesh_pair(sizes):
    pod, data, model = sizes
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    sz = (data, model) if pod is None else (pod, data, model)
    return meshes.AbstractMesh(sz, names), jabstract(sz, names)


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rules", RULES)
def test_resolve_spec_and_fallbacks_equal_repro(rules, sizes):
    tmesh, jmesh = _mesh_pair(sizes)
    rng = np.random.default_rng(len(rules) * 7 + sum(s or 0 for s in sizes))
    cases = 0
    for axes in LOGICAL:
        for _ in range(4):
            shape = tuple(int(d) for d in rng.choice(DIMS, len(axes)))
            with meshes.use_mesh(tmesh), jmeshes.use_mesh(jmesh):
                got = meshes.resolve_spec(axes, shape, tmesh, rules=getattr(meshes, rules),
                                          tensor_name=f"t{cases}")
                want = jmeshes.resolve_spec(axes, shape, jmesh,
                                            rules=getattr(jmeshes, rules),
                                            tensor_name=f"t{cases}")
                assert tuple(got) == tuple(want), (axes, shape)
                assert meshes.fallbacks() == jmeshes.fallbacks(), (axes, shape)
            cases += 1
    assert cases == 4 * len(LOGICAL)


def test_rule_tables_equal_repro():
    for name in RULES:
        assert getattr(meshes, name) == getattr(jmeshes, name), name


def test_tree_shardings_names_and_order_equal_repro():
    sizes, names = (2, 4), ("data", "model")
    specs = {"w": ("embed", "ff"), "b": ("ff",), "blocks": [("vocab", "embed"), ("heads",)],
             "step": ()}
    shapes = {"w": (4, 8), "b": (6,), "blocks": [(6, 4), (3,)], "step": ()}
    tree = {"w": torch.zeros(4, 8), "b": torch.zeros(6),
            "blocks": [torch.zeros(6, 4), torch.zeros(3)], "step": torch.zeros(())}
    jtree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple) and all(
                             isinstance(e, int) for e in x))
    with meshes.use_mesh(None), jmeshes.use_mesh(None):
        got = meshes.tree_shardings(specs, tree, meshes.AbstractMesh(sizes, names))
        want = jmeshes.tree_shardings(specs, jtree, jabstract(sizes, names))
        assert meshes.fallbacks() == jmeshes.fallbacks()
        assert [t for t, _, _ in meshes.fallbacks()] == ["b", "blocks/0", "blocks/1"]
    assert tuple(got["w"].spec) == tuple(want["w"].spec) == (None, "model")
    assert [tuple(s.spec) for s in got["blocks"]] == [tuple(s.spec) for s in want["blocks"]]
    assert tuple(got["step"].spec) == ()


# ------------------------------- shard_act ------------------------------------
def test_shard_act_is_the_same_object_without_a_mesh_or_sharding():
    x = torch.arange(12.0).reshape(3, 4)
    assert meshes.shard_act(x, ("batch", "embed")) is x
    with meshes.use_mesh(meshes.make_host_mesh(device=CPU)):
        assert meshes.shard_act(x, ("batch", "ff"), "act") is x  # (1, 1): replicated
    with meshes.use_mesh(abstract(("data", 3), ("model", 2))):
        assert meshes.shard_act(x, ("batch", "ff"), "act") is x  # no ranks to place on


# --------------------------- named / tree shardings ---------------------------
def test_named_and_tree_shardings_on_the_host_mesh():
    from torch.distributed.tensor import DTensor, Replicate

    mesh = meshes.make_host_mesh(device=CPU)
    assert isinstance(mesh, meshes.Mesh)
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)
    sh = meshes.named_sharding(("batch", "ff"), (4, 8), mesh, tensor_name="h")
    assert isinstance(sh, meshes.NamedSharding) and sh.mesh is mesh
    assert sh.placements == (Replicate(), Replicate())
    specs = {"w": ("embed", "ff"), "scale": ("embed",), "step": ()}
    tree = {"w": torch.randn(4, 8), "scale": torch.zeros(4), "step": torch.zeros(())}
    shardings = meshes.tree_shardings(specs, tree, mesh)
    assert set(shardings) == {"w", "scale", "step"}
    for k, s in shardings.items():
        assert isinstance(s, meshes.NamedSharding), k
    placed = {k: meshes.device_put(tree[k], shardings[k]) for k in tree}
    assert isinstance(placed["w"], DTensor)
    assert torch.equal(meshes.full_tensor(placed["w"]), tree["w"])
    assert meshes.replicated(mesh).spec == meshes.PartitionSpec()


def test_placements_name_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = abstract(("pod", 2), ("data", 2), ("model", 2))
    sh = meshes.NamedSharding(mesh, meshes.PartitionSpec(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert meshes.NamedSharding(mesh, meshes.PartitionSpec()).placements == (Replicate(),) * 3


def test_mesh_axis_size_and_data_axes():
    mesh = abstract(("pod", 2), ("data", 4), ("model", 2))
    assert meshes.mesh_axis_size(mesh, "pod", "data") == 8
    assert meshes.mesh_axis_size(mesh, "expert") == 1
    assert meshes.mesh_data_axes(mesh) == ("pod", "data")
    assert meshes.mesh_data_axes(abstract(("data", 1), ("model", 4))) == ()
    host = meshes.make_host_mesh(device=CPU)
    assert meshes.mesh_axis_size(host, "data", "model") == 1
    for m in (mesh, abstract(("data", 1), ("model", 4))):
        names = m.axis_names
        jm = jabstract(m.axis_sizes, names)
        assert meshes.mesh_data_axes(m) == jmeshes.mesh_data_axes(jm)
        assert meshes.mesh_axis_size(m, *names) == jmeshes.mesh_axis_size(jm, *names)


# ------------------------------ constructors -----------------------------------
def test_make_host_mesh_in_a_lone_process_is_one_by_one():
    import torch.distributed as dist

    mesh = meshes.make_host_mesh(model_parallel=4, device=CPU)
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
    assert mesh.device_type == "cpu"


def test_production_mesh_needs_its_world(monkeypatch):
    meshes.make_host_mesh(device=CPU)
    with pytest.raises(ValueError, match="256"):
        meshes.make_production_mesh(device=CPU)
    with pytest.raises(ValueError, match="512"):
        meshes.make_production_mesh(multi_pod=True, device=CPU)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        meshes.make_mesh((2, 4), ("data", "model"), device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshes.make_host_mesh()


def test_launch_mesh_shim_reexports():
    from repro_torch.launch import mesh as launch_mesh

    assert launch_mesh.make_host_mesh is meshes.make_host_mesh
    assert launch_mesh.make_production_mesh is meshes.make_production_mesh
    assert launch_mesh.make_mesh is meshes.make_mesh


def test_mesh_flags_match_repro():
    from repro.launch import common as jcommon
    from repro_torch.launch import common

    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_mesh_flags(ap)
    jcommon.add_mesh_flags(jap)
    for argv in ([], ["--mesh", "host", "--model-parallel", "2"]):
        assert vars(ap.parse_args(argv)) == vars(jap.parse_args(argv))
    assert common.mesh_from_args(ap.parse_args([])) is None
    args = ap.parse_args(["--mesh", "host", "--model-parallel", "2"])
    args.device = CPU
    mesh = common.mesh_from_args(args)
    assert isinstance(mesh, meshes.Mesh) and tuple(mesh.shape) == (1, 1)


def test_server_takes_a_mesh_and_serves_on_one_rank():
    """``BatchedServer(mesh=)``: a mesh that is not a mesh raises
    ``TypeError``; the one-rank host mesh of a lone process serves the
    unsharded server's tokens, its caches the same tensors."""
    from test_torch_serve_util import params, serve

    cfg, p = params()
    with pytest.raises(TypeError, match="meshes.Mesh"):
        serve(cfg, p, mesh=object())
    with pytest.raises(TypeError, match="AbstractMesh"):
        serve(cfg, p, mesh=abstract(("data", 2), ("model", 1)))
    want, _ = serve(cfg, p)
    got, srv = serve(cfg, p, mesh=meshes.make_host_mesh(device=CPU))
    assert got == want
    assert srv.last_sharded_path == ("gspmd", (), None)
    assert not any(meshes.is_dtensor(c) for seg in srv.cache for c in seg.values())


# --------------------------- engine on the host mesh ---------------------------
def _toy_problem(n=512, d=12, coef=64, seed=0):
    from repro_torch.algorithms import linear_regression
    from repro_torch.core.engine import init_models, make_engine
    from repro_torch.core.translator import trace

    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, d)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = (X @ w).astype(np.float32)
    g, part = trace(lambda: linear_regression(d, lr=0.3, merge_coef=coef))
    eng = make_engine(g, part, use_fused_kernel=False, device=CPU)
    models = init_models(g, device=CPU)
    Xb = torch.from_numpy(X).reshape(-1, coef, d)
    Yb = torch.from_numpy(y).reshape(-1, coef)
    return eng, models, Xb, Yb, torch.ones(Yb.shape)


def test_engine_sharded_epoch_matches_unsharded_on_host_mesh():
    eng, models, Xb, Yb, Mb = _toy_problem()
    want, wantg = eng.run_epoch(models, Xb, Yb, Mb)
    got, gotg = eng.run_epoch_sharded(models, Xb, Yb, Mb,
                                      mesh=meshes.make_host_mesh(device=CPU))
    assert eng.last_sharded_path == ("shard_map", (), None)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gotg.numpy(), wantg.numpy(), rtol=1e-4, atol=1e-5)


def test_engine_run_epoch_skips_sharded_path_without_data_parallelism():
    eng, models, Xb, Yb, Mb = _toy_problem()
    with meshes.use_mesh(meshes.make_host_mesh(device=CPU)):
        eng.run_epoch(models, Xb, Yb, Mb)
    assert eng.last_sharded_path is None


def test_solver_train_accepts_mesh(tmp_path):
    from repro_torch.algorithms import linear_regression
    from repro_torch.core import solver
    from repro_torch.core.translator import trace
    from repro_torch.db.heap import write_table

    rng = np.random.default_rng(21)
    w_true = rng.normal(0, 1, 8).astype(np.float32)
    X = rng.normal(0, 1, (1500, 8)).astype(np.float32)
    heap = write_table(str(tmp_path / "m.heap"), X, X @ w_true, page_bytes=8192)
    g, part = trace(lambda: linear_regression(8, lr=0.3, merge_coef=64, epochs=25))
    res = solver.train(g, part, heap, mode="dana", mesh=meshes.make_host_mesh(device=CPU),
                       device=CPU)
    np.testing.assert_allclose(res.models[0], w_true, atol=0.05)
    assert res.device_syncs == res.epochs_run


@pytest.mark.parametrize("axes,shape", list(itertools.product(
    [("tuples",), ("heap_pages", None)], [(8,), (115,)])))
def test_one_rank_placement_helpers(axes, shape):
    mesh = meshes.make_host_mesh(device=CPU)
    full = tuple(shape) + (3,) * (len(axes) - 1)
    x = torch.arange(float(np.prod(full))).reshape(full)
    sh = meshes.named_sharding(axes, full, mesh)
    assert meshes.local_slice(x, sh) is x
    assert meshes.from_local(x, sh, full) is x
    assert meshes.shard_range(full[0], mesh, ("data",)) == (0, full[0])
    assert meshes.axis_ranks(mesh, ("data",)) == [0]
    assert meshes.axis_group(mesh, ("data", "model")) is None
    assert meshes.all_reduce(x, mesh, ("data",)) is x


def test_strider_axes_equal_repro():
    """The page stream's and the decoded tensors' logical axes, which the
    page-range decode resolves, are repro's."""
    from repro.kernels.strider import ops as jstrider_ops
    from repro_torch.kernels.strider import ops as strider_ops

    assert strider_ops.PAGE_AXES == jstrider_ops.PAGE_AXES
    assert strider_ops.DECODED_AXES == jstrider_ops.DECODED_AXES
    mesh, jmesh = _mesh_pair((None, 4, 2))
    for name, axes in strider_ops.DECODED_AXES.items():
        shape = (115, 138, 54)[:len(axes)]
        with meshes.use_mesh(mesh), jmeshes.use_mesh(jmesh):
            got = meshes.resolve_spec(axes, shape, mesh, rules=meshes.MODEL_SHARD_RULES,
                                      tensor_name=name)
            want = jmeshes.resolve_spec(axes, shape, jmesh, rules=jmeshes.MODEL_SHARD_RULES,
                                        tensor_name=name)
            assert tuple(got) == tuple(want) and meshes.fallbacks() == jmeshes.fallbacks()
