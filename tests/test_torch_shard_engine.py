"""The engine's sharded epochs (``Engine.sharded_path``, the shard_map and
gspmd paths, ``shard_model``) against ``repro``: the path decisions and their
fallbacks on abstract meshes, in process and over a sweep of engines x
meshes x coefficients x ``shard_impl``; the degenerate one-rank mesh; and one
spawn of 8 gloo ranks that runs the cases of ``repro``'s 8-device scripts
(tests/test_shard_map_engine.py) and holds them against ``repro``'s unsharded
results from the same numpy inputs, with the models the same bits on every
rank."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_util as dist_util
from repro.algorithms import linear_regression as jlinear
from repro.algorithms import logistic_regression as jlogistic
from repro.algorithms import lrmf as jlrmf
from repro.algorithms import svm as jsvm
from repro.core import dsl as jdana
from repro.core import engine as jengine
from repro.core import solver as jsolver
from repro.core import translator as jtranslator
from repro.db.heap import HeapFile as JHeapFile
from repro.dist import meshes as jmeshes
from repro_torch.algorithms import linear_regression, logistic_regression, lrmf, svm
from repro_torch.core import dsl as dana
from repro_torch.core.engine import init_models, make_engine, model_logical_axes
from repro_torch.core.translator import trace
from repro_torch.db.heap import write_table
from repro_torch.dist import meshes

CPU = "cpu"
WORLD = 8


def abstract(*pairs):
    return meshes.AbstractMesh(tuple(s for _, s in pairs), tuple(n for n, _ in pairs))


def _glm_engine(d=16, coef=64, **kw):
    g, part = trace(lambda: linear_regression(d, lr=0.3, merge_coef=coef))
    return make_engine(g, part, device=CPU, **kw)


# ---------------------------- path selection ----------------------------------
def test_sharded_path_prefers_shard_map_on_data_mesh():
    eng = _glm_engine()
    assert eng.sharded_path(abstract(("data", 8), ("model", 1))) == (
        "shard_map", ("data",), None)
    assert eng.sharded_path(abstract(("pod", 2), ("data", 4), ("model", 1))) == (
        "shard_map", ("pod", "data"), None)


def test_sharded_path_model_axis_requires_shard_model_and_divisibility():
    mesh = abstract(("data", 2), ("model", 4))
    assert _glm_engine(d=16).sharded_path(mesh)[2] is None
    eng = _glm_engine(d=16, shard_model=True)
    assert eng.sharded_path(mesh) == ("shard_map", ("data",), "model")
    eng13 = _glm_engine(d=13, shard_model=True)
    meshes.clear_fallbacks()
    assert eng13.sharded_path(mesh) == ("shard_map", ("data",), None)
    assert any(
        t == "engine_model" and ax == "features"
        for t, (ax, _), _ in meshes.fallbacks()
    )


def test_sharded_path_coef_divisibility_falls_back_to_gspmd():
    eng = _glm_engine(coef=64)
    meshes.clear_fallbacks()
    path, _, _ = eng.sharded_path(abstract(("data", 8), ("model", 1)), coef=6)
    assert path == "gspmd"
    assert any(t == "engine_batch" for t, _, _ in meshes.fallbacks())
    with pytest.raises(ValueError, match="does not divide"):
        make_engine(
            *trace(lambda: linear_regression(16, merge_coef=6)),
            shard_impl="shard_map", device=CPU,
        ).sharded_path(abstract(("data", 8), ("model", 1)), coef=6)


def test_sharded_path_generic_graph_model_shards_via_gspmd():
    g, part = trace(lambda: lrmf(24, rank=4, merge_coef=8))
    eng = make_engine(g, part, shard_model=True, device=CPU)
    assert eng.glm_template is None
    mesh = abstract(("data", 2), ("model", 4))
    path, _, model = eng.sharded_path(mesh)
    assert (path, model) == ("gspmd", None)
    forced = make_engine(g, part, shard_model=True, shard_impl="shard_map", device=CPU)
    with pytest.raises(ValueError, match="model-axis shard_map"):
        forced.sharded_path(mesh)


def test_sharded_path_forced_gspmd():
    eng = _glm_engine(shard_impl="gspmd")
    assert eng.sharded_path(abstract(("data", 8), ("model", 1)))[0] == "gspmd"


def test_make_engine_rejects_unknown_shard_impl():
    with pytest.raises(ValueError, match="shard_impl"):
        _glm_engine(shard_impl="magic")


def test_make_engine_mesh_policy():
    """A non-mesh raises TypeError; an abstract mesh is kept and never
    dispatched; a CPU mesh for a card engine is refused."""
    with pytest.raises(TypeError, match="mesh"):
        _glm_engine(mesh=object())
    eng = _glm_engine(mesh=abstract(("data", 8), ("model", 1)))
    assert eng._active_mesh() is None
    host = meshes.make_host_mesh(device=CPU)
    assert _glm_engine(mesh=host).mesh is host


def test_solver_rejects_prebuilt_engine_without_shard_model(tmp_path):
    from repro_torch.core import solver

    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (64, 8)).astype(np.float32)
    heap = write_table(str(tmp_path / "e.heap"), X, X @ rng.normal(0, 1, 8),
                       page_bytes=8192)
    g, part = trace(lambda: linear_regression(8, merge_coef=8, epochs=1))
    eng = make_engine(g, part, device=CPU)
    for pipelined in (True, False):
        with pytest.raises(ValueError, match="shard_model"):
            solver.train(g, part, heap, engine=eng, shard_model=True, pipelined=pipelined)
    eng2 = make_engine(g, part, shard_model=True, device=CPU)
    solver.train(g, part, heap, engine=eng2, shard_model=True)
    solver.train(g, part, heap, engine=eng2, shard_model=True, pipelined=False)


def test_model_logical_axes_declared_by_algorithms():
    g, _ = trace(lambda: svm(8))
    assert model_logical_axes(g) == (("features",),)
    g, _ = trace(lambda: lrmf(12, rank=3))
    assert model_logical_axes(g) == (("features", "rank"),)


# ---------------------------- the sweep against repro -----------------------------
def _max_merge(pkg):
    """A GLM-shaped update merged with 'max': the gspmd path's other
    operator (defined in both DSLs)."""
    def algo():
        mo = pkg.model([8], axes=("features",))
        inp, out, mu = pkg.input([8]), pkg.output(), pkg.meta(0.1)
        a = pkg.algo(mo, inp, out)
        grad = a.merge((pkg.sigma(mo * inp, 1) - out) * inp, 16, "max")
        a.setModel(mo - mu * grad)
        a.setEpochs(2)
        return a
    return algo


GRAPHS = {
    "linear16": (lambda: linear_regression(16, merge_coef=64),
                 lambda: jlinear(16, merge_coef=64)),
    "logistic54": (lambda: logistic_regression(54, merge_coef=256),
                   lambda: jlogistic(54, merge_coef=256)),
    "svm13": (lambda: svm(13, merge_coef=24), lambda: jsvm(13, merge_coef=24)),
    "lrmf24": (lambda: lrmf(24, rank=4, merge_coef=8), lambda: jlrmf(24, rank=4, merge_coef=8)),
    "max8": (_max_merge(dana), _max_merge(jdana)),
}
SWEEP_MESHES = ((None, 1, 1), (None, 8, 1), (None, 2, 4), (None, 4, 2), (None, 1, 2),
                (None, 3, 1), (2, 4, 1), (2, 2, 2))


@pytest.fixture(scope="module")
def engine_pairs():
    out = {}
    for name, (tfn, jfn) in GRAPHS.items():
        g, part = trace(tfn)
        jg, jpart = jtranslator.trace(jfn)
        for shard_model, impl in itertools.product((False, True),
                                                   ("auto", "shard_map", "gspmd")):
            out[name, shard_model, impl] = (
                make_engine(g, part, shard_model=shard_model, shard_impl=impl, device=CPU),
                jengine.make_engine(jg, jpart, shard_model=shard_model, shard_impl=impl))
    return out


def _decide(eng, mesh, coef):
    try:
        return eng.sharded_path(mesh, coef=coef)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_path_sweep_equals_repro(engine_pairs, name):
    cases = 0
    for (shard_model, impl), sizes, coef in itertools.product(
            itertools.product((False, True), ("auto", "shard_map", "gspmd")),
            SWEEP_MESHES, (None, 6, 64)):
        eng, jeng = engine_pairs[name, shard_model, impl]
        assert (eng.glm_template, eng.merge_op, eng.merge_coef) == (
            jeng.glm_template, jeng.merge_op, jeng.merge_coef)
        pod, data, model = sizes
        names = ("data", "model") if pod is None else ("pod", "data", "model")
        sz = (data, model) if pod is None else (pod, data, model)
        tmesh, jmesh = meshes.AbstractMesh(sz, names), jax.sharding.AbstractMesh(sz, names)
        with meshes.use_mesh(tmesh), jmeshes.use_mesh(jmesh):
            got, want = _decide(eng, tmesh, coef), _decide(jeng, jmesh, coef)
            assert got == want, (shard_model, impl, sizes, coef)
            assert meshes.fallbacks() == jmeshes.fallbacks(), (shard_model, impl, sizes)
        cases += 1
    assert cases == 6 * len(SWEEP_MESHES) * 3


# ---------------------------- degenerate meshes -------------------------------
def test_one_rank_mesh_is_a_noop():
    """The (1, 1) host mesh of a lone process must not engage the sharded
    dispatch even with shard_model on: nothing to partition."""
    eng = _glm_engine(shard_model=True)
    rng = np.random.default_rng(0)
    Xb = torch.from_numpy(rng.normal(0, 1, (4, 64, 16)).astype(np.float32))
    Yb = torch.from_numpy(rng.normal(0, 1, (4, 64)).astype(np.float32))
    with meshes.use_mesh(meshes.make_host_mesh(device=CPU)):
        eng.run_epoch(init_models(eng.g, device=CPU), Xb, Yb, torch.ones(Yb.shape))
    assert eng.last_sharded_path is None


@pytest.mark.parametrize("graph", ["linear16", "max8"])
def test_explicit_sharded_epoch_parity_on_degenerate_mesh(graph):
    """run_epoch_sharded stays callable on any mesh; on the one-rank mesh the
    per-rank datapath (no collective runs) equals the plain epoch, and
    repro's."""
    tfn, jfn = GRAPHS[graph]
    g, part = trace(tfn)
    eng = make_engine(g, part, device=CPU)
    jg, jpart = jtranslator.trace(jfn)
    jeng = jengine.make_engine(jg, jpart)
    d, coef = g.node(g.model_ids[0]).shape[0], eng.merge_coef
    rng = np.random.default_rng(3)
    X = rng.normal(0, 1, (6, coef, d)).astype(np.float32)
    Y = rng.normal(0, 1, (6, coef)).astype(np.float32)
    Xb, Yb, Mb = torch.from_numpy(X), torch.from_numpy(Y), torch.ones(6, coef)
    models = init_models(g, device=CPU)
    want, wantg = eng.run_epoch(models, Xb, Yb, Mb)
    got, gotg = eng.run_epoch_sharded(models, Xb, Yb, Mb,
                                      mesh=meshes.make_host_mesh(device=CPU))
    jw, jgn = jeng.run_epoch(jengine.init_models(jg), jnp.asarray(X), jnp.asarray(Y),
                             jnp.ones((6, coef), jnp.float32))
    assert eng.last_sharded_path[0] == ("shard_map" if graph == "linear16" else "gspmd")
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gotg.numpy(), wantg.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jw[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gotg.numpy(), np.asarray(jgn), rtol=1e-4, atol=1e-5)


# ---------------------------- 8 gloo ranks ------------------------------------
@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Start 8 gloo ranks on the CPU (dist_util.case_engine) and, while they
    run, compute repro's unsharded results from the same numpy inputs."""
    work = str(tmp_path_factory.mktemp("shard_engine_8"))
    inp = dist_util.toy_inputs()
    write_table(f"{work}/t.heap", inp["Xt"], inp["yt"], page_bytes=8192)
    started = dist_util.start("engine", WORLD, work)
    try:
        want = _repro_results(inp, work)
    finally:
        ranks = dist_util.collect(started)
    return ranks, want


def _repro_results(inp, work):
    d, coef = 16, 64
    g, part = jtranslator.trace(lambda: jlogistic(d, lr=0.3, merge_coef=coef))
    eng = jengine.make_engine(g, part)
    Xb = jnp.asarray(inp["X"]).reshape(-1, coef, d)
    Yb = jnp.asarray(inp["y"]).reshape(-1, coef)
    want, wantg = eng.run_epoch(jengine.init_models(g), Xb, Yb, jnp.ones(Yb.shape))
    gm, pm = jtranslator.trace(lambda: jlrmf(24, rank=4, lr=1e-2, merge_coef=8))
    engm = jengine.make_engine(gm, pm, shard_model=True)
    Rb = jnp.asarray(inp["R"]).reshape(-1, 8, 24)
    m0 = jengine.init_models(gm, np.random.default_rng(1), scale=0.05)
    wantm, _ = engm._epoch(m0, Rb, jnp.zeros(Rb.shape[:2]), jnp.ones(Rb.shape[:2]))
    gt, pt = jtranslator.trace(lambda: jlinear(d, lr=0.3, merge_coef=64, epochs=4))
    base = jsolver.train(gt, pt, JHeapFile(f"{work}/t.heap"), mode="dana", seed=2,
                         pipelined=True)
    with jax.enable_x64(True):
        g64, p64 = jtranslator.trace(lambda: jlinear(12, lr=0.3, merge_coef=64))
        eng64 = jengine.make_engine(g64, p64, use_fused_kernel=False)
        X64 = jnp.asarray(inp["X64"]).reshape(-1, 64, 12)
        Y64 = jnp.asarray(inp["y64"]).reshape(-1, 64)
        assert X64.dtype == jnp.float64
        w64, g64n = eng64._epoch([jnp.zeros(12, jnp.float64)], X64, Y64,
                                 jnp.ones(Y64.shape, jnp.float64))
        w64, g64n = np.asarray(w64[0]), np.asarray(g64n)
    return {"w": np.asarray(want[0]), "gnorms": np.asarray(wantg), "M": np.asarray(wantm[0]),
            "train": base.models[0], "w64": w64, "gnorms64": g64n}


def _same_on_every_rank(ranks, *keys):
    first = ranks[0]
    for k in keys:
        first = first[k]
    for r in ranks[1:]:
        v = r
        for k in keys:
            v = v[k]
        assert np.array_equal(v, first) and v.dtype == first.dtype, keys


def test_8_ranks_data_mesh_keeps_the_kernel_path(eight_ranks):
    """repro's FUSED-SHARD-MAP case: glm_grad a batch, _pre never called."""
    ranks, want = eight_ranks
    for r in ranks:
        out = r["data"]
        assert out["mesh"] == {"data": 8, "model": 1}
        assert out["path"] == ("shard_map", ("data",), None)
        assert out["calls"] == 16  # one per merge batch: 1,024 / 64
        assert out["collectives"] == {"all_reduce": 16, "broadcast": 0}
        np.testing.assert_allclose(out["w"], want["w"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["gnorms"], want["gnorms"], rtol=1e-3, atol=1e-4)
        assert r["forbidden"] == []
    _same_on_every_rank(ranks, "data", "w")


def test_8_ranks_model_axis(eight_ranks):
    """repro's MODEL-AXIS case: (2 x 4), w Shard(0) on the model axis."""
    ranks, want = eight_ranks
    for rank, r in enumerate(ranks):
        out = r["model"]
        assert out["mesh"] == {"data": 2, "model": 4}
        assert out["path"] == ("shard_map", ("data",), "model")
        assert out["placements"] == ["R", "S(0)"]
        np.testing.assert_allclose(out["local"], out["w"][rank % 4 * 4:(rank % 4 + 1) * 4])
        # a batch: z over the model axis, g over the data axis; the norms once
        assert out["collectives"]["all_reduce"] == 2 * 16 + 1
        np.testing.assert_allclose(out["w"], want["w"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["gnorms"], want["gnorms"], rtol=1e-3, atol=1e-4)
    _same_on_every_rank(ranks, "model", "w")


def test_8_ranks_lrmf_gspmd(eight_ranks):
    """repro's LRMF-GSPMD case: the gspmd path, items Shard(0) on model."""
    ranks, want = eight_ranks
    for r in ranks:
        assert r["lrmf"]["path"] == ("gspmd", ("data",), None)
        assert r["lrmf"]["placements"] == ["R", "S(0)"]
        np.testing.assert_allclose(r["lrmf"]["M"], want["M"], rtol=1e-4, atol=1e-5)
    _same_on_every_rank(ranks, "lrmf", "M")


def test_8_ranks_solver_train_shard_model(eight_ranks):
    """repro's TRAIN-SHARD-MODEL case: the pipelined solver on (2 x 4)."""
    ranks, want = eight_ranks
    for r in ranks:
        assert r["train"]["device_syncs"] == r["train"]["epochs_run"] == 4
        np.testing.assert_allclose(r["train"]["w"], want["train"], rtol=1e-4, atol=1e-5)
    _same_on_every_rank(ranks, "train", "w")


def test_8_ranks_float64_parity(eight_ranks):
    """repro's FLOAT64-PARITY case: the all_reduce merge is the same sum up
    to order, so float64 holds at 1e-12."""
    ranks, want = eight_ranks
    for r in ranks:
        out = r["f64"]
        assert out["path"] == ("shard_map", ("data",), None)
        assert out["dtype"] == "torch.float64" and out["w"].dtype == np.float64
        np.testing.assert_allclose(out["w"], want["w64"], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["gnorms"], want["gnorms64"], rtol=1e-12, atol=1e-12)
    _same_on_every_rank(ranks, "f64", "w")


def test_8_ranks_shard_act_places_by_the_local_slice(eight_ranks):
    ranks, _ = eight_ranks
    for rank, r in enumerate(ranks):
        out = r["shard_act"]
        assert out["placements"] == ["S(0)", "S(1)"]  # batch on data, ff on model
        whole = np.arange(64.0, dtype=np.float32).reshape(8, 8)
        np.testing.assert_array_equal(out["whole"], whole)
        i, j = divmod(rank, 4)
        np.testing.assert_array_equal(out["local"], whole[4 * i:4 * i + 4, 2 * j:2 * j + 2])
