"""The sharded server's decisions and placements in one process, against
``repro``: ``BatchedServer.sharded_path`` and its ``serve_cache`` fallbacks
on ``AbstractMesh``es (the cases of ``tests/test_serving_cb.py``'s sharding
section, dense, paged and MLA, and the kernel path's replicated pool),
``model_zoo.cache_specs`` for every architecture's dense and paged cache
(``tests/test_serve_dist_data.py``'s), each cache leaf's resolved spec and
fallbacks under both serve rule tables, the resolver cases of
``test_serve_dist_data.py`` that ``test_torch_dist_meshes.py`` does not
hold, and the one-rank host mesh serving the unsharded server's tokens.
The runs on 8 gloo ranks are in ``test_torch_serve_mesh_ranks.py``."""
import itertools

import jax
import numpy as np
import pytest
import torch

from test_torch_serve_util import CPU, STREAM, one_cpu_thread, params, serve  # noqa: F401
from repro.configs import ARCH_IDS
from repro.configs import get_reduced_config as jreduced
from repro.dist import meshes as jmeshes
from repro.models import model_zoo as jzoo
from repro.serve import serving as jserving
from repro_torch.configs import get_reduced_config
from repro_torch.dist import meshes
from repro_torch.models import model_zoo
from repro_torch.serve import serving
from repro_torch.serve.serving import BatchedServer

MESHES = [(4, 2), (2, 4), (1, 3), (8, 1), (1, 1)]
SERVED = [a for a in ARCH_IDS if a != "seamless-m4t-medium"]


def _servers(arch, **kw):
    """The port's server and ``repro``'s on the reduced ``arch`` (weights do
    not matter to the decision: the port's drawn on the CPU, ``repro``'s
    from its own seed); the kernel path is ``repro``'s ``pallas``."""
    cfg, p = params(arch)
    jcfg = jreduced(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(2))
    jkw = dict(kw, attn_impl="pallas") if kw.get("attn_impl") == "kernel" else kw
    return (BatchedServer(cfg, p, max_seq=16, device=CPU, **kw),
            jserving.BatchedServer(jcfg, jp, max_seq=16, **jkw))


def _decide(srv, jsrv, sizes):
    """Both servers' ``sharded_path`` on a (data, model) mesh of ``sizes``,
    each with the fallbacks it recorded."""
    names = ("data", "model")
    meshes.clear_fallbacks()
    jmeshes.clear_fallbacks()
    got = srv.sharded_path(meshes.AbstractMesh(sizes, names))
    want = jsrv.sharded_path(jax.sharding.AbstractMesh(sizes, names))
    return (got, meshes.fallbacks()), (want, jmeshes.fallbacks())


# ------------------------------- the decision -----------------------------------
def test_sharded_path_decision_and_fallbacks():
    """test_serving_cb.py's cases: slots over data and KV heads over model;
    3 slots that do not divide data 4; 2 KV heads that do not divide model
    3; MLA's latent cache with no head dim."""
    srv, jsrv = _servers("internlm2-20b", batch_slots=4)  # reduced: n_kv_heads = 2
    got, want = _decide(srv, jsrv, (4, 2))
    assert got == want and got == (("gspmd", ("data",), "model"), [])
    srv3, jsrv3 = _servers("internlm2-20b", batch_slots=3)
    got, want = _decide(srv3, jsrv3, (4, 2))
    assert got == want and got[0] == ("gspmd", (), "model")
    assert [(t, ax) for t, (ax, _), _ in got[1]] == [("serve_cache", "batch")]
    got, want = _decide(srv, jsrv, (1, 3))
    assert got == want and got[0] == ("gspmd", (), None)
    assert [(t, ax) for t, (ax, _), _ in got[1]] == [("serve_cache", "kv_heads")]
    srv_mla, jsrv_mla = _servers("minicpm3-4b", batch_slots=4)
    got, want = _decide(srv_mla, jsrv_mla, (4, 2))
    assert got == want and got[0] == ("gspmd", ("data",), None)
    assert [t for t, _, _ in got[1]] == ["serve_cache"]


def test_sharded_path_paged_block_pool_fallbacks():
    """Paged KV divides the pool's blocks, not the slots: 3 slots over 16
    blocks shard; 10 blocks fall back; the kernel path keeps the pool
    replicated with its record. The landing block is not counted."""
    kw = dict(batch_slots=3, kv="paged", block_size=4, kv_blocks=16)
    srv, jsrv = _servers("internlm2-20b", **kw)
    assert srv.cache[0]["k"].shape[1] == 17  # 16 blocks and the landing block
    got, want = _decide(srv, jsrv, (4, 2))
    assert got == want == (("gspmd", ("data",), "model"), [])
    srv10, jsrv10 = _servers("internlm2-20b", **dict(kw, batch_slots=4, kv_blocks=10))
    got, want = _decide(srv10, jsrv10, (4, 2))
    assert got == want and got[0] == ("gspmd", (), "model")
    assert [(t, ax) for t, (ax, _), _ in got[1]] == [("serve_cache", "kv_blocks")]
    srvk, jsrvk = _servers("internlm2-20b", **dict(kw, attn_impl="kernel"))
    got, want = _decide(srvk, jsrvk, (4, 2))
    assert got == want and got[0] == ("gspmd", (), "model")
    assert [(t, ax) for t, (ax, _), _ in got[1]] == [("serve_cache", "kv_blocks")]


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("mode", ["dense", "paged", "kernel"])
def test_sharded_path_equals_repro_for_every_family(arch, mode):
    """Every served family (the recurrent head count of RWKV, MLA's latent,
    hymba's single reduced KV head, MoE) on every test mesh: the same tuple
    and the same fallbacks as ``repro``."""
    kw = {"dense": {}, "paged": dict(kv="paged", block_size=4, kv_blocks=16),
          "kernel": dict(kv="paged", block_size=4, kv_blocks=16, attn_impl="kernel")}[mode]
    srv, jsrv = _servers(arch, batch_slots=4, **kw)
    for sizes in MESHES:
        got, want = _decide(srv, jsrv, sizes)
        assert got == want, (arch, mode, sizes)


# ------------------------------- cache_specs ------------------------------------
def _specs(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_repro(arch):
    """test_serve_dist_data.py's check (one spec a leaf, as long as its
    shape) and equality with ``repro``'s trees, dense and paged."""
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    dense = model_zoo.make_cache(cfg, 2, 16, device=CPU)
    want = jzoo.cache_specs(jzoo.make_cache(jcfg, 2, 16, abstract=True))
    got = model_zoo.cache_specs(dense)
    assert _specs(got) == _specs(want)
    for c, s in zip(jax.tree.leaves(dense), _specs(got)):
        assert len(s) == c.dim(), (arch, s, c.shape)
    if cfg.family in ("ssm", "encdec"):  # no paged attention cache in repro
        return
    paged = model_zoo.make_paged_cache(cfg, 8, 4, device=CPU, slots=2)
    jpaged = jzoo.make_paged_cache(jcfg, 2, 8, 4, abstract=True)
    assert model_zoo.cache_specs(paged, paged=True) == jzoo.cache_specs(jpaged, paged=True)


@pytest.mark.parametrize("arch", SERVED)
def test_cache_leaf_shardings_equal_repro(arch):
    """Each cache leaf's resolved spec and the resolver's fallbacks, over
    both serve rule tables and the test meshes, for the port's caches
    (their logical shapes: no landing row or block) and ``repro``'s."""
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    caches = [(model_zoo.make_cache(cfg, 4, 16, device=CPU),
               jzoo.make_cache(jcfg, 4, 16, abstract=True), False)]
    if cfg.family != "ssm":
        caches.append((model_zoo.make_paged_cache(cfg, 16, 4, device=CPU, slots=4),
                       jzoo.make_paged_cache(jcfg, 4, 16, 4, abstract=True), True))
    for (cache, jcache, paged), sizes, rules in itertools.product(
            caches, MESHES, ("SERVE_CACHE_RULES", "SERVE_KERNEL_CACHE_RULES")):
        names = ("data", "model")
        with meshes.use_mesh(None), jmeshes.use_mesh(None):
            got = meshes.tree_shardings(model_zoo.cache_specs(cache, paged=paged),
                                        serving._logical(cache), meshes.AbstractMesh(sizes, names),
                                        rules=getattr(meshes, rules))
            want = jmeshes.tree_shardings(jzoo.cache_specs(jcache, paged=paged), jcache,
                                          jax.sharding.AbstractMesh(sizes, names),
                                          rules=getattr(jmeshes, rules))
            assert meshes.fallbacks() == jmeshes.fallbacks(), (arch, paged, sizes, rules)
        assert [tuple(s.spec) for s in jax.tree.leaves(
                    got, is_leaf=lambda x: isinstance(x, meshes.NamedSharding))] == \
            [tuple(s.spec) for s in jax.tree.leaves(want)], (arch, paged, sizes, rules)


def test_logical_shapes_drop_the_landing_only():
    cfg = get_reduced_config("hymba-1.5b")
    cache = model_zoo.make_paged_cache(cfg, 8, 4, device=CPU, slots=2)
    shapes = [{k: tuple(c.shape) for k, c in seg.items()} for seg in serving._logical(cache)]
    jshapes = [{k: tuple(c.shape) for k, c in seg.items()}
               for seg in jzoo.make_paged_cache(jreduced("hymba-1.5b"), 2, 8, 4, abstract=True)]
    assert shapes == jshapes


# ---------------------------- the resolver's cases -------------------------------
def test_resolver_cases_of_the_serving_tests():
    """test_serve_dist_data.py's resolver cases: a (1, 1) mesh degenerates
    cleanly, both dims wanting 'model' get it once, a divisibility drop is
    recorded under its tensor name, FSDP shards embed over data, and
    shard_act is the identity outside a mesh."""
    one = meshes.make_host_mesh(device=CPU)
    spec = meshes.resolve_spec(("vocab", "embed"), (128, 64), one)
    assert all(s is None for s in spec)
    assert len(meshes.resolve_spec(("embed", "ff"), (64, 128), one,
                                   rules=meshes.FSDP_PARAM_RULES)) <= 2
    mesh = meshes.AbstractMesh((2, 4), ("data", "model"))
    assert [s for s in meshes.resolve_spec(("vocab", "ff"), (8, 8), mesh)
            if s is not None].count("model") == 1
    with meshes.use_mesh(mesh):
        assert list(meshes.resolve_spec(("kv_heads",), (6,), mesh, tensor_name="kv")) == [None]
        assert any(t == "kv" for t, _, _ in meshes.fallbacks())
    spec3 = meshes.resolve_spec(("embed", "ff"), (64, 128), mesh, rules=meshes.FSDP_PARAM_RULES)
    assert spec3[0] == "data" and spec3[1] == "model"
    x = torch.ones(4, 4)
    np.testing.assert_array_equal(meshes.shard_act(x, ("batch", "embed")).numpy(), x.numpy())


# ------------------------------- one rank ----------------------------------------
@pytest.mark.parametrize("mode", [dict(), dict(kv="paged", block_size=5, prefill_chunk=2),
                                  dict(kv="paged", block_size=4, step_mode="tokens",
                                       prefill_chunk=3, attn_impl="kernel")],
                         ids=["dense", "paged", "tokens_kernel"])
def test_degenerate_mesh_parity_in_process(mode):
    """mesh= on the one-rank host mesh (with the weights' specs) serves the
    unsharded server's tokens; the decision is recorded."""
    cfg = get_reduced_config("internlm2-20b")
    p, specs = model_zoo.init_params(cfg, seed=2, device=CPU)
    ref, _ = serve(cfg, p, **mode)
    got, srv = serve(cfg, p, mesh=meshes.make_host_mesh(device=CPU), param_specs=specs, **mode)
    assert got == ref
    assert srv.last_sharded_path is not None and srv.rank_disagreements == 0
    assert srv.metrics.finished == len(STREAM)
