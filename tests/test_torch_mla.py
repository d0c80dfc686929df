"""The port's MLA decode (``repro_torch.models.attention``: ``mla_decode``,
``mla_decode_paged``, the latent caches) against ``repro``'s on the CPU, with
the same weights carried over by ``params_from_numpy`` and the same numpy
inputs, and the server on reduced minicpm3-4b: within the port (paged vs
dense, tokens vs chunked, the kernel's plain version vs the gather path) and
against ``repro``'s server on the same weights.

Tolerances. In f32 the two packages differ by summation order (2e-5). In
bf16, as served, they round the activations at other places: layer outputs
within 3e-2 (``tests/test_prefill_decode_parity.py``'s), caches within one
bf16 step. The kernel path (``impl="kernel"``: here the plain B5, which sums
in f32) is held against the reference's ``"pallas"`` (on the CPU its
``paged_attn_ref`` oracle, also f32); the gather path rounds its two score
products to bf16 as the reference's does, so the two paths meet only token
for token, up to the near-ties ``assert_greedy_matches`` prints."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve_util import (CPU, STREAM, assert_greedy_matches, one_cpu_thread,  # noqa: F401
                                   serve)
from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.serve import serving as jserving
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention, model_zoo
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.serving import BatchedServer, Request

ARCH = "minicpm3-4b"
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
CACHE = dict(rtol=2 ** -7, atol=1e-6)


def _first(tree):
    return {k: _first(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _attn(dtype, seed=3):
    """Reduced minicpm3 in both packages and its first attention layer: the
    reference's f32 masters and the port's copy stored as ``dtype``."""
    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=dtype)
    return (cfg, jcfg, jax.tree.map(lambda a: a[0], jp["segments"][0]["attn"]),
            _first(tp["segments"][0]["attn"]))


def _inputs(precision):
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    return dtype, jnp.float32 if precision == "f32" else jnp.bfloat16, \
        F32 if precision == "f32" else BF16


def _x(rng, b, cfg, jdt):
    x = rng.normal(0, 0.5, (b, 1, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32)))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_mla_decode_dense_matches_repro(precision):
    dtype, jdt, tol = _inputs(precision)
    cfg, _, jp, tp = _attn(dtype)
    rng = np.random.default_rng(1)
    b, s = 3, 8
    lat = rng.normal(0, 0.3, (b, s, cfg.kv_lora_rank)).astype(np.float32)
    rope = rng.normal(0, 0.3, (b, s, cfg.qk_rope_head_dim)).astype(np.float32)
    jcache = {"c": jnp.asarray(lat, jnp.bfloat16), "kr": jnp.asarray(rope, jnp.bfloat16)}
    tcache = attention.init_mla_cache(cfg, b, s)
    assert tcache["c"].shape == (b + 1, s, cfg.kv_lora_rank)
    tcache["c"][:b], tcache["kr"][:b] = torch.from_numpy(lat), torch.from_numpy(rope)
    for pos in ([0, 3, 7], [1, 4, 7]):
        jx, tx = _x(rng, b, cfg, jdt)
        got, tcache = attention.mla_decode(tp, tx.to(dtype), tcache,
                                           torch.tensor(pos, dtype=torch.int32), cfg)
        want, jcache = jattn.mla_decode(jp, jx, jcache, jnp.asarray(pos), cfg)
        assert got.dtype == dtype and got.shape == (b, 1, cfg.d_model)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
        for key in ("c", "kr"):
            np.testing.assert_allclose(tcache[key][:b].float().numpy(),
                                       np.asarray(jcache[key], np.float32), **CACHE)


def test_mla_decode_token_batch_slots_and_gated_rows():
    """Token-batched decode: rows map onto cache slots through ``slot``;
    gated-off rows that share (slot 0, position 0) with a live row land in
    the spare row, so the live write survives."""
    cfg, _, jp, tp = _attn(torch.float32)
    rng = np.random.default_rng(2)
    nslots, s = 2, 6
    x = rng.normal(0, 0.5, (6, 1, cfg.d_model)).astype(np.float32)
    slot = np.array([0, 0, 1, 0, 0, 0], np.int32)
    pos = np.array([0, 1, 2, 0, 0, 0], np.int32)
    ok = np.array([True, True, True, False, False, False])
    jcache = {"c": jnp.zeros((nslots, s, cfg.kv_lora_rank), jnp.bfloat16),
              "kr": jnp.zeros((nslots, s, cfg.qk_rope_head_dim), jnp.bfloat16)}
    tcache = attention.init_mla_cache(cfg, nslots, s)
    got, tcache = attention.mla_decode(tp, torch.from_numpy(x), tcache, torch.from_numpy(pos),
                                       cfg, slot=torch.from_numpy(slot),
                                       write_ok=torch.from_numpy(ok))
    want, jcache = jattn.mla_decode(jp, jnp.asarray(x), jcache, jnp.asarray(pos), cfg,
                                    slot=jnp.asarray(slot), write_ok=jnp.asarray(ok))
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3], **F32)
    for key in ("c", "kr"):
        np.testing.assert_allclose(tcache[key][:nslots].float().numpy(),
                                   np.asarray(jcache[key], np.float32), **CACHE)
    assert tcache["c"][0, 0].abs().sum() > 0 and tcache["c"][nslots, 0].abs().sum() > 0
    assert not torch.equal(tcache["c"][0, 0], tcache["c"][nslots, 0])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_mla_decode_paged_matches_repro(impl, precision):
    """Recycled (permuted, stale) blocks, a parked row gated off past its
    table, and a position on the last mapped row; ``kernel`` against the
    reference's ``pallas`` (its oracle on the CPU), ``gather`` against its
    ``gather``."""
    dtype, jdt, tol = _inputs(precision)
    cfg, _, jp, tp = _attn(dtype)
    rng = np.random.default_rng(3)
    b, bs, nb_slot, num_blocks = 4, 4, 3, 16
    lat = rng.normal(0, 0.3, (num_blocks, bs, cfg.kv_lora_rank)).astype(np.float32)
    rope = rng.normal(0, 0.3, (num_blocks, bs, cfg.qk_rope_head_dim)).astype(np.float32)
    table = rng.permutation(num_blocks)[: b * nb_slot].reshape(b, nb_slot).astype(np.int32)
    jcache = {"c": jnp.asarray(lat, jnp.bfloat16), "kr": jnp.asarray(rope, jnp.bfloat16)}
    tcache = attention.init_mla_cache_paged(cfg, num_blocks, bs)
    assert tcache["kr"].shape == (num_blocks + 1, bs, cfg.qk_rope_head_dim)
    tcache["c"][:num_blocks], tcache["kr"][:num_blocks] = (torch.from_numpy(lat),
                                                           torch.from_numpy(rope))
    pos = np.array([0, 5, bs * nb_slot - 1, 30], np.int32)
    ok = np.array([True, True, True, False])
    jx, tx = _x(rng, b, cfg, jdt)
    got, tcache = attention.mla_decode_paged(
        tp, tx.to(dtype), tcache, torch.from_numpy(pos), cfg, table=torch.from_numpy(table),
        block_size=bs, max_seq=bs * nb_slot, write_ok=torch.from_numpy(ok), impl=impl)
    want, jcache = jattn.mla_decode_paged(
        jp, jx, jcache, jnp.asarray(pos), cfg, table=jnp.asarray(table), block_size=bs,
        max_seq=bs * nb_slot, write_ok=jnp.asarray(ok),
        impl="pallas" if impl == "kernel" else "gather")
    np.testing.assert_allclose(got[:3].float().numpy(), np.asarray(want, np.float32)[:3], **tol)
    for key in ("c", "kr"):
        np.testing.assert_allclose(tcache[key][:num_blocks].float().numpy(),
                                   np.asarray(jcache[key], np.float32), **CACHE)
    with pytest.raises(ValueError, match="impl"):
        attention.mla_decode_paged(tp, tx.to(dtype), tcache, torch.from_numpy(pos), cfg,
                                   table=torch.from_numpy(table), block_size=bs,
                                   impl="pallas")


def test_mla_kernel_path_is_one_mqa_call_of_b5(monkeypatch):
    """The kernel path hands B5's latent entry one kv head of the latent: q
    (T, H, kv_lora + rope), and the cache's own c and kr pools (the same
    storage: no concatenation of the pool), the step's runs passed on."""
    from repro_torch.kernels.paged_attn import ops

    cfg, _, _, tp = _attn(torch.bfloat16)
    seen = []
    real = ops.paged_latent_attention

    def spy(q, c_pool, kr_pool, table, pos, **kw):
        seen.append((q.shape, c_pool, kr_pool, kw["runs"]))
        return real(q, c_pool, kr_pool, table, pos, **kw)

    def concatenated(*a, **kw):
        raise AssertionError("the kernel path reached the generic entry")

    monkeypatch.setattr(ops, "paged_latent_attention", spy)
    monkeypatch.setattr(ops, "paged_attention", concatenated)
    cache = attention.init_mla_cache_paged(cfg, 6, 4)
    runs = torch.tensor([[0, 2]], dtype=torch.int32)
    x = torch.zeros((2, 1, cfg.d_model), dtype=torch.bfloat16)
    attention.mla_decode_paged(tp, x, cache, torch.tensor([0, 1]), cfg,
                               table=torch.zeros((2, 2), dtype=torch.int32), block_size=4,
                               impl="kernel", runs=runs)
    dk = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    (q, c, kr, passed), = seen
    assert q == (2, cfg.n_heads, dk)
    assert c is cache["c"] and kr is cache["kr"]
    assert c.data_ptr() == cache["c"].data_ptr() and kr.data_ptr() == cache["kr"].data_ptr()
    assert passed is runs


# ------------------------------ the server ------------------------------------
@pytest.fixture(scope="module")
def both():
    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(5))
    return cfg, jcfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)


def test_server_paged_equals_dense_and_tokens_equal_chunked(both):
    """The same read path (gather) on both sides of each comparison: the
    same bits, so the same tokens."""
    cfg, _, _, tp = both
    dense, _ = serve(cfg, tp)
    chunked, srv = serve(cfg, tp, kv="paged", block_size=4, prefill_chunk=3)
    tokens, tsrv = serve(cfg, tp, kv="paged", block_size=4, prefill_chunk=3,
                         step_mode="tokens")
    assert dense == chunked == tokens
    assert srv.metrics.finished == tsrv.metrics.finished == len(STREAM)
    assert set(tsrv.cache[0]) == {"c", "kr"}


@pytest.mark.parametrize("step_mode", ["chunked", "tokens"])
def test_server_prefix_sharing_reaches_the_latent(both, step_mode):
    """Rid 0 holds a 3-block template; rid 2, admitted when rid 1 frees its
    slot, is the template alone: it maps the template's blocks shared and
    copies the last one before writing it. The latent leaves take every
    copy, so the tokens equal an unshared run's."""
    cfg, _, _, tp = both
    shared = [7, 3, 9, 1, 4, 2, 8, 5, 6, 1, 3, 7]
    stream = [(shared, 16), (shared + [10], 4), (shared, 5)]
    kw = dict(slots=2, max_seq=40, kv="paged", block_size=4, prefill_chunk=4,
              step_mode=step_mode)
    got, srv = serve(cfg, tp, stream, prefix_cache=True, **kw)
    want, _ = serve(cfg, tp, stream, prefix_cache=False, **kw)
    assert got == want
    assert srv.metrics.prefix_hits > 0 and srv.metrics.cow_splits > 0
    srv._paged.check()


def test_server_kernel_path_matches_gather_up_to_near_ties(both):
    cfg, jcfg, jp, tp = both
    kw = dict(kv="paged", block_size=4, prefill_chunk=4, step_mode="tokens")
    kernel, srv = serve(cfg, tp, attn_impl="kernel", **kw)
    gather, _ = serve(cfg, tp, attn_impl="gather", **kw)
    assert srv.attn_impl == "kernel"
    for (prompt, _), k, g in zip(STREAM, kernel, gather):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, k, g)


# one mixed stream: more requests than slots, two priority classes, a prompt
# that shares a 4-token prefix with another
_MIXED = [([5, 6, 7, 8, 2, 1, 9], 7, 2), ([1, 2], 3, 2), ([9, 3, 9, 4], 5, 0),
          ([2], 4, 2), ([5, 6, 7, 8, 3], 6, 0), ([4, 4, 4, 4, 4], 3, 2)]


@pytest.mark.parametrize("mode", [dict(),
                                  dict(kv="paged", block_size=4, prefill_chunk=3),
                                  dict(kv="paged", block_size=4, prefill_chunk=4,
                                       step_mode="tokens", attn_impl="kernel")],
                         ids=["dense", "paged_chunked", "paged_tokens_kernel"])
def test_greedy_stream_matches_repro(both, mode):
    cfg, jcfg, jp, tp = both
    jmode = dict(mode, attn_impl="pallas") if mode.get("attn_impl") == "kernel" else mode
    servers = (jserving.BatchedServer(jcfg, jp, batch_slots=2, max_seq=24, **jmode),
               BatchedServer(cfg, tp, batch_slots=2, max_seq=24, device=CPU, **mode))
    for srv, req in zip(servers, (jserving.Request, Request)):
        for i, (prompt, n, prio) in enumerate(_MIXED):
            srv.submit(req(i, list(prompt), n, priority=prio))
    want, got = ([r.out for r in s.run()] for s in servers)
    for (prompt, _, _), g, w in zip(_MIXED, got, want):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, g, w)
    jm, tm = servers[0].metrics, servers[1].metrics
    for name in ("steps", "active_slot_steps", "admitted", "finished", "tokens_generated",
                 "prompt_tokens", "batched_tokens", "preemptions", "deferrals",
                 "prefix_hits", "prefix_tokens", "kv_blocks_total", "kv_blocks_peak",
                 "ttft_steps"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_cache_row_bytes_count_the_latent():
    """A written position costs kv_lora + rope bf16 values a layer: the unit
    behind ``metrics.kv_bytes_written``."""
    from repro_torch.serve.serving import _cache_row_bytes

    cfg = get_reduced_config(ARCH)
    for cache in (model_zoo.make_cache(cfg, 2, 8, CPU),
                  model_zoo.make_paged_cache(cfg, 4, 4, CPU)):
        assert _cache_row_bytes(cache) == \
            cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2


def test_full_latent_widths_serve_kernel_and_gather_alike():
    """The reduced model at minicpm3's full latent widths (kv_lora 256, rope
    32), as the card test serves it so that B5 takes its tiled body (Dk 288,
    Dv 256): the kernel path's plain version and the gather path agree up to
    near-ties."""
    arch_kw = dict(kv_lora_rank=256, qk_rope_head_dim=32)
    cfg, jcfg = get_reduced_config(ARCH, **arch_kw), jreduced(ARCH, **arch_kw)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(7))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    assert (cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.kv_lora_rank) == (288, 256)
    kw = dict(kv="paged", block_size=4, prefill_chunk=4, step_mode="tokens")
    kernel, _ = serve(cfg, tp, attn_impl="kernel", **kw)
    gather, _ = serve(cfg, tp, attn_impl="gather", **kw)
    for (prompt, _), k, g in zip(STREAM, kernel, gather):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, k, g)
