"""The port's GQA model stack (``repro_torch.models``) against ``repro.models``
on the CPU, with the same weights carried over by ``params_from_numpy`` and
the same numpy inputs: parameters, layers, dense and paged decode attention
(gather and the kernel's plain version), and several decode steps of the
whole stack for reduced internlm2-20b and mistral-nemo-12b.

Tolerances. ``repro`` runs every activation in bf16 (its ``embed`` casts the
table to bf16); XLA and PyTorch round bf16 products in different places, so
the bf16 path is held by its logits within ``BF16_LOGITS`` (0.039 measured
here, 2.5 bf16 ulps at logits of magnitude up to 3.3). The algorithm is held
in f32 by keeping the activations in f32 in both packages (their ``embed``
patched to skip the cast): only the bf16 KV caches and the bf16 unembedding
round then, and the logits agree bit for bit (``F32_LOGITS``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from test_torch_serve_util import one_cpu_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.models import attention, layers, model_zoo, transformer
from repro_torch.models.params import count_params, params_from_numpy

ARCHS = ["internlm2-20b", "mistral-nemo-12b"]
CPU = "cpu"
BF16_LOGITS = dict(rtol=0, atol=5e-2)
F32_LOGITS = dict(rtol=0, atol=0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(arch, seed=3, dtype=torch.bfloat16):
    cfg = get_reduced_config(arch)
    jp, jspecs = jzoo.init_params(jreduced(arch), jax.random.PRNGKey(seed))
    return cfg, jp, jspecs, params_from_numpy(cfg, _np_tree(jp), device=CPU, dtype=dtype)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


# ------------------------------ parameters ------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trip(arch):
    cfg, jp, jspecs, tp32 = _both(arch, dtype=torch.float32)
    tp16 = params_from_numpy(cfg, _np_tree(jp), device=CPU)
    own, own_specs = model_zoo.init_params(cfg, seed=0, device=CPU)
    jflat = dict(_flat(jp))
    flat32, flat16, mine_flat = dict(_flat(tp32)), dict(_flat(tp16)), dict(_flat(own))
    assert sorted(flat32) == sorted(jflat) == sorted(mine_flat)
    assert own_specs == jspecs  # same logical axes, leaf for leaf
    for path, want in jflat.items():
        a32, a16, mine = flat32[path], flat16[path], mine_flat[path]
        want = np.asarray(want)
        np.testing.assert_array_equal(a32.numpy(), want)  # f32 masters: exact
        assert a16.shape == mine.shape == want.shape and a16.dtype == mine.dtype
        if path[-1] == "scale":
            assert a16.dtype == torch.float32  # norm scales stay f32
        else:
            cast = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(a16.float().numpy(), cast)  # astype's rounding
    assert count_params(own) == sum(np.asarray(x).size for x in jflat.values())
    with pytest.raises(ValueError, match="not made for"):
        params_from_numpy(get_reduced_config("hymba-1.5b"), _np_tree(jp), device=CPU)


def test_init_params_is_seeded_and_explicit():
    cfg = get_reduced_config("mistral-nemo-12b")
    a, _ = model_zoo.init_params(cfg, seed=5, device=CPU)
    b, _ = model_zoo.init_params(cfg, seed=5, device=CPU)
    c, _ = model_zoo.init_params(cfg, seed=6, device=CPU)
    wa, wb, wc = (p["segments"][0]["attn"]["wq"] for p in (a, b, c))
    assert wa.dtype == torch.bfloat16 and torch.equal(wa, wb) and not torch.equal(wa, wc)
    # fan_in scale: wq is (L, d, H, hd) with fan_in d
    assert abs(float(wa.float().std()) - 1 / np.sqrt(cfg.d_model)) < 0.01


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS])
def test_unported_families_raise_with_their_names(arch):
    cfg = get_reduced_config(arch)
    # every family runs: GQA or MLA attention, MoE, RWKV6, the hybrid layers
    # and enc-dec; only the paged cache still refuses enc-dec, as repro's does
    if cfg.family != "encdec":
        params, _ = model_zoo.init_params(cfg, device=CPU)
        logits, _ = model_zoo.decode_fn(cfg)(
            params, torch.tensor([1, 2], dtype=torch.int32),
            model_zoo.make_cache(cfg, 2, 4, CPU), 0)
        assert logits.shape == (2, cfg.padded_vocab)
        # paged caches: block pools, and the recurrent state's 2 slot rows
        paged = model_zoo.make_paged_cache(cfg, 4, 4, CPU, slots=2)
        for seg, s in zip(paged, transformer.segments_for(cfg)):
            for k, c in seg.items():
                assert c.shape[:2] == ((s.n_layers, 2) if k in ("wkv", "shift_t", "shift_c",
                                                                "ssm", "conv")
                                       else (s.n_layers, 5)), (k, c.shape)
        return
    params, _ = model_zoo.init_params(cfg, device=CPU)
    cache = model_zoo.make_cache(cfg, 2, 4, CPU)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: (cfg.n_layers, 3 if k in ("k", "v") else 2, 4, cfg.n_kv_heads, cfg.hd)
        for k in ("k", "v", "xk", "xv")}
    logits, _ = model_zoo.decode_fn(cfg)(params, torch.tensor([1, 2], dtype=torch.int32),
                                         cache, 0)
    assert logits.shape == (2, cfg.padded_vocab) and torch.isfinite(logits.float()).all()
    with pytest.raises(ValueError, match="family 'encdec' has no paged attention cache"):
        model_zoo.make_paged_cache(cfg, 4, 4, CPU)
    with pytest.raises(ValueError, match="family 'encdec' has no paged attention cache"):
        jzoo.make_paged_cache(jreduced(arch), 2, 4, 4)


def test_segments_for_matches_repro_for_every_family():
    for arch in ARCH_IDS:
        for cfg, jcfg in ((get_reduced_config(arch), jreduced(arch)),):
            mine = [(s.kind, s.n_layers) for s in transformer.segments_for(cfg)]
            assert mine == [(s.kind, s.n_layers) for s in jtransformer.segments_for(jcfg)]
    hy = dataclasses.replace(get_reduced_config("hymba-1.5b"), n_layers=6, n_global_layers=2)
    jhy = dataclasses.replace(jreduced("hymba-1.5b"), n_layers=6, n_global_layers=2)
    assert [(s.kind, s.n_layers) for s in transformer.segments_for(hy)] == \
        [(s.kind, s.n_layers) for s in jtransformer.segments_for(jhy)]


# -------------------------------- layers --------------------------------------
def test_norm_rope_embed_mlp_match_repro():
    cfg, jp, _, tp = _both("mistral-nemo-12b")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (3, 5, cfg.d_model)).astype(np.float32)
    norm = {"scale": rng.normal(0, 0.1, cfg.d_model).astype(np.float32)}
    got = layers.apply_norm({"scale": torch.from_numpy(norm["scale"])}, torch.from_numpy(x),
                            cfg.norm_eps)
    want = jlayers.apply_norm(norm, jnp.asarray(x), cfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # bf16 in, bf16 out: one rounding of the same f32 value
    got16 = layers.apply_norm({"scale": torch.from_numpy(norm["scale"])},
                              torch.from_numpy(x).to(torch.bfloat16), cfg.norm_eps)
    want16 = jlayers.apply_norm(norm, jnp.asarray(x, jnp.bfloat16), cfg.norm_eps)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               rtol=2 ** -7, atol=0)

    pos = rng.integers(0, 100_000, (3, 5)).astype(np.int32)
    cos, sin = layers.rope_tables(torch.from_numpy(pos), cfg.hd, cfg.rope_theta)
    jcos, jsin = jlayers.rope_tables(jnp.asarray(pos), cfg.hd, cfg.rope_theta)
    # theta ** (-i / half) in f32 and angles up to 1e5 rad: within a few ulps
    # of the angle, which is 1e5 * 2**-24 ~ 6e-3 rad at the largest position
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-2)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-2)
    small = torch.arange(64, dtype=torch.int32)
    c2, s2 = layers.rope_tables(small, cfg.hd, cfg.rope_theta)
    jc2, js2 = jlayers.rope_tables(jnp.arange(64, dtype=jnp.int32), cfg.hd, cfg.rope_theta)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=0, atol=1e-5)
    h = rng.normal(0, 1, (3, 64, 4, cfg.hd)).astype(np.float32)
    got = layers.apply_rope(torch.from_numpy(h), c2[None, :, None, :], s2[None, :, None, :])
    want = jlayers.apply_rope(jnp.asarray(h), jc2[None, :, None, :], js2[None, :, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    tok = rng.integers(0, cfg.vocab_size, (3, 5))
    e = layers.embed(tp["embed"], torch.from_numpy(tok), cfg)
    np.testing.assert_array_equal(
        e.float().numpy(), np.asarray(jlayers.embed(jp["embed"], jnp.asarray(tok), cfg),
                                      np.float32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jxb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_allclose(
        layers.unembed(tp["embed"], xb, cfg).float().numpy(),
        np.asarray(jlayers.unembed(jp["embed"], jxb, cfg), np.float32), rtol=0, atol=2e-2)
    mlp_t = {k: v[0] for k, v in tp["segments"][0]["mlp"].items()}
    mlp_j = {k: v[0] for k, v in jp["segments"][0]["mlp"].items()}
    np.testing.assert_allclose(layers.apply_mlp(mlp_t, xb).float().numpy(),
                               np.asarray(jlayers.apply_mlp(mlp_j, jxb), np.float32),
                               rtol=0, atol=2e-2)


# ------------------------------ attention -------------------------------------
def _attn(arch, dtype=torch.float32):
    cfg, jp, _, tp = _both(arch, dtype=dtype)
    return (cfg, {k: v[0] for k, v in jp["segments"][0]["attn"].items()},
            {k: v[0] for k, v in tp["segments"][0]["attn"].items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_dense_matches_repro(arch):
    cfg, jp, tp = _attn(arch)
    rng = np.random.default_rng(1)
    b, s = 3, 8
    kv = rng.normal(0, 0.3, (2, b, s, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    jcache = {"k": jnp.asarray(kv[0], jnp.bfloat16), "v": jnp.asarray(kv[1], jnp.bfloat16)}
    tcache = attention.init_gqa_cache(cfg, b, s)
    tcache["k"][:b] = torch.from_numpy(kv[0])
    tcache["v"][:b] = torch.from_numpy(kv[1])
    for step, pos in enumerate(([0, 3, 7], [1, 4, 7])):
        x = rng.normal(0, 0.5, (b, 1, cfg.d_model)).astype(np.float32)
        got, tcache = attention.gqa_decode(tp, torch.from_numpy(x), tcache,
                                           torch.tensor(pos, dtype=torch.int32), cfg)
        want, jcache = jattn.gqa_decode(jp, jnp.asarray(x), jcache, jnp.asarray(pos), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key][:b].float().numpy(),
                                       np.asarray(jcache[key], np.float32),
                                       rtol=2 ** -7, atol=1e-6)


def test_gqa_decode_token_batch_slots_and_gated_rows():
    """Token-batched decode: rows map onto cache slots through ``slot``;
    gated-off padding rows that share (slot 0, position 0) with a live row
    land in the spare row, so the live write survives. A clamped padding
    write onto the live index would overwrite it."""
    cfg, jp, tp = _attn("mistral-nemo-12b")
    rng = np.random.default_rng(2)
    nslots, s = 2, 6
    x = rng.normal(0, 0.5, (6, 1, cfg.d_model)).astype(np.float32)
    slot = np.array([0, 0, 1, 0, 0, 0], np.int32)
    pos = np.array([0, 1, 2, 0, 0, 0], np.int32)
    ok = np.array([True, True, True, False, False, False])
    jcache = {k: jnp.zeros((nslots, s, cfg.n_kv_heads, cfg.hd), jnp.bfloat16)
              for k in ("k", "v")}
    tcache = attention.init_gqa_cache(cfg, nslots, s)
    got, tcache = attention.gqa_decode(tp, torch.from_numpy(x), tcache, torch.from_numpy(pos),
                                       cfg, slot=torch.from_numpy(slot),
                                       write_ok=torch.from_numpy(ok))
    want, jcache = jattn.gqa_decode(jp, jnp.asarray(x), jcache, jnp.asarray(pos), cfg,
                                    slot=jnp.asarray(slot), write_ok=jnp.asarray(ok))
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3], rtol=1e-5, atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:nslots].float().numpy(),
                                   np.asarray(jcache[key], np.float32), rtol=2 ** -7, atol=1e-6)
    # the live row 0 write of slot 0 is there, and the spare row took the rest
    assert tcache["k"][0, 0].abs().sum() > 0 and tcache["k"][nslots, 0].abs().sum() > 0
    assert not torch.equal(tcache["k"][0, 0], tcache["k"][nslots, 0])


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_paged_matches_repro(arch, impl):
    """Recycled (permuted, stale) blocks, a parked row gated off, and a
    position on the last mapped row."""
    cfg, jp, tp = _attn(arch)
    rng = np.random.default_rng(3)
    b, bs, nb_slot, num_blocks = 4, 4, 3, 16
    pools = rng.normal(0, 0.3, (2, num_blocks, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    table = rng.permutation(num_blocks)[: b * nb_slot].reshape(b, nb_slot).astype(np.int32)
    jcache = {"k": jnp.asarray(pools[0], jnp.bfloat16), "v": jnp.asarray(pools[1], jnp.bfloat16)}
    tcache = attention.init_gqa_cache_paged(cfg, num_blocks, bs)
    tcache["k"][:num_blocks] = torch.from_numpy(pools[0])
    tcache["v"][:num_blocks] = torch.from_numpy(pools[1])
    pos = np.array([0, 5, bs * nb_slot - 1, 30], np.int32)  # the last row parks past its table
    ok = np.array([True, True, True, False])
    x = rng.normal(0, 0.5, (b, 1, cfg.d_model)).astype(np.float32)
    got, tcache = attention.gqa_decode_paged(
        tp, torch.from_numpy(x), tcache, torch.from_numpy(pos), cfg,
        table=torch.from_numpy(table), block_size=bs, max_seq=bs * nb_slot,
        write_ok=torch.from_numpy(ok), impl=impl)
    want, jcache = jattn.gqa_decode_paged(
        jp, jnp.asarray(x), jcache, jnp.asarray(pos), cfg, table=jnp.asarray(table),
        block_size=bs, max_seq=bs * nb_slot, write_ok=jnp.asarray(ok), impl="gather")
    np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3], rtol=2e-5, atol=2e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:num_blocks].float().numpy(),
                                   np.asarray(jcache[key], np.float32), rtol=2 ** -7, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        attention.gqa_decode_paged(tp, torch.from_numpy(x), tcache, torch.from_numpy(pos),
                                   cfg, table=torch.from_numpy(table), block_size=bs,
                                   impl="pallas")


def test_sliding_window_ring_decode_matches_repro():
    """The SWA ring forms the reference keeps for its hybrid layers: a dense
    ring (``window=``) and a paged ring (``ring_width=``), cold and warm."""
    cfg, jp, tp = _attn("mistral-nemo-12b")
    rng = np.random.default_rng(5)
    b, w, bs = 3, 6, 2
    pos = np.array([2, 5, 13], np.int32)  # cold, the last cold row, warm
    x = rng.normal(0, 0.5, (b, 1, cfg.d_model)).astype(np.float32)
    ring = rng.normal(0, 0.3, (2, b, w, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    tcache = attention.init_gqa_cache(cfg, b, 64, window=w)
    tcache["k"][:b], tcache["v"][:b] = torch.from_numpy(ring[0]), torch.from_numpy(ring[1])
    jcache = {"k": jnp.asarray(ring[0], jnp.bfloat16), "v": jnp.asarray(ring[1], jnp.bfloat16)}
    got, _ = attention.gqa_decode(tp, torch.from_numpy(x), tcache, torch.from_numpy(pos), cfg,
                                  window=w)
    want, _ = jattn.gqa_decode(jp, jnp.asarray(x), jcache, jnp.asarray(pos), cfg, window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    nb_slot, num_blocks = w // bs, 12
    pools = rng.normal(0, 0.3, (2, num_blocks, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    table = rng.permutation(num_blocks)[: b * nb_slot].reshape(b, nb_slot).astype(np.int32)
    tpool = attention.init_gqa_cache_paged(cfg, num_blocks, bs)
    tpool["k"][:num_blocks], tpool["v"][:num_blocks] = (torch.from_numpy(a) for a in pools)
    jpool = {"k": jnp.asarray(pools[0], jnp.bfloat16), "v": jnp.asarray(pools[1], jnp.bfloat16)}
    ok = np.ones(b, bool)
    want, _ = jattn.gqa_decode_paged(jp, jnp.asarray(x), jpool, jnp.asarray(pos), cfg,
                                     table=jnp.asarray(table), block_size=bs, ring_width=w,
                                     max_seq=w, write_ok=jnp.asarray(ok))
    for impl in ("gather", "kernel"):
        pool = {k: v.clone() for k, v in tpool.items()}
        got, _ = attention.gqa_decode_paged(tp, torch.from_numpy(x), pool, torch.from_numpy(pos),
                                            cfg, table=torch.from_numpy(table), block_size=bs,
                                            ring_width=w, max_seq=w,
                                            write_ok=torch.from_numpy(ok), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ------------------------------ whole stack -----------------------------------
def _decode_steps(arch, paged, f32, monkeypatch, steps=5):
    """Logits of ``steps`` decode steps of 3 slots at staggered positions in
    both packages, fed the same tokens."""
    dtype = torch.float32 if f32 else torch.bfloat16
    cfg, jp, _, tp = _both(arch, dtype=dtype)
    jcfg = jreduced(arch)
    if f32:
        monkeypatch.setattr(jtransformer, "embed",
                            lambda p, t, cfg: jnp.take(p["table"], t, axis=0))
        monkeypatch.setattr(transformer, "embed", lambda p, t, cfg: p["table"][t])
    b, s, bs = 3, 12, 4
    rng = np.random.default_rng(4)
    jdec, tdec = jzoo.decode_fn(jcfg), model_zoo.decode_fn(cfg)
    if paged:
        nb = b * s // bs
        table = np.arange(nb, dtype=np.int32)[::-1].reshape(b, s // bs).copy()
        jc = jzoo.make_paged_cache(jcfg, b, nb, bs)
        tc = model_zoo.make_paged_cache(cfg, nb, bs, CPU)
    else:
        jc = jzoo.make_cache(jcfg, b, s)
        tc = model_zoo.make_cache(cfg, b, s, CPU)
    out = []
    start = np.array([0, 2, 5], np.int32)
    for step in range(steps):
        tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        pos = start + step
        kw_j, kw_t = {}, {}
        if paged:
            ok = np.ones(b, bool)
            kw_j["paged"] = dict(table=jnp.asarray(table), ring_table=None, write_ok=jnp.asarray(ok),
                                 block_size=bs, ring_width=0, max_seq=s, impl="gather")
            kw_t["paged"] = dict(table=torch.from_numpy(table), write_ok=torch.from_numpy(ok),
                                 block_size=bs, max_seq=s, impl="kernel")
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(pos), **kw_j)
        tl, tc = tdec(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), **kw_t)
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
    return out


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_steps_match_repro(arch, paged, f32, monkeypatch):
    for want, got in _decode_steps(arch, paged, f32, monkeypatch):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **(F32_LOGITS if f32 else BF16_LOGITS))
