"""The port's training-form attention (``repro_torch.models.attention``:
``_mask``, ``_sdpa``, ``_sdpa_qchunk``, ``gqa_train``, ``mla_train``) and
the attention families' loss (``transformer.lm_loss``) against ``repro`` on
the CPU, with the same weights carried over by ``params_from_numpy`` and the
same numpy inputs; a port of ``tests/test_attention_variants.py``.

Tolerances. The attention functions run in f32 in both packages and differ
by summation order: values at 2e-5, gradients at 1e-4 (the reference
test's). The whole model's loss: ``F32_*`` with the embedding's and the
unembedding's bf16 casts taken out of both packages (as
``test_torch_rwkv.py`` does), ``BF16_*`` as configured, where bf16 rounds
each activation at other places in XLA's and torch's kernels."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention, model_zoo, transformer
from repro_torch.models.params import leaves, params_from_numpy
from test_torch_serve_util import one_cpu_thread  # noqa: F401

CPU = "cpu"
ATTN = dict(rtol=2e-5, atol=2e-5)
ATTN_GRAD = dict(rtol=1e-4, atol=1e-4)
F32_LOSS = dict(rtol=2e-6, atol=2e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS = 2e-2
BF16_GRAD_REL = 5e-2
# every family whose training forward the port runs besides RWKV
TRAINED = ["minicpm3-4b", "internlm2-20b", "mistral-nemo-12b", "deepseek-67b",
           "internvl2-26b"]
KINDS = [("causal", 0), ("swa", 8), ("bidir", 0)]


def _qkv(rng, shape_q, shape_kv, dv=None):
    q = rng.normal(0, 1, shape_q).astype(np.float32)
    k = rng.normal(0, 1, shape_kv).astype(np.float32)
    v = rng.normal(0, 1, shape_kv[:-1] + (dv or shape_kv[-1],)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------ the mask and the tiles ------------------------
@pytest.mark.parametrize("kind,window", KINDS)
def test_mask_matches_repro(kind, window):
    for sq, skv, offset in ((5, 5, 0), (4, 12, 8), (3, 9, 2)):
        np.testing.assert_array_equal(
            attention._mask(sq, skv, kind, window, offset=offset).numpy(),
            np.asarray(jattn._mask(sq, skv, kind, window, offset=offset)))


@pytest.mark.parametrize("kind,window", KINDS)
@pytest.mark.parametrize("q_chunk", [4, 16, 64])
def test_qchunk_matches_naive(kind, window, q_chunk):
    """The query-chunked form against the naive one (one mask, broadcast),
    and both against the reference's query-chunked form."""
    rng = np.random.default_rng(0)
    b, s, kvh, g, d = 2, 48, 2, 3, 16
    q, k, v = _qkv(rng, (b, s, kvh, g, d), (b, s, kvh, d))
    tq, tk, tv = _t(q, k, v)
    want = attention._sdpa(tq, tk, tv, attention._mask(s, s, kind, window), 0.25)
    got = attention._sdpa_qchunk(tq, tk, tv, kind, window, 0.25, q_chunk)
    torch.testing.assert_close(got, want, **ATTN)
    ref = jattn._sdpa_qchunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kind, window,
                             0.25, q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN)


def test_qchunk_with_other_value_width_and_ragged_tail():
    """MLA's value width differs from the key's; 13 queries in tiles of 4
    leave a padded last tile."""
    rng = np.random.default_rng(2)
    b, s, h, dk, dv = 2, 13, 3, 12, 8
    q, k, v = _qkv(rng, (b, s, h, 1, dk), (b, s, h, dk), dv)
    got = attention._sdpa_qchunk(*_t(q, k, v), "causal", 0, 0.3, 4)
    assert got.shape == (b, s, h, 1, dv)
    want = jattn._sdpa_qchunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), "causal", 0,
                              0.3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


def test_qchunk_bf16_operands_match_repro():
    """``qk_bf16``: the operands of both products rounded to bf16, the sums in
    f32, as the reference's bf16 einsums with f32 results; farther from the
    f32 form than the f32 forms are from each other."""
    rng = np.random.default_rng(3)
    b, s, kvh, g, d = 2, 32, 2, 2, 16
    q, k, v = _qkv(rng, (b, s, kvh, g, d), (b, s, kvh, d))
    got = attention._sdpa_qchunk(*_t(q, k, v), "causal", 0, 0.25, 8, qk_bf16=True)
    want = jattn._sdpa_qchunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), "causal", 0,
                              0.25, 8, qk_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
    f32 = attention._sdpa_qchunk(*_t(q, k, v), "causal", 0, 0.25, 8)
    assert float((got - f32).abs().max()) > 1e-3


def test_qchunk_grads_match():
    rng = np.random.default_rng(1)
    b, s, kvh, g, d = 1, 32, 2, 2, 8
    q, k, v = _qkv(rng, (b, s, kvh, g, d), (b, s, kvh, d))

    def grads(fn):
        ts = [t.requires_grad_(True) for t in _t(q, k, v)]
        return torch.autograd.grad(fn(*ts).square().sum(), ts)

    naive = grads(lambda q, k, v: attention._sdpa(q, k, v, attention._mask(s, s, "causal", 0),
                                                  0.3))
    chunk = grads(lambda q, k, v: attention._sdpa_qchunk(q, k, v, "causal", 0, 0.3, 8))
    ref = jax.grad(lambda q, k, v: jnp.sum(jnp.square(
        jattn._sdpa_qchunk(q, k, v, "causal", 0, 0.3, 8))), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, c, r in zip(naive, chunk, ref):
        torch.testing.assert_close(c, a, **ATTN_GRAD)
        np.testing.assert_allclose(c.numpy(), np.asarray(r), **ATTN_GRAD)


# ------------------------------ the layers ------------------------------------
def _layer(arch, seed=3, **overrides):
    """A reduced config in both packages, the reference's first attention
    layer and the port's copy of it in f32."""
    cfg = dataclasses.replace(get_reduced_config(arch), **overrides)
    jcfg = dataclasses.replace(jreduced(arch), **overrides)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=torch.float32)
    return (cfg, jcfg, jax.tree.map(lambda a: a[0], jp["segments"][0]["attn"]),
            _first(tp["segments"][0]["attn"]))


def _first(tree):
    return {k: _first(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _train_matches(arch, fn, jfn, kind="causal", window=0, **overrides):
    """``fn`` against ``jfn`` on one numpy input at positions 0..S-1: the
    output, and the gradients of its product with a fixed random cotangent
    with respect to the input and to every weight."""
    cfg, jcfg, jp, tp = _layer(arch, **overrides)
    rng = np.random.default_rng(4)
    b, s = 2, 12
    x = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ct = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out = jfn(p, x, jcfg, jnp.asarray(pos), kind=kind, window=window)
        return jnp.sum(out * ct), out

    (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    named = list(_flat(tp))
    for _, t in named:
        t.requires_grad_(True)
    got = fn(tp, tx, cfg, torch.from_numpy(pos.copy()), kind=kind, window=window)
    grads = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                                [tx] + [t for _, t in named])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATTN)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **ATTN_GRAD)
    jflat = dict(_flat(jgp))
    assert set(jflat) == {path for path, _ in named}
    for (path, _), g in zip(named, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]), **ATTN_GRAD,
                                   err_msg=str(path))
    return cfg


@pytest.mark.parametrize("kind,window", KINDS)
@pytest.mark.parametrize("arch", ["internlm2-20b", "mistral-nemo-12b"])
def test_gqa_train_matches_repro(arch, kind, window):
    _train_matches(arch, attention.gqa_train, jattn.gqa_train, kind, window)


@pytest.mark.parametrize("q_chunk", [0, 5])
@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
def test_mla_train_matches_repro(q_lora, q_chunk):
    """Both query forms (minicpm3's low-rank wq_a/q_norm/wq_b and the full
    wq), naive and query-chunked. The rope part is 8 wide of 24: a rotation
    applied to the wrong slice, or a key rope head not shared, moves the
    output far beyond the tolerance."""
    over = dict(attn_q_chunk=q_chunk)
    if not q_lora:
        over["q_lora_rank"] = 0
    cfg = _train_matches("minicpm3-4b", attention.mla_train, jattn.mla_train, **over)
    assert cfg.qk_rope_head_dim < cfg.qk_nope_head_dim + cfg.qk_rope_head_dim


def test_mla_params_have_repro_names_shapes_and_types():
    cfg = get_reduced_config("minicpm3-4b")
    jp, jspecs = jzoo.init_params(jreduced("minicpm3-4b"), jax.random.PRNGKey(0))
    own, specs = model_zoo.init_params(cfg, device=CPU)
    mine, ref = own["segments"][0]["attn"], jp["segments"][0]["attn"]
    assert sorted(mine) == sorted(ref)
    assert specs["segments"][0]["attn"] == jspecs["segments"][0]["attn"]
    for name in ref:
        if name.endswith("_norm"):
            assert mine[name]["scale"].dtype == torch.float32
            assert tuple(mine[name]["scale"].shape) == np.shape(ref[name]["scale"])
        else:
            assert mine[name].dtype == torch.bfloat16
            assert tuple(mine[name].shape) == np.shape(ref[name])


# ------------------------------ the model's loss ------------------------------
def _uncast(monkeypatch):
    """f32 embedding and unembedding in both packages (tied or not)."""
    def jun(p, x, cfg):
        return x @ (p["table"].T if cfg.tie_embeddings else p["unembed"])

    def tun(p, x, cfg):
        return x @ (p["table"].T if cfg.tie_embeddings else p["unembed"])

    for mod in (jtransformer, jzoo):
        monkeypatch.setattr(mod, "embed", lambda p, t, cfg: jnp.take(p["table"], t, axis=0))
        monkeypatch.setattr(mod, "unembed", jun)
    monkeypatch.setattr(transformer, "embed", lambda p, t, cfg: p["table"][t])
    monkeypatch.setattr(transformer, "unembed", tun)
    monkeypatch.setattr(model_zoo, "unembed", tun)


def _both(arch, seed=3, batch=2, seq=16, **overrides):
    cfg = dataclasses.replace(get_reduced_config(arch), **overrides)
    jcfg = dataclasses.replace(jreduced(arch), **overrides)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=torch.float32)
    jb = jzoo.demo_batch(jcfg, batch, seq, np.random.default_rng(seed))
    tb = model_zoo.demo_batch(cfg, batch, seq, np.random.default_rng(seed), device=CPU)
    return cfg, jcfg, jp, tp, jb, tb


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _port_grads(cfg, tp, tb, remat="none"):
    for p in leaves(tp):
        p.requires_grad_(True)
    loss = model_zoo.loss_fn(cfg, remat)(tp, tb)
    paths = [path for path, _ in _flat(tp)]
    return float(loss.detach()), dict(zip(paths, torch.autograd.grad(loss, list(leaves(tp)))))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", TRAINED)
def test_lm_loss_and_gradients_match_repro(arch, precision, monkeypatch):
    if precision == "f32":
        _uncast(monkeypatch)
    cfg, jcfg, jp, tp, jb, tb = _both(arch)
    assert set(tb) == set(jb)
    jloss, jgrads = jax.value_and_grad(jzoo.loss_fn(jcfg, remat="none"))(jp, jb)
    loss, grads = _port_grads(cfg, tp, tb)
    jflat = dict(_flat(jgrads))
    assert set(jflat) == set(grads)
    if precision == "f32":
        np.testing.assert_allclose(loss, float(jloss), **F32_LOSS)
        for path, g in grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]), **F32_GRAD,
                                       err_msg=str(path))
    else:
        assert abs(loss - float(jloss)) < BF16_LOSS
        for path, g in grads.items():
            want = np.asarray(jflat[path], np.float32)
            err = np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want), 1e-12)
            assert err < BF16_GRAD_REL, (path, err)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "internlm2-20b"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    cfg, _, _, tp, _, tb = _both(arch)
    loss, grads = _port_grads(cfg, tp, tb, "none")
    for remat in ("full", "dots"):
        loss_r, grads_r = _port_grads(cfg, tp, tb, remat)
        assert loss_r == loss
        for path, g in grads.items():
            assert torch.equal(grads_r[path], g), (remat, path)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "internlm2-20b", "hymba-1.5b"])
def test_model_loss_invariant_to_attn_chunking(arch):
    cfg = get_reduced_config(arch)
    params, _ = model_zoo.init_params(cfg, seed=0, device=CPU,
                                      dtype=getattr(torch, cfg.param_dtype))
    batch = model_zoo.demo_batch(cfg, 2, 32, device=CPU)
    with torch.no_grad():
        l1 = float(model_zoo.loss_fn(cfg, remat="none")(params, batch))
        l2 = float(model_zoo.loss_fn(dataclasses.replace(cfg, attn_q_chunk=8),
                                     remat="none")(params, batch))
    assert abs(l1 - l2) < 5e-3, (arch, l1, l2)


def test_model_loss_invariant_to_loss_chunking():
    cfg = get_reduced_config("internlm2-20b")
    cfg_c = dataclasses.replace(cfg, loss_chunk=8)
    params, _ = model_zoo.init_params(cfg, seed=0, device=CPU, dtype=torch.float32)
    batch = model_zoo.demo_batch(cfg, 2, 32, device=CPU)
    l1, g1 = _port_grads(cfg, params, batch)
    l2, g2 = _port_grads(cfg_c, params, batch)
    assert abs(l1 - l2) < 5e-3
    n1 = float(torch.sqrt(sum(g.float().square().sum() for g in g1.values())))
    n2 = float(torch.sqrt(sum(g.float().square().sum() for g in g2.values())))
    assert abs(n1 - n2) / max(n1, 1e-9) < 2e-2
