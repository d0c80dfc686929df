"""The port's encoder-decoder family (``repro_torch.models.encdec`` and the
cross attention of ``models.attention``) against ``repro`` on reduced
seamless-m4t-medium: the same weights carried over by ``params_from_numpy``,
the same numpy inputs from a seed.

Tolerances. The cross attention in f32 runs the same function in both
packages up to summation order: ``ATTN``/``ATTN_GRAD``, the port's attention
tests' (``test_torch_attention.py``). Everything else runs bf16 activations
in both packages whatever the weights' type (the encoder casts the frames to
bf16, the embedding returns bf16), and XLA and torch round them at other
places: the loss within ``BF16_LOSS`` and each gradient within
``BF16_GRAD_REL`` of its norm (``test_torch_attention.py``'s), activations
and caches within ``BF16_REL`` of their norm (a few bf16 steps, 2^-8 each),
logits at ``BF16_LOGITS`` (``test_torch_prefill_parity.py``'s)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention, encdec, model_zoo
from repro_torch.models.params import leaves, params_from_numpy
from test_torch_attention import ATTN, ATTN_GRAD, BF16_GRAD_REL, BF16_LOSS, _first, _flat
from test_torch_prefill_parity import BF16_LOGITS
from test_torch_serve_util import CPU, one_cpu_thread  # noqa: F401

ARCH = "seamless-m4t-medium"
BF16_REL = 1e-2
B, S, SRC = 2, 12, 10


def _setup(seed=3, dtype=torch.bfloat16, **overrides):
    cfg = dataclasses.replace(get_reduced_config(ARCH), **overrides)
    jcfg = dataclasses.replace(jreduced(ARCH), **overrides)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=dtype)
    return cfg, jcfg, jp, tp


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _np(t):
    return t.detach().float().numpy()


# ------------------------------ cross attention -------------------------------
def test_cross_train_matches_repro():
    """f32: the output, and the gradients of its product with a random
    cotangent with respect to x, the encoder's output and every weight."""
    cfg, jcfg, jp, tp = _setup(dtype=torch.float32)
    jl = jax.tree.map(lambda a: a[0], jp["dec"]["cross"])
    tl = _first(tp["dec"]["cross"])
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (B, SRC, cfg.d_model)).astype(np.float32)
    ct = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)

    def jloss(p, x, e):
        out = jattn.cross_train(p, x, e, jcfg)
        return jnp.sum(out * ct), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jl, jnp.asarray(x), jnp.asarray(enc))
    tx, te = (torch.from_numpy(a).requires_grad_(True) for a in (x, enc))
    named = list(_flat(tl))
    for _, t in named:
        t.requires_grad_(True)
    got = attention.cross_train(tl, tx, te, cfg)
    grads = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                                [tx, te] + [t for _, t in named])
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATTN)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg[1]), **ATTN_GRAD)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jg[2]), **ATTN_GRAD)
    jflat = dict(_flat(jg[0]))
    assert set(jflat) == {path for path, _ in named}
    for (path, _), g in zip(named, grads[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]), **ATTN_GRAD,
                                   err_msg=str(path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_decode_matches_repro(dtype):
    """One query row a batch row over bf16 cross K/V (the cache's type)."""
    cfg, jcfg, jp, tp = _setup(dtype=dtype)
    jl = jax.tree.map(lambda a: a[0], jp["dec"]["cross"])
    tl = _first(tp["dec"]["cross"])
    rng = np.random.default_rng(5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = jnp.asarray(rng.normal(0, 1, (B, 1, cfg.d_model)), jdt)
    kv = [jnp.asarray(rng.normal(0, 1, (B, SRC, cfg.n_kv_heads, cfg.hd)), jnp.bfloat16)
          for _ in range(2)]
    want = jattn.cross_decode(jl, x, {"k": kv[0], "v": kv[1]}, jcfg)

    def port(a):
        return torch.from_numpy(np.array(a, np.float32))

    got = attention.cross_decode(tl, port(x).to(dtype),
                                 {"k": port(kv[0]).to(torch.bfloat16),
                                  "v": port(kv[1]).to(torch.bfloat16)}, cfg)
    assert got.dtype == dtype and got.shape == (B, 1, cfg.d_model)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), np.asarray(want), **ATTN)
    else:
        assert _rel(_np(got), want) < BF16_REL


# ------------------------------ encoder, loss ---------------------------------
def test_encode_matches_repro():
    cfg, jcfg, jp, tp = _setup()
    frames = np.random.default_rng(6).normal(0, 1, (B, SRC, cfg.d_model)).astype(np.float32)
    want = jencdec.encode(jp, jnp.asarray(frames), jcfg, remat="none")
    got = encdec.encode(tp, torch.from_numpy(frames), cfg, remat="none")
    assert got.dtype == torch.bfloat16 and got.shape == (B, SRC, cfg.d_model)
    assert _rel(_np(got), want) < BF16_REL


def _grads(cfg, tp, tb, remat="none"):
    for p in leaves(tp):
        p.requires_grad_(True)
    loss = model_zoo.loss_fn(cfg, remat)(tp, tb)
    paths = [path for path, _ in _flat(tp)]
    return float(loss.detach()), dict(zip(paths, torch.autograd.grad(loss, list(leaves(tp)))))


def test_encdec_loss_and_gradients_match_repro():
    """f32 masters, as training keeps them: the loss and every gradient
    against ``jax.grad`` of the reference's loss."""
    cfg, jcfg, jp, tp = _setup(dtype=torch.float32)
    jb = jzoo.demo_batch(jcfg, B, S, np.random.default_rng(3))
    tb = model_zoo.demo_batch(cfg, B, S, np.random.default_rng(3), device=CPU)
    assert set(tb) == set(jb) == {"tokens", "targets", "loss_mask", "frames"}
    jloss, jgrads = jax.value_and_grad(jzoo.loss_fn(jcfg, remat="none"))(jp, jb)
    loss, grads = _grads(cfg, tp, tb)
    assert abs(loss - float(jloss)) < BF16_LOSS
    jflat = dict(_flat(jgrads))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), jflat[path]) < BF16_GRAD_REL, path


def test_remat_modes_give_the_same_loss_and_gradients():
    cfg, _, _, tp = _setup(dtype=torch.float32)
    tb = model_zoo.demo_batch(cfg, B, S, np.random.default_rng(1), device=CPU)
    loss, grads = _grads(cfg, tp, tb, "none")
    for remat in ("full", "dots"):
        loss_r, grads_r = _grads(cfg, tp, tb, remat)
        assert loss_r == loss
        for path, g in grads.items():
            assert torch.equal(grads_r[path], g), (remat, path)


def test_params_have_repro_names_shapes_and_types():
    cfg = get_reduced_config(ARCH)
    jp, jspecs = jzoo.init_params(jreduced(ARCH), jax.random.PRNGKey(0))
    tp, specs = model_zoo.init_params(cfg, device=CPU)
    assert specs == jax.tree.map(tuple, jspecs, is_leaf=lambda s: isinstance(s, tuple))
    jflat, tflat = dict(_flat(jp)), dict(_flat(tp))
    assert set(jflat) == set(tflat) and "frame_proj" in tp and "cross" in tp["dec"]
    for path, t in tflat.items():
        assert tuple(t.shape) == np.shape(jflat[path]), path
        assert t.dtype == (torch.float32 if path[-1] == "scale" else torch.bfloat16), path


def test_params_from_numpy_refuses_a_tree_of_another_family():
    cfg = get_reduced_config(ARCH)
    jp, _ = jzoo.init_params(jreduced(ARCH), jax.random.PRNGKey(0))
    lm, _ = jzoo.init_params(jreduced("internlm2-20b"), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=cfg.name):
        params_from_numpy(cfg, jax.tree.map(np.asarray, lm), device=CPU)
    with pytest.raises(ValueError, match="internlm2-20b"):
        params_from_numpy(get_reduced_config("internlm2-20b"), jax.tree.map(np.asarray, jp),
                          device=CPU)
    deeper = dataclasses.replace(cfg, enc_layers=cfg.enc_layers + 1)
    with pytest.raises(ValueError, match=cfg.name):
        params_from_numpy(deeper, jax.tree.map(np.asarray, jp), device=CPU)


# ------------------------------ prefill ---------------------------------------
def test_prefill_fn_matches_repro():
    cfg, jcfg, jp, tp = _setup()
    jb = jzoo.demo_batch(jcfg, B, S, np.random.default_rng(8))
    tb = model_zoo.demo_batch(cfg, B, S, np.random.default_rng(8), device=CPU)
    want = jzoo.prefill_fn(jcfg)(jp, jb)
    with torch.no_grad():
        got = model_zoo.prefill_fn(cfg)(tp, tb)
    assert got.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **BF16_LOGITS)
