"""The port's RWKV6 training stack against ``repro``'s on reduced rwkv6-3b
with the same weights (``params_from_numpy``) and the same batches: the loss
and every gradient, the rematerialisation modes, prefill, prefill against
the port's own decode, and one AdamW train step parameter by parameter.

Tolerances. ``F32``: the reference casts the embedding and the unembedding
to bf16 whatever the configuration says, so the f32 comparisons replace
``embed``/``unembed`` in both packages by their uncast forms (as
``test_torch_models.py`` does); what remains differs by summation order only.
``BF16``: the model as configured, bf16 activations; the loss agrees within
2e-2 and each gradient within 5% of its norm (bf16 rounds each activation
to 8 bits, at other places in XLA's and torch's kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro.train import optimizer as jopt
from repro_torch.configs import get_reduced_config
from repro_torch.models import model_zoo, transformer
from repro_torch.models.params import leaves, params_from_numpy
from repro_torch.train import optimizer as topt
from test_torch_serve_util import one_cpu_thread  # noqa: F401

ARCH = "rwkv6-3b"
CPU = "cpu"
F32_LOSS = dict(rtol=2e-6, atol=2e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS = 2e-2
BF16_GRAD_REL = 5e-2


def _uncast(monkeypatch):
    """f32 embedding and unembedding in both packages."""
    monkeypatch.setattr(jtransformer, "embed", lambda p, t, cfg: jnp.take(p["table"], t, axis=0))
    monkeypatch.setattr(jtransformer, "unembed", lambda p, x, cfg: x @ p["unembed"])
    monkeypatch.setattr(jzoo, "embed", lambda p, t, cfg: jnp.take(p["table"], t, axis=0))
    monkeypatch.setattr(jzoo, "unembed", lambda p, x, cfg: x @ p["unembed"])
    monkeypatch.setattr(transformer, "embed", lambda p, t, cfg: p["table"][t])
    monkeypatch.setattr(transformer, "unembed", lambda p, x, cfg: x @ p["unembed"])
    monkeypatch.setattr(model_zoo, "unembed", lambda p, x, cfg: x @ p["unembed"])


def _setup(seed=3, batch=2, seq=16):
    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    mask = (rng.uniform(size=(batch, seq)) < 0.9).astype(np.float32)
    nb = {"tokens": tok[:, :-1].astype(np.int32), "targets": tok[:, 1:].astype(np.int32),
          "loss_mask": mask}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    return cfg, jcfg, jp, tp, jb, tb


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _port_grads(cfg, tp, tb, remat="none"):
    for p in leaves(tp):
        p.requires_grad_(True)
    loss = model_zoo.loss_fn(cfg, remat)(tp, tb)
    grads = torch.autograd.grad(loss, list(leaves(tp)))
    it = iter(grads)
    return float(loss.detach()), {path: next(it) for path, _ in _flat_in_leaf_order(tp)}


def _flat_in_leaf_order(tree, prefix=()):
    """(path, leaf) in ``params.leaves`` order (dict insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_in_leaf_order(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_in_leaf_order(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lm_loss_and_gradients_match_repro(precision, monkeypatch):
    if precision == "f32":
        _uncast(monkeypatch)
    cfg, jcfg, jp, tp, jb, tb = _setup()
    jloss, jgrads = jax.value_and_grad(jtransformer.lm_loss)(jp, jb, jcfg, remat="none")
    loss, grads = _port_grads(cfg, tp, tb)
    jflat = dict(_flat(jgrads))
    assert set(jflat) == set(grads) and len(grads) == 23
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


def test_remat_modes_give_the_same_loss_and_gradients():
    cfg, _, _, tp, _, tb = _setup()
    loss, grads = _port_grads(cfg, tp, tb, "none")
    for remat in ("full", "dots"):
        loss_r, grads_r = _port_grads(cfg, tp, tb, remat)
        assert loss_r == loss
        for path, g in grads.items():
            assert torch.equal(grads_r[path], g), (remat, path)


def test_remat_dots_keeps_the_matmul_outputs_only():
    """The selective policy saves matrix products and recomputes the rest."""
    assert transformer._save_dots(None, torch.ops.aten.mm.default).name == "MUST_SAVE"
    assert transformer._save_dots(None, torch.ops.aten.tanh.default).name == "PREFER_RECOMPUTE"
    cfg, _, _, tp, _, tb = _setup()
    with pytest.raises(ValueError, match="remat"):
        model_zoo.loss_fn(cfg, "some")(tp, tb)


# bf16 logits: the time mix is a long chain of bf16 elementwise operations,
# which the two frameworks round at different places; the f32 comparison
# shows the computation itself agrees to 1e-5
BF16_LOGITS = dict(rtol=0, atol=1e-1)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_prefill_matches_repro(precision, monkeypatch):
    if precision == "f32":
        _uncast(monkeypatch)
    cfg, jcfg, jp, tp, jb, tb = _setup(seq=24)
    want = np.asarray(jzoo.prefill_fn(jcfg)(jp, jb), np.float32)
    with torch.no_grad():
        got = model_zoo.prefill_fn(cfg)(tp, tb).float().numpy()
    assert got.shape == want.shape == (2, cfg.padded_vocab)
    tol = dict(rtol=1e-5, atol=1e-5) if precision == "f32" else BF16_LOGITS
    np.testing.assert_allclose(got, want, **tol)


def test_prefill_equals_decode():
    """tests/test_prefill_decode_parity.py on the port alone: the chunked
    prefill (the WKV chunk path) against token-by-token decode (the
    sequential recurrence and the caches), at its tolerance."""
    cfg, _, _, tp, _, _ = _setup()
    seq = 24
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, seq)).astype(np.int32))
    with torch.no_grad():
        want = model_zoo.prefill_fn(cfg)(tp, {"tokens": tokens}).float().numpy()
        step = model_zoo.decode_fn(cfg)
        cache = model_zoo.make_cache(cfg, 2, seq + 1, CPU)
        for t in range(seq):
            logits, cache = step(tp, tokens[:, t], cache, t)
    got = logits.float().numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    assert np.all(got.argmax(-1) == want.argmax(-1))
    assert cache[0]["wkv"].dtype == torch.float32 and cache[0]["shift_t"].dtype == torch.bfloat16


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_decode_matches_repro(precision, monkeypatch):
    if precision == "f32":
        _uncast(monkeypatch)
    cfg, jcfg, jp, tp, _, _ = _setup()
    rng = np.random.default_rng(5)
    jc = jzoo.make_cache(jcfg, 2, 8)
    tc = model_zoo.make_cache(cfg, 2, 8, CPU)
    jdec, tdec = jzoo.decode_fn(jcfg), model_zoo.decode_fn(cfg)
    for pos in range(4):
        tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(pos))
        with torch.no_grad():
            tl, tc = tdec(tp, torch.from_numpy(tok), tc, pos)
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                   **(dict(rtol=1e-5, atol=1e-5) if precision == "f32"
                                      else BF16_LOGITS))
    for key in ("wkv", "shift_t", "shift_c"):  # the shifts are bf16 in both caches
        np.testing.assert_allclose(tc[0][key].float().numpy(),
                                   np.asarray(jc[0][key], np.float32),
                                   **(dict(rtol=1e-5, atol=1e-5) if precision == "f32"
                                      else dict(BF16_LOGITS, rtol=2e-2)))


def test_train_step_matches_repro(monkeypatch):
    _uncast(monkeypatch)
    cfg, jcfg, jp, tp, jb, tb = _setup()
    ocfg = jopt.OptConfig(lr=1e-3, warmup_steps=2)
    jstep = jopt.make_train_step(lambda p, b: jtransformer.lm_loss(p, b, jcfg, remat="none"),
                                 ocfg)
    jnew, jstate, jm = jstep(jp, jopt.adamw_init(jp, ocfg), jb)
    tcfg = topt.OptConfig(lr=1e-3, warmup_steps=2)
    tstep = topt.make_train_step(model_zoo.loss_fn(cfg, "none"), tcfg)
    tnew, tstate, tm = tstep(tp, topt.adamw_init(tp, tcfg), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32_LOSS)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]))
    assert int(tstate["step"]) == int(jstate["step"]) == 1
    jflat = dict(_flat(jnew))
    for path, p in _flat(tnew):
        # the first step moves each weight by lr * g/(|g| + eps), about lr
        # (5e-4 after warmup's half): compare within a tenth of that; a
        # gradient near its rounding noise moves its weight by a different
        # fraction of lr in the two packages
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jflat[path]), rtol=0,
                                   atol=5e-5, err_msg=str(path))
    for key in ("mu", "nu"):
        jm_flat = dict(_flat(jstate[key]))
        for path, m in _flat(tstate[key]):
            want = np.asarray(jm_flat[path])
            np.testing.assert_allclose(m.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(), err_msg=str((key, path)))


def test_attention_families_do_not_train_yet():
    """The attention families train: the GQA and MLA ones with dense layers
    (``test_torch_attention.py`` holds them against ``repro``), the MoE ones
    (``test_torch_moe.py``) and, since the enc-dec slice, encoder-decoder
    models (``test_torch_encdec.py``)."""
    for arch in ("mistral-nemo-12b", "olmoe-1b-7b", "seamless-m4t-medium"):
        cfg = get_reduced_config(arch)
        params, _ = model_zoo.init_params(cfg, device=CPU)
        batch = model_zoo.demo_batch(cfg, 1, 8, device=CPU)
        assert torch.isfinite(model_zoo.loss_fn(cfg, "none")(params, batch))


def test_demo_batch_matches_repro():
    """rwkv6-3b's tokens, and seamless-m4t-medium's frames after them."""
    for arch in (ARCH, "seamless-m4t-medium"):
        cfg, jcfg = get_reduced_config(arch), jreduced(arch)
        want = jzoo.demo_batch(jcfg, 3, 10, np.random.default_rng(4))
        got = model_zoo.demo_batch(cfg, 3, 10, np.random.default_rng(4), device=CPU)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == getattr(torch, str(want[k].dtype))
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("seq,chunk", [(16, 0), (13, 4)])
def test_xent_losses_match_repro(seq, chunk):
    """softmax_xent (padded vocab entries masked) and chunked_xent (sequence
    chunks under checkpoint, the last chunk padded) against the reference's,
    value and gradient, on the same inputs."""
    from repro.models import layers as jlayers

    from repro_torch.models import layers

    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    rng = np.random.default_rng(seq)
    b, v, d = 2, cfg.padded_vocab, cfg.d_model
    targets = rng.integers(0, cfg.vocab_size, (b, seq)).astype(np.int32)
    mask = (rng.uniform(size=(b, seq)) < 0.8).astype(np.float32)
    if chunk == 0:
        x = rng.normal(0, 3, (b, seq, v)).astype(np.float32)

        def jfn(xx):
            return jlayers.softmax_xent(xx, jnp.asarray(targets), jnp.asarray(mask),
                                        cfg.vocab_size)

        def tfn(xx):
            return layers.softmax_xent(xx, torch.from_numpy(targets),
                                       torch.from_numpy(mask), cfg.vocab_size)
    else:
        x = rng.normal(0, 1, (b, seq, d)).astype(np.float32)
        emb = {"table": rng.normal(0, 0.02, (v, d)).astype(np.float32),
               "unembed": rng.normal(0, 0.1, (d, v)).astype(np.float32)}

        def jfn(xx):
            return jlayers.chunked_xent({k: jnp.asarray(a) for k, a in emb.items()}, xx,
                                        jnp.asarray(targets), jnp.asarray(mask), jcfg, chunk)

        def tfn(xx):
            return layers.chunked_xent({k: torch.from_numpy(a) for k, a in emb.items()}, xx,
                                       torch.from_numpy(targets), torch.from_numpy(mask),
                                       cfg, chunk)
    jloss, jgrad = jax.value_and_grad(jfn)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = tfn(tx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
