"""The port's enc-dec decode on reduced seamless-m4t-medium: the cross K/V
precomputed once a source and the decoder's steps against ``repro``'s,
with a scalar and with a per-slot position vector (logits and the cache's
``k``/``v``), prefill against decode (a port of
``tests/test_prefill_decode_parity.py::test_encdec_prefill_equals_decode``,
at its tolerance: 3e-2 and an equal argmax), and the seamless row of
``tests/test_models_smoke.py`` (a train step, prefill, decode: finite, of
the right shapes, the decode reading its history). Tolerances as in
``test_torch_encdec.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import model_zoo as jzoo
from repro_torch.models import encdec, model_zoo
from repro_torch.models.params import leaves
from test_torch_encdec import BF16_LOGITS, BF16_REL, _np, _rel, _setup
from test_torch_serve_util import CPU, one_cpu_thread  # noqa: F401

B, SRC, STEPS = 2, 10, 6
SEQ = 24  # the reference test's


def _frames(cfg, seed, b=B, src=SRC):
    return np.random.default_rng(seed).normal(0, 1, (b, src, cfg.d_model)).astype(np.float32)


def test_precompute_cross_kv_matches_repro():
    cfg, jcfg, jp, tp = _setup()
    enc = np.random.default_rng(2).normal(0, 1, (B, SRC, cfg.d_model)).astype(np.float32)
    jk, jv = jencdec.precompute_cross_kv(jp, jnp.asarray(enc, jnp.bfloat16), jcfg)
    k, v = encdec.precompute_cross_kv(tp, torch.from_numpy(enc).to(torch.bfloat16), cfg)
    shape = (cfg.n_layers, B, SRC, cfg.n_kv_heads, cfg.hd)
    assert k.shape == v.shape == shape and k.dtype == v.dtype == torch.bfloat16
    # the same bf16 operands in both: one rounding of an f32 sum apart at most
    for got, want in ((k, jk), (v, jv)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=2 ** -7,
                                   atol=2 ** -12)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos", "vector_pos"])
def test_decode_steps_match_repro(per_slot):
    """STEPS decoder steps from an empty self cache over the source's
    precomputed cross K/V; with ``per_slot`` the rows run at positions t and
    t + 3 (continuous batching). The logits at every step, and the caches'
    ``k``/``v`` after the last (the port's spare landing row left out)."""
    cfg, jcfg, jp, tp = _setup()
    frames = _frames(cfg, 9)
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    jenc = jencdec.encode(jp, jnp.asarray(frames), jcfg, remat="none")
    jcache = dict(jencdec.init_encdec_cache(jcfg, B, 16, src=SRC),
                  **dict(zip(("xk", "xv"), jencdec.precompute_cross_kv(jp, jenc, jcfg))))
    jstep = jax.jit(jzoo.decode_fn(jcfg))
    with torch.no_grad():
        tenc = encdec.encode(tp, torch.from_numpy(frames), cfg, remat="none")
        cache = encdec.init_encdec_cache(cfg, B, 16, src=SRC, device=CPU)
        cache["xk"][:], cache["xv"][:] = encdec.precompute_cross_kv(tp, tenc, cfg)
        step = model_zoo.decode_fn(cfg)
        for t in range(STEPS):
            pos = np.array([t, t + 3], np.int32) if per_slot else np.int32(t)
            want, jcache = jstep(jp, jnp.asarray(tokens[t]), jcache, jnp.asarray(pos))
            got, cache = step(tp, torch.from_numpy(tokens[t]), cache, torch.from_numpy(
                np.asarray(pos)))
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **BF16_LOGITS,
                                       err_msg=f"step {t}")
    for key in ("k", "v"):
        mine, ref = _np(cache[key][:, :B]), np.asarray(jcache[key], np.float32)
        assert mine.shape == ref.shape
        assert _rel(mine, ref) < BF16_REL, key
        # written rows exactly where the reference writes them
        np.testing.assert_array_equal(mine != 0, ref != 0)


def test_encdec_prefill_equals_decode():
    cfg, _, _, tp = _setup(seed=4)
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, cfg.vocab_size, (2, SEQ))
    frames = rng.normal(0, 1, (2, SEQ, cfg.d_model)).astype(np.float32)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        want = model_zoo.prefill_fn(cfg)(tp, batch)
        enc_out = encdec.encode(tp, batch["frames"], cfg, remat="none")
        ks, vs = encdec.precompute_cross_kv(tp, enc_out, cfg)
        cache = dict(encdec.init_encdec_cache(cfg, 2, SEQ + 1, src=SEQ, device=CPU),
                     xk=ks, xv=vs)
        step = model_zoo.decode_fn(cfg)
        for t in range(SEQ):
            logits, cache = step(tp, batch["tokens"][:, t], cache, t)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=3e-2, atol=3e-2)
    assert np.all(_np(logits).argmax(-1) == _np(want).argmax(-1))


# ------------------------------ the smoke row ---------------------------------
SMOKE_BATCH, SMOKE_SEQ = 2, 32  # test_models_smoke.py's


def test_train_step_smoke():
    cfg, _, _, tp = _setup(seed=0, dtype=torch.float32)
    batch = model_zoo.demo_batch(cfg, SMOKE_BATCH, SMOKE_SEQ, device=CPU)
    with torch.no_grad():
        loss = model_zoo.loss_fn(cfg, remat="none")(tp, batch)
    assert loss.shape == () and np.isfinite(float(loss)) and float(loss) > 0
    params = list(leaves(tp))
    for p in params:
        p.requires_grad_(True)
    grads = torch.autograd.grad(model_zoo.loss_fn(cfg, remat="full")(tp, batch), params)
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads)))
    assert np.isfinite(gnorm) and gnorm > 0


def test_prefill_smoke():
    cfg, _, _, tp = _setup(seed=0)
    batch = model_zoo.demo_batch(cfg, SMOKE_BATCH, SMOKE_SEQ, device=CPU)
    with torch.no_grad():
        logits = model_zoo.prefill_fn(cfg)(tp, batch)
    assert logits.shape == (SMOKE_BATCH, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()


def test_decode_step_smoke():
    """Tokens A then B against B on a fresh cache: the history must matter
    (the cross K/V stay zero, as in the reference's smoke test)."""
    cfg, _, _, tp = _setup(seed=0)
    step = model_zoo.decode_fn(cfg)
    tok_a, tok_b = torch.tensor([1, 2], dtype=torch.int32), torch.tensor([3, 4],
                                                                         dtype=torch.int32)
    with torch.no_grad():
        cache = model_zoo.make_cache(cfg, SMOKE_BATCH, SMOKE_SEQ, CPU)
        assert cache["xk"].shape[2] == SMOKE_SEQ  # src = seq, as the reference's
        logits_a, cache = step(tp, tok_a, cache, 0)
        logits_ab, _ = step(tp, tok_b, cache, 1)
        logits_b, _ = step(tp, tok_b, model_zoo.make_cache(cfg, SMOKE_BATCH, SMOKE_SEQ, CPU), 0)
    assert logits_a.shape == (SMOKE_BATCH, cfg.padded_vocab)
    assert torch.isfinite(logits_ab.float()).all()
    assert not torch.allclose(logits_ab.float(), logits_b.float())
