"""Port hDFG backend (repro_torch.core.torch_backend) against
repro.core.jax_backend: pre/post/conv functions of every algorithm agree on
the same models, tuples and metas (rtol=1e-5, atol=1e-6), and the GLM
template matcher picks the same template."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.core import engine as jengine
from repro.core import jax_backend
from repro.core import translator as jtranslator
import repro_torch.algorithms as talgos
from repro_torch.core import engine as tengine
from repro_torch.core import torch_backend
from repro_torch.core import translator as ttranslator

TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (args, kwargs, per-tuple x shape, label kind)
CASES = {
    "linear": ((9,), dict(lr=0.1, merge_coef=8, conv_factor=0.5), (9,), "real"),
    "logistic": ((9,), dict(lr=0.1, merge_coef=8, conv_factor=0.5), (9,), "01"),
    "svm": ((9,), dict(lr=0.1, merge_coef=8, conv_factor=0.5), (9,), "pm1"),
    "lrmf": ((12,), dict(rank=3, merge_coef=4, conv_factor=0.5), (12,), "real"),
}
TEMPLATES = {"linear": "linear", "logistic": "logistic", "svm": "svm", "lrmf": None}


def _both(name):
    args, kwargs, _, _ = CASES[name]
    gj, pj = jtranslator.trace(lambda: jalgos.ALGORITHMS[name](*args, **kwargs))
    gt, pt = ttranslator.trace(lambda: talgos.ALGORITHMS[name](*args, **kwargs))
    return (gj, pj), (gt, pt)


def _label(kind, rng):
    if kind == "01":
        return np.float32(rng.integers(0, 2))
    if kind == "pm1":
        return np.float32(rng.choice([-1.0, 1.0]))
    return np.float32(rng.normal())


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_functions_match_jax(name):
    (gj, pj), (gt, pt) = _both(name)
    jpre, jpost, jconv, jspec = jax_backend.compile_hdfg(gj, pj)
    tpre, tpost, tconv, tspec = torch_backend.compile_hdfg(gt, pt)
    assert jspec == tspec
    metas = jengine.default_metas(gj)
    assert metas == tengine.default_metas(gt)
    rng = np.random.default_rng(hash(name) % 1000)
    jmodels = jengine.init_models(gj, np.random.default_rng(4), scale=0.5)
    tmodels = tengine.init_models(gt, np.random.default_rng(4), scale=0.5, device="cpu")
    for jm, tm in zip(jmodels, tmodels):
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    x_shape, kind = CASES[name][2], CASES[name][3]
    for _ in range(5):
        x = rng.normal(0, 1, x_shape).astype(np.float32)
        y = _label(kind, rng)
        jv = jpre(jmodels, jnp.asarray(x), jnp.asarray(y), metas)
        tv = tpre(tmodels, torch.from_numpy(x), torch.tensor(y), metas)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        merged = np.asarray(jv) * 3.0
        jnew = jpost(jmodels, jnp.asarray(merged), metas)
        tnew = tpost(tmodels, torch.from_numpy(merged), metas)
        for a, b in zip(jnew, tnew):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        for scale in (1e-4, 10.0):  # one merged value under the threshold, one over
            m = merged * scale
            want = bool(jconv(jmodels, jnp.asarray(m), metas))
            assert bool(tconv(tmodels, torch.from_numpy(m), metas)) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_template_match_matches_jax(name):
    (gj, pj), (gt, pt) = _both(name)
    want = jengine.match_glm_template(gj, pj)
    assert want == TEMPLATES[name]
    assert tengine.match_glm_template(gt, pt) == want


def test_reference_sgd_step_matches_jax():
    (gj, pj), (gt, pt) = _both("linear")
    jstep = jax_backend.reference_sgd(gj, pj)
    tstep = torch_backend.reference_sgd(gt, pt)
    metas = jengine.default_metas(gj)
    rng = np.random.default_rng(8)
    w = rng.normal(0, 1, 9).astype(np.float32)
    jm, tm = [jnp.asarray(w)], [torch.from_numpy(w)]
    for _ in range(20):
        x = rng.normal(0, 1, 9).astype(np.float32)
        y = np.float32(rng.normal())
        jm = jstep(jm, jnp.asarray(x), jnp.asarray(y), metas)
        tm = tstep(tm, torch.from_numpy(x), torch.tensor(y), metas)
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), **TOL)


def test_outer_broadcast_matches_jax():
    """The DSL's outer replication ([5,10] x [2,10] -> [5,2,10]) and the
    right-aligned rank broadcast, operand by operand."""
    rng = np.random.default_rng(2)
    for sa, sb, out in (((5, 10), (2, 10), (5, 2, 10)), ((4, 3), (3,), (4, 3)),
                        ((6,), (6,), (6,))):
        a = rng.normal(0, 1, sa).astype(np.float32)
        b = rng.normal(0, 1, sb).astype(np.float32)
        ja, jb = jax_backend._outer_broadcast(jnp.asarray(a), jnp.asarray(b), out)
        ta, tb = torch_backend._outer_broadcast(torch.from_numpy(a), torch.from_numpy(b),
                                                out)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
