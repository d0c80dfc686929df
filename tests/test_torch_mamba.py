"""The port's Mamba mixer (``repro_torch.models.ssm``: ``make_mamba``,
``_mamba_core``, ``mamba_mix``) against ``repro.models.ssm`` on the CPU, with
the same numpy inputs and weights; a port of the Mamba tests of
``tests/test_moe_ssm.py``, and their tolerances: the chunked scan at
``rtol=atol=2e-4`` against the reference's scan and a per-token oracle, the
streaming state (a full pass against two halves) at 3e-3.

The scan's chunk boundaries are the reference's wherever it runs a length.
The reference reshapes T tokens into ``T // chunk`` chunks and raises where
that count does not divide T; the port answers there with one ragged last
chunk, pinned here against the per-token oracle (ROADMAP §C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import ssm as jssm
from repro.models.params import Maker, split_tree
from repro_torch.configs import get_reduced_config
from repro_torch.models import ssm
from repro_torch.models.params import Maker as TMaker
from repro_torch.models.params import split_tree as tsplit
from test_torch_serve_util import one_cpu_thread  # noqa: F401

ARCH = "hymba-1.5b"
SCAN = dict(rtol=2e-4, atol=2e-4)
STREAM = dict(rtol=3e-3, atol=3e-3)


def _setup(seed=0):
    """The reduced config, ``repro``'s mixer weights (f32) and the same as
    torch tensors."""
    cfg = get_reduced_config(ARCH)
    jp, _ = split_tree(jssm.make_mamba(Maker(jax.random.PRNGKey(seed)), jreduced(ARCH)))
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return cfg, jp, tp


def _sequential(p, xc, cfg, h0):
    """Per-token oracle of ``_mamba_core`` in f64 numpy."""
    f = {k: np.asarray(v, np.float64) for k, v in p.items()}
    x = np.asarray(xc, np.float64)
    dt = np.logaddexp(x @ f["w_dt"] + f["dt_bias"], 0.0)
    bm, cm = x @ f["w_b"], x @ f["w_c"]
    a = -np.exp(f["a_log"])
    h = np.asarray(h0, np.float64)
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, cm[:, t]) + f["d_skip"] * x[:, t])
    return np.stack(ys, 1), h


def _xc(cfg, t, seed=5, b=2):
    di = cfg.ssm_expand * cfg.d_model
    return (np.random.default_rng(seed).normal(0, 1, (b, t, di)) * 0.3).astype(np.float32)


def test_make_mamba_has_repro_names_shapes_and_axes():
    cfg, jp, _ = _setup()
    _, jspecs = split_tree(jssm.make_mamba(Maker(jax.random.PRNGKey(0)), jreduced(ARCH)))
    own, specs = tsplit(ssm.make_mamba(TMaker(torch.Generator().manual_seed(0), "cpu",
                                              torch.float32), cfg))
    assert sorted(own) == sorted(jp) and specs == jspecs
    for k, v in jp.items():
        assert tuple(own[k].shape) == np.shape(v), k
    # the same scales: a_log at 0.02, conv at 0.2 (std of the draws)
    assert abs(float(own["a_log"].std()) - 0.02) < 0.005
    assert abs(float(own["conv"].std()) - 0.2) < 0.05


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mamba_core_matches_repro_and_the_sequential_oracle(chunk):
    cfg, jp, tp = _setup()
    xc = _xc(cfg, 32)
    h0 = np.random.default_rng(1).normal(0, 0.1, (2, xc.shape[2], cfg.ssm_state)).astype(np.float32)
    y, h = ssm._mamba_core(tp, torch.from_numpy(xc), cfg, torch.from_numpy(h0), chunk=chunk)
    jy, jh = jssm._mamba_core(jp, jnp.asarray(xc), jreduced(ARCH), jnp.asarray(h0), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN)
    sy, sh = _sequential(jp, xc, cfg, h0)
    np.testing.assert_allclose(y.numpy(), sy, **SCAN)
    np.testing.assert_allclose(h.numpy(), sh, **SCAN)


def test_chunk_bounds_are_the_references_where_it_runs():
    # the reference's reshape: nc = max(T // chunk, 1) chunks of T // nc
    for t, chunk in ((32, 8), (32, 32), (1100, 256), (512, 256), (5, 8), (1, 1)):
        nc = max(t // chunk, 1)
        assert ssm.chunk_bounds(t, chunk) == [(i * (t // nc), (i + 1) * (t // nc))
                                              for i in range(nc)]
    # where it raises, one ragged chunk more
    assert ssm.chunk_bounds(33, 16) == [(0, 16), (16, 32), (32, 33)]
    assert ssm.chunk_bounds(1025, 16)[-1] == (1024, 1025)


def test_repro_quirk_ragged_length_answered_by_the_port():
    """``repro``'s ``mamba_mix`` raises on 33 tokens at ``chunk=16`` (2
    chunks do not reshape 33 tokens); the port gives the per-token oracle's
    answer there."""
    cfg, jp, tp = _setup()
    xc = _xc(cfg, 33, seed=7)
    x = np.random.default_rng(8).normal(0, 1, (2, 33, cfg.d_model)).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jssm.mamba_mix(jp, jnp.asarray(x), jreduced(ARCH), chunk=16)
    out, _ = ssm.mamba_mix(tp, torch.from_numpy(x), cfg, chunk=16)
    assert out.shape == (2, 33, cfg.d_model) and torch.isfinite(out).all()
    h0 = np.zeros((2, xc.shape[2], cfg.ssm_state), np.float32)
    y, h = ssm._mamba_core(tp, torch.from_numpy(xc), cfg, torch.from_numpy(h0), chunk=16)
    sy, sh = _sequential(jp, xc, cfg, h0)
    np.testing.assert_allclose(y.numpy(), sy, **SCAN)
    np.testing.assert_allclose(h.numpy(), sh, **SCAN)


def test_mamba_mix_matches_repro():
    cfg, jp, tp = _setup()
    x = np.random.default_rng(6).normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    out, (s, c) = ssm.mamba_mix(tp, torch.from_numpy(x), cfg)
    jout, (js, jc) = jssm.mamba_mix(jp, jnp.asarray(x), jreduced(ARCH))
    for got, want in ((out, jout), (s, js), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


def test_mamba_streaming_state():
    """Chunk-carried state: the full pass equals two half passes (the
    decode contract), and the two packages' halves agree."""
    cfg, jp, tp = _setup()
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (1, 16, cfg.d_model))
                         .astype(np.float32))
    y_full, (s_full, c_full) = ssm.mamba_mix(tp, x, cfg)
    y1, (s1, c1) = ssm.mamba_mix(tp, x[:, :8], cfg)
    y2, (s2, c2) = ssm.mamba_mix(tp, x[:, 8:], cfg, state=s1, conv_prev=c1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **STREAM)
    torch.testing.assert_close(s2, s_full, **STREAM)
    torch.testing.assert_close(c2, c_full, rtol=0, atol=0)
    jy1, (js1, jc1) = jssm.mamba_mix(jp, jnp.asarray(x[:, :8].numpy()), jreduced(ARCH))
    jy2, (js2, _) = jssm.mamba_mix(jp, jnp.asarray(x[:, 8:].numpy()), jreduced(ARCH),
                                   state=js1, conv_prev=jc1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **SCAN)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **SCAN)


def test_one_token_decode_equals_the_scan():
    """T = 1 steps (the direct update) carry the state as the chunked scan
    over the whole sequence does, in f32 and in bf16 activations."""
    cfg, _, tp = _setup()
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (2, 12, cfg.d_model))
                         .astype(np.float32))
    for dtype, tol in ((torch.float32, SCAN), (torch.bfloat16, STREAM)):
        p = {k: v.to(dtype) for k, v in tp.items()}
        xs = x.to(dtype)
        y_full, (s_full, c_full) = ssm.mamba_mix(p, xs, cfg, chunk=4)
        s = c = None
        ys = []
        for t in range(xs.shape[1]):
            y, (s, c) = ssm.mamba_mix(p, xs[:, t:t + 1], cfg, state=s, conv_prev=c)
            ys.append(y)
        torch.testing.assert_close(torch.cat(ys, 1).float(), y_full.float(), **tol)
        torch.testing.assert_close(s, s_full, **tol)
        assert s.dtype == torch.float32 and c.dtype == dtype
