"""The port's WKV6 (``repro_torch.kernels.wkv`` and the core of
``repro_torch.models.ssm``) against ``repro``'s on the same numpy inputs:
the sequential oracle and the chunked form against ``repro.models.ssm``'s
``wkv_scan`` and ``wkv_chunked`` and the Pallas kernel in interpret mode, at
the reference's own tolerance (rtol=atol=2e-4, ``tests/test_moe_ssm.py``),
and ``ops.wkv``'s gradients against ``jax.grad`` of ``wkv_chunked``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.wkv.wkv import wkv_pallas
from repro.models import ssm as jssm
from repro_torch.kernels.wkv import kernel, ops, ref
from repro_torch.models import ssm
from test_torch_serve_util import one_cpu_thread  # noqa: F401
from test_torch_wkv_cases import make

TOL = dict(rtol=2e-4, atol=2e-4)


def _both(case):
    *arrs, chunk = make(case)
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs], chunk


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("case", ["chunk8", "chunk16", "chunk32", "k_ne_v"])
def test_wkv_chunked_and_oracle_match_repro(case):
    jin, tin, chunk = _both(case)
    j_scan = jssm.wkv_scan(*jin)
    t_scan = ref.wkv_ref(*tin)
    t_chunk = ref.wkv_chunked_ref(*tin, chunk)
    for got in (t_scan, t_chunk):
        for g, w in zip(got, j_scan):
            _close(g, w)
    if case != "k_ne_v":  # the reference's chunked form assumes K == V
        for g, w in zip(t_chunk, jssm.wkv_chunked(*jin, chunk)):
            _close(g, w)
    assert ssm.wkv_scan is ref.wkv_ref and ssm.wkv_chunked is ref.wkv_chunked_ref


def test_wkv_matches_repro_pallas_kernel():
    jin, tin, chunk = _both("pallas_small")
    want = wkv_pallas(*jin, chunk=chunk, interpret=True)
    for got in (ref.wkv_chunked_ref(*tin, chunk), ops.wkv(*tin, chunk)):
        for g, w in zip(got, want):
            _close(g, w)


@settings(max_examples=8, deadline=None)
@given(t=st.sampled_from([16, 32, 64]), chunk=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 100))
def test_wkv_property_matches_repro_pallas(t, chunk, seed):
    jin, tin, _ = _both((1, t, 2, 8, 8, chunk, seed, "random"))
    want = wkv_pallas(*jin, chunk=chunk, interpret=True)
    for g, w in zip(ops.wkv(*tin, chunk), want):
        _close(g, w, dict(rtol=5e-4, atol=5e-4))  # the reference's property tolerance


def test_wkv_state_carries_across_calls():
    """Splitting a sequence across two calls == one call (streaming decode)."""
    _, (r, k, v, lw, u, s0), chunk = _both("chunk16")
    y_full, s_full = ref.wkv_ref(r, k, v, lw, u, s0)
    y1, s_mid = ops.wkv(r[:, :32], k[:, :32], v[:, :32], lw[:, :32], u, s0, chunk)
    y2, s_end = ref.wkv_ref(r[:, 32:], k[:, 32:], v[:, 32:], lw[:, 32:], u, s_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s_end, s_full, rtol=1e-4, atol=1e-5)


def test_wkv_chunked_stays_finite_at_the_clip_bounds():
    """At log-decays of -8 the reference's chunked form overflows
    exp(q_ex_t - cum_s) for s > t and multiplies inf by 0: NaN. The port's
    gives the sequential oracle's values (see kernels/wkv/ref.py)."""
    jin, tin, chunk = _both("clip_low")
    j_y, _ = jssm.wkv_chunked(*jin, chunk)
    assert np.isnan(np.asarray(j_y)).any()
    for case in ("clip_low", "clip_high", "clip_mixed"):
        jin, tin, chunk = _both(case)
        for g, w in zip(ref.wkv_chunked_ref(*tin, chunk), jssm.wkv_scan(*jin)):
            _close(g, w)


@pytest.mark.parametrize("case", ["chunk8", "chunk32", "k_ne_v", "clip_mixed"])
def test_wkv_chunk_states_match_repro_scan_on_each_prefix(case):
    """The chunk states B6 writes for B6-bwd, in their plain version: chunk
    c's starting state is the reference's sequential state after the first
    c chunks, and the final state is wkv_chunked_ref's."""
    jin, tin, chunk = _both(case)
    r, k, v, lw, u, s0 = tin
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    states, s_out = ref.wkv_chunk_states_ref(k, v, lw, s0, chunk)
    assert states.shape == (b * h, t // chunk, kd, vd) and states.dtype == torch.float32
    assert torch.equal(states[:, 0], s0.reshape(b * h, kd, vd))
    for c in range(1, t // chunk):
        _, want = jssm.wkv_scan(*(x[:, :c * chunk] for x in jin[:4]), *jin[4:])
        _close(states[:, c], np.asarray(want).reshape(b * h, kd, vd))
    assert torch.equal(s_out, ref.wkv_chunked_ref(*tin, chunk)[1])


def _cotangents(jin):
    rng = np.random.default_rng(9)
    dy = rng.normal(0, 1, (*np.shape(jin[0])[:3], np.shape(jin[2])[-1])).astype(np.float32)
    ds = rng.normal(0, 1, np.shape(jin[5])).astype(np.float32)
    return dy, ds


@pytest.mark.parametrize("case", ["chunk8", "chunk32", "k_ne_v", "clip_mixed"])
def test_wkv_chunk_dstates_match_jax_vjp_on_each_suffix(case):
    """The state gradients B6-bwd's serial pass writes, in their plain
    version: the gradient of the state after chunk c is the reference's
    cotangent of the starting state of the sequence's suffix from chunk
    c + 1 (the same dy there, the same final-state cotangent); the last is
    the final-state cotangent, and ds0 the whole sequence's."""
    jin, tin, chunk = _both(case)
    r, k, v, lw, u, s0 = tin
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    dy, ds = _cotangents(jin)
    dstates, ds0 = ref.wkv_chunk_dstates_ref(r, lw, torch.from_numpy(dy),
                                             torch.from_numpy(ds), chunk)
    assert dstates.shape == (b * h, t // chunk, kd, vd) and dstates.dtype == torch.float32
    assert torch.equal(dstates[:, -1], torch.from_numpy(ds).reshape(b * h, kd, vd))

    def suffix_vjp(t0):  # jax.vjp of wkv_scan from token t0, in its starting state
        xs = [x[:, t0:] for x in jin[:4]]
        _, vjp = jax.vjp(lambda st: jssm.wkv_scan(*xs, jin[4], st), jin[5])
        return np.asarray(vjp((jnp.asarray(dy[:, t0:]), jnp.asarray(ds)))[0])

    for c in range(t // chunk - 1):
        _close(dstates[:, c], suffix_vjp((c + 1) * chunk).reshape(b * h, kd, vd))
    _close(ds0, suffix_vjp(0))


@pytest.mark.parametrize("case", ["chunk8", "chunk32", "k_ne_v", "clip_mixed"])
def test_wkv_bwd_chunked_matches_jax_grad(case):
    """B6-bwd's chunk-parallel gradient pass and du's sum, in their plain
    version, fed by the plain chunk states and state gradients: all six
    gradients are jax.grad's of the reference's wkv_chunked (of wkv_scan
    where wkv_chunked cannot run: K != V, or log-decays at -8, where it
    overflows)."""
    jin, tin, chunk = _both(case)
    r, k, v, lw, u, s0 = tin
    dy, ds = _cotangents(jin)
    fn = (lambda *xs: jssm.wkv_chunked(*xs, chunk)) if case in ("chunk8", "chunk32") \
        else jssm.wkv_scan

    def jloss(*xs):
        y, s = fn(*xs)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*jin)
    states, _ = ref.wkv_chunk_states_ref(k, v, lw, s0, chunk)
    dstates, ds0 = ref.wkv_chunk_dstates_ref(r, lw, torch.from_numpy(dy),
                                             torch.from_numpy(ds), chunk)
    got = (*ref.wkv_bwd_chunked_ref(r, k, v, lw, u, states, dstates, torch.from_numpy(dy)),
           ds0)
    for g, w, x in zip(got, want, tin):
        assert g.shape == x.shape and g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("case", ["chunk8", "chunk32", "pallas_small", "clip_high"])
def test_wkv_gradients_match_jax_grad(case):
    jin, tin, chunk = _both(case)
    rng = np.random.default_rng(9)
    dy = rng.normal(0, 1, np.shape(jin[2])).astype(np.float32)
    ds = rng.normal(0, 1, np.shape(jin[5])).astype(np.float32)

    def jloss(*xs):
        y, s = jssm.wkv_chunked(*xs, chunk)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*jin)
    leaves = [x.clone().requires_grad_(True) for x in tin]
    y, s = ops.wkv(*leaves, chunk)
    torch.autograd.backward([y, s], [torch.from_numpy(dy), torch.from_numpy(ds)])
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)
    # the backward's plain version is the same function
    for g, leaf in zip(ref.wkv_bwd_ref(*tin, chunk, torch.from_numpy(dy),
                                       torch.from_numpy(ds)), leaves):
        torch.testing.assert_close(g, leaf.grad)


@pytest.mark.parametrize("case", ["chunk8", "clip_mixed"])
def test_wkv_plain_versions_compute_in_f64_when_given_f64(case):
    """f64 inputs keep f64 through the plain versions (the witness the card
    checks hold the kernels against); the f32 run is within 2e-4 of it."""
    _, tin, chunk = _both(case)
    t64 = [x.double() for x in tin]
    y64, s64 = ref.wkv_chunked_ref(*t64, chunk)
    assert y64.dtype == s64.dtype == torch.float64
    y_seq, s_seq = ref.wkv_ref(*t64)
    torch.testing.assert_close(y64, y_seq, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(s64, s_seq, rtol=1e-10, atol=1e-10)
    for g, w in zip(ref.wkv_chunked_ref(*tin, chunk), (y64, s64)):
        torch.testing.assert_close(g.double(), w, **TOL)
    rng = np.random.default_rng(9)
    dy = torch.from_numpy(rng.normal(0, 1, tuple(y64.shape)))
    ds = torch.from_numpy(rng.normal(0, 1, tuple(s64.shape)))
    grads = ref.wkv_bwd_ref(*t64, chunk, dy, ds)
    assert all(g.dtype == torch.float64 for g in grads)
    for g, w in zip(ref.wkv_bwd_ref(*tin, chunk, dy.float(), ds.float()), grads):
        torch.testing.assert_close(g.double(), w, **TOL)


def test_wkv_gradient_without_a_state_cotangent():
    _, tin, chunk = _both("chunk8")
    leaves = [x.clone().requires_grad_(True) for x in tin]
    y, _ = ops.wkv(*leaves, chunk)
    y.square().sum().backward()
    want = ref.wkv_bwd_ref(*tin, chunk, 2 * y.detach(), None)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w)


def test_jax_grad_cannot_enter_the_pallas_kernel():
    """The reference trains through wkv_chunked because jax.grad of its
    Pallas kernel fails; the port's backward is a kernel of its own."""
    jin, _, chunk = _both("pallas_small")

    def loss(r):
        return jnp.sum(wkv_pallas(r, *jin[1:], chunk=chunk, interpret=True)[0])

    with pytest.raises(Exception):
        jax.grad(loss)(jin[0])


def test_wkv_output_is_v_wide_where_the_reference_docstring_says_k():
    """wkv_pallas's docstring says y is (B,T,H,K); its out_shape is V wide
    (the state's last dim), as the port's y is. The Pallas kernel itself
    needs K == V, so the V-wide case runs against the sequential oracle."""
    assert "y (B,T,H,K)" in wkv_pallas.__doc__
    jin, tin, chunk = _both("k_ne_v")
    y, s = ops.wkv(*tin, chunk)
    assert y.shape == (*tin[0].shape[:3], tin[2].shape[-1]) != tin[0].shape
    assert s.dtype == torch.float32
    for g, w in zip((y, s), jssm.wkv_scan(*jin)):
        _close(g, w)


def test_cuda_wrappers_reject_cpu_tensors():
    _, tin, chunk = _both("chunk8")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv_forward(*tin, chunk)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv_backward(*tin, None, None, None, None, chunk)


@pytest.mark.parametrize("case", ["chunk8", "chunk16", "k_ne_v", "clip_mixed", "t64_c8"])
def test_wkv_chunked_grouped_is_the_chunked_function(case, monkeypatch):
    """The dry-run's WKV form (``wkv_chunked_grouped``, a group of chunks at
    a time) computes ``wkv_chunked_ref``'s function: its outputs and
    gradients within f32 rounding of the per-chunk form's, its outputs
    within the reference's tolerance of ``repro``'s ``wkv_scan``, with a
    group smaller than the chunk count and one larger."""
    jin, tin, chunk = _both(case)
    want = jssm.wkv_scan(*jin)
    for group in (2, 64):
        monkeypatch.setattr(ref, "CHUNK_GROUP", group)
        a = [x.clone().requires_grad_(True) for x in tin]
        b = [x.clone().requires_grad_(True) for x in tin]
        ya, sa = ref.wkv_chunked_grouped(*a, chunk)
        yb, sb = ref.wkv_chunked_ref(*b, chunk)
        for g, w, j in ((ya, yb, want[0]), (sa, sb, want[1])):
            np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                       rtol=1e-5, atol=1e-5)
            _close(g, j)
        (ya.square().sum() + sa.sum()).backward()
        (yb.square().sum() + sb.sum()).backward()
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-4, atol=1e-5)
