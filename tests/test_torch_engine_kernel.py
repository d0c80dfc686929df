"""Port fused GLM gradient (repro_torch.kernels.engine) against repro's plain
version and its Pallas kernel in interpret mode, at the reference's own
tolerance (rtol=2e-5, atol=2e-4). The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.engine import ops as jops
from repro.kernels.engine import ref as jref
from repro.kernels.engine.engine import glm_grad_pallas
from repro_torch.kernels.engine import kernel, ops, ref


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
    w = rng.normal(0, 0.5, d).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return x, y, w, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("act", ref.ACTS)
@pytest.mark.parametrize("n,d", [(128, 128), (256, 384), (512, 128), (217, 31)])
def test_glm_grad_matches_repro(act, n, d):
    x, y, w, mask = _data(n, d, seed=n + d)
    got = ops.glm_grad(*_torch(x, y, w, mask), act=act)
    assert got.shape == (d,) and got.dtype == torch.float32
    want_ref = jref.glm_grad_ref(x, y, w, mask, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=2e-5, atol=2e-4)
    if n % 128 == 0:
        want_pallas = glm_grad_pallas(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(mask),
            act, block_rows=128, interpret=True,
        )
    else:  # repro's wrapper pads N and D to 128 lanes before the Pallas kernel
        want_pallas = jops.glm_grad(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                    jnp.asarray(mask), act=act, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("act", ref.ACTS)
def test_masked_rows_are_ignored(act):
    x, y, w, _ = _data(128, 64, seed=5)
    x[64:] = 1e6  # must be ignored
    mask = np.ones(128, np.float32)
    mask[64:] = 0
    got = ops.glm_grad(*_torch(x, y, w, mask), act=act)
    want = jref.glm_grad_ref(x[:64], y[:64], w, np.ones(64, np.float32), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-4)


def test_glm_error_matches_repro():
    rng = np.random.default_rng(3)
    z = rng.normal(0, 3, 500).astype(np.float32)
    y = np.sign(rng.normal(0, 1, 500)).astype(np.float32)
    for act in ref.ACTS:
        got = ref.glm_error(torch.from_numpy(z), torch.from_numpy(y), act)
        want = jref.glm_error(jnp.asarray(z), jnp.asarray(y), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_bad_act_rejected():
    x, y, w, mask = _torch(*_data(8, 4))
    with pytest.raises(ValueError):
        ops.glm_grad(x, y, w, mask, act="tanh")
    with pytest.raises(ValueError):
        kernel.glm_grad(x.to("meta"), y, w, mask, act="tanh")


def test_cuda_path_never_falls_back(monkeypatch):
    x, y, w, mask = _torch(*_data(16, 4))
    calls = []
    monkeypatch.setattr(ref, "glm_grad_ref", lambda *a: calls.append("ref"))
    monkeypatch.setattr(kernel, "glm_grad", lambda *a: calls.append("kernel"))
    ops.glm_grad(x, y, w, mask, act="linear")
    ops.glm_grad(*(t.to("meta") for t in (x, y, w, mask)), act="linear")
    assert calls == ["ref", "kernel"]


def test_kernel_wrapper_rejects_non_cuda_input():
    launches = kernel.glm_grad.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.glm_grad(*_torch(*_data(16, 4)), act="svm")
    assert kernel.glm_grad.launches == launches
