"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and the TRAIN path on the card against the
same run on the CPU. Marked ``cuda``; every test skips where no card is
present. This file imports no JAX, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import linear_regression, logistic_regression
from repro_torch.core import solver
from repro_torch.core.translator import trace
from repro_torch.db.heap import write_table, write_token_table
from repro_torch.db.page import PageLayout, build_pages
from repro_torch.kernels.engine import kernel as glm_kernel
from repro_torch.kernels.engine import ref as glm_ref
from repro_torch.kernels.strider import kernel as strider_kernel
from repro_torch.kernels.strider import ops as strider_ops
from repro_torch.kernels.strider import ref as strider_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("page_kb", [8, 32, 128])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [1, 3, 54, 520])
def test_strider_kernel_bit_exact(card, d, quant, page_kb):
    layout = PageLayout(n_features=d, page_bytes=page_kb * 1024, quantized=quant)
    t = layout.tuples_per_page
    n = 2 * t + t // 2 + 1
    rng = np.random.default_rng(d + page_kb)
    feats = rng.normal(0, 2, (n, d)).astype(np.float32)
    labels = rng.normal(0, 2, n).astype(np.float32)
    pages = strider_ops.pages_tensor(build_pages(feats, labels, layout))
    launches = strider_kernel.strider_decode.launches
    got = strider_ops.decode_pages(pages.to(card), layout)
    assert strider_kernel.strider_decode.launches == launches + 1
    for g, p, h in zip(got, strider_ref.decode_pages_ref(pages.to(card), layout),
                       strider_ref.decode_pages_ref(pages, layout)):
        assert g.device.type == "cuda"
        assert _same_bits(g, p) and _same_bits(g.cpu(), h)


def test_strider_kernel_keeps_denormal_tokens(card, tmp_path):
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(str(tmp_path / "tok.heap"), seqs, page_bytes=8192)
    pages = strider_ops.pages_tensor(heap.read_all()).to(card)
    feats = strider_kernel.strider_decode(pages, heap.layout)[0].view(torch.int32).cpu()
    for i, s in enumerate(seqs):
        assert feats[0, i, : len(s)].tolist() == s


@pytest.mark.parametrize("act", glm_ref.ACTS)
@pytest.mark.parametrize("n,d", [(256, 54), (217, 31), (70_656, 54), (33, 1000)])
def test_glm_kernel_matches_plain(card, act, n, d):
    rng = np.random.default_rng(n + d)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
    w = rng.normal(0, 0.5, d).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    x[mask == 0] = 1e6  # dead rows must not contribute
    x, y, w, mask = (torch.from_numpy(a).to(card) for a in (x, y, w, mask))
    got = glm_kernel.glm_grad(x, y, w, mask, act)
    torch.testing.assert_close(got, glm_ref.glm_grad_ref(x, y, w, mask, act),
                               rtol=2e-5, atol=2e-4)
    assert torch.equal(got, glm_kernel.glm_grad(x, y, w, mask, act))  # deterministic


@pytest.mark.parametrize("algo,labels", [("linear", "real"), ("logistic", "01")])
def test_train_on_card_matches_cpu(card, tmp_path, algo, labels):
    rng = np.random.default_rng(4)
    X = rng.normal(0, 1, (3000, 16)).astype(np.float32)
    z = X @ rng.normal(0, 1, 16).astype(np.float32)
    y = z if labels == "real" else (z > 0).astype(np.float32)
    heap = write_table(str(tmp_path / "t.heap"), X, y, page_bytes=8192)
    fn = linear_regression if algo == "linear" else logistic_regression
    g, part = trace(lambda: fn(16, lr=0.1, merge_coef=64, epochs=3))
    glm = glm_kernel.glm_grad.launches
    strider = strider_kernel.strider_decode.launches
    a = solver.train(g, part, heap, mode="dana", seed=1)
    assert glm_kernel.glm_grad.launches - glm == 3 * -(-heap.n_pages * heap.layout
                                                       .tuples_per_page // 64)
    assert strider_kernel.strider_decode.launches - strider == 3
    b = solver.train(g, part, heap, mode="dana", seed=1, device="cpu")
    assert a.device_syncs == b.device_syncs == 3
    np.testing.assert_allclose(a.models[0], b.models[0], rtol=1e-4, atol=1e-5)
