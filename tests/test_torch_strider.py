"""Port strider decode (repro_torch.kernels.strider) against repro's plain
decode and its Pallas kernel in interpret mode: bit-exact on int32 views,
swept over widths, int8 and f32 pages, page sizes and partial last pages.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db.page import PageLayout as JPageLayout
from repro.kernels.strider import ref as jref
from repro.kernels.strider.strider import strider_decode as pallas_decode
from repro_torch.db.heap import write_token_table
from repro_torch.db.page import PageLayout, build_pages, parse_page
from repro_torch.kernels.strider import kernel, ops, ref

# one compiled program per layout instead of one per eager op
_jax_ref = jax.jit(jref.decode_pages_ref, static_argnums=1)


def _make(n, d, quant=False, page_bytes=8192, seed=0):
    lo = PageLayout(n_features=d, page_bytes=page_bytes, quantized=quant)
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 2, (n, d)).astype(np.float32)
    labels = rng.normal(0, 2, n).astype(np.float32)
    return lo, feats, labels, build_pages(feats, labels, lo)


def _bits(a):
    return np.array(a).view(np.int32)


def _assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), torch.from_numpy(_bits(w)))


@pytest.mark.parametrize("page_kb", [8, 16, 32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [1, 3, 16, 54, 128])
def test_decode_bit_exact_vs_repro(d, quant, page_kb):
    t = PageLayout(n_features=d, page_bytes=page_kb * 1024, quantized=quant).tuples_per_page
    # two full pages and a partial last one
    lo, feats, labels, pages = _make(2 * t + t // 2 + 1, d, quant, page_kb * 1024,
                                     seed=d + page_kb)
    jlo = JPageLayout(n_features=d, page_bytes=page_kb * 1024, quantized=quant)
    got = ops.decode_pages(ops.pages_tensor(pages), lo)
    _assert_same_bits(got, _jax_ref(jnp.asarray(pages), jlo))
    _assert_same_bits(got, pallas_decode(jnp.asarray(pages), jlo, interpret=True))
    assert got[2][-1].sum() == t // 2 + 1


def test_token_page_denormals_survive(tmp_path):
    """int32 tokens stored as f32 denormals come back bit for bit."""
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(str(tmp_path / "tok.heap"), seqs, page_bytes=8192)
    pages = heap.read_all()
    jlo = JPageLayout(n_features=heap.layout.n_features, page_bytes=8192)
    got = ops.decode_pages(ops.pages_tensor(pages), heap.layout)
    _assert_same_bits(got, _jax_ref(jnp.asarray(pages), jlo))
    tokens = got[0].view(torch.int32)
    for i, s in enumerate(seqs):
        assert tokens[0, i, : len(s)].tolist() == s
    assert torch.count_nonzero(tokens[0, len(seqs):]) == 0


@pytest.mark.parametrize("quant", [False, True])
def test_decode_recovers_exact_tuples(quant):
    lo, feats, labels, pages = _make(200, 33, quant)
    kf, kl, km = ops.decode_pages(ops.pages_tensor(pages), lo)
    live = km.reshape(-1).bool()
    flat_f = kf.reshape(-1, 33)[live].numpy()
    flat_l = kl.reshape(-1)[live].numpy()
    np.testing.assert_array_equal(flat_l, labels)
    if quant:
        # the honest per-tuple parser is the oracle for dequantised values
        want = np.concatenate([parse_page(p, lo)[0] for p in pages])
        np.testing.assert_array_equal(flat_f, want)
    else:
        np.testing.assert_array_equal(flat_f, feats)


def test_ref_is_the_cpu_path_and_cuda_never_falls_back(monkeypatch):
    lo, _, _, pages = _make(50, 20)
    pt = ops.pages_tensor(pages)
    calls = []
    monkeypatch.setattr(ref, "decode_pages_ref",
                        lambda *a: calls.append("ref") or ("ref",))
    monkeypatch.setattr(kernel, "strider_decode",
                        lambda *a: calls.append("kernel") or ("kernel",))
    assert ops.decode_pages(pt, lo) == ("ref",)
    assert ops.decode_pages(pt.to("meta"), lo) == ("kernel",)
    assert calls == ["ref", "kernel"]


def test_kernel_wrapper_rejects_non_cuda_input():
    lo, _, _, pages = _make(50, 20)
    launches = kernel.strider_decode.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.strider_decode(ops.pages_tensor(pages), lo)
    assert kernel.strider_decode.launches == launches


def test_pages_tensor_is_an_int32_view():
    lo, _, _, pages = _make(30, 5)
    pt = ops.pages_tensor(pages)
    assert pt.dtype == torch.int32 and pt.shape == pages.shape
    assert np.shares_memory(pt.numpy(), pages)
    assert pt[0, 0].item() == np.int32(pages[0, 0].view(np.int32))
