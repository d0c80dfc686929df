"""The plain version of the paged-attention kernel B5
(``repro_torch.kernels.paged_attn``) against ``repro``'s gather oracle
``paged_attn_ref`` and its Pallas kernel in interpret mode, on the same numpy
inputs, at the reference's tolerance (rtol=atol=2e-5,
``tests/test_paged_attn_kernel.py``). The cases are in
``test_torch_paged_attn_cases.py``; ``test_torch_cuda.py`` holds the kernel
against this plain version on the card, with and without each case's runs.
The latent entry's plain version (the absorbed-MLA call over the pools c and
kr) is held against the same oracles on the concatenated pools."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged_attn_cases import (CASES, LATENT_CASES, LATENT_SPLIT_ROWS,
                                         SPLIT_ROWS)
from repro.kernels.paged_attn import ref as jref
from repro.kernels.paged_attn.kernel import paged_attn_pallas
from repro_torch.kernels.paged_attn import kernel, ops, ref

TOL = dict(rtol=2e-5, atol=2e-5)


RUN_CASES = sorted(n for n, fn in CASES.items() if len(fn()[7]) < fn()[0].shape[0])


def _torch_inputs(case):
    q, k, v, table, pos, kw, bf16, _ = case
    dt = torch.bfloat16 if bf16 else torch.float32
    return ([torch.from_numpy(a).to(dt) for a in (q, k, v)]
            + [torch.from_numpy(table), torch.from_numpy(pos)], kw)


def _jax_inputs(case):
    q, k, v, table, pos, kw, bf16, _ = case
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return [jnp.asarray(a, dt) for a in (q, k, v)] + [jnp.asarray(table), jnp.asarray(pos)], kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_repro_ref(name):
    case = CASES[name]()
    (q, k, v, table, pos), kw = _torch_inputs(case)
    got = ops.paged_attention(q, k, v, table, pos, **kw)
    assert got.dtype == torch.float32 and got.shape == (*q.shape[:3], v.shape[-1])
    want = jref.paged_attn_ref(*_jax_inputs(case)[0], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["gqa", "mqa_dk_ne_dv", "g5_dk_ne_dv", "bs5", "ring6",
                                  "max_rows", "bf16", "unmapped_clamped", "runs_ring6",
                                  "runs_ring4", "shared_blocks_run", "runs_max_rows"])
def test_plain_matches_repro_kernel_interpret(name):
    case = CASES[name]()
    (q, k, v, table, pos), kw = _torch_inputs(case)
    got = ref.paged_attn_ref(q, k, v, table, pos, **kw)
    want = paged_attn_pallas(*_jax_inputs(case)[0], interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", RUN_CASES)
def test_plain_ignores_runs(name):
    """The runs are a hint to the kernel: the plain version gives the same
    bits with and without them, and both match ``repro``'s ref."""
    case = CASES[name]()
    (q, k, v, table, pos), kw = _torch_inputs(case)
    runs = torch.from_numpy(case[7])
    got = ops.paged_attention(q, k, v, table, pos, runs=runs, **kw)
    assert torch.equal(got, ops.paged_attention(q, k, v, table, pos, **kw))
    want = jref.paged_attn_ref(*_jax_inputs(case)[0], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_cases_sit_on_the_kernels_boundary():
    """The split cases are placed on the kernel's split size: the constant
    they use is the one the CUDA source compiles."""
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/paged_attn.cu").read_text()
    assert int(re.search(r"constexpr int kSplitRows = (\d+);", src).group(1)) == SPLIT_ROWS
    assert kernel.n_splits(68, 16, 0, 1088, SPLIT_ROWS) == 9
    assert kernel.n_splits(40, 8, 0, SPLIT_ROWS, SPLIT_ROWS) == 1
    assert kernel.n_splits(3, 2, 6, 6, SPLIT_ROWS) == 1


def test_stale_rows_never_read():
    """Rewriting every row past each token's last valid row (stale content
    of recycled blocks, and block 0 behind unmapped entries) leaves the
    output bit for bit."""
    case = CASES["unmapped_clamped"]()
    (q, k, v, table, pos), kw = _torch_inputs(case)
    out = ops.paged_attention(q, k, v, table, pos, **kw)
    read = torch.zeros(k.shape[:2], dtype=torch.bool)
    for t in range(q.shape[0]):
        for n in range(int(pos[t]) + 1):
            read[table[t, n // kw["block_size"]], n % kw["block_size"]] = True
    k2, v2 = k.clone(), v.clone()
    k2[~read], v2[~read] = 1e4, -1e4
    torch.testing.assert_close(ops.paged_attention(q, k2, v2, table, pos, **kw), out,
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    (q, k, v, table, pos), kw = _torch_inputs(CASES["gqa"]())
    launches = kernel.paged_attention.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.paged_attention(q, k, v, table, pos, **kw)
    assert kernel.paged_attention.launches == launches


# ------------------------------ the latent entry ------------------------------
LATENT_RUN_CASES = sorted(n for n, fn in LATENT_CASES.items() if len(fn()[7]) < fn()[0].shape[0])


def _latent_inputs(case):
    """The case's bf16 values as torch bf16 tensors, and as the generic
    call's f32 numpy operands: q (T, 1, H, Dk), K = [c ; kr] and V = c pools
    (NB, bs, 1, D)."""
    q, c, kr, table, pos, kw, _, _ = case
    tq, tc, tkr = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, c, kr))
    q32, c32, kr32 = (x.float().numpy() for x in (tq, tc, tkr))
    generic = (q32[:, None], np.concatenate([c32, kr32], -1)[:, :, None], c32[:, :, None])
    return (tq, tc, tkr, torch.from_numpy(table), torch.from_numpy(pos)), generic, kw


@pytest.mark.parametrize("name", sorted(LATENT_CASES))
def test_latent_plain_matches_repro_ref_on_the_concatenated_pools(name):
    """The latent entry's plain version against ``repro``'s gather oracle
    and the port's generic plain version, each given q (T, 1, H, Dk), K =
    [c ; kr] and V = c as pools of one kv head."""
    case = LATENT_CASES[name]()
    (q, c, kr, table, pos), generic, kw = _latent_inputs(case)
    got = ops.paged_latent_attention(q, c, kr, table, pos, **kw)
    assert got.dtype == torch.float32 and got.shape == (*q.shape[:2], c.shape[-1])
    want = jref.paged_attn_ref(*(jnp.asarray(a) for a in generic), jnp.asarray(case[3]),
                               jnp.asarray(case[4]), ring_width=0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)
    port = ref.paged_attn_ref(*(torch.from_numpy(a) for a in generic), table, pos,
                              ring_width=0, **kw)
    np.testing.assert_allclose(got.numpy(), port[:, 0].numpy(), **TOL)


@pytest.mark.parametrize("name", ["recycled", "max_rows", "unmapped", "runs_max_rows"])
def test_latent_plain_matches_repro_kernel_interpret(name):
    """The same against ``repro``'s Pallas kernel in interpret mode, as
    ``repro``'s MLA ``pallas`` path calls it."""
    case = LATENT_CASES[name]()
    (q, c, kr, table, pos), generic, kw = _latent_inputs(case)
    got = ref.paged_latent_attn_ref(q, c, kr, table, pos, **kw)
    want = paged_attn_pallas(*(jnp.asarray(a) for a in generic), jnp.asarray(case[3]),
                             jnp.asarray(case[4]), ring_width=0, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)


@pytest.mark.parametrize("name", LATENT_RUN_CASES)
def test_latent_plain_ignores_runs(name):
    case = LATENT_CASES[name]()
    (q, c, kr, table, pos), _, kw = _latent_inputs(case)
    got = ops.paged_latent_attention(q, c, kr, table, pos, runs=torch.from_numpy(case[7]), **kw)
    assert torch.equal(got, ops.paged_latent_attention(q, c, kr, table, pos, **kw))


def test_latent_stale_rows_never_read():
    """Rewriting every c and kr row past each token's last valid row (stale
    rows of recycled blocks, block 0 behind unmapped entries) leaves the
    latent output bit for bit."""
    (q, c, kr, table, pos), _, kw = _latent_inputs(LATENT_CASES["unmapped"]())
    out = ops.paged_latent_attention(q, c, kr, table, pos, **kw)
    read = torch.zeros(c.shape[:2], dtype=torch.bool)
    for t in range(q.shape[0]):
        for n in range(int(pos[t]) + 1):
            read[table[t, n // kw["block_size"]], n % kw["block_size"]] = True
    c2, kr2 = c.clone(), kr.clone()
    c2[~read], kr2[~read] = 1e4, -1e4
    assert torch.equal(ops.paged_latent_attention(q, c2, kr2, table, pos, **kw), out)


def test_latent_split_rows_fill_the_card_from_the_shape():
    """The latent entry's context split is picked on the host from the call's
    shape: minicpm3's mixed step (96 rows of 40 heads in 21 runs, a 68-block
    table) takes 128-row splits; its decode-only step (8 slots) 64-row
    splits, 17 x 13 possible items for 132 SMs; a call too small to fill the
    card the smallest split; every choice is one the kernel takes, and the
    cases' splits are the kernel's."""
    assert kernel.LATENT_SPLITS == LATENT_SPLIT_ROWS
    assert kernel.latent_split_rows(21, 96, 40, 68, 16, 1088, 132) == 128
    assert kernel.latent_split_rows(8, 8, 40, 68, 16, 1088, 132) == 64
    assert kernel.n_splits(68, 16, 0, 1088, 64) == 17
    assert kernel.latent_split_rows(2, 2, 40, 6, 4, 24, 132) == 32
    assert kernel.n_splits(6, 4, 0, 24, 32) == 1
    for runs in (1, 8, 21, 96):
        for width in (1, 6, 68, 1000):
            assert kernel.latent_split_rows(runs, 96, 40, width, 16, width * 16,
                                            132) in LATENT_SPLIT_ROWS


def test_latent_kernel_wrapper_refuses_cpu_tensors():
    (q, c, kr, table, pos), _, kw = _latent_inputs(LATENT_CASES["recycled"]())
    launches = kernel.paged_latent_attention.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.paged_latent_attention(q, c, kr, table, pos, **kw)
    assert kernel.paged_latent_attention.launches == launches
