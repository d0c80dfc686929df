"""The port's hybrid family (hymba: attention, sliding-window or global,
beside a Mamba mixer in every layer) against ``repro`` on the CPU, with the
same numpy weights (``params_from_numpy``) and inputs: the training loss and
every gradient, and ``lm_decode_step`` over dense caches and over paged
caches whose sliding-window layers read the ring pool through its own table
(the gather path and the kernel's plain version), over steps that wrap the
ring.

Reduced hymba makes both its layers global; "hymba-swa" keeps one global
layer (``n_global_layers=1``), so the other is a sliding-window layer of
window 16, and the sequences (24-40 tokens) run past it.

Tolerances. f32: the embedding's and the unembedding's bf16 casts taken out
of both packages (``test_torch_attention._uncast``), the loss at
``F32_LOSS`` and the gradients at ``F32_GRAD``, the decode logits at
``F32_LOGITS`` (one bf16 step: the unembedding rounds them) and the Mamba
state at ``F32_STATE``. bf16 as configured: ``HYBRID_BF16_LOGITS``. The hybrid
layer rounds more bf16 activations than an attention layer (the Mamba
mixer's projections, its convolution and two more norms), and XLA's fusions
round them at other places than op by op, which the Mamba scan's
exponentials carry far: ``repro``'s own decode logits move between its
jitted run and its op-by-op run by more than ``BF16_LOGITS`` (5e-2, which
holds the attention models) allows here
(``test_reference_itself_moves_past_bf16_logits``), so the bound is three
times that: about 10 bf16 steps at these logits (|logit| < 4), while the f32
comparisons stay tight."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro_torch.configs import get_reduced_config
from repro_torch.models import model_zoo, transformer
from repro_torch.models.params import params_from_numpy
from test_torch_attention import F32_GRAD, F32_LOSS, _flat, _port_grads, _uncast
from test_torch_serve_util import one_cpu_thread  # noqa: F401

CPU = "cpu"
# f32 activations; the unembedding still rounds the logits to bf16, where
# the two packages' f32 sums may round to neighbours: one bf16 step at
# |logit| < 4
F32_LOGITS = dict(rtol=0, atol=2 ** -6)
F32_STATE = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS = dict(rtol=0, atol=5e-2)
HYBRID_BF16_LOGITS = dict(rtol=0, atol=1.5e-1)
ARCHS = ["hymba-1.5b", "hymba-swa"]


def configs(arch):
    """The port's and ``repro``'s reduced configs of ``arch`` ("hymba-swa":
    reduced hymba with one global layer)."""
    over = {"n_global_layers": 1} if arch == "hymba-swa" else {}
    return get_reduced_config("hymba-1.5b", **over), jreduced("hymba-1.5b", **over)


def both(arch, seed=3):
    """The configs, ``repro``'s weights and the port's f32 copy of them."""
    cfg, jcfg = configs(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU,
                                            dtype=torch.float32)


def test_segments_and_params_match_repro():
    for arch in ARCHS:
        cfg, jcfg, jp, tp = both(arch)
        assert [s.kind for s in transformer.segments_for(cfg)] == \
            [s.kind for s in jtransformer.segments_for(jcfg)]
        own, specs = model_zoo.init_params(cfg, device=CPU)
        _, jspecs = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
        assert specs == jspecs
        jflat, mine = dict(_flat(jp)), dict(_flat(own))
        assert sorted(jflat) == sorted(mine)
        for path, v in jflat.items():
            assert tuple(mine[path].shape) == np.shape(v), path
    assert [s.kind for s in transformer.segments_for(configs("hymba-swa")[0])] == \
        ["hybrid_global", "hybrid_swa"]


# ------------------------------ training --------------------------------------
@pytest.mark.parametrize("seq", [24, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_repro(arch, seq, monkeypatch):
    _uncast(monkeypatch)
    cfg, jcfg, jp, tp = both(arch)
    jb = jzoo.demo_batch(jcfg, 2, seq, np.random.default_rng(seq))
    tb = model_zoo.demo_batch(cfg, 2, seq, np.random.default_rng(seq), device=CPU)
    jloss, jgrads = jax.value_and_grad(jzoo.loss_fn(jcfg, remat="none"))(jp, jb)
    loss, grads = _port_grads(cfg, tp, tb)
    np.testing.assert_allclose(loss, float(jloss), **F32_LOSS)
    jflat = dict(_flat(jgrads))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path]), **F32_GRAD,
                                   err_msg=str(path))


def test_remat_modes_give_the_same_loss_and_gradients():
    cfg, _, _, tp = both("hymba-swa")
    tb = model_zoo.demo_batch(cfg, 2, 24, np.random.default_rng(1), device=CPU)
    loss, grads = _port_grads(cfg, tp, tb, "none")
    for remat in ("full", "dots"):
        loss_r, grads_r = _port_grads(cfg, tp, tb, remat)
        assert loss_r == loss
        for path, g in grads.items():
            assert torch.equal(grads_r[path], g), (remat, path)


# ------------------------------ decode ----------------------------------------
B, S, BS, START = 3, 32, 4, np.array([0, 3, 6], np.int32)


def _tables(cfg):
    """Block tables of 3 slots: the full pool's (3, 8) and, for the
    sliding-window layers, the ring pool's (3, 4), both permuted."""
    ring_w = min(cfg.swa_window, S)
    nb, ring_nb = B * S // BS, B * ring_w // BS
    rng = np.random.default_rng(11)
    return (rng.permutation(nb).astype(np.int32).reshape(B, S // BS),
            rng.permutation(ring_nb).astype(np.int32).reshape(B, ring_w // BS), ring_w)


def _decode_steps(arch, layout, f32, monkeypatch, steps=24):
    """Logits of ``steps`` decode steps of 3 slots at staggered positions in
    both packages, the same tokens fed: dense caches, or paged caches read
    through the gather path or the kernel's plain version ("kernel"). The
    reference's step is jitted once (as its server runs it)."""
    cfg, jcfg, jp, tp = both(arch)
    if f32:
        monkeypatch.setattr(jtransformer, "embed",
                            lambda p, t, cfg: jnp.take(p["table"], t, axis=0))
        monkeypatch.setattr(transformer, "embed", lambda p, t, cfg: p["table"][t])
    tdec = model_zoo.decode_fn(cfg)
    if layout == "dense":
        jc, tc = jzoo.make_cache(jcfg, B, S), model_zoo.make_cache(cfg, B, S, CPU)
    else:
        table, ring, ring_w = _tables(cfg)
        nb, ring_nb = table.size, ring.size
        jc = jzoo.make_paged_cache(jcfg, B, nb, BS, ring_num_blocks=ring_nb, ring_width=ring_w)
        tc = model_zoo.make_paged_cache(cfg, nb, BS, CPU, slots=B, ring_num_blocks=ring_nb,
                                        ring_width=ring_w)
        ok = np.ones(B, bool)
        jtables = (jnp.asarray(table), jnp.asarray(ring), jnp.asarray(ok))
        tctx = dict(table=torch.from_numpy(table), ring_table=torch.from_numpy(ring),
                    write_ok=torch.from_numpy(ok), block_size=BS, ring_width=ring_w,
                    max_seq=S, impl=layout)

    @jax.jit
    def jdec(p, tok, c, pos, tables=None):
        paged = None if tables is None else dict(
            table=tables[0], ring_table=tables[1], write_ok=tables[2], block_size=BS,
            ring_width=ring_w, max_seq=S, impl="gather")
        return jtransformer.lm_decode_step(p, tok, c, pos, jcfg, paged=paged)

    rng = np.random.default_rng(4)
    out = []
    for step in range(steps):
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        pos = START + step
        kw_j = {} if layout == "dense" else {"tables": jtables}
        kw_t = {} if layout == "dense" else {"paged": tctx}
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.asarray(pos), **kw_j)
        tl, tc = tdec(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos), **kw_t)
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
    return out, jc, tc


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["dense", "gather", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_steps_match_repro(arch, layout, f32, monkeypatch):
    """24 steps from positions 0, 3 and 6: every slot's position passes the
    window (16), so the sliding-window layer's ring wraps; the recurrent
    state and the ring rows end as the reference's."""
    steps, jc, tc = _decode_steps(arch, layout, f32, monkeypatch)
    for want, got in steps:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **(F32_LOGITS if f32 else HYBRID_BF16_LOGITS))
    if f32:
        for jseg, tseg in zip(jc, tc):
            np.testing.assert_allclose(tseg["ssm"].numpy(), np.asarray(jseg["ssm"]), **F32_STATE)
            np.testing.assert_allclose(tseg["conv"].float().numpy(),
                                       np.asarray(jseg["conv"], np.float32), rtol=0, atol=1e-2)


def test_reference_itself_moves_past_bf16_logits():
    """Why ``HYBRID_BF16_LOGITS``: ``repro``'s decode logits on hymba-swa
    move between its jitted run and its op-by-op run by more than
    ``BF16_LOGITS`` allows, and by less than the hybrid bound."""
    _, jcfg, jp, _ = both("hymba-swa")
    step = jax.jit(lambda p, t, c, pos: jtransformer.lm_decode_step(p, t, c, pos, jcfg))
    a, b = jzoo.make_cache(jcfg, 2, 40), jzoo.make_cache(jcfg, 2, 40)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    spread = 0.0
    for t in range(24):
        tok = jnp.asarray(toks[:, t])
        la, a = step(jp, tok, a, t)
        with jax.disable_jit():
            lb, b = jtransformer.lm_decode_step(jp, tok, b, t, jcfg)
        spread = max(spread, float(jnp.abs(la.astype(jnp.float32) - lb.astype(jnp.float32)).max()))
    assert BF16_LOGITS["atol"] < spread < HYBRID_BF16_LOGITS["atol"], spread


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_write_ok_freezes_recurrent_state(layout):
    """A row whose ``write_ok`` is off keeps its Mamba state and its
    convolution window (the server's idle rows); the other rows advance as
    in an ungated step."""
    cfg, _, _, tp = both("hymba-swa")
    tok = torch.tensor([5, 7, 9], dtype=torch.int32)
    pos = torch.tensor([2, 20, 9], dtype=torch.int32)
    ok = torch.tensor([True, False, True])
    caches = []
    for gate in (None, ok):
        if layout == "dense":
            cache = model_zoo.make_cache(cfg, B, S, CPU)
            kw = {"write_ok": gate}
        else:
            table, ring, ring_w = _tables(cfg)
            cache = model_zoo.make_paged_cache(cfg, table.size, BS, CPU, slots=B,
                                               ring_num_blocks=ring.size, ring_width=ring_w)
            kw = {"paged": dict(table=torch.from_numpy(table), ring_table=torch.from_numpy(ring),
                                write_ok=gate, block_size=BS, ring_width=ring_w, max_seq=S)}
        for seg in cache:
            for k in ("ssm", "conv"):
                seg[k].copy_(torch.randn(seg[k].shape, generator=torch.Generator().manual_seed(1)))
        before = [{k: seg[k].clone() for k in ("ssm", "conv")} for seg in cache]
        model_zoo.decode_fn(cfg)(tp, tok, cache, pos, **kw)
        caches.append((before, cache))
    (_, free), (before, gated) = caches
    for seg_free, seg_before, seg_gated in zip(free, before, gated):
        for k in ("ssm", "conv"):
            assert torch.equal(seg_gated[k][:, 1], seg_before[k][:, 1]), k
            assert torch.equal(seg_gated[k][:, [0, 2]], seg_free[k][:, [0, 2]]), k
            assert not torch.equal(seg_free[k][:, 1], seg_before[k][:, 1]), k


def test_slot_mapping_refused_for_recurrent_segments():
    cfg, _, _, tp = both("hymba-swa")
    cache = model_zoo.make_cache(cfg, 2, S, CPU)
    with pytest.raises(ValueError, match="per-slot recurrent state"):
        model_zoo.decode_fn(cfg)(tp, torch.tensor([1, 2], dtype=torch.int32), cache,
                                 torch.tensor([0, 1], dtype=torch.int32),
                                 slot=torch.tensor([0, 0]), write_ok=torch.ones(2, dtype=torch.bool))


def test_caches_have_the_references_layout():
    """Dense: the sliding-window layer's ring of ``swa_window`` rows, the
    per-slot Mamba state. Paged: sliding-window layers on the ring pool,
    global layers on the full pool, recurrent state dense per slot."""
    cfg, jcfg, _, _ = both("hymba-swa")
    for jc, tc, spare in ((jzoo.make_cache(jcfg, B, S), model_zoo.make_cache(cfg, B, S, CPU), 1),
                          (jzoo.make_paged_cache(jcfg, B, 24, BS, ring_num_blocks=12,
                                                 ring_width=16),
                           model_zoo.make_paged_cache(cfg, 24, BS, CPU, slots=B,
                                                      ring_num_blocks=12, ring_width=16), 1)):
        for jseg, tseg in zip(jc, tc):
            assert sorted(jseg) == sorted(tseg)
            for k, v in jseg.items():
                want = list(np.shape(v))
                if k in ("k", "v"):
                    want[1] += spare  # the port's spare row or landing block
                assert list(tseg[k].shape) == want, k
                assert tseg[k].dtype == {"float32": torch.float32,
                                         "bfloat16": torch.bfloat16}[str(v.dtype)], k
