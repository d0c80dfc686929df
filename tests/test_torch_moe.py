"""The port's Mixture-of-Experts (``repro_torch.models.moe``) and the MoE
models' loss (olmoe-1b-7b; deepseek-v3-671b with MLA, a shared expert, a
leading dense layer and multi-token prediction) against ``repro`` on the
CPU, with the same weights and the same numpy inputs: ports of the MoE tests
of ``tests/test_moe_ssm.py`` and of ``tests/test_moe_properties.py``, and of
``tests/test_train.py::test_train_loop_descends_and_resumes``, whose
reference family is olmoe. deepseek-v3's whole-model loss, with its
multi-token prediction, is ``test_torch_moe_mtp.py``.

Tolerances. The MoE block runs in f32 here as in the reference tests: its
rtol = atol = 2e-4 (``MOE``), gradients against ``jax.grad`` at ``MOE_GRAD``
(``test_torch_attention.py``'s F32_GRAD). The whole model's loss uses
``test_torch_attention.py``'s bounds: ``F32_*`` with the embedding's and
the unembedding's bf16 casts taken out of both packages, ``BF16_LOSS`` as
configured (see ``check_lm_loss``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models.params import Maker as JMaker
from repro.models.params import split_tree as jsplit
from repro_torch.configs import get_reduced_config
from repro_torch.models import model_zoo, moe
from repro_torch.models.params import Maker, split_tree
from test_torch_attention import BF16_LOSS, F32_GRAD, F32_LOSS, _both, _flat, _port_grads, _uncast
from test_torch_serve_util import CPU, one_cpu_thread  # noqa: F401

MOE = dict(rtol=2e-4, atol=2e-4)
MOE_GRAD = F32_GRAD
ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]


def _setup(seed=0, cf=8.0, arch="olmoe-1b-7b"):
    """Reduced ``arch``'s MoE block at capacity factor ``cf``: the config,
    ``repro``'s f32 parameters and the same values as the port's."""
    jcfg = dataclasses.replace(jreduced(arch), capacity_factor=cf)
    cfg = dataclasses.replace(get_reduced_config(arch), capacity_factor=cf)
    jp, _ = jsplit(jmoe.make_moe(JMaker(jax.random.PRNGKey(seed)), jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return cfg, jcfg, jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _apply(tp, x, cfg):
    with torch.no_grad():
        return moe.apply_moe(tp, torch.from_numpy(x), cfg).numpy()


# ----------------------- ports of tests/test_moe_ssm.py -----------------------
def test_moe_matches_dense_reference_when_capacity_ample():
    cfg, jcfg, jp, tp = _setup(cf=8.0)
    x = _x((2, 16, cfg.d_model), 1)
    got = _apply(tp, x, cfg)
    with torch.no_grad():
        oracle = moe.moe_dense_reference(tp, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, oracle, **MOE)
    np.testing.assert_allclose(got, np.asarray(jmoe.moe_dense_reference(jp, jnp.asarray(x), jcfg)),
                               **MOE)
    np.testing.assert_allclose(got, np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg)), **MOE)


def test_moe_decode_single_group():
    """A decode batch (S == 1) routes as one group across the batch."""
    cfg, jcfg, jp, tp = _setup(cf=8.0)
    x = _x((8, 1, cfg.d_model), 2)
    got = _apply(tp, x, cfg)
    with torch.no_grad():
        oracle = moe.moe_dense_reference(tp, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, oracle, **MOE)
    np.testing.assert_allclose(got, np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg)), **MOE)
    routed = []
    moe.apply_moe(tp, torch.from_numpy(x), cfg, routing_out=routed)
    assert routed[0].groups == 1 and routed[0].cap == moe.capacity(cfg, 8)


def test_moe_capacity_drops_are_bounded():
    """With tight capacity the output degrades gracefully (drops), never
    NaNs, and it is ``repro``'s."""
    cfg, jcfg, jp, tp = _setup(cf=0.5)
    x = _x((2, 32, cfg.d_model), 3)
    routed = []
    with torch.no_grad():
        out = moe.apply_moe(tp, torch.from_numpy(x), cfg, routing_out=routed).numpy()
    assert np.all(np.isfinite(out))
    assert 0 < float((~routed[0].choice_ok).float().mean()) < 1
    np.testing.assert_allclose(out, np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg)), **MOE)


def test_moe_grad_flows_to_router():
    cfg, _, _, tp = _setup()
    x = torch.from_numpy(_x((1, 16, cfg.d_model), 4))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    moe.apply_moe(p, x, cfg).square().sum().backward()
    assert float(p["router"].grad.abs().max()) > 0
    assert float(p["wi"].grad.abs().max()) > 0


# ------------------- ports of tests/test_moe_properties.py --------------------
@pytest.mark.parametrize("seed,tokens", [(0, 4), (7, 11), (23, 16), (50, 24)])
def test_group_independence(seed, tokens):
    """Routing groups are independent: batching two groups equals routing
    each on its own."""
    cfg, _, _, tp = _setup(seed)
    x = _x((2, tokens, cfg.d_model), seed)
    both = _apply(tp, x, cfg)
    one, two = _apply(tp, x[:1], cfg), _apply(tp, x[1:], cfg)
    np.testing.assert_allclose(both, np.concatenate([one, two], 0), **MOE)


@pytest.mark.parametrize("seed", [0, 13, 31, 50])
def test_capacity_monotone_drops(seed):
    """Shrinking capacity can only drop tokens: the routed contribution
    never gains mass."""
    cfg8, _, _, tp = _setup(seed, cf=8.0)
    tight_cfg = dataclasses.replace(cfg8, capacity_factor=0.25)
    x = _x((1, 32, cfg8.d_model), seed)
    full, tight = _apply(tp, x, cfg8), _apply(tp, x, tight_cfg)
    assert np.all(np.isfinite(tight))
    assert np.abs(tight).sum() <= np.abs(full).sum() * 1.05


@pytest.mark.parametrize("seed", [0, 19, 42])
def test_token_permutation_with_ample_capacity(seed):
    """With capacity that does not bind, routing commutes with a permutation
    of the tokens."""
    cfg, _, _, tp = _setup(seed, cf=16.0)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(0, 1, (1, 16, cfg.d_model)).astype(np.float32)
    perm = rng.permutation(16)
    np.testing.assert_allclose(_apply(tp, x, cfg)[:, perm], _apply(tp, x[:, perm], cfg), **MOE)


def test_router_gradient_balance_signal():
    """Expert weights get gradients on the selected experts only: 8 tokens
    x top-2 touch at most 16 experts."""
    cfg, _, _, tp = _setup(0)
    x = torch.from_numpy(_x((1, 8, cfg.d_model), 2))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    moe.apply_moe(p, x, cfg).square().sum().backward()
    per_expert = p["wi"].grad.abs().sum(dim=(1, 2))
    assert float(per_expert.max()) > 0
    assert int((per_expert > 0).sum()) <= 16


# ----------------------- value and gradient against repro ----------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.25, 16.0])
def test_apply_moe_and_its_gradient_match_repro(cf, arch):
    """At binding capacity (0.5, the default 1.25) and ample (16): the output
    and the gradient of every parameter and of the input against
    ``jax.grad`` (deepseek-v3's block adds its shared expert)."""
    cfg, jcfg, jp, tp = _setup(cf=cf, arch=arch)
    x = _x((2, 32, cfg.d_model), 5)

    def jloss(p, xx):
        return jnp.sum(jnp.square(jmoe.apply_moe(p, xx, jcfg)))

    (jgp, jgx) = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    p = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    out = moe.apply_moe(p, xt, cfg)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg)), **MOE)
    out.square().sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=MOE_GRAD["rtol"],
                               atol=MOE_GRAD["atol"] * np.abs(np.asarray(jgx)).max())
    jflat = dict(_flat(jgp))
    for path, leaf in _flat(p):
        want = np.asarray(jflat[path])
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=MOE_GRAD["rtol"],
                                   atol=MOE_GRAD["atol"] * max(np.abs(want).max(), 1.0),
                                   err_msg=str(path))


def test_top_k_takes_the_lower_expert_on_ties():
    """``jax.lax.top_k``'s order on equal probabilities: a zero router makes
    every probability equal (experts 0..k-1 chosen); a router with two equal
    columns chooses the lower of the two."""
    cfg, jcfg, jp, tp = _setup()
    x = _x((1, 6, cfg.d_model), 6)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    _, _, topi = moe.route(torch.from_numpy(x), torch.from_numpy(router), 2)
    assert (topi == torch.tensor([0, 1])).all()
    router = np.random.default_rng(1).normal(0, 1, router.shape).astype(np.float32)
    router[:, 5] = router[:, 2]
    _, _, topi = moe.route(torch.from_numpy(x), torch.from_numpy(router), 2)
    _, jtopi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1), 2)
    assert topi.tolist() == np.asarray(jtopi).tolist()
    assert not (topi == 5).any() or (topi == 2).any()


def test_dispatch_and_combine_backward_gradcheck():
    """The dispatch/combine pair's hand-written backward against numerical
    differentiation in f64, at binding capacity (dropped choices included)."""
    cfg = dataclasses.replace(get_reduced_config("olmoe-1b-7b"), capacity_factor=0.5,
                              d_model=6, moe_d_ff=5)
    gen = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(6, cfg.n_experts, generator=gen, dtype=torch.float64),
         "wi": torch.randn(cfg.n_experts, 6, 5, generator=gen, dtype=torch.float64),
         "wg": torch.randn(cfg.n_experts, 6, 5, generator=gen, dtype=torch.float64),
         "wo": torch.randn(cfg.n_experts, 5, 6, generator=gen, dtype=torch.float64)}
    x = torch.randn(2, 12, 6, generator=gen, dtype=torch.float64, requires_grad=True)
    routed = []
    moe.apply_moe(p, x, cfg, routing_out=routed)
    r = routed[0]
    assert not r.choice_ok.all()

    def pair(xx, y):
        xs = moe._Dispatch.apply(xx.reshape(-1, 6), r.slot_tok, r.filled, r.choice_slot,
                                 r.choice_ok)
        rows = moe._Combine.apply(y, r.choice_slot, r.slot_choice, r.filled)
        return xs, rows * r.choice_ok[..., None]

    y = torch.randn(r.n_slots, 6, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(pair, (x, y))
    # the whole block's Jacobian at ample capacity against the dense oracle's
    # plain autograd (the router runs in f32, as the reference's, so finite
    # differences of the block are not f64-exact)
    ample = dataclasses.replace(cfg, capacity_factor=16.0)
    jac = torch.autograd.functional.jacobian(lambda xx: moe.apply_moe(p, xx, ample), x)
    oracle = torch.autograd.functional.jacobian(
        lambda xx: moe.moe_dense_reference(p, xx, ample), x)
    torch.testing.assert_close(jac, oracle, rtol=1e-10, atol=1e-10)


def test_backward_gathers_and_never_index_adds():
    """The block's graph holds the dispatch/combine pair and no row-gather
    backward (an ``index_add`` of up to k rows into a token: float atomics on
    the card)."""
    cfg, _, _, tp = _setup(cf=1.25)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 7)).requires_grad_()
    out = moe.apply_moe(p, x, cfg)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert {"_DispatchBackward", "_CombineBackward"} <= names, names
    assert not {n for n in names if n.startswith(("Index", "Embedding"))}, names


def test_moe_params_have_repro_names_shapes_and_axes():
    for arch in ARCHS:
        cfg = get_reduced_config(arch)
        jp, jspecs = jsplit(jmoe.make_moe(JMaker(jax.random.PRNGKey(0)), jreduced(arch)))
        tp, specs = split_tree(moe.make_moe(Maker(torch.Generator().manual_seed(0), CPU), cfg))
        assert specs == jspecs
        for path, leaf in _flat(tp):
            assert tuple(leaf.shape) == np.shape(dict(_flat(jp))[path]), path
    # the model trees: stacked experts (L, E, d, f), and deepseek-v3's mtp tree
    for arch in ARCHS:
        cfg, jcfg = get_reduced_config(arch), jreduced(arch)
        jp, jspecs = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
        tp, specs = model_zoo.init_params(cfg, device=CPU)
        assert specs == jspecs
        assert {p: tuple(t.shape) for p, t in _flat(tp)} == \
            {p: np.shape(t) for p, t in _flat(jp)}
    assert "mtp" in tp and specs["segments"][1]["moe"]["wi"] == ("layers", "experts", "embed",
                                                                 "ff")


# ------------------------------ the model's loss ------------------------------
def check_lm_loss(arch, precision, monkeypatch):
    """The MoE model's loss (deepseek-v3's with its multi-token-prediction
    term) against ``repro``'s.

    f32 (the casts taken out): the loss and every parameter's gradient
    against ``jax.value_and_grad`` at the default capacity factor, where
    capacity binds, at ``F32_*``. bf16: the loss against ``repro``'s
    op-by-op run (``jax.disable_jit``) at capacity factor 16, as the
    reference's parity test runs the MoE models, within ``BF16_LOSS``
    (doubled for deepseek-v3, as the reference doubles its parity tolerance
    there). A route that bf16 rounding flips moves the loss by a step, not
    by noise: at the default capacity ``repro``'s own jitted run leaves its
    op-by-op run by 0.011 (olmoe) and 0.044 (deepseek-v3)."""
    if precision == "f32":
        _uncast(monkeypatch)
        cfg, jcfg, jp, tp, jb, tb = _both(arch)
        jloss, jgrads = jax.value_and_grad(jzoo.loss_fn(jcfg, remat="none"))(jp, jb)
        loss, grads = _port_grads(cfg, tp, tb)
        jflat = dict(_flat(jgrads))
        assert set(jflat) == set(grads)
        if cfg.mtp:
            assert any(path[0] == "mtp" and float(g.abs().max()) > 0
                       for path, g in grads.items())
        np.testing.assert_allclose(loss, float(jloss), **F32_LOSS)
        for path, g in grads.items():
            want = np.asarray(jflat[path])
            np.testing.assert_allclose(g.numpy(), want, rtol=F32_GRAD["rtol"],
                                       atol=F32_GRAD["atol"] * max(np.abs(want).max(), 1.0),
                                       err_msg=str(path))
        return
    cfg, jcfg, jp, tp, jb, tb = _both(arch, capacity_factor=16.0)
    with jax.disable_jit():
        jloss = float(jzoo.loss_fn(jcfg, remat="none")(jp, jb))
    with torch.no_grad():
        loss = float(model_zoo.loss_fn(cfg, "none")(tp, tb))
    widen = 2 if arch == "deepseek-v3-671b" else 1
    assert abs(loss - jloss) < widen * BF16_LOSS, (loss, jloss)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lm_loss_and_gradients_match_repro(precision, monkeypatch):
    check_lm_loss("olmoe-1b-7b", precision, monkeypatch)


def test_remat_modes_give_the_same_loss_and_gradients():
    check_remat("olmoe-1b-7b")


def check_remat(arch):
    cfg, _, _, tp, _, tb = _both(arch)
    loss, grads = _port_grads(cfg, tp, tb, "none")
    for remat in ("full", "dots"):
        loss_r, grads_r = _port_grads(cfg, tp, tb, remat)
        assert loss_r == loss
        for path, g in grads.items():
            assert torch.equal(grads_r[path], g), (remat, path)


# ------------------- port of tests/test_train.py (olmoe) ----------------------
def test_train_loop_descends_and_resumes(tmp_path):
    from repro_torch.data.pipeline import synthetic_data_fn
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainLoopConfig, run

    cfg = get_reduced_config("olmoe-1b-7b")
    params, _ = model_zoo.init_params(cfg, 0, CPU, dtype=torch.float32)
    data_fn = synthetic_data_fn(cfg, batch=4, seq=32, device=CPU)
    ckdir = str(tmp_path / "ck")
    loop1 = TrainLoopConfig(total_steps=12, ckpt_every=6, ckpt_dir=ckdir, log_every=2)
    _, _, hist1 = run(model_zoo.loss_fn(cfg, remat="none"), params, data_fn, loop1,
                      OptConfig(lr=1e-3, warmup_steps=2))
    assert hist1[-1]["loss"] < hist1[0]["loss"]
    assert ckpt.latest_step(ckdir) == 12

    # resume: a fresh invocation continues from step 12 to 18
    fresh, _ = model_zoo.init_params(cfg, 0, CPU, dtype=torch.float32)
    loop2 = TrainLoopConfig(total_steps=18, ckpt_every=6, ckpt_dir=ckdir, log_every=2)
    _, o2, hist2 = run(model_zoo.loss_fn(cfg, remat="none"), fresh, data_fn, loop2,
                       OptConfig(lr=1e-3, warmup_steps=2))
    assert int(o2["step"]) == 18
    assert ckpt.latest_step(ckdir) == 18
    assert hist2[0]["step"] == 13
