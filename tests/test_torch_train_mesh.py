"""LM training on a mesh (``repro_torch.train`` under ``meshes.use_mesh``)
against ``repro``: the optimizer state's logical specs and their resolution
on abstract meshes for every family, the one-rank host mesh of a lone
process (the same bits as no mesh, through ``run`` and the launcher),
checkpoints that cross between the packages with ``shardings=``; and one
spawn of 8 gloo ranks on a (4 data x 2 model) mesh (``test_torch_dist_util``'s
``train_mesh`` case), held against ``repro``'s unsharded ``train_loop.run``
and the port's unsharded runs computed here while the ranks run, with every
whole leaf the same bits on every rank and no collective but
``all_reduce``, ``broadcast`` and ``barrier``. The other families train on
the mesh in ``test_torch_train_mesh_moe_mla.py`` and
``test_torch_train_mesh_hybrid_encdec_vlm.py``, through ``train_families``
and the checks below."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_util as dist_util
from repro.configs import get_reduced_config as jreduced
from repro.dist import meshes as jmeshes
from repro.models import model_zoo as jzoo
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.data.pipeline import synthetic_data_fn
from repro_torch.dist import meshes
from repro_torch.models import model_zoo
from repro_torch.models.params import params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_init,
    make_train_step,
    param_shardings,
    state_shardings,
    state_specs,
)
from repro_torch.train.train_loop import TrainLoopConfig, run
from test_torch_rwkv import BF16_LOSS, F32_GRAD
from test_torch_serve_util import one_cpu_thread  # noqa: F401

CPU = "cpu"
WORLD = 8
# the bounds of test_torch_train.py::test_train_loop_follows_repro_over_steps
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
# a bf16 gradient leaf against another, relative to its norm
# (test_torch_attention's bound): bf16 activations round apart where the
# rows a matmul sees differ. The weights themselves are not compared:
# AdamW's first steps move each element by about lr whatever its
# gradient's size, so a gradient element near 0 that the rounding flips
# moves its weight by 2 lr
from test_torch_attention import BF16_GRAD_REL  # noqa: E402
ABSTRACT_MESHES = ((2, 4), (4, 2), (8, 1), (1, 8))


# ------------------------- specs on abstract meshes ----------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_resolve_as_in_repro(arch):
    """The moments' logical specs (the ZeRO axis) and their resolution with
    the weights' on four abstract meshes: the specs and the fallback log
    equal repro's for the reduced parameter tree of every family."""
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    tp, tspecs = model_zoo.init_params(cfg, 0, CPU, dtype=torch.float32)
    box = {}

    def init(key):  # traced only: the shapes and the specs, no arrays
        params, box["specs"] = jzoo.init_params(jcfg, key)
        return params

    jp = jax.eval_shape(init, jax.random.PRNGKey(0))
    jspecs = box["specs"]
    got_ss = state_specs(tspecs, OptConfig(), tp)
    want_ss = jopt.state_specs(jspecs, jopt.OptConfig(), jp)
    assert got_ss["step"] == want_ss["step"] == ()
    assert jax.tree.leaves(got_ss["mu"], is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.leaves(want_ss["mu"], is_leaf=lambda x: isinstance(x, tuple))
    for sizes in ABSTRACT_MESHES:
        names = ("data", "model")
        with meshes.use_mesh(None), jmeshes.use_mesh(None):
            mesh, jmesh = meshes.AbstractMesh(sizes, names), jax.sharding.AbstractMesh(sizes,
                                                                                       names)
            got = meshes.tree_shardings(got_ss, {"mu": tp, "nu": tp, "step": torch.zeros(())},
                                        mesh)
            want = jmeshes.tree_shardings(want_ss, {"mu": jp, "nu": jp,
                                                    "step": jax.ShapeDtypeStruct((), jnp.int32)},
                                          jmesh)
            gotp = meshes.tree_shardings(tspecs, tp, mesh)
            wantp = jmeshes.tree_shardings(jspecs, jp, jmesh)
            assert meshes.fallbacks() == jmeshes.fallbacks(), sizes
        spec = lambda s: tuple(s.spec)
        assert [spec(s) for _, s in ckpt._flatten(got)] == \
            [tuple(s.spec) for s in jax.tree.leaves(want)], sizes
        assert [spec(s) for _, s in ckpt._flatten(gotp)] == \
            [tuple(s.spec) for s in jax.tree.leaves(wantp)], sizes


# -------------------------- the one-rank host mesh ------------------------------
def _rwkv(seed=3):
    cfg, jcfg = get_reduced_config("rwkv6-3b"), jreduced("rwkv6-3b")
    npt = jax.tree.map(np.asarray, jzoo.init_params(jcfg, jax.random.PRNGKey(seed))[0])
    return cfg, jcfg, npt


def test_one_rank_host_mesh_trains_to_the_same_bits(tmp_path, one_cpu_thread):  # noqa: F811
    cfg, _, npt = _rwkv()
    _, specs = model_zoo.init_params(cfg, 0, CPU, dtype=torch.float32)
    out = []
    for mesh in (None, meshes.make_host_mesh(device=CPU)):
        params = params_from_numpy(cfg, npt, device=CPU, dtype=torch.float32)
        with meshes.use_mesh(mesh):
            p, opt, hist = run(model_zoo.loss_fn(cfg, remat="none"), params,
                               synthetic_data_fn(cfg, 4, 16, device=CPU),
                               TrainLoopConfig(total_steps=3, ckpt_every=2, log_every=1,
                                               ckpt_dir=str(tmp_path / str(mesh is None))),
                               OptConfig(**dist_util.MESH_OPT), param_specs=specs)
        out.append((p, opt, hist))
    (p0, o0, h0), (p1, o1, h1) = out
    assert [(r["loss"], r["grad_norm"]) for r in h0] == [(r["loss"], r["grad_norm"]) for r in h1]
    for (_, a), (_, b) in zip(ckpt._flatten({"p": p0, "o": o0}), ckpt._flatten({"p": p1, "o": o1})):
        assert not meshes.is_dtensor(b) and torch.equal(a, b)


def test_launcher_host_mesh_trains_to_the_same_bits_as_none(tmp_path, one_cpu_thread):  # noqa: F811
    from repro_torch.launch import train as train_cli

    hist = {}
    for mesh in ("none", "host"):
        hist[mesh] = train_cli.main(["--arch", "rwkv6-3b", "--reduced", "--device", CPU,
                                     "--steps", "3", "--batch", "2", "--seq", "16",
                                     "--data-path", "pages", "--mesh", mesh,
                                     "--ckpt-dir", str(tmp_path / mesh)])
    strip = lambda h: [(r["step"], r["loss"], r["grad_norm"], r["lr"]) for r in h]
    assert strip(hist["host"]) == strip(hist["none"]) and len(hist["host"]) == 1


def test_launcher_mesh_flags_default_to_host():
    from repro.launch import train as jtrain_cli
    from repro_torch.launch import common

    ap = __import__("argparse").ArgumentParser()
    common.add_mesh_flags(ap, default_mesh="host")
    assert ap.parse_args([]).mesh == "host"
    assert 'default_mesh="host"' in open(jtrain_cli.__file__).read()
    env = dict(os.environ)
    env.pop("WORLD_SIZE", None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", env)
        assert common.init_from_env(CPU) is False  # a lone process opens nothing
        env["WORLD_SIZE"] = "1"
        assert common.init_from_env(CPU) is False


# ------------------------ checkpoints with shardings= ---------------------------
def test_repro_checkpoint_restores_with_shardings_and_back(tmp_path):
    cfg, jcfg, npt = _rwkv()
    jp = jax.tree.map(jnp.asarray, npt)
    jstate = {"params": jp, "opt": jopt.adamw_init(jp, jopt.OptConfig())}
    jstate["opt"]["step"] = jnp.int32(4)
    jckpt.save(str(tmp_path / "j"), 4, jstate)
    _, specs = model_zoo.init_params(cfg, 0, CPU, dtype=torch.float32)
    mesh = meshes.make_host_mesh(device=CPU)
    with meshes.use_mesh(mesh):
        tp = params_from_numpy(cfg, npt, device=CPU, dtype=torch.float32)
        opt_cfg = OptConfig()
        template = {"params": tp, "opt": adamw_init(tp, opt_cfg, param_specs=specs)}
        sh = {"params": param_shardings(tp, mesh, specs),
              "opt": state_shardings(tp, opt_cfg, mesh, specs)}
        got, step = ckpt.restore(str(tmp_path / "j"), template, shardings=sh)
    assert step == 4 and int(got["opt"]["step"]) == 4
    for (name, a), b in zip(ckpt._flatten(got["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    ckpt.save(str(tmp_path / "t"), 4, got)
    back, step = jckpt.restore(str(tmp_path / "t"), jstate)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bad", ["missing_key", "leaf_for_tree", "not_a_sharding"])
def test_shardings_that_do_not_match_the_template_raise(tmp_path, bad):
    state = {"params": {"w": torch.ones(4, 2), "b": [torch.zeros(2)]},
             "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    ckpt.save(str(tmp_path / "ck"), 1, state)
    mesh = meshes.make_host_mesh(device=CPU)
    rep = meshes.replicated(mesh)
    sh = {"params": {"w": rep, "b": [rep]}, "opt": {"step": rep}}
    ckpt.restore(str(tmp_path / "ck"), state, shardings=sh)  # the matching tree places
    if bad == "missing_key":
        del sh["params"]["b"]
    elif bad == "leaf_for_tree":
        sh["params"]["b"] = rep
    else:
        sh["opt"]["step"] = None
    with pytest.raises(ValueError, match="shardings do not match"):
        ckpt.restore(str(tmp_path / "ck"), state, shardings=sh)


# ------------------------------- 8 gloo ranks -----------------------------------
@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Write repro's reduced rwkv6-3b weights and a repro checkpoint, start 8
    gloo ranks (dist_util.case_train_mesh), and compute meanwhile repro's
    unsharded run and steps and the port's from the same inputs."""
    work = str(tmp_path_factory.mktemp("train_mesh_8"))
    cfg, jcfg, npt = _rwkv()
    torch.save(npt, os.path.join(work, "rwkv_weights.pt"))
    jp = jax.tree.map(jnp.asarray, npt)
    jstate = {"params": jp, "opt": jopt.adamw_init(jp, jopt.OptConfig())}
    jstate["opt"]["step"] = jnp.int32(7)
    jckpt.save(os.path.join(work, "repro_ck"), 7, jstate)
    started = dist_util.start("train_mesh", WORLD, work)
    try:
        with torch.inference_mode(False):
            want = _unsharded(cfg, jcfg, npt, work)
    finally:
        ranks = dist_util.collect(started)
    return ranks, want, work, npt, jstate


def _unsharded(cfg, jcfg, npt, work):
    from repro.data import pipeline as jpipeline
    from repro.train import train_loop as jloop
    from test_torch_rwkv import _uncast

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    want = {}
    loop = dict(total_steps=6, ckpt_every=1000, log_every=1)
    opt = dist_util.MESH_OPT
    try:
        with pytest.MonkeyPatch.context() as mp:
            _uncast(mp)
            jparams, _, jhist = jloop.run(
                jzoo.loss_fn(jcfg, remat="none"), jax.tree.map(jnp.asarray, npt),
                jpipeline.synthetic_data_fn(jcfg, dist_util.MESH_BATCH, dist_util.MESH_SEQ),
                jloop.TrainLoopConfig(ckpt_dir=os.path.join(work, "j"), **loop),
                jopt.OptConfig(**opt))
            tp = params_from_numpy(cfg, npt, device=CPU, dtype=torch.float32)
            p, o, hist = run(model_zoo.loss_fn(cfg, remat="none"), tp,
                             synthetic_data_fn(cfg, dist_util.MESH_BATCH, dist_util.MESH_SEQ,
                                               device=CPU),
                             TrainLoopConfig(ckpt_dir=os.path.join(work, "t"), **loop),
                             OptConfig(**opt))
            step_fn = make_train_step(model_zoo.loss_fn(cfg, remat="none"), OptConfig(**opt))
            jstep = jax.jit(jopt.make_train_step(jzoo.loss_fn(jcfg, remat="none"),
                                                 jopt.OptConfig(**opt)))
            for name, rows in (("unequal", 8), ("six_rows", 6)):
                nb = {k: v[:rows] for k, v in
                      dist_util.unequal_mask_batch(cfg.vocab_size).items()}
                tp = params_from_numpy(cfg, npt, device=CPU, dtype=torch.float32)
                tp, _, m = step_fn(tp, adamw_init(tp, OptConfig(**opt)),
                                   {k: torch.from_numpy(v) for k, v in nb.items()})
                jp = jax.tree.map(jnp.asarray, npt)
                _, _, jm = jstep(jp, jopt.adamw_init(jp, jopt.OptConfig(**opt)),
                                 {k: jnp.asarray(v) for k, v in nb.items()})
                want[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                              "params": {k: v.detach().numpy() for k, v in ckpt._flatten(tp)},
                              "repro_loss": float(jm["loss"]),
                              "repro_grad_norm": float(jm["grad_norm"])}
        want["repro_history"], want["history"] = jhist, hist
        want["params"] = {k: v.detach().numpy() for k, v in ckpt._flatten(p)}
        want["repro_params"] = {k: np.asarray(v) for (k, _), v in
                                zip(ckpt._flatten(p), jax.tree.leaves(jparams))}
    finally:
        torch.set_num_threads(threads)
    return want


def _same_on_every_rank(ranks, key, sub):
    first = ranks[0][key][sub]
    for r in ranks[1:]:
        assert r[key][sub].keys() == first.keys()
        for name, v in r[key][sub].items():
            assert np.array_equal(v, first[name]) and v.dtype == first[name].dtype, name


def test_8_ranks_follow_repros_unsharded_run(eight_ranks):
    """Six steps on (4 x 2) against repro's unsharded train_loop.run: the
    same losses and gradient norms at the single-card test's bounds; the
    final weights at F32_GRAD from repro's and from the port's unsharded
    run; the same bits on every rank; only all_reduce and broadcast."""
    ranks, want, _, _, _ = eight_ranks
    jhist = want["repro_history"]
    for r in ranks:
        hist = r["run"]["history"]
        assert [h["step"] for h in hist] == [h["step"] for h in jhist] == list(range(1, 7))
        np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose([h["grad_norm"] for h in hist],
                                   [h["grad_norm"] for h in jhist], rtol=GNORM_RTOL)
        for name, v in r["run"]["params"].items():
            np.testing.assert_allclose(v, want["repro_params"][name], err_msg=name, **F32_GRAD)
            np.testing.assert_allclose(v, want["params"][name], err_msg=name, **F32_GRAD)
        assert r["forbidden"] == []
        assert set(r["run"]["collectives"]) == {"all_reduce", "broadcast"}
    _same_on_every_rank(ranks, "run", "params")
    _same_on_every_rank(ranks, "run", "opt")


def test_8_ranks_place_weights_and_moments_as_resolved(eight_ranks):
    """Weights on the model axis by their specs, moments by state_specs:
    the zero axis on the data axis, the step replicated."""
    ranks, _, _, _, _ = eight_ranks
    r = ranks[0]["run"]
    assert r["placements"]["embed/table"] == ["R", "S(0)"]  # vocab on model
    assert r["placements"]["segments/0/cmix/wk"] == ["R", "S(2)"]  # ff on model
    assert r["placements"]["final_norm/scale"] is None  # replicated: a whole tensor
    for name, spec in r["opt_specs"].items():
        want = ["R", "R"]
        for dim, entry in enumerate(spec):
            for axis in meshes.entry_axes(entry):
                want[("data", "model").index(axis)] = f"S({dim})"
        assert r["opt_placements"][name] == (None if want == ["R", "R"] else want), name
    assert r["opt_placements"]["mu/segments/0/cmix/wk"] == ["S(1)", "S(2)"]
    assert r["opt_placements"]["nu/final_norm/scale"] == ["S(0)", "R"]
    assert r["opt_specs"]["mu/embed/table"] == ("model", "data")  # vocab, zero
    assert r["opt_placements"]["step"] is None


def _batch_fallbacks(got):
    """The drops the step recorded for the batch's leaves (the moments'
    placement records its own in the same block)."""
    return [f for f in got["fallbacks"] if f[0] in ("loss_mask", "targets", "tokens")]


def test_8_ranks_loss_is_the_global_batchs_under_unequal_masks(eight_ranks):
    """Ranks with 32, 21, 9 and 0 loss tokens: the loss is the global
    batch's (the mean of the ranks' means is not), and the step equals the
    unsharded one; the loss and the gradient norm are repro's unsharded
    step's at the bounds of the run above."""
    ranks, want, _, _, _ = eight_ranks
    w = want["unequal"]
    for r in ranks:
        got = r["unequal"]
        np.testing.assert_allclose(got["loss"], w["repro_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], w["repro_grad_norm"], rtol=GNORM_RTOL)
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-4)
        for name, v in got["params"].items():
            np.testing.assert_allclose(v, w["params"][name], err_msg=name, **F32_GRAD)
        assert got["collectives"]["all_reduce"] >= 3  # counts, loss, gradient buckets
        assert _batch_fallbacks(got) == []
    _same_on_every_rank(ranks, "unequal", "params")


def test_unequal_masks_tell_the_global_mean_from_the_mean_of_means(one_cpu_thread):  # noqa: F811
    """The batch of the test above gives 4 data ranks 32, 21, 9 and 0 loss
    tokens, and the mean of the ranks' own means is 3% off the global
    batch's: a step that averaged the ranks' losses would fail there."""
    cfg, _, npt = _rwkv()
    b = dist_util.unequal_mask_batch(cfg.vocab_size)
    counts = b["loss_mask"].reshape(4, 2, -1).sum(axis=(1, 2))
    assert counts.tolist() == [32, 21, 9, 0]
    tp = params_from_numpy(cfg, npt, device=CPU, dtype=torch.float32)
    loss = model_zoo.loss_fn(cfg, remat="none")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        whole = float(loss(tp, tb))
        means = [float(loss(tp, {k: v[2 * i:2 * i + 2] for k, v in tb.items()}))
                 for i in range(4)]
    assert abs(np.mean(means) - whole) / whole > 3e-2


@pytest.mark.parametrize("name", ["micro2", "fsdp"])
def test_8_ranks_microbatches_and_fsdp_rules_take_the_same_step(eight_ranks, name):
    """The unequal-mask step again, each rank's rows in 2 microbatches
    (gradients summed over the pieces, then over the data axes), and with
    weights and moments placed by FSDP's rules (the embed dim over the data
    axes too, made whole on use; a rank updates its own region and sends
    nothing): the same loss and weights as the one-piece default step, the
    same on every rank."""
    ranks = eight_ranks[0]
    for got in ranks:
        want = got["unequal"]
        assert got[name]["loss"] == pytest.approx(want["loss"], rel=1e-6)
        assert got[name]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
        for k, w in want["params"].items():
            np.testing.assert_allclose(got[name]["params"][k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    _same_on_every_rank(ranks, name, "params")
    if name == "fsdp":  # FSDP's rules place some weights other than the default's
        fsdp, default = ranks[0]["fsdp"]["placements"], ranks[0]["run"]["placements"]
        assert fsdp.keys() == default.keys()
        assert any(fsdp[k] != default[k] for k in fsdp)


def test_8_ranks_batch_that_does_not_divide_stays_whole(eight_ranks):
    """6 rows on 4 data ranks: the drop recorded with repro's resolver text,
    every rank on the whole batch, no reduction over the data axis, and the
    unsharded step's result (the loss and the gradient norm also repro's)."""
    ranks, want, _, _, _ = eight_ranks
    w = want["six_rows"]
    with meshes.use_mesh(None), jmeshes.use_mesh(None):
        jmesh = jax.sharding.AbstractMesh((4, 2), ("data", "model"))
        for key in ("loss_mask", "targets", "tokens"):
            jmeshes.resolve_spec(("batch", None), (6, dist_util.MESH_SEQ), jmesh,
                                 tensor_name=key)
        jfall = jmeshes.fallbacks()
    for r in ranks:
        got = r["six_rows"]
        assert _batch_fallbacks(got) == jfall and len(jfall) == 3
        np.testing.assert_allclose(got["loss"], w["repro_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], w["repro_grad_norm"], rtol=GNORM_RTOL)
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-6)
        for name, v in got["params"].items():
            np.testing.assert_allclose(v, w["params"][name], rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        # no count, loss or gradient sum: only the weights made whole and the
        # moments' regions broadcast
        assert got["collectives"]["all_reduce"] == 0
    _same_on_every_rank(ranks, "six_rows", "params")


def test_8_ranks_checkpoints_write_the_logical_format(eight_ranks):
    """The async and the sync checkpoint of the placed state: rank 0 wrote
    them, their manifest is an unsharded save's, and repro restores them
    to the ranks' whole leaves."""
    ranks, _, work, _, jstate = eight_ranks
    whole = dict(ranks[0]["run"]["params"])
    for name in ("async_ck", "sync_ck"):
        path = os.path.join(work, name, "step_00000006")
        assert sorted(os.listdir(os.path.join(work, name))) == ["step_00000006"]
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        cfg = get_reduced_config("rwkv6-3b")
        tp, _ = model_zoo.init_params(cfg, 0, CPU, dtype=torch.float32)
        ckpt.save(os.path.join(work, "plain_" + name), 6,
                  {"params": tp, "opt": adamw_init(tp, OptConfig())})
        with open(os.path.join(work, "plain_" + name, "step_00000006", "manifest.json")) as f:
            assert manifest == json.load(f)
        back, step = jckpt.restore(os.path.join(work, name), jstate)
        assert step == 6 and int(back["opt"]["step"]) == 6
        flat = dict(zip((k for k, _ in ckpt._flatten(jstate["params"])),
                        jax.tree.leaves(back["params"])))
        for key, v in whole.items():
            np.testing.assert_array_equal(np.asarray(flat[key]), v, err_msg=key)


def test_8_ranks_restore_a_repro_checkpoint_with_shardings(eight_ranks):
    ranks, _, _, npt, jstate = eight_ranks
    want = {k: np.asarray(v) for k, v in zip(
        (k for k, _ in ckpt._flatten(jstate)), jax.tree.leaves(jstate))}
    for rank, r in enumerate(ranks):
        got = r["restored"]
        assert got["step"] == 7
        for name, v in got["whole"].items():
            np.testing.assert_array_equal(v, want[name], err_msg=name)
        # embed/table (512, 64): vocab rows on the model axis, no communication
        j = rank % 2
        np.testing.assert_array_equal(got["local"]["params/embed/table"],
                                      want["params/embed/table"][256 * j:256 * (j + 1)])
        assert got["placements"]["params/embed/table"] == ["R", "S(0)"]
    assert ranks[0]["restored"]["placements"]["opt/mu/embed/table"] == ["S(1)", "S(0)"]


# ------------------- every family (two files of three each) ---------------------
def train_families(archs, work):
    """Start 8 ranks of dist_util's ``train_families`` case on ``archs`` and
    compute meanwhile, from the same weights (the port's ``init_params``,
    seed 0) and batches, two unsharded steps of each in the port and in
    repro (its jitted train step from the same weights)."""
    with open(os.path.join(work, "families.json"), "w") as f:
        json.dump(list(archs), f)
    started = dist_util.start("train_families", WORLD, work)
    try:
        with torch.inference_mode(False):
            want = _families_unsharded(archs)
    finally:
        ranks = dist_util.collect(started)
    return ranks, want


def _families_unsharded(archs):
    from repro.data import pipeline as jpipeline

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    opt = dist_util.MESH_OPT
    want = {}
    try:
        for arch in archs:
            fcfg, jcfg = get_reduced_config(arch), jreduced(arch)
            fp, _ = model_zoo.init_params(fcfg, 0, CPU, dtype=torch.float32)
            shapes = jax.eval_shape(lambda k: jzoo.init_params(jcfg, k)[0],
                                    jax.random.PRNGKey(0))
            # copies: the port's step updates fp in place, and jnp.asarray
            # may share a numpy array's memory
            jp = jax.tree.unflatten(jax.tree.structure(shapes),
                                    [jnp.array(t.numpy(), s.dtype) for (_, t), s in
                                     zip(ckpt._flatten(fp), jax.tree.leaves(shapes))])
            data_fn = synthetic_data_fn(fcfg, dist_util.MESH_BATCH, dist_util.MESH_SEQ,
                                        device=CPU)
            jdata_fn = jpipeline.synthetic_data_fn(jcfg, dist_util.MESH_BATCH,
                                                   dist_util.MESH_SEQ)
            first, step_fn = dist_util.first_grads(model_zoo.loss_fn(fcfg, remat="none"),
                                                   OptConfig(**opt))
            jstep = jax.jit(jopt.make_train_step(jzoo.loss_fn(jcfg, remat="none"),
                                                 jopt.OptConfig(**opt)))
            o, jo = adamw_init(fp, OptConfig(**opt)), jopt.adamw_init(jp, jopt.OptConfig(**opt))
            w = {"losses": [], "grad_norms": [], "grads": first, "repro_losses": [],
                 "repro_grad_norms": []}
            for s in range(2):
                fp, o, _, m = step_fn(fp, o, data_fn(s), None)
                jp, jo, jm = jstep(jp, jo, jdata_fn(s))
                w["losses"].append(float(m["loss"]))
                w["grad_norms"].append(float(m["grad_norm"]))
                w["repro_losses"].append(float(jm["loss"]))
                w["repro_grad_norms"].append(float(jm["grad_norm"]))
            want[arch] = w
    finally:
        torch.set_num_threads(threads)
    return want


def check_family(families, arch):
    """Two steps on (4 x 2) against the unsharded port: losses and gradient
    norms at BF16_LOSS (bf16 activations), and every leaf of the first
    step's summed gradient at BF16_GRAD_REL of the unsharded one; the
    weights and the gradients the same bits on every rank."""
    ranks, want = families
    w = want[arch]
    for r in ranks:
        got = r[arch]
        np.testing.assert_allclose(got["losses"], w["losses"], rtol=BF16_LOSS)
        np.testing.assert_allclose(got["grad_norms"], w["grad_norms"], rtol=BF16_LOSS)
        assert got["grads"].keys() == w["grads"].keys()
        for name, g in got["grads"].items():
            ref = w["grads"][name]
            err = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
            assert err <= BF16_GRAD_REL, (name, err)
        assert r["forbidden"] == []
    _same_on_every_rank(ranks, arch, "params")
    _same_on_every_rank(ranks, arch, "grads")


def check_family_as_repro(families, arch):
    """The same two steps against repro's unsharded steps from the same
    weights and batches: losses and gradient norms at BF16_LOSS."""
    ranks, want = families
    w = want[arch]
    for r in ranks:
        np.testing.assert_allclose(r[arch]["losses"], w["repro_losses"], rtol=BF16_LOSS)
        np.testing.assert_allclose(r[arch]["grad_norms"], w["repro_grad_norms"],
                                   rtol=BF16_LOSS)
