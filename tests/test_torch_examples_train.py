"""``repro_torch.launch.train_lm`` (the port of ``examples/train_lm.py``)
against ``repro``'s same flow, written out here: ``--small`` (internlm2 at
width 128, 4 layers, vocab 8,000) for 5 steps from ``repro``'s
``PRNGKey(0)`` weights carried across as f32, 4 x 128 tokens from the page
data path, an async checkpoint every step, the "preemption" at step 3 and
the resume, every step logged in both. Every step's loss and gradient norm
within ``test_torch_rwkv``'s bf16 bounds as the packages ship, and within
``test_torch_train.py``'s f32 bounds with f32 activations in both (its
uncast embedding), where a frozen update or a stale restore shows; both
resumed at the same step, the final step the budget; and the example's
quirk under 4 steps."""
import argparse
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch import train_lm
from repro_torch.models.params import params_from_numpy
from test_torch_rwkv import BF16_GRAD_REL, BF16_LOSS, _uncast
from test_torch_serve_util import one_cpu_thread  # noqa: F401

STEPS = 5
# test_train_loop_follows_repro_over_steps' bounds (f32 activations)
F32_LOSS_RTOL, F32_GRAD_NORM_RTOL = 1e-4, 1e-3


def _repro_flow(tmp, steps, params):
    """``examples/train_lm.py``'s two phases through ``repro`` at ``--small``:
    the history of both phases and the step each reached."""
    from repro.configs import get_config
    from repro.data.pipeline import PageTokenDataset
    from repro.models import model_zoo
    from repro.train.optimizer import OptConfig
    from repro.train.train_loop import TrainLoopConfig, run

    cfg = dataclasses.replace(get_config("internlm2-20b"), **train_lm.SMALL)
    ds = PageTokenDataset(os.path.join(tmp, "tokens.heap"), n_seqs=256, seq_len=128,
                          vocab=cfg.vocab_size)
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=steps // 4,
                           ckpt_dir=os.path.join(tmp, "ckpt"), log_every=train_lm.LOG_EVERY,
                           async_checkpoint=True)
    opt = OptConfig(lr=3e-4, warmup_steps=20)
    data = lambda s: ds.batch(s, 4)  # noqa: E731
    phase1 = dataclasses.replace(loop, total_steps=int(steps * 0.6))
    _, o1, h1 = run(model_zoo.loss_fn(cfg, remat="none"), params, data, phase1, opt)
    _, o2, h2 = run(model_zoo.loss_fn(cfg, remat="none"), params, data, loop, opt)
    return {"history": h1 + h2, "preempted_at": int(o1["step"]), "step": int(o2["step"]),
            "resumed_at": h2[0]["step"] - 1}


def _weights():
    from repro.configs import get_config as jget
    from repro.models import model_zoo as jzoo

    jcfg = dataclasses.replace(jget("internlm2-20b"), **train_lm.SMALL)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _args(tmp, steps):
    return train_lm.build_parser().parse_args(
        ["--small", "--steps", str(steps), "--device", "cpu", "--workdir", tmp])


def _both(tmp_path_factory, f32):
    """Both flows from the same weights, every step logged; with f32
    activations in both where ``f32``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_lm, "LOG_EVERY", 1)
        if f32:
            _uncast(mp)
        jp, npt = _weights()
        want = _repro_flow(str(tmp_path_factory.mktemp("repro")), STEPS, jp)
        tp = params_from_numpy(train_lm.build_cfg(True), npt, device="cpu", dtype=torch.float32)
        got = train_lm.flow(_args(str(tmp_path_factory.mktemp("port")), STEPS), params=tp)
    assert [r["step"] for r in got["history"]] == [r["step"] for r in want["history"]] \
        == list(range(1, STEPS + 1))
    return got, want


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return _both(tmp_path_factory, f32=False)


@pytest.fixture(scope="module")
def both_f32(tmp_path_factory):
    return _both(tmp_path_factory, f32=True)


def _series(run, key):
    return [r[key] for r in run["history"]]


def test_losses_follow_repro(both):
    got, want = both
    np.testing.assert_allclose(_series(got, "loss"), _series(want, "loss"), rtol=BF16_LOSS)
    np.testing.assert_allclose(_series(got, "grad_norm"), _series(want, "grad_norm"),
                               rtol=BF16_GRAD_REL)


def test_every_step_follows_repro_in_f32(both_f32):
    """With f32 activations only the order of sums differs: every step's
    loss and gradient norm, across the preemption and the resume."""
    got, want = both_f32
    np.testing.assert_allclose(_series(got, "loss"), _series(want, "loss"), rtol=F32_LOSS_RTOL)
    np.testing.assert_allclose(_series(got, "grad_norm"), _series(want, "grad_norm"),
                               rtol=F32_GRAD_NORM_RTOL)
    assert got["resumed_at"] == want["resumed_at"] == 3


def test_resume_at_the_same_step_and_end_at_the_budget(both):
    got, want = both
    assert got["preempted_at"] == want["preempted_at"] == int(STEPS * train_lm.PREEMPT_AT)
    assert got["resumed_at"] == want["resumed_at"] == 3
    assert got["step"] == want["step"] == STEPS
    assert got["lines"][-1] == "OK" and got["n_params"] > 0


def test_under_4_steps_the_checkpoint_interval_is_0_in_both(tmp_path):
    """The example's ``ckpt_every=steps // 4`` is 0 under 4 steps, and both
    packages' loops then raise ``ZeroDivisionError`` after the first step:
    a reference quirk, matched (ROADMAP §C)."""
    jp, npt = _weights()
    with pytest.raises(ZeroDivisionError):
        _repro_flow(str(tmp_path / "repro"), 3, jp)
    tp = params_from_numpy(train_lm.build_cfg(True), npt, device="cpu", dtype=torch.float32)
    with pytest.raises(ZeroDivisionError):
        train_lm.flow(_args(str(tmp_path / "port"), 3), params=tp)


def test_flow_draws_its_own_weights_in_a_temporary_directory():
    args = argparse.Namespace(small=True, steps=4, batch=2, seq=16, device="cpu", workdir=None)
    out = train_lm.flow(args)
    assert out["step"] == 4 and out["preempted_at"] == 2 and out["resumed_at"] == 2
