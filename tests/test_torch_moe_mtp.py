"""deepseek-v3-671b at reduced size on the CPU against ``repro``: MLA
beside the experts, a shared expert, a leading dense layer, and the
multi-token-prediction loss (the last part of ROADMAP A18). Its whole-model
loss and gradients through ``test_torch_moe.check_lm_loss`` (the same
bounds as olmoe's, doubled where the reference doubles its own), the MTP
term itself, and rematerialisation."""
import dataclasses

import pytest
import torch

from repro_torch.models import model_zoo, transformer
from test_torch_attention import _both
from test_torch_moe import check_lm_loss, check_remat
from test_torch_serve_util import one_cpu_thread  # noqa: F401

ARCH = "deepseek-v3-671b"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lm_loss_and_gradients_match_repro(precision, monkeypatch):
    check_lm_loss(ARCH, precision, monkeypatch)


def test_mtp_loss_is_the_weighted_second_term():
    """Without its MTP term, deepseek-v3's loss is the plain next-token loss:
    the MTP term is ``mtp_loss_weight`` times the extra layer's loss."""
    cfg, _, _, tp, _, tb = _both("deepseek-v3-671b")
    with torch.no_grad():
        full = float(model_zoo.loss_fn(cfg, "none")(tp, tb))
        plain = float(model_zoo.loss_fn(dataclasses.replace(cfg, mtp=False), "none")(tp, tb))
        x, pos = transformer.embed_inputs(tp, tb, cfg)
        h = transformer.apply_norm(tp["final_norm"],
                                   transformer._run_segments(tp["segments"], x, cfg, pos, "none"),
                                   cfg.norm_eps)
        mtp = float(transformer._mtp_loss(tp, h, tb, cfg, pos))
    assert abs(full - (plain + cfg.mtp_loss_weight * mtp)) < 1e-5


def test_remat_modes_give_the_same_loss_and_gradients():
    check_remat(ARCH)
