"""Prefill against decode in the port, for every arch whose attention the
port serves (a port of ``tests/test_prefill_decode_parity.py``'s
``test_prefill_equals_decode``): the training-form attention over the whole
sequence and the per-token cache updates must give the same last-position
logits. Beside it, the port's prefill against ``repro``'s on the same
weights (``params_from_numpy``) and tokens.

Tolerances: the reference test's 3e-2 on the logits (6e-2 for
deepseek-v3) and an equal argmax;
for the VLM backbone, whose zero patches still take positions, the argmax
only, as there. Against ``repro``, ``BF16_LOGITS``: both packages run bf16
activations and round them at other places (``test_torch_models.py``'s
bound for the decode logits); for the hybrid family
``test_torch_hybrid.HYBRID_BF16_LOGITS``, where ``repro``'s own logits move
as far between its jitted and its op-by-op run, and ``MOE_BF16_LOGITS`` for
the MoE models, on the same measure."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_reduced_config
from repro_torch.models import model_zoo
from repro_torch.models.params import params_from_numpy
from test_torch_hybrid import HYBRID_BF16_LOGITS
from test_torch_serve_util import CPU, one_cpu_thread  # noqa: F401

SEQ = 24
SERVED = ["internlm2-20b", "mistral-nemo-12b", "deepseek-67b", "internvl2-26b",
          "minicpm3-4b", "hymba-1.5b", "hymba-swa", "olmoe-1b-7b", "deepseek-v3-671b"]
BF16_LOGITS = dict(rtol=0, atol=5e-2)
# reduced hymba makes both its layers global; "hymba-swa" keeps one global
# layer, so the other is a sliding-window layer (window 16 < SEQ). The MoE
# models run at capacity factor 16, as the reference's test runs them:
# capacity drops are first come, first served over a routing group, and
# prefill's groups are sequences where decode's is the batch, so parity
# holds only where capacity does not bind
OVERRIDES = {"hymba-swa": ("hymba-1.5b", dict(n_global_layers=1)),
             "olmoe-1b-7b": ("olmoe-1b-7b", dict(capacity_factor=16.0)),
             "deepseek-v3-671b": ("deepseek-v3-671b", dict(capacity_factor=16.0))}
# the reference's prefill-vs-decode tolerance: 3e-2, 6e-2 for deepseek-v3 (its
# deepest bf16 chain: q_lora + MLA + router + shared expert)
PARITY_TOL = {"deepseek-v3-671b": 6e-2}
# against repro, the MoE models: repro's own jitted and op-by-op prefill part
# by 0.055 on reduced olmoe and by 0.23 on reduced deepseek-v3 (the port sits
# within 0.008 of the op-by-op run on olmoe); BF16_LOGITS doubled, as the
# reference's own parity test doubles its tolerance for deepseek-v3
MOE_BF16_LOGITS = dict(rtol=0, atol=2 * BF16_LOGITS["atol"])


def _setup(arch):
    arch, over = OVERRIDES.get(arch, (arch, {}))
    cfg, jcfg = get_reduced_config(arch, **over), jreduced(arch, **over)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    tokens = np.random.default_rng(7).integers(1, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.vis_tokens:
        # the decode path has no patch injection: zero patches stand in
        batch["patches"] = np.zeros((2, cfg.vis_tokens, cfg.d_model), np.float32)
    return cfg, jcfg, jp, tp, batch


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_equals_decode(arch):
    cfg, _, _, tp, batch = _setup(arch)
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        want = model_zoo.prefill_fn(cfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        step = model_zoo.decode_fn(cfg)
        cache = model_zoo.make_cache(cfg, 2, SEQ + cfg.vis_tokens + 1, CPU)
        for t in range(SEQ):
            logits, cache = step(tp, tokens[:, t], cache, cfg.vis_tokens + t)
    got, ref = logits.float().numpy(), want.float().numpy()
    assert got.shape == ref.shape == (2, cfg.padded_vocab)
    if not cfg.vis_tokens:
        tol = PARITY_TOL.get(arch, 3e-2)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=arch)
    assert np.all(got.argmax(-1) == ref.argmax(-1)), arch


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_matches_repro(arch, remat):
    cfg, jcfg, jp, tp, batch = _setup(arch)
    want = np.asarray(jzoo.prefill_fn(jcfg, remat=remat)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}), np.float32)
    with torch.no_grad():
        got = model_zoo.prefill_fn(cfg, remat=remat)(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}).float().numpy()
    tol = {"hybrid": HYBRID_BF16_LOGITS, "moe": MOE_BF16_LOGITS}.get(cfg.family, BF16_LOGITS)
    np.testing.assert_allclose(got, want, **tol, err_msg=arch)
