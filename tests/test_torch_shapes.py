"""The shape cells of the port's ``models.model_zoo`` (``SHAPES``,
``shape_applicable``, ``input_specs``) against ``repro.models.model_zoo``'s,
for every architecture and shape: the same cells, the same skip texts, and
inputs of the same names, shapes and types; and the meta forms of
``init_params`` and ``make_cache`` (shapes only, nothing drawn)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model_zoo
from repro_torch.models.params import leaves

DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


def test_shapes_are_the_reference_cells():
    assert list(model_zoo.SHAPES) == list(jzoo.SHAPES)
    for name, s in model_zoo.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jzoo.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(jzoo.SHAPES))
def test_shape_cell_matches_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert model_zoo.shape_applicable(cfg, model_zoo.SHAPES[shape]) == \
        jzoo.shape_applicable(jcfg, jzoo.SHAPES[shape])
    got = model_zoo.input_specs(cfg, model_zoo.SHAPES[shape])
    want = jzoo.input_specs(jcfg, jzoo.SHAPES[shape])
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == DTYPES[w.dtype.type], k


def test_input_specs_on_another_device():
    cfg = get_config("internvl2-26b")
    got = model_zoo.input_specs(cfg, model_zoo.SHAPES["train_4k"], device="cpu")
    assert got["patches"].device.type == "cpu"
    assert got["tokens"].shape == (256, 4096 - cfg.vis_tokens)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "seamless-m4t-medium", "deepseek-v3-671b"])
def test_meta_init_params_and_cache_are_shapes_only(arch):
    """Full width on meta: as many parameters as the reference's abstract
    tree, and a cache on meta; nothing is allocated."""
    import jax

    cfg = get_config(arch)
    params, specs = model_zoo.init_params(cfg, device="meta", dtype=torch.float32)
    assert all(p.device.type == "meta" for p in leaves(params))
    jparams, _ = jzoo.init_params(jget_config(arch), abstract=True)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in leaves(params)) == want
    cache = model_zoo.make_cache(cfg, 2, 64, device="meta")
    assert all(c.device.type == "meta" for c in leaves(cache))


def test_meta_init_matches_a_drawn_init_in_shape():
    """The meta branch builds the same tree, shapes and types as a drawn
    one (reduced config, CPU)."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=2, d_model=64, d_ff=128,
                              n_heads=4, n_kv_heads=4, head_dim=16, vocab_size=128,
                              n_experts=4, experts_per_token=2, moe_d_ff=32)
    meta, mspecs = model_zoo.init_params(cfg, device="meta")
    real, rspecs = model_zoo.init_params(cfg, seed=3, device="cpu")
    assert mspecs == rspecs
    for m, r in zip(leaves(meta), leaves(real)):
        assert (m.shape, m.dtype) == (r.shape, r.dtype)
    assert np.isfinite(sum(float(r.float().sum()) for r in leaves(real)))
