"""The sharded server on 8 gloo CPU ranks, (4 data x 2 model), for every
served family against ``repro``'s unsharded server (``test_torch_dist_util``'s
``serve_families`` case), from ``repro``'s weights carried across by
``params_from_numpy``: MLA (minicpm3-4b: the latent cache's slots over data
with the join over them, and its paged pool over data made whole a layer),
the hybrid (hymba-1.5b: its single reduced KV head replicated with
``repro``'s fallback, Mamba's ``ssm``/``conv`` over data and ``inner`` over
model, made whole a layer), RWKV (rwkv6-3b: ``wkv`` over data and heads over
model, the shifts over data) and MoE (olmoe-1b-7b: the experts' capacity
groups over every row, whole on every rank; every activation f32 in both
packages, where the two hold the server token for token); then prefix
sharing on reduced internlm2-20b with a preemption and a copy-on-write
block copied from one data rank to another. On every rank: rank 0's tokens and the collectives of
a fused step as designed."""
import os

import jax.numpy as jnp
import torch

from test_torch_dist_util import (FAMILIES, SERVE_STREAM, SHARE, SHARE_STREAM, collect,
                                  start)
from test_torch_serve_mesh_ranks import (WORLD, check_collectives, check_ranks, repro_serve,
                                         repro_weights)
from test_torch_serve_util import one_cpu_thread  # noqa: F401
from repro.models import transformer as jtransformer
from repro_torch.configs import get_reduced_config

# (all_reduce, broadcast) a sub-step a layer, by family and mode: the join
# of the attention's parts over the axes its cache splits (MLA's dense
# latent and hymba's K/V: slots over data; olmoe: slots and heads), and one
# broadcast from each rank that holds a slice of a leaf made whole: MLA's
# paged c and kr over the 4 data ranks, hymba's ssm and conv over all 8,
# rwkv's wkv over all 8 and its two shifts over the 4 data ranks
PER_LAYER = {("minicpm3-4b", 0): (1, 0), ("minicpm3-4b", 1): (0, 8),
             ("hymba-1.5b", 0): (1, 16), ("rwkv6-3b", 0): (0, 16),
             ("olmoe-1b-7b", 0): (1, 0)}
# the paths: MLA and hymba have no KV-head dim the model axis divides
PATHS = {"minicpm3-4b": ("gspmd", ("data",), None), "hymba-1.5b": ("gspmd", ("data",), None),
         "rwkv6-3b": ("gspmd", ("data",), "model"), "olmoe-1b-7b": ("gspmd", ("data",), "model")}


def _repro_family(arch, jp, kw):
    """``repro``'s unsharded tokens of one FAMILIES mode; with ``f32``,
    every activation f32 (its embedding and unembedding uncast, as
    tests/test_torch_serving_moe.py does)."""
    kw = dict(kw)
    if not kw.pop("f32", False):
        return repro_serve(arch, jp, SERVE_STREAM, **kw)[0]
    saved = jtransformer.embed, jtransformer.unembed
    jtransformer.embed = lambda p, t, cfg: jnp.take(p["table"], t, axis=0)
    jtransformer.unembed = lambda p, x, cfg: x @ (p["table"].T if cfg.tie_embeddings
                                                  else p["unembed"])
    try:
        return repro_serve(arch, jp, SERVE_STREAM, **kw)[0]
    finally:
        jtransformer.embed, jtransformer.unembed = saved


def test_every_family_and_prefix_sharing_on_8_gloo_ranks(tmp_path, one_cpu_thread):  # noqa: F811
    archs = list(FAMILIES) + ["internlm2-20b"]
    weights, jparams = repro_weights(archs)
    torch.save(weights, os.path.join(tmp_path, "serve_weights.pt"))
    started = start("serve_families", WORLD, str(tmp_path))
    try:
        want = {arch: [_repro_family(arch, jparams[arch], kw) for kw in modes]
                for arch, modes in FAMILIES.items()}
        want_share, jm = repro_serve("internlm2-20b", jparams["internlm2-20b"], SHARE_STREAM,
                                     **SHARE)
    finally:
        ranks = collect(started)
    check_ranks(ranks, archs[:-1] + ["share"])
    got = ranks[0]
    for arch, modes in FAMILIES.items():
        cfg = get_reduced_config(arch)
        for i, kw in enumerate(modes):
            res = got[arch][i]
            assert res["outs"] == want[arch][i], (arch, kw)
            assert res["path"] == PATHS[arch], (arch, res["path"])
            assert res["finished"] == len(SERVE_STREAM)
            check_collectives(res, PER_LAYER[arch, i], cfg.n_layers,
                              kw.get("prefill_chunk", 1))
    # hymba: the cache's K/V replicated over model, Mamba's state over it
    layout = got["hymba-1.5b"][0]["layout"][0]
    assert layout["k"][0] == ["S(1)", "R"] and layout["ssm"][0] == ["S(1)", "S(2)"]
    assert got["rwkv6-3b"][0]["layout"][0]["wkv"][0] == ["S(1)", "S(2)"]

    share = got["share"]
    assert share["outs"] == want_share
    assert (share["preemptions"], share["cow_splits"], share["prefix_hits"]) == \
        (jm.preemptions, jm.cow_splits, jm.prefix_hits) == (1, 1, 1)
    assert share["kv_bytes_written"] == jm.kv_bytes_written
    # the split block was copied from one data rank's slice to another's
    assert share["crossed"]
    cfg = get_reduced_config("internlm2-20b")
    check_collectives(share, (1, 8), cfg.n_layers, SHARE["prefill_chunk"],
                      cow_broadcasts=2 * share["cow_splits"])
