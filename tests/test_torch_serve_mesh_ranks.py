"""The sharded server on 8 gloo CPU ranks, (4 data x 2 model), against
``repro``'s unsharded server: the cases of ``tests/test_serving_cb.py``'s
two 8-device scripts on reduced internlm2-20b (``test_torch_dist_util``'s
``serve_mesh`` case), from ``repro``'s weights carried across by
``params_from_numpy``.

  * 10 teacher-forced decode steps at staggered positions over the placed
    dense cache (slots over data, KV heads over model): within ``repro``'s
    6e-2 of its unsharded ``decode_fn``, and within ``PORT_TF_ATOL`` of the
    port's unsharded decode (the attention's parts join exactly; what
    differs is the rounding of the matmuls over a rank's rows and heads);
  * the 5-request, 4-slot stream: the tokens of ``repro``'s unsharded
    server, admission token-exact (the last request alone gives the same);
  * the paged pool over data (16 blocks of 6, chunk 2): ``got == solo ==
    ref`` with the pool really partitioned; 10 blocks: the fallback recorded
    and the tokens still ``repro``'s;
  * the kernel path (B5's plain version here): the pool replicated with
    ``repro``'s fallback, the heads split.

On every rank: rank 0's tokens (no disagreement), no collective that gloo
cannot run on CUDA tensors, and the collectives of a fused step as the
design has them (``PER_LAYER``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_dist_util import (KERNEL, PAGED, PAGED_10, SERVE_MAX_SEQ, SERVE_SLOTS,
                                  SERVE_STREAM, collect, run_arrivals, serve_tf_tokens, start)
from test_torch_serve_util import one_cpu_thread  # noqa: F401
from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.serve import serving as jserving
from repro_torch.configs import get_reduced_config
from repro_torch.models import model_zoo
from repro_torch.models.params import params_from_numpy

WORLD, ARCH = 8, "internlm2-20b"
# the port's sharded teacher-forced logits against its unsharded ones: the
# largest difference measured is 0 on the CPU (a rank's matmuls over 1 of
# 4 rows and 1 of 2 heads give the same bits); the bound leaves room for a
# bf16 step of a logit
PORT_TF_ATOL = 1e-2
# the collectives of one sub-step of one layer: (all_reduce, broadcast).
# Dense caches (slots over data, heads over model): one join of the
# attention's parts. The paged pool over data: the join over model, and K's
# and V's pools made whole by one broadcast from each of the 4 data ranks.
# The 10-block pool and the kernel path's stay replicated: the join alone
PER_LAYER = {"dense": (1, 0), "solo": (1, 0), "paged": (1, 8), "paged_10": (1, 0),
             "kernel": (1, 0)}


def repro_weights(archs, seed=2):
    """``repro``'s reduced weights of each of ``archs`` (PRNGKey(seed)) as
    numpy trees, and the jax trees."""
    out, jparams = {}, {}
    for arch in archs:
        jp, _ = jzoo.init_params(jreduced(arch), jax.random.PRNGKey(seed))
        jparams[arch], out[arch] = jp, jax.tree.map(np.asarray, jp)
    return out, jparams


def repro_serve(arch, jp, stream, **kw):
    """``repro``'s unsharded server on ``stream``: {rid: tokens}. The kernel
    path is its ``pallas``."""
    if kw.get("attn_impl") == "kernel":
        kw = dict(kw, attn_impl="pallas")
    srv = jserving.BatchedServer(jreduced(arch), jp, batch_slots=kw.pop("batch_slots",
                                                                       SERVE_SLOTS),
                                 max_seq=SERVE_MAX_SEQ, **kw)
    return run_arrivals(srv, stream, jserving.Request), srv.metrics


def check_collectives(res, per_layer, n_layers, sub_steps, cow_broadcasts=0):
    """A run's collectives: its fused steps' joins and broadcasts as
    ``per_layer`` has them for each sub-step of each layer, and one rank-0
    broadcast a fused step."""
    n = res["steps"] * sub_steps * n_layers
    want = {"all_reduce": n * per_layer[0],
            "broadcast": res["steps"] + n * per_layer[1] + cow_broadcasts}
    assert res["collectives"] == want, (res["collectives"], want)


def check_ranks(ranks, keys):
    """Every rank holds rank 0's tokens, never disagreed with it before the
    broadcast, and called no collective gloo cannot run on CUDA tensors."""
    for r, res in enumerate(ranks):
        assert res["forbidden"] == [], (r, res["forbidden"])
        for key in keys:
            got = res[key] if isinstance(res[key], list) else [res[key]]
            want = ranks[0][key] if isinstance(ranks[0][key], list) else [ranks[0][key]]
            for g, w in zip(got, want):
                assert g["outs"] == w["outs"] and g["disagreements"] == 0, (r, key)
                assert g["collectives"] == w["collectives"], (r, key)


def test_sharded_server_on_8_gloo_ranks(tmp_path, one_cpu_thread):  # noqa: F811
    weights, jparams = repro_weights([ARCH])
    torch.save(weights, os.path.join(tmp_path, "serve_weights.pt"))
    started = start("serve_mesh", WORLD, str(tmp_path))
    try:
        # repro's unsharded runs and the port's unsharded decode, while the
        # ranks run
        jp, jcfg, cfg = jparams[ARCH], jreduced(ARCH), get_reduced_config(ARCH)
        toks, offsets = serve_tf_tokens(cfg.vocab_size)
        jdecode, jcache = jax.jit(jzoo.decode_fn(jcfg)), jzoo.make_cache(jcfg, SERVE_SLOTS, 24)
        tp = params_from_numpy(cfg, weights[ARCH], device="cpu")
        decode, cache = model_zoo.decode_fn(cfg), model_zoo.make_cache(cfg, SERVE_SLOTS, 24, "cpu")
        want_tf, port_tf = [], []
        for t in range(len(toks)):
            lg, jcache = jdecode(jp, jnp.asarray(toks[t]), jcache, jnp.asarray(offsets + t))
            want_tf.append(np.asarray(lg[:, :cfg.vocab_size], np.float32))
            lg, _ = decode(tp, torch.from_numpy(toks[t]), cache, torch.from_numpy(offsets + t))
            port_tf.append(lg[:, :cfg.vocab_size].float().numpy())
        ref, _ = repro_serve(ARCH, jp, SERVE_STREAM)
        solo, _ = repro_serve(ARCH, jp, SERVE_STREAM, **PAGED)
        pallas, _ = repro_serve(ARCH, jp, SERVE_STREAM, **KERNEL)
    finally:
        ranks = collect(started)
    got = ranks[0]
    check_ranks(ranks, ["dense", "solo", "paged", "paged_10", "kernel"])
    for r in ranks:
        np.testing.assert_array_equal(r["tf_logits"], got["tf_logits"])

    # 1. teacher-forced logits over the placed dense cache
    assert got["tf_layout"][0]["k"] == (["S(1)", "S(3)"], (cfg.n_layers, 2, 24, 1, cfg.hd))
    np.testing.assert_allclose(got["tf_logits"], np.stack(want_tf), rtol=6e-2, atol=6e-2)
    np.testing.assert_allclose(got["tf_logits"], np.stack(port_tf), rtol=0, atol=PORT_TF_ATOL)

    # 2. the stream: repro's tokens, admission exact, the decision
    dense = got["dense"]
    assert dense["path"] == ("gspmd", ("data",), "model") and dense["fallbacks"] == []
    assert dense["outs"] == ref
    assert got["solo"]["outs"][4] == dense["outs"][4]
    assert dense["admitted"] == dense["finished"] == 5

    # 3. the paged pool over data, and the 10-block fallback
    paged = got["paged"]
    assert paged["path"] == ("gspmd", ("data",), "model") and paged["fallbacks"] == []
    assert paged["outs"] == solo == ref
    # 16 blocks over 4 data ranks, each with its landing block; 2 heads over 2
    assert paged["layout"][0]["k"] == (["S(1)", "S(3)"], (cfg.n_layers, 5, 6, 1, cfg.hd))
    assert 0 < paged["kv_blocks_peak"] <= 16 and paged["finished"] == 5
    p10 = got["paged_10"]
    assert p10["path"] == ("gspmd", (), "model")
    assert [(t, ax) for t, (ax, _), _ in p10["fallbacks"]] == [("serve_cache", "kv_blocks")]
    assert p10["outs"] == ref
    assert p10["layout"][0]["k"] == (["R", "S(3)"], (cfg.n_layers, 11, 6, 1, cfg.hd))

    # 4. the kernel path: the pool replicated (repro's record), the heads split
    kern = got["kernel"]
    assert kern["attn_impl"] == "kernel" and kern["step_mode"] == "tokens"
    assert kern["path"] == ("gspmd", (), "model")
    assert [(t, ax) for t, (ax, _), _ in kern["fallbacks"]] == [("serve_cache", "kv_blocks")]
    assert kern["layout"][0]["k"] == (["R", "S(3)"], (cfg.n_layers, 17, 6, 1, cfg.hd))
    assert kern["outs"] == pallas == ref

    # the collectives of a fused step, as designed
    for key, kw in (("dense", {}), ("solo", {}), ("paged", PAGED), ("paged_10", PAGED_10),
                    ("kernel", KERNEL)):
        sub = 1 if kw.get("step_mode") == "tokens" else kw.get("prefill_chunk", 1)
        check_collectives(got[key], PER_LAYER[key], cfg.n_layers, sub)
