"""Enc-dec decode over caches placed on a mesh of 4 gloo CPU ranks, (2 data x
2 model), as the port's dry-run places them (``test_torch_dist_util``'s
``encdec_mesh`` case): reduced seamless-m4t-medium from ``repro``'s weights
carried across by ``params_from_numpy``, and one set of numpy caches and
inputs.

  * layer 0's cross attention (``attention.cross_decode``) over its cross
    K/V split by rows over data and KV heads over model: each rank attends
    over its part and one ``all_reduce`` joins the parts. Within
    ``PORT_ATOL`` of the port's unsharded ``cross_decode`` and within
    ``REPRO_TOL`` of ``repro``'s;
  * the whole decode step's logits over the placed self and cross caches:
    within ``PORT_ATOL`` of the port's unsharded step and within ``repro``'s
    6e-2 of its ``decode_fn``, as ``test_torch_serve_mesh_ranks`` holds the
    decoder-only step.

Every rank holds rank 0's numbers and called no collective that gloo cannot
run on CUDA tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_dist_util import ENCDEC_CACHE, collect, start
from test_torch_serve_mesh_ranks import repro_weights
from test_torch_serve_util import one_cpu_thread  # noqa: F401
from repro.configs import get_reduced_config as jreduced
from repro.models import attention as jattention
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention, model_zoo
from repro_torch.models.params import params_from_numpy
from repro_torch.models.transformer import _layer

WORLD, ARCH = 4, "seamless-m4t-medium"
SLOTS, SEQ = 4, 8  # cache rows and positions (the source's too, as make_cache has it)
POS = (1, 3, 6, 7)  # each slot's position
# the placed step against the port's unsharded one: the parts join exactly
# (each element comes from one rank, the rest add zeros); what may differ is
# the rounding of the matmuls over a rank's rows and heads. Measured: 0
PORT_ATOL = 1e-2
# layer 0's cross attention against repro's: bf16 inputs and output, f32
# scores in both
REPRO_TOL = 2e-2


def _inputs(cfg):
    rng = np.random.default_rng(5)
    kvh, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def draw(rows):
        return rng.standard_normal((n, rows, SEQ, kvh, hd)).astype(np.float32)

    # the self K/V carry the landing row after the slots (attention.gqa_decode)
    inp = {"k": draw(SLOTS + 1), "v": draw(SLOTS + 1), "xk": draw(SLOTS), "xv": draw(SLOTS),
           "x": rng.standard_normal((SLOTS, 1, cfg.d_model)).astype(np.float32),
           "tokens": rng.integers(1, cfg.vocab_size, SLOTS).astype(np.int32),
           "pos": np.asarray(POS, np.int32)}
    # bf16 values, so that every side starts from the same numbers
    for k in (*ENCDEC_CACHE, "x"):
        inp[k] = torch.from_numpy(inp[k]).to(torch.bfloat16).float().numpy()
    return inp


def test_encdec_decode_on_a_placed_cache(tmp_path, one_cpu_thread):  # noqa: F811
    weights, jparams = repro_weights([ARCH])
    torch.save(weights, tmp_path / "serve_weights.pt")
    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    inp = _inputs(cfg)
    np.savez(tmp_path / "encdec_inputs.npz", **inp)
    started = start("encdec_mesh", WORLD, str(tmp_path))
    try:
        # the port's unsharded step and repro's, while the ranks run
        tp = params_from_numpy(cfg, weights[ARCH], device="cpu", dtype=torch.bfloat16)
        cache = {k: torch.from_numpy(inp[k]).to(torch.bfloat16) for k in ENCDEC_CACHE}
        x = torch.from_numpy(inp["x"]).to(torch.bfloat16)
        port_cross = attention.cross_decode(
            _layer(tp["dec"], 0)["cross"], x,
            {"k": cache["xk"][0], "v": cache["xv"][0]}, cfg).float().numpy()
        port_logits, _ = model_zoo.decode_fn(cfg)(tp, torch.from_numpy(inp["tokens"]), cache,
                                                  torch.from_numpy(inp["pos"]))
        port_logits = port_logits[:, :cfg.vocab_size].float().numpy()

        jp = jparams[ARCH]
        jcross = jattention.cross_decode(
            jax.tree.map(lambda a: a[0], jp["dec"]["cross"]), jnp.asarray(x.float().numpy(),
                                                                         jnp.bfloat16),
            {"k": jnp.asarray(inp["xk"][0], jnp.bfloat16),
             "v": jnp.asarray(inp["xv"][0], jnp.bfloat16)}, jcfg)
        # repro's self K/V have no landing row
        jcache = {k: jnp.asarray(inp[k][:, :SLOTS] if k in ("k", "v") else inp[k], jnp.bfloat16)
                  for k in ENCDEC_CACHE}
        jlogits, _ = jzoo.decode_fn(jcfg)(jp, jnp.asarray(inp["tokens"]), jcache,
                                          jnp.asarray(inp["pos"]))
        want_cross = np.asarray(jcross, np.float32)
        want_logits = np.asarray(jlogits[:, :cfg.vocab_size], np.float32)
    finally:
        ranks = collect(started)

    got = ranks[0]
    for r, res in enumerate(ranks):
        assert res["forbidden"] == [], (r, res["forbidden"])
        np.testing.assert_array_equal(res["cross"], got["cross"])
        np.testing.assert_array_equal(res["logits"], got["logits"])
    # the cross K/V really split: 2 of 4 rows over data, 2 of 4 heads over model
    kvh, hd = cfg.n_kv_heads, cfg.hd
    assert got["layout"]["xk"] == (["S(1)", "S(3)"], (cfg.n_layers, SLOTS // 2, SEQ, kvh // 2,
                                                      hd))
    assert got["layout"]["xv"] == got["layout"]["xk"]
    # layer 0's cross attention: one join of the parts
    assert got["joins"] == {"all_reduce": 1, "broadcast": 0}
    np.testing.assert_allclose(got["cross"], port_cross, rtol=0, atol=PORT_ATOL)
    np.testing.assert_allclose(got["cross"], want_cross, rtol=REPRO_TOL, atol=REPRO_TOL)
    # the whole step
    np.testing.assert_allclose(got["logits"], port_logits, rtol=0, atol=PORT_ATOL)
    np.testing.assert_allclose(got["logits"], want_logits, rtol=6e-2, atol=6e-2)
