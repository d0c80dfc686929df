"""The port's server on the MoE family (reduced olmoe-1b-7b and reduced
deepseek-v3-671b: MLA beside the experts, a shared expert, a leading dense
layer), on the CPU, against ``repro``'s server with the same weights and the
same traffic; and the server's MoE fallbacks.

A decode sub-step routes the whole batch as one group, so rows couple
through expert capacity: the rows that do not run (empty slots, finished
rows, fed token 0 at their frozen position) claim capacity in slot order,
before the live rows below them. What an idle row's attention reads
therefore decides the live rows' tokens where capacity binds, and the port
must read what ``repro`` reads on each layout (``attention._dense_write``;
paged: the blocks the idle row's table maps).

Two comparisons:

* **bf16** (the model as served): greedy tokens equal to ``repro``'s up
  to the first discontinuity. Both servers' logits are tapped at every
  sub-step (the schedules are the same: admissions depend on lengths only),
  and so are the port's router probabilities. Sub-step by sub-step, every
  live row's logits stay within LIMIT of ``repro``'s (the spread
  of their difference) with the same greedy token, until the first
  sub-step where that fails. There, either ``repro``'s top-2 logit margin
  at a differing row is below the deviation so far (a near-tie, as the
  other serving tests allow), or a route flipped: the port's router has a
  (token, layer) whose k-th and (k+1)-th probabilities lie within
  ROUTE_TIE, where bf16 rounding noise can swap them, and one swapped
  expert moves a row's logits by units. Every later sub-step follows
  another history in every row (the group couples them), so it is not
  compared; the test prints the discontinuity with its margins.
* **f32** (embedding and unembedding uncast in both packages, as
  ``test_torch_attention.py`` does, so every activation is f32): token for
  token, in a stream built so that capacity binds on live rows behind idle
  ones, on dense and paged caches, gather and kernel paths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro.serve import serving as jserving
from repro_torch.configs import get_reduced_config
from repro_torch.dist import meshes
from repro_torch.models import model_zoo, moe, transformer
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.serving import BatchedServer, Request
from test_torch_serve_util import CPU, DEVIATION_LIMIT, one_cpu_thread  # noqa: F401

ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
# the largest difference of the two packages' f32 router probabilities over
# 12 teacher-forced bf16 decode steps of 8 rows is 4.2e-5 on reduced olmoe
# and 1.7e-4 on reduced deepseek-v3 (each layer's input differs by bf16
# rounding); a route can flip where the k-th and (k+1)-th probabilities lie
# within twice that, and ROUTE_TIE leaves a factor of 3 above it
ROUTE_TIE = 1e-3
# the deviation limit: DEVIATION_LIMIT, doubled for deepseek-v3 as the
# reference's prefill-vs-decode test doubles its tolerance there (6e-2
# against 3e-2: the deepest bf16 chain, q_lora + MLA + router + shared expert)
LIMIT = {"olmoe-1b-7b": DEVIATION_LIMIT, "deepseek-v3-671b": 2 * DEVIATION_LIMIT}
SLOTS, MAX_SEQ = 8, 24
MODES = {
    "dense": {},
    "dense_chunked": dict(prefill_chunk=3),
    "paged_gather": dict(kv="paged", block_size=4),
    "paged_kernel_chunked": dict(kv="paged", block_size=4, prefill_chunk=3,
                                 step_mode="tokens", attn_impl="kernel"),
}


def _stream(vocab, seed=0):
    """(prompt, max_new_tokens, arrival step) from ``seed``: staggered
    arrivals onto 8 slots, so slots sit empty, finish and refill."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, int(rng.integers(2, 9))).tolist(), int(rng.integers(2, 10)),
             int(rng.integers(0, 8))) for _ in range(10)]


# six identical short requests finish together in slots 0-5 and idle there
# with one state, so they route alike and fill two experts' capacity ahead
# of the long requests in slots 6-7; later arrivals refill the freed slots
BINDING = ([([7, 7, 7], 2, 0)] * 6
           + [([5, 6, 7, 8, 9], 14, 0), ([2, 9, 4], 16, 0), ([3, 1, 4, 1], 6, 6),
              ([8, 8], 5, 9)])


def _both(arch, dtype=torch.bfloat16):
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=dtype)
    return cfg, jcfg, jp, tp


def _uncast(monkeypatch):
    """f32 embedding and unembedding in both packages: every activation f32."""
    def unembed(p, x, cfg):
        return x @ (p["table"].T if cfg.tie_embeddings else p["unembed"])

    monkeypatch.setattr(jtransformer, "embed", lambda p, t, cfg: jnp.take(p["table"], t, axis=0))
    monkeypatch.setattr(jtransformer, "unembed", unembed)
    monkeypatch.setattr(transformer, "embed", lambda p, t, cfg: p["table"][t])
    monkeypatch.setattr(transformer, "unembed", unembed)


def _run(srv, req, stream):
    """Submit each request at its arrival step and step until all are done.
    Returns {rid: tokens}."""
    pending = sorted(enumerate(stream), key=lambda x: x[1][2])
    step = 0
    while pending or srv.queue or any(r is not None for r in srv.active):
        while pending and pending[0][1][2] <= step:
            rid, (prompt, n, _) = pending.pop(0)
            srv.submit(req(rid, list(prompt), n))
        srv.step()
        step += 1
    return {r.rid: r.out for r in srv.finished}


class _Taps:
    """The logits of every decode both servers make, in order, the port's run
    and emit masks at each (the schedules are the same in both), and the smallest
    margin between the k-th and the (k+1)-th router probability over the
    rows and MoE layers of each of the port's decodes."""

    def __init__(self, monkeypatch):
        self.ref, self.port, self.run, self.emit, self.route_margin = [], [], [], [], []
        real_fn = jserving.model_zoo.decode_fn

        def decode_fn(cfg, **kw):
            real = real_fn(cfg, **kw)

            def decode(*args, **kwargs):
                logits, cache = real(*args, **kwargs)
                jax.debug.callback(lambda x: self.ref.append(np.asarray(x, np.float32)),
                                   logits, ordered=True)
                return logits, cache

            return decode

        real_route = moe.route

        def route(x, router, k):
            probs, topw, topi = real_route(x, router, k)
            top = torch.sort(probs.detach(), dim=-1, descending=True).values
            while len(self.route_margin) < len(self.run):  # this decode's first layer
                self.route_margin.append(float("inf"))
            self.route_margin[-1] = min(self.route_margin[-1],
                                        float((top[..., k - 1] - top[..., k]).min()))
            return probs, topw, topi

        monkeypatch.setattr(jserving.model_zoo, "decode_fn", decode_fn)
        monkeypatch.setattr(moe, "route", route)

    def port_server(self, srv):
        real_forward, real_decode = srv._forward, srv._decode

        def forward(tok, pos, write_ok, **kw):
            self.run.append(write_ok.clone())
            # the rows whose sample is a generated token (past their prompt)
            self.emit.append(write_ok & (pos + 1 >= torch.from_numpy(srv._prompt_len)))
            return real_forward(tok, pos, write_ok, **kw)

        def decode(*args, **kw):
            logits, cache = real_decode(*args, **kw)
            self.port.append(logits.float().numpy())
            return logits, cache

        srv._forward, srv._decode = forward, decode
        return srv


def _first_divergence(taps, vocab, limit=DEVIATION_LIMIT):
    """None when every live row's logits stay within ``limit`` of
    ``repro``'s, and every generated token is ``repro``'s, at every
    sub-step; else the first
    sub-step where they do not, checked to be a near-tie or a route flip
    (see the module's docstring): (sub-step, logit margin, deviation,
    router margin)."""
    assert len(taps.ref) == len(taps.port) == len(taps.run) == len(taps.route_margin)
    deviation = 0.0
    for j, (ref, port, run, emit) in enumerate(zip(taps.ref, taps.port, taps.run, taps.emit)):
        live, emit = run.numpy(), emit.numpy()
        delta = port[live, :vocab] - ref[live, :vocab]
        spread = float((delta.max(1) - delta.min(1)).max()) if live.any() else 0.0
        differ = ref[emit, :vocab].argmax(1) != port[emit, :vocab].argmax(1)
        if spread <= limit and not differ.any():
            deviation = max(deviation, spread)
            continue
        top = np.sort(ref[emit, :vocab][differ], axis=1)
        margin = float((top[:, -1] - top[:, -2]).max()) if differ.any() else None
        near_tie = spread <= limit and margin < max(deviation, spread)
        flip = taps.route_margin[j] < ROUTE_TIE
        print(f"discontinuity at sub-step {j}: logit spread {spread:.4g} (before: "
              f"{deviation:.4g}), reference margin {margin}, router margin "
              f"{taps.route_margin[j]:.3g}")
        assert near_tie or flip, ("neither a near-tie nor a route flip", j, spread, margin,
                                  taps.route_margin[j])
        return j, margin, spread, taps.route_margin[j]
    return None


def _servers(cfg, jcfg, jp, tp, mode, taps=None):
    jmode = dict(mode, attn_impl="pallas") if mode.get("attn_impl") == "kernel" else mode
    jsrv = jserving.BatchedServer(jcfg, jp, batch_slots=SLOTS, max_seq=MAX_SEQ, **jmode)
    srv = BatchedServer(cfg, tp, batch_slots=SLOTS, max_seq=MAX_SEQ, device=CPU, **mode)
    return jsrv, (taps.port_server(srv) if taps is not None else srv)


# --------------------------- against repro, bf16 -------------------------------
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_matches_repro(arch, mode, monkeypatch):
    """The same staggered stream through both packages' servers (bf16
    weights, the default capacity factor 1.25): every live row's token at
    every sub-step equal to ``repro``'s up to a reported near-tie; both
    servers fall back to chunked stepping with prefix sharing off, and
    their step and token counters agree."""
    cfg, jcfg, jp, tp = _both(arch)
    taps = _Taps(monkeypatch)
    meshes.clear_fallbacks()
    jsrv, srv = _servers(cfg, jcfg, jp, tp, MODES[mode], taps)
    stream = _stream(cfg.vocab_size)
    want, got = _run(jsrv, jserving.Request, stream), _run(srv, Request, stream)
    assert sorted(got) == sorted(want) == list(range(len(stream)))
    if _first_divergence(taps, cfg.vocab_size, LIMIT[arch]) is None:
        assert got == want
    assert srv.step_mode == jsrv.step_mode == "chunked"
    assert srv.prefix_cache is jsrv.prefix_cache is False
    jm, tm = jsrv.metrics, srv.metrics
    for name in ("steps", "admitted", "finished", "tokens_generated", "prompt_tokens",
                 "kv_blocks_peak", "kv_bytes_written"):
        assert getattr(tm, name) == getattr(jm, name), name


# --------------------------- idle rows, f32 -----------------------------------
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_idle_rows_claim_capacity_as_in_repro(arch, mode, monkeypatch):
    """Every activation f32: the tokens equal ``repro``'s exactly, in a
    stream where idle rows ahead of live ones fill experts' capacity and a
    live row's choice of such an expert is dropped (checked on the port's
    routing)."""
    _uncast(monkeypatch)
    cfg, jcfg, jp, tp = _both(arch, torch.float32)
    taps = _Taps(monkeypatch)
    jsrv, srv = _servers(cfg, jcfg, jp, tp, MODES[mode], taps)
    crowded = []
    real_route = moe.route_groups

    def route_groups(x, p, c, cap, routing_out=None):
        got = []
        out = real_route(x, p, c, cap, got)
        r, run = got[0], taps.run[-1]
        if x.shape[0] == 1 and not run.all():  # a decode sub-step with idle rows
            expert = r.choice_slot // (r.groups * cap)
            lost = expert[run[:, None] & ~r.choice_ok]
            held = expert[~run[:, None] & r.choice_ok]
            crowded.append(bool(torch.isin(lost, held).any()))
        return out

    monkeypatch.setattr(moe, "route_groups", route_groups)
    want, got = _run(jsrv, jserving.Request, BINDING), _run(srv, Request, BINDING)
    assert any(crowded), "no live row lost its expert to an idle row"
    assert _first_divergence(taps, cfg.vocab_size) is None
    assert got == want


# --------------------------- within the port ------------------------------------
def test_paged_vs_dense_token_exact_at_ample_capacity():
    """With capacity that never binds, idle rows cannot reach the live ones:
    paged KV (both read paths, chunked or not) is token-exact vs dense, as
    ``repro``'s paged test holds for attention-only models."""
    cfg = dataclasses.replace(get_reduced_config("olmoe-1b-7b"), capacity_factor=16.0)
    p, _ = model_zoo.init_params(cfg, seed=2, device=CPU)
    stream = _stream(cfg.vocab_size, seed=1)

    def serve(**kw):
        return _run(BatchedServer(cfg, p, batch_slots=4, max_seq=MAX_SEQ, device=CPU, **kw),
                    Request, stream)

    ref = serve()
    for mode in MODES.values():
        assert serve(**mode) == ref, mode


# --------------------------- fallbacks -------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fallbacks_are_recorded(arch):
    """As in ``repro``: token stepping falls back to chunked stepping (MoE
    capacity groups would see the padding rows), and an explicit
    ``prefix_cache=True`` falls back to unshared serving (skipped positions
    carry capacity state that blocks do not hold), each recorded with its
    reason; by default prefix sharing is simply off."""
    cfg = get_reduced_config(arch)
    p, _ = model_zoo.init_params(cfg, seed=2, device=CPU)
    meshes.clear_fallbacks()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=16, kv="paged", step_mode="tokens",
                        device=CPU)
    assert srv.step_mode == "chunked" and not srv.prefix_cache
    (kind, _, why), = meshes.fallbacks()
    assert kind == "serve_step" and "MoE capacity groups see padding rows" in why
    meshes.clear_fallbacks()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=16, kv="paged", prefix_cache=True,
                        device=CPU)
    assert srv.prefix_cache is False and srv._paged.index is None
    assert [k for k, _, _ in meshes.fallbacks()] == ["serve_prefix"]
    srv.submit(Request(0, [1, 2, 3], 3))
    assert len(srv.run()[0].out) == 3


def test_launch_serve_runs_reduced_olmoe_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    done = serve_cli.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                           "--batch", "2", "--requests", "3", "--kv", "paged",
                           "--prefill-chunk", "4", "--attn-impl", "kernel"])
    assert len(done) == 3 and all(r.out for r in done)
    assert "[serve] olmoe-1b-7b" in capsys.readouterr().out
