"""The port's server (``repro_torch.serve.serving``) on the recurrent
families, on the CPU: hymba (a sliding-window ring beside a Mamba mixer in
every layer; "hymba-swa" keeps one global layer of reduced hymba's two, so
the other reads a 16-row ring) and rwkv6-3b. Ports of ``tests/test_serving_cb.py``'s
mid-run admission, paged and chunked-prefill parity for these families,
``tests/test_serving_tokbatch.py``'s token-stepping fallback and
``tests/test_serve_prefix.py``'s prefix-cache fallback; the per-slot state
machinery (the admission reset under paged KV, KV byte counts without the
recurrent leaves); and one stream through both packages' servers with the
same weights.

Within the port the contracts are exact. Against ``repro`` the greedy
tokens must agree except at near-ties
(``test_torch_serve_util.assert_greedy_matches``), whose deviation limit is
twice the family's logit bound as DEVIATION_LIMIT is twice BF16_LOGITS:
``HYBRID_LIMIT`` for hymba (``test_torch_hybrid.HYBRID_BF16_LOGITS``)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.serve import serving as jserving
from repro_torch.configs import get_reduced_config
from repro_torch.dist import meshes
from repro_torch.models import model_zoo
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import serving
from repro_torch.serve.serving import BatchedServer, Request
from test_torch_hybrid import HYBRID_BF16_LOGITS
from test_torch_serve_util import (CPU, DEVIATION_LIMIT, STREAM,  # noqa: F401
                                   assert_greedy_matches, one_cpu_thread, serve)

ARCHS = ["hymba-1.5b", "hymba-swa", "rwkv6-3b"]
# the serving stream and one request whose positions pass the 16-row window,
# so hymba-swa's ring wraps
LONG = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 12)
WRAP_STREAM = STREAM + [LONG]
HYBRID_LIMIT = 2 * HYBRID_BF16_LOGITS["atol"]


def _cfgs(arch):
    over = {"n_global_layers": 1} if arch == "hymba-swa" else {}
    name = "hymba-1.5b" if arch == "hymba-swa" else arch
    return get_reduced_config(name, **over), jreduced(name, **over)


@functools.cache
def params(arch, seed=2):
    """The port's own reduced weights (read-only: the server never writes
    its parameters)."""
    cfg, _ = _cfgs(arch)
    return cfg, model_zoo.init_params(cfg, seed=seed, device=CPU)[0]


# --------------------------- mid-run admission --------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_midrun_admission_token_exact(arch):
    """Admission into a freed slot is token-exact vs solo (the slot's
    recurrent state starts from zeros), and the long-running neighbour is
    not perturbed by it."""
    cfg, p = params(arch)
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=32, device=CPU)
    srv.submit(Request(0, [5, 6, 7, 8], 12))  # long: still running at admission
    srv.submit(Request(1, [1, 2], 3))         # short: frees its slot mid-run
    while not any(r.rid == 1 for r in srv.finished):
        srv.step()
    assert all(r.rid == 0 for r in srv.active if r)
    srv.submit(Request(2, [9, 3, 9, 4], 5))   # admitted into the freed slot
    done = srv.run()
    assert [r.rid for r in done] == [0, 1, 2]
    for rid, prompt, n in ((2, [9, 3, 9, 4], 5), (0, [5, 6, 7, 8], 12)):
        solo = BatchedServer(cfg, p, batch_slots=2, max_seq=32, device=CPU)
        solo.submit(Request(rid, prompt, n))
        assert done[rid].out == solo.run()[0].out, (arch, rid)


# --------------------------- chunked prefill and paged KV ---------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_token_exact(arch):
    """C in {1, 4, the longest prompt} is token-exact vs one-token prefill:
    each sub-step is a one-token step, and rows that do not run it keep
    their recurrent state. Paged x chunked composes (the kernel's plain
    version among them)."""
    cfg, p = params(arch)
    ref, _ = serve(cfg, p, WRAP_STREAM)
    for c in (1, 4, max(len(q) for q, _ in WRAP_STREAM)):
        assert serve(cfg, p, WRAP_STREAM, prefill_chunk=c)[0] == ref, (arch, c)
    for impl in ("gather", "kernel"):
        got, _ = serve(cfg, p, WRAP_STREAM, prefill_chunk=4, kv="paged", block_size=5,
                       attn_impl=impl)
        assert got == ref, (arch, impl)


def test_idle_rows_keep_their_state_under_chunked_stepping():
    """Without the write gate, a row that stops mid-chunk (at the ``max_seq``
    horizon) or sits empty would advance its recurrent state; with it the
    state of a parked row is exactly its state when it stopped."""
    cfg, p = params("hymba-swa")
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=12, prefill_chunk=4, device=CPU)
    srv.submit(Request(0, [4, 5, 6], 20))  # runs into max_seq 12 mid-chunk
    states = []
    real = srv._chunked_program

    def program():
        states.append([seg["ssm"][:, 1].clone() for seg in srv.cache])  # slot 1: empty
        return real()

    srv._chunked_program = program
    srv.run()
    for before in states:
        for seg, s in zip(srv.cache, before):
            assert torch.equal(seg["ssm"][:, 1], s)
    assert all(not s.any() for s in states[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_vs_dense_token_exact(arch):
    """Paged KV (recycled blocks, partial trailing blocks, the ring pool
    for sliding-window layers) is token-exact vs dense; RWKV has no
    per-token cache and serves dense."""
    cfg, p = params(arch)
    ref, _ = serve(cfg, p, WRAP_STREAM)
    for impl in ("gather", "kernel"):
        got, srv = serve(cfg, p, WRAP_STREAM, kv="paged", block_size=5, attn_impl=impl)
        assert got == ref, (arch, impl)
        m = srv.metrics
        assert m.finished == len(WRAP_STREAM)
        if cfg.family == "ssm":
            assert srv.kv_mode == "dense" and srv._paged is None and m.kv_blocks_total == 0
            continue
        assert srv.kv_mode == "paged" and 0 < m.kv_blocks_peak <= m.kv_blocks_total
        assert srv._paged.pool.blocks_in_use == 0  # free-on-finish drained
        ring = srv._paged.ring
        assert (ring is not None) == (arch == "hymba-swa")
        if ring is not None:
            assert ring.blocks_in_use == 0 and srv._paged.ring_width == cfg.swa_window


# --------------------------- fallbacks ----------------------------------------
@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-swa"])
def test_tokens_fallback_non_attn_families(arch):
    """Recurrent state is per slot: token stepping falls back to chunked
    stepping, recorded, and the fallen-back server still serves."""
    cfg, p = params(arch)
    meshes.clear_fallbacks()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=16, step_mode="tokens", device=CPU)
    assert srv.step_mode == "chunked"
    assert any(t == "serve_step" for t, _, _ in meshes.fallbacks())
    srv.submit(Request(0, [1, 2, 3], 3))
    assert len(srv.run()[0].out) == 3


def test_prefix_cache_falls_back_for_hybrid_and_rwkv():
    cfg, p = params("hymba-swa")
    meshes.clear_fallbacks()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged", block_size=4,
                        prefix_cache=True, device=CPU)
    assert srv.prefix_cache is False and srv._paged.index is None
    assert any(t == "serve_prefix" for t, _, _ in meshes.fallbacks())
    # by default it is simply off: no record
    meshes.clear_fallbacks()
    assert not BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged",
                             device=CPU).prefix_cache
    assert not meshes.fallbacks()
    cfg, p = params("rwkv6-3b")
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged", prefix_cache=True,
                        device=CPU)
    assert srv.prefix_cache is False and srv.kv_mode == "dense"
    assert any(t == "serve_prefix" for t, _, _ in meshes.fallbacks())


# --------------------------- per-slot state -----------------------------------
@pytest.mark.parametrize("arch", ["hymba-swa", "rwkv6-3b"])
def test_cache_row_bytes_leave_per_slot_leaves_out(arch):
    """The bytes one written position costs count the KV leaves only (a pure
    recurrent model: 0), as ``repro``'s do."""
    cfg, jcfg = _cfgs(arch)
    for kv in ("dense", "paged"):
        srv = BatchedServer(cfg, params(arch)[1], batch_slots=2, max_seq=24, kv=kv,
                            device=CPU)
        jsrv = jserving.BatchedServer(jcfg, jzoo.init_params(jcfg, jax.random.PRNGKey(0))[0],
                                      batch_slots=2, max_seq=24, kv=kv)
        kv_only = sum(int(c.shape[0]) * int(np.prod(c.shape[3:])) * c.element_size()
                      for seg in srv.cache for k, c in seg.items() if k in ("k", "v"))
        assert srv._kv_row_bytes == kv_only == jsrv._kv_row_bytes, (arch, kv)
        if cfg.family == "ssm":
            assert kv_only == 0


def test_paged_admission_resets_only_per_slot_rows():
    """Under paged KV the admission zeroes the admitted slot's recurrent
    rows, and nothing of the other slot's rows or of the block pools."""
    cfg, p = params("hymba-swa")
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged", block_size=4,
                        device=CPU)
    for seg in srv.cache:
        for c in seg.values():
            c.fill_(1)
    srv.submit(Request(0, [1, 2], 1))
    srv._admit()
    slot = next(i for i, r in enumerate(srv.active) if r is not None)
    for seg in srv.cache:
        for k, c in seg.items():
            if k in serving._PER_SLOT_KEYS:
                assert not c[:, slot].any() and (c[:, 1 - slot] == 1).all(), k
            else:
                assert (c == 1).all(), k


# --------------------------- against repro ------------------------------------
@pytest.mark.parametrize("mode", [dict(), dict(kv="paged", block_size=4, prefill_chunk=3,
                                                step_mode="tokens", attn_impl="kernel")],
                         ids=["dense", "paged_chunked_kernel"])
@pytest.mark.parametrize("arch", ["hymba-swa", "rwkv6-3b"])
def test_greedy_stream_matches_repro(arch, mode):
    """The same stream through both packages' servers with the same weights
    (``repro``'s f32 tree, which both cast at each use: the recurrent
    mixers' f32 projections read the f32 values): greedy tokens equal except
    at near-ties, and the step and token counters equal (token stepping
    falls back to chunked in both)."""
    cfg, jcfg = _cfgs(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU, dtype=torch.float32)
    jmode = dict(mode, attn_impl="pallas") if mode.get("attn_impl") == "kernel" else mode
    servers = (jserving.BatchedServer(jcfg, jp, batch_slots=2, max_seq=24, **jmode),
               BatchedServer(cfg, tp, batch_slots=2, max_seq=24, device=CPU, **mode))
    for srv, req in zip(servers, (jserving.Request, Request)):
        for i, (prompt, n) in enumerate(WRAP_STREAM):
            srv.submit(req(i, list(prompt), n))
    want, got = ([r.out for r in s.run()] for s in servers)
    limit = HYBRID_LIMIT if cfg.family == "hybrid" else DEVIATION_LIMIT
    for (prompt, _), g, w in zip(WRAP_STREAM, got, want):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, g, w, limit=limit)
    jm, tm = servers[0].metrics, servers[1].metrics
    assert servers[1].step_mode == servers[0].step_mode == "chunked"
    assert servers[1].kv_mode == servers[0].kv_mode
    for name in ("steps", "active_slot_steps", "admitted", "finished", "tokens_generated",
                 "prompt_tokens", "batched_tokens", "kv_blocks_total", "kv_blocks_peak",
                 "kv_bytes_written", "ttft_steps"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_recurrent_families_construct_and_moe_still_raises():
    """The recurrent families construct, and since the MoE slice the MoE
    model serves beside them (``test_torch_serving_moe.py`` holds it against
    ``repro``)."""
    for arch in ("hymba-1.5b", "rwkv6-3b"):
        cfg, p = params(arch)
        srv = BatchedServer(cfg, p, batch_slots=1, max_seq=8, device=CPU)
        assert srv.kv_mode == "dense"
    cfg = get_reduced_config("olmoe-1b-7b")
    srv = BatchedServer(cfg, model_zoo.init_params(cfg, seed=2, device=CPU)[0], batch_slots=1,
                        max_seq=8, device=CPU)
    srv.submit(Request(0, [1, 2, 3], 2))
    assert len(srv.run()[0].out) == 2


def test_entry_points_raise_without_a_card(monkeypatch):
    """The recurrent families' entry points run on the card unless the CPU
    is asked for, and raise where there is none."""
    from repro_torch.launch import serve as serve_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("hymba-1.5b", "rwkv6-3b"):
        cfg, p = params(arch)
        for call in (lambda: model_zoo.init_params(cfg),
                     lambda: model_zoo.make_cache(cfg, 1, 8),
                     lambda: model_zoo.make_paged_cache(cfg, 4, 4, slots=1),
                     lambda: BatchedServer(cfg, p, batch_slots=1, max_seq=8),
                     lambda: serve_cli.main(["--arch", arch, "--reduced"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-3b"])
def test_launch_serve_runs_reduced_on_the_cpu(arch, capsys):
    """``launch/serve.py`` serves the recurrent families (paged KV asked for:
    hymba pages its attention, RWKV serves dense)."""
    from repro_torch.launch import serve as serve_cli

    done = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                           "--requests", "3", "--kv", "paged", "--prefill-chunk", "4"])
    assert len(done) == 3 and all(r.out for r in done)
    assert f"[serve] {arch}" in capsys.readouterr().out
