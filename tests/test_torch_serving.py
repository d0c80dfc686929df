"""The port's continuous-batching server (``repro_torch.serve.serving``) on the
CPU: the GQA cases of ``tests/test_serving_cb.py`` within the port (mid-run
admission, slot reuse, paged vs dense and chunked prefill token for token,
OOM as deferral, stop handling, metrics identities), and one mixed stream
through both packages' servers with the same weights (greedy outputs, and
the ``ServeMetrics`` step and token counters).

Within the port the contracts are exact: the same decode on the same rows
gives the same bits. Against ``repro`` the greedy tokens must agree except at
near-ties, as ``test_torch_serve_util.assert_greedy_matches`` defines them; every
near-tie is printed."""
import copy
import json

import jax
import numpy as np
import pytest

from test_torch_serve_util import (CPU, STREAM, assert_greedy_matches, one_cpu_thread,  # noqa: F401
                         params, serve)
from repro.configs import get_reduced_config as jreduced
from repro.models import model_zoo as jzoo
from repro.serve import serving as jserving
from repro_torch.configs import get_reduced_config
from repro_torch.dist import meshes
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.serving import (BatchedServer, Request, generate_greedy,
                                       score_tokens)

ARCHS = ["internlm2-20b", "mistral-nemo-12b"]


# --------------------------- mid-run admission --------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_midrun_admission_token_exact(arch):
    """Admission into a freed slot is token-exact vs solo, and the
    long-running neighbour is not perturbed by it."""
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


def test_slot_reuse_chain_token_exact():
    cfg, p = params()
    prompts = [[3, 1, 4], [1, 5, 9, 2], [6, 5]]
    got, _ = serve(cfg, p, [(q, 4) for q in prompts], slots=1)
    for i, q in enumerate(prompts):
        assert got[i] == serve(cfg, p, [(q, 4)], slots=1)[0][0], i


# --------------------------- paged KV parity ----------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_vs_dense_token_exact(arch):
    """Block tables, recycled blocks and partial trailing blocks (block size
    5 does not divide max_seq 24): token-exact vs the dense reference, with
    mid-run admission into slots whose blocks were freed and re-mapped."""
    cfg, p = params(arch)
    ref, _ = serve(cfg, p)
    for impl in ("gather", "kernel"):
        got, srv = serve(cfg, p, kv="paged", block_size=5, attn_impl=impl)
        assert got == ref, (arch, impl)
        m = srv.metrics
        assert m.finished == len(STREAM)
        assert 0 < m.kv_blocks_peak <= m.kv_blocks_total
        assert srv._paged.pool.blocks_in_use == 0  # free-on-finish drained


def test_paged_oom_defers_admission_and_completes():
    cfg, p = params()
    ref, _ = serve(cfg, p, slots=3)
    got, srv = serve(cfg, p, slots=3, kv="paged", block_size=4, kv_blocks=5)
    assert got == ref
    m = srv.metrics
    assert m.finished == len(STREAM) and m.deferrals > 0 and m.kv_blocks_peak <= 5
    with pytest.raises(ValueError, match="KV blocks"):
        srv.submit(Request(99, list(range(1, 20)), 10))


def test_paged_long_prompt_beyond_dense_slot_budget():
    cfg, p = params()
    slots, dense_seq = 2, 16
    dense = BatchedServer(cfg, p, batch_slots=slots, max_seq=dense_seq, device=CPU)
    long_prompt = list(range(1, 21))
    with pytest.raises(ValueError, match="max_seq"):
        dense.submit(Request(0, long_prompt, 4))
    got, srv = serve(cfg, p, [(long_prompt, 4), ([3, 1, 4], 4)], slots=slots,
                     max_seq=2 * dense_seq, kv="paged", block_size=4,
                     kv_blocks=slots * dense_seq // 4)
    assert len(got[0]) == 4
    solo, _ = serve(cfg, p, [(long_prompt, 4)], slots=1, max_seq=2 * dense_seq,
                    kv="paged", block_size=4)
    assert solo[0] == got[0]


# --------------------------- chunked prefill -----------------------------------
def test_chunked_prefill_token_exact():
    cfg, p = params("mistral-nemo-12b")
    ref, _ = serve(cfg, p)
    for c in (1, 4, max(len(q) for q, _ in STREAM)):
        assert serve(cfg, p, prefill_chunk=c)[0] == ref, c
    assert serve(cfg, p, prefill_chunk=4, kv="paged", block_size=5)[0] == ref


def test_chunked_prefill_ttft_steps_contract():
    cfg, p = params()
    prompts = [[7] * 1, [7] * 4, [7] * 5, [7] * 9]
    for c in (1, 4):
        _, srv = serve(cfg, p, [(q, 2) for q in prompts], slots=len(prompts),
                       max_seq=16, prefill_chunk=c)
        assert all(r.steps >= -(-len(r.prompt) // c) for r in srv.finished)
        assert sorted(srv.metrics.ttft_steps) == sorted(-(-len(q) // c) for q in prompts)


def test_invalid_kv_and_chunk_args_rejected():
    cfg, p = params()
    for kw, msg in ((dict(kv="virtual"), "kv must be"), (dict(prefill_chunk=0), "prefill_chunk"),
                    (dict(kv="paged", block_size=0), "block_size")):
        with pytest.raises(ValueError, match=msg):
            BatchedServer(cfg, p, batch_slots=1, max_seq=8, device=CPU, **kw)
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=8, device=CPU)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit(Request(0, [1, 2], 0))
    paged = BatchedServer(cfg, p, batch_slots=2, max_seq=8, kv="paged", block_size=1,
                          kv_blocks=2, prefill_chunk=4, device=CPU)
    with pytest.raises(ValueError, match="max_new_tokens"):
        paged.submit(Request(1, [4], 0))


# ------------------------------ metrics ----------------------------------------
def test_metrics_zero_division_edges_and_round_trip():
    m = ServeMetrics(slots=4)
    assert m.occupancy_pct == 0.0 and m.tok_per_s == 0.0
    assert m.mean_ttft_s is None and m.mean_ttft_steps is None
    assert m.kv_blocks_peak_pct == 0.0
    json.dumps(m.as_dict())
    m.tokens_generated = 5
    assert m.tok_per_s == 0.0
    m = ServeMetrics(slots=2, steps=7, active_slot_steps=11, admitted=3, finished=2,
                     deferrals=1, tokens_generated=9, prompt_tokens=6, wall_s=0.25,
                     kv_blocks_total=8, kv_blocks_peak=5, ttft_s=[0.1, 0.2],
                     ttft_steps=[2, 3])
    d = json.loads(json.dumps(m.as_dict()))
    assert ServeMetrics.from_dict(d) == m
    assert d["prefill_tokens"] == 6 and d["decode_tokens"] == 9
    assert d["kv_blocks_peak_pct"] == pytest.approx(62.5)


def test_metrics_prefill_vs_decode_token_split():
    cfg, p = params()
    for c in (1, 3):
        _, srv = serve(cfg, p, [([5, 6, 7, 8], 3)], slots=1, max_seq=16, prefill_chunk=c)
        assert srv.metrics.prompt_tokens == 4 and srv.metrics.tokens_generated == 3, c


def test_occupancy_saturated_under_poisson_stream():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=3, max_seq=16, device=CPU)
    rng = np.random.default_rng(0)
    rid, n_total = 0, 9
    while rid < n_total or srv.queue or any(srv.active):
        for _ in range(int(rng.poisson(0.9))):
            if rid < n_total:
                plen = int(rng.integers(2, 5))
                srv.submit(Request(rid, rng.integers(1, 100, plen).tolist(),
                                   int(rng.integers(3, 7))))
                rid += 1
        if srv.queue or any(srv.active):
            srv.step()
    m = srv.metrics
    assert m.finished == n_total == m.admitted
    assert m.occupancy_pct >= 60.0, m.as_dict()
    assert m.tokens_generated == sum(len(r.out) for r in srv.finished)
    assert m.tok_per_s > 0 and len(m.ttft_s) == n_total
    # TTFT in steps == prompt length under prefill-as-decode
    assert m.mean_ttft_steps == pytest.approx(
        sum(len(r.prompt) for r in srv.finished) / n_total)


def test_continuous_beats_drain_on_steps():
    cfg, p = params()
    reqs = [Request(i, [1, 2], 8 if i % 2 == 0 else 2) for i in range(6)]
    steps = {}
    for mode in ("continuous", "drain"):
        srv = BatchedServer(cfg, p, batch_slots=2, max_seq=16, admission=mode, device=CPU)
        for r in copy.deepcopy(reqs):
            srv.submit(r)
        srv.run()
        assert srv.metrics.finished == 6
        steps[mode] = srv.metrics.steps
    assert (steps["continuous"], steps["drain"]) == (21, 27), steps


def test_per_slot_stop_and_max_seq():
    cfg, p = params()
    _, srv = serve(cfg, p, [([1, 2], 3), ([1, 2, 3, 4], 50), ([7], 1)], slots=3, max_seq=10)
    done = sorted(srv.finished, key=lambda r: r.rid)
    assert len(done[0].out) == 3 and done[0].steps == 4
    assert len(done[1].out) == 10 - 4 + 1 and done[1].steps == 10
    assert len(done[2].out) == 1 and done[2].steps == 1
    assert all(r.done for r in done)


def test_run_max_steps_and_rid_order():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=20, device=CPU)
    srv.submit(Request(0, [1, 2], 9))
    srv.submit(Request(1, [3, 4], 2))
    assert srv.run(max_steps=2) == [] and srv.metrics.steps == 2
    assert [r.rid for r in srv.run()] == [0, 1]
    assert [r.rid for r in srv.finished] == [1, 0]


def test_submit_validation_and_unserved_families():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=8, device=CPU)
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit(Request(0, [], 4))
    with pytest.raises(ValueError, match="max_seq"):
        srv.submit(Request(1, list(range(1, 9)), 4))
    with pytest.raises(ValueError, match="admission"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=8, admission="magic", device=CPU)
    with pytest.raises(ValueError, match="decoder-only"):
        BatchedServer(get_reduced_config("seamless-m4t-medium"), {}, batch_slots=1,
                      max_seq=8, device=CPU)
    # the recurrent and MoE families construct (their weights do not matter
    # here)
    for arch in ("rwkv6-3b", "hymba-1.5b", "olmoe-1b-7b", "deepseek-v3-671b"):
        BatchedServer(get_reduced_config(arch), p, batch_slots=1, max_seq=8, device=CPU)
    # a mesh that is not a mesh (the sharded server takes a meshes.Mesh)
    with pytest.raises(TypeError, match="meshes.Mesh"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=8, mesh=object(), device=CPU)


def test_kernel_on_dense_falls_back_with_a_record():
    cfg, p = params()
    meshes.clear_fallbacks()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=16, attn_impl="kernel", device=CPU)
    assert srv.attn_impl == "gather"
    assert any(t == "serve_attn" for t, _, _ in meshes.fallbacks())
    with pytest.raises(ValueError, match="attn_impl"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=8, attn_impl="pallas", device=CPU)


# --------------------------- against repro ------------------------------------
# one mixed stream: prompts of 1 to 7 tokens, more requests than slots, two
# priority classes, a prompt that shares a 4-token prefix with another
_MIXED = [([5, 6, 7, 8, 2, 1, 9], 7, 2), ([1, 2], 3, 2), ([9, 3, 9, 4], 5, 0),
          ([2], 4, 2), ([5, 6, 7, 8, 3], 6, 0), ([4, 4, 4, 4, 4], 3, 2)]


@pytest.mark.parametrize("mode", [dict(),
                                  dict(kv="paged", block_size=4, prefill_chunk=3),
                                  dict(kv="paged", block_size=4, prefill_chunk=4,
                                       step_mode="tokens", attn_impl="kernel")],
                         ids=["dense", "paged_chunked", "paged_tokens_kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_matches_repro(arch, mode):
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    jmode = dict(mode, attn_impl="pallas") if mode.get("attn_impl") == "kernel" else mode
    servers = (jserving.BatchedServer(jcfg, jp, batch_slots=2, max_seq=24, **jmode),
               BatchedServer(cfg, tp, batch_slots=2, max_seq=24, device=CPU, **mode))
    for srv, req in zip(servers, (jserving.Request, Request)):
        for i, (prompt, n, prio) in enumerate(_MIXED):
            srv.submit(req(i, list(prompt), n, priority=prio))
    want, got = ([r.out for r in s.run()] for s in servers)
    for (prompt, _, _), g, w in zip(_MIXED, got, want):
        assert_greedy_matches(cfg, tp, jcfg, jp, prompt, g, w)
    jm, tm = servers[0].metrics, servers[1].metrics
    for name in ("steps", "active_slot_steps", "admitted", "finished", "tokens_generated",
                 "prompt_tokens", "batched_tokens", "preemptions", "deferrals",
                 "prefix_hits", "prefix_tokens", "kv_blocks_total", "kv_blocks_peak",
                 "kv_bytes_written", "ttft_steps"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_generate_greedy_and_score_tokens_match_repro():
    arch = "mistral-nemo-12b"
    cfg, jcfg = get_reduced_config(arch), jreduced(arch)
    jp, _ = jzoo.init_params(jcfg, jax.random.PRNGKey(6))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    prompts = [[3, 1, 4, 1], [5, 9], [2, 6, 5]]
    want = jserving.generate_greedy(jcfg, jp, prompts, 5)
    got = generate_greedy(cfg, tp, prompts, 5, device=CPU)
    for q, g, w in zip(prompts, got, want):
        assert_greedy_matches(cfg, tp, jcfg, jp, q, g, w)
    outs, m = score_tokens(cfg, tp, prompts * 4, 3, batch_slots=4, device=CPU)
    jouts, jm = jserving.score_tokens(jcfg, jp, prompts * 4, 3, batch_slots=4)
    for q, g, w in zip(prompts * 4, outs, jouts):
        assert_greedy_matches(cfg, tp, jcfg, jp, q, g, w)
    assert (m.steps, m.tokens_generated, m.finished) == (jm.steps, jm.tokens_generated,
                                                          jm.finished)
    assert score_tokens(cfg, tp, [], 3, device=CPU) == ([], None)
    with pytest.raises(ValueError, match="max_seq"):
        generate_greedy(cfg, tp, [[1, 2]], 2, max_seq=0, device=CPU)
