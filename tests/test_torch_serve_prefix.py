"""Refcounted prefix-sharing KV blocks in the port's server on the CPU: the GQA
cases of ``tests/test_serve_prefix.py``. A server with ``prefix_cache=True``
(requests map resident prompt blocks read-only, pay prefill only from their
first divergent block, and copy a shared block before writing it) must emit
exactly the tokens the unshared pool emits, across step modes and both
attention read paths, full-prompt hits, preempt-then-resume, block 0 shared
under clamped table entries, and a synthetic production trace."""
import pytest

from test_torch_serve_util import CPU, one_cpu_thread, params  # noqa: F401
from repro_torch.dist import meshes
from repro_torch.serve.faults import replay_trace, synth_trace
from repro_torch.serve.kv_pool import KVBlockPool, PagedKV
from repro_torch.serve.serving import BatchedServer, Request

# a 3-full-block (block_size 4) shared template; requests diverge on token 13
_SHARED = [7, 3, 9, 1, 4, 2, 8, 5, 6, 1, 3, 7]
# rid 0 is a long-running holder, so its registered template blocks are
# still resident when rids 2/3 are admitted into the slots rids 1/2 freed
_STREAM = [(0, _SHARED + [10], 20), (1, _SHARED + [11], 4),
           (2, _SHARED + [12], 5), (3, _SHARED + [13], 6)]


def _serve(cfg, p, stream, prefix, **kw):
    kw = dict(dict(batch_slots=2, max_seq=40, kv="paged", block_size=4, prefill_chunk=4), **kw)
    srv = BatchedServer(cfg, p, prefix_cache=prefix, device=CPU, **kw)
    for rid, prompt, n in stream:
        srv.submit(Request(rid, list(prompt), n))
    return {r.rid: r.out for r in srv.run(max_steps=500)}, srv


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
@pytest.mark.parametrize("step_mode", ["chunked", "tokens"])
@pytest.mark.parametrize("arch", ["internlm2-20b", "mistral-nemo-12b"])
def test_shared_prefix_token_exact(arch, step_mode, attn_impl):
    cfg, p = params(arch)
    kw = dict(step_mode=step_mode, attn_impl=attn_impl)
    ref, off = _serve(cfg, p, _STREAM, prefix=False, **kw)
    got, on = _serve(cfg, p, _STREAM, prefix=True, **kw)
    assert on.prefix_cache and not off.prefix_cache
    assert got == ref
    m_on, m_off = on.metrics, off.metrics
    assert m_on.finished == len(_STREAM) == m_off.finished
    assert m_on.prefix_hits > 0 and m_on.prefix_tokens > 0
    assert m_on.prompt_tokens < m_off.prompt_tokens
    assert 0 < m_on.kv_bytes_written < m_off.kv_bytes_written
    pool = on._paged.pool
    assert pool.blocks_in_use == 0 and pool.reserved_blocks == 0
    assert len(on._paged.index) == 0
    on._paged.check()


@pytest.mark.parametrize("step_mode", ["chunked", "tokens"])
def test_full_prompt_hit_cow_splits_before_write(step_mode):
    cfg, p = params()
    stream = [(0, list(_SHARED), 16), (1, list(_SHARED), 4), (2, list(_SHARED), 5)]
    ref, _ = _serve(cfg, p, stream, prefix=False, step_mode=step_mode)
    got, srv = _serve(cfg, p, stream, prefix=True, step_mode=step_mode)
    assert got == ref
    assert srv.metrics.prefix_hits > 0 and srv.metrics.cow_splits > 0
    srv._paged.check()


def test_preempt_then_resume_holding_shared_blocks_token_exact():
    cfg, p = params()
    lo = [(0, _SHARED + [10], 16, 2), (1, _SHARED + [11], 12, 2)]
    hi = [(2, _SHARED + [12], 6, 0), (3, [9, 9, 2, 1, 8], 6, 0)]
    ref, _ = _serve(cfg, p, [(r, q, n) for r, q, n, _ in lo + hi], prefix=False)
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=40, kv="paged", block_size=4,
                        prefill_chunk=4, kv_blocks=14, scheduler="priority",
                        prefix_cache=True, device=CPU)
    for rid, q, n, prio in lo:
        srv.submit(Request(rid, list(q), n, priority=prio))
    srv.step()
    srv.step()
    for rid, q, n, prio in hi:
        srv.submit(Request(rid, list(q), n, priority=prio))
    done = {r.rid: r.out for r in srv.run(max_steps=500)}
    assert srv.metrics.preemptions > 0 and srv.metrics.prefix_hits > 0
    assert done == ref
    srv._paged.check()
    assert srv._paged.pool.blocks_in_use == 0


def test_block_zero_shared_clamp_is_harmless():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=40, kv="paged", block_size=4,
                        prefill_chunk=4, prefix_cache=True, device=CPU)
    srv.submit(Request(0, _SHARED + [10], 14))
    for _ in range(4):
        srv.step()
    pool = srv._paged.pool
    assert int(pool.table[0, 0]) == 0 and 0 in srv._paged.index.blocks()
    srv.submit(Request(1, _SHARED + [11], 8))
    srv.step()
    assert int(pool.refcount[0]) == 2 and pool.table_array().min() == 0
    done = {r.rid: r.out for r in srv.run(max_steps=300)}
    ref, _ = _serve(cfg, p, [(0, _SHARED + [10], 14), (1, _SHARED + [11], 8)], prefix=False)
    assert done == ref
    srv._paged.check()


def test_prefix_cache_eligibility_and_fallback():
    with pytest.raises(ValueError, match="ring"):
        PagedKV(block_size=4, max_seq=16, pool=KVBlockPool(8, 4, 2, 4), ring_width=8,
                ring=KVBlockPool(8, 4, 2, 4), prefix_cache=True)
    cfg, p = params()
    meshes.clear_fallbacks()
    dense = BatchedServer(cfg, p, batch_slots=2, max_seq=24, prefix_cache=True, device=CPU)
    assert dense.prefix_cache is False
    assert any(t == "serve_prefix" for t, _, _ in meshes.fallbacks())
    auto = BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged", block_size=4,
                         device=CPU)
    assert auto.prefix_cache is True
    meshes.clear_fallbacks()
    assert BatchedServer(cfg, p, batch_slots=2, max_seq=24, device=CPU).prefix_cache is False
    assert not meshes.fallbacks()


_TRACE_KW = dict(steps=10, tenants=2, vocab=32, rate=0.5, p_shared=0.9,
                 templates_per_tenant=1, template_len=12, mean_suffix=3,
                 max_prompt=20, max_new=6)


def test_trace_replay_determinism_and_prefix_parity():
    cfg, p = params()
    trace = synth_trace(7, **_TRACE_KW)
    assert len(trace) > 3 and trace.shared_fraction() > 0.5

    def replay(prefix):
        srv = BatchedServer(cfg, p, batch_slots=3, max_seq=32, kv="paged", block_size=4,
                            prefill_chunk=4, scheduler="wdrr",
                            tenant_weights=trace.tenant_weights, prefix_cache=prefix,
                            device=CPU)
        return {r.rid: r.out for r in replay_trace(srv, trace, max_steps=600)}, srv

    out_on, srv_on = replay(True)
    out_on2, _ = replay(True)
    out_off, srv_off = replay(False)
    assert out_on == out_on2 == out_off
    m_on, m_off = srv_on.metrics, srv_off.metrics
    assert m_on.finished == len(trace) == m_off.finished
    assert m_on.prefix_hits > 0 and m_on.prompt_tokens < m_off.prompt_tokens
    per = m_on.per_tenant
    assert sorted(per) == trace.tenants
    assert sum(v["finished"] for v in per.values()) == m_on.finished
    assert sum(v["tokens_generated"] for v in per.values()) == m_on.tokens_generated
    assert sum(v["prefix_hits"] for v in per.values()) == m_on.prefix_hits


def test_synth_trace_validation_and_determinism():
    with pytest.raises(ValueError, match="template_len"):
        synth_trace(0, template_len=32, max_prompt=32)
    with pytest.raises(ValueError, match="tenants"):
        synth_trace(0, tenants=0)
    a, b = synth_trace(3, steps=6), synth_trace(3, steps=6)
    assert a.requests == b.requests and a.tenant_weights == {0: 1.0, 1: 2.0, 2: 4.0}
    assert all(1 <= len(r.prompt) <= 32 and r.max_new_tokens >= 1 for r in a.requests)


def test_replay_trace_bounded_drain_raises():
    cfg, p = params()
    trace = synth_trace(1, steps=6, tenants=2, rate=1.0, max_prompt=16, max_new=4)
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged", block_size=4,
                        device=CPU)
    with pytest.raises(RuntimeError, match="did not drain"):
        replay_trace(srv, trace, max_steps=0)
