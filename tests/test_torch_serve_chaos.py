"""Preemption, deadlines and seeded fault injection in the port's server on
the CPU: the GQA cases of ``tests/test_serve_chaos.py`` and the server cases
of ``tests/test_serve_scheduler.py``. Under every fault plan each request
ends in a terminal status, the block-pool invariants hold after every step
(``check()``), the pool drains, and every FINISHED request byte-matches its
uncontended greedy run; preempt-then-resume is token-exact across dense and
paged KV, chunked and token stepping."""
import functools

import numpy as np
import pytest

from test_torch_serve_util import CPU, one_cpu_thread, params  # noqa: F401
from repro_torch.configs import get_reduced_config
from repro_torch.serve import scheduler as sched
from repro_torch.serve.faults import FaultEvent, FaultPlan, VirtualClock
from repro_torch.serve.serving import BatchedServer, Request

SEEDS = list(range(14))
# (prompt len, max_new, priority); rids 2 and 5 carry deadlines
_MIX = [(4, 6, 0), (6, 8, 1), (5, 5, 2), (7, 7, 2), (4, 6, 1), (6, 5, 0)]


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    vocab = get_reduced_config("internlm2-20b").vocab_size
    return [list(map(int, rng.integers(1, vocab, s))) for s in sizes]


_MIX_PROMPTS = _prompts([s for s, _, _ in _MIX], seed=7)


def _solo(prompt, max_new, max_seq=64, **kw):
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=max_seq, device=CPU, **kw)
    srv.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=max_new))
    return srv.run()[0].out


@functools.cache
def _oracle(rid):
    """Uncontended greedy output of request ``rid`` of the mix (token-exact
    across dense/paged and chunked/tokens, so one oracle serves every mode)."""
    return _solo(_MIX_PROMPTS[rid], _MIX[rid][1], max_seq=48, prefill_chunk=4)


def _requests(deadlines=True):
    reqs = []
    for rid, (_, max_new, prio) in enumerate(_MIX):
        kw = {}
        if deadlines and rid == 2:
            kw["deadline_ttft_s"] = 1.0
        if deadlines and rid == 5:
            kw["deadline_s"] = 2.5
        reqs.append(Request(rid=rid, prompt=list(_MIX_PROMPTS[rid]), max_new_tokens=max_new,
                            priority=prio, **kw))
    return reqs


def _chaos_run(plan, step_mode="chunked", kv="paged", deadlines=True, max_steps=300):
    cfg, p = params()
    kw = dict(prefill_chunk=4, step_mode=step_mode, fault_plan=plan, debug_checks=True)
    if kv == "paged":
        kw.update(kv="paged", block_size=8)
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=48, device=CPU, **kw)
    reqs = _requests(deadlines=deadlines)
    for r in reqs:
        srv.submit(r)
    return srv, reqs, srv.run(max_steps=max_steps)


def _assert_contracts(srv, reqs, done):
    assert not srv.queue and all(r is None for r in srv.active)
    assert len(done) == len(reqs)
    assert all(r.status in sched.TERMINAL for r in reqs)
    assert srv.metrics.finished + srv.metrics.deadline_misses == len(reqs)
    if srv._paged is not None:
        srv._paged.check()
        pool = srv._paged.pool
        assert pool.blocks_in_use == 0 and pool.reserved_blocks == 0
        assert pool.free_blocks + pool.quarantined_blocks == pool.num_blocks
    for r in reqs:
        if r.status == sched.FINISHED:
            assert r.out == _oracle(r.rid), (r.rid, r.preemptions)


# ------------------------------ chaos -----------------------------------------
@pytest.mark.parametrize("step_mode", ["chunked", "tokens"])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_chaos(seed, step_mode):
    plan = FaultPlan.random(seed, horizon=16, max_blocks=3)
    _assert_contracts(*_chaos_run(plan, step_mode=step_mode))


@pytest.mark.parametrize("seed", [0, 5])
def test_chaos_replay_determinism(seed):
    def once():
        plan = FaultPlan.random(seed, horizon=16, max_blocks=3)
        srv, reqs, _ = _chaos_run(plan)
        return ([(r.rid, r.status, tuple(r.out), r.preemptions) for r in reqs],
                srv.metrics.preemptions, plan.applied)

    assert once() == once()


def test_scripted_midrun_shrink_preempts_not_raises():
    plan = FaultPlan([FaultEvent(2, "shrink_pool", 12)], heal_step=8)
    srv, reqs, done = _chaos_run(plan, deadlines=False)
    _assert_contracts(srv, reqs, done)
    assert srv.metrics.preemptions > 0 and srv.metrics.recompute_tokens > 0
    assert all(r.status == sched.FINISHED for r in reqs)


def test_scripted_admission_stall():
    plan = FaultPlan([FaultEvent(0, "stall_admission", 5)], heal_step=6)
    srv, reqs, done = _chaos_run(plan, deadlines=False)
    _assert_contracts(srv, reqs, done)
    assert all(r.status == sched.FINISHED for r in reqs)


def test_scripted_deadline_storm():
    plan = FaultPlan([FaultEvent(0, "stall_admission", 4), FaultEvent(1, "advance_clock", 3.0)],
                     heal_step=5)
    assert isinstance(plan.clock, VirtualClock)
    srv, reqs, done = _chaos_run(plan)
    _assert_contracts(srv, reqs, done)
    assert srv.metrics.deadline_misses == 2
    by_rid = {r.rid: r.status for r in reqs}
    assert by_rid[2] == by_rid[5] == sched.CANCELLED_DEADLINE


@pytest.mark.parametrize("seed", [1, 3, 8])
def test_dense_mode_chaos(seed):
    plan = FaultPlan.random(seed, horizon=16, max_blocks=3)
    _assert_contracts(*_chaos_run(plan, kv="dense"))


def test_headroom_deficit_closes_admission_and_recovers():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=48, kv="paged", block_size=8,
                        prefill_chunk=4, debug_checks=True, device=CPU)
    srv.submit(Request(rid=0, prompt=list(_MIX_PROMPTS[0]), max_new_tokens=_MIX[0][1]))
    srv.step()
    pool = srv._paged.pool
    assert pool.reserved_blocks > 0 and srv._paged.shrink(pool.num_blocks) > 0
    assert pool.free_blocks < pool.reserved_blocks and pool.headroom == 0
    assert not pool.can_admit(1)
    srv.submit(Request(rid=1, prompt=list(_MIX_PROMPTS[1]), max_new_tokens=_MIX[1][1]))
    srv.step()
    assert srv.metrics.deferrals >= 1
    srv._paged.grow(None)
    assert {r.rid: r.out for r in srv.run(max_steps=200)} == {0: _oracle(0), 1: _oracle(1)}
    assert pool.blocks_in_use == 0 and pool.reserved_blocks == 0


# ---------------------------- scheduling --------------------------------------
def test_submit_rejection_carries_status_and_policy_validation(monkeypatch):
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=16, device=CPU)
    bad = Request(rid=0, prompt=[1], max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit(bad)
    assert bad.status == sched.REJECTED and srv.metrics.rejected == 1
    worse = Request(rid=1, prompt=[1], max_new_tokens=1, deadline_s=-1.0)
    with pytest.raises(ValueError, match="deadline_s"):
        srv.submit(worse)
    assert worse.status == sched.REJECTED and not srv.queue
    with pytest.raises(ValueError, match="scheduler"):
        BatchedServer(cfg, p, batch_slots=1, max_seq=16, scheduler="lifo", device=CPU)
    assert srv.debug_checks  # under pytest
    monkeypatch.setenv("REPRO_SERVE_DEBUG_CHECKS", "0")
    assert not BatchedServer(cfg, p, batch_slots=1, max_seq=16, device=CPU).debug_checks
    monkeypatch.setenv("REPRO_SERVE_DEBUG_CHECKS", "1")
    assert not BatchedServer(cfg, p, batch_slots=1, max_seq=16, debug_checks=False,
                             device=CPU).debug_checks


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("step_mode", ["chunked", "tokens"])
def test_preempt_resume_token_exact(kv, step_mode):
    cfg, p = params()
    prompts = _prompts([7, 5])
    kw = dict(prefill_chunk=4, step_mode=step_mode)
    if kv == "paged":
        kw.update(kv="paged", block_size=8)
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=64, device=CPU, **kw)
    for i, q in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=q, max_new_tokens=8, priority=2))
    for _ in range(3):
        srv.step()
    victim = next(i for i, r in enumerate(srv.active) if r is not None)
    assert len(srv.active[victim].out) > 0
    srv._preempt(victim)
    done = {r.rid: r for r in srv.run()}
    assert srv.metrics.preemptions == 1 and srv.metrics.recompute_tokens > 0
    for i, q in enumerate(prompts):
        assert done[i].status == sched.FINISHED
        assert done[i].out == _solo(q, 8, **kw), i
    assert len([r for r in done.values() if r.preemptions > 0]) == 1


def test_preempt_mid_prefill_and_twice_token_exact():
    cfg, p = params()
    kw = dict(prefill_chunk=4, kv="paged", block_size=8)
    (prompt,) = _prompts([11])
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=64, device=CPU, **kw)
    srv.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
    srv.step()
    assert len(srv.active[0].out) == 0
    srv._preempt(0)
    (req,) = srv.run()
    assert req.out == _solo(prompt, 6, **kw) and req.preemptions == 1
    assert len(srv.metrics.ttft_s) == 1

    bg_p, hi1_p, hi2_p = _prompts([6, 4, 5])
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=64, device=CPU, **kw)
    bg = Request(rid=0, prompt=bg_p, max_new_tokens=16, priority=2)
    srv.submit(bg)
    for _ in range(3):
        srv.step()
    srv.submit(Request(rid=1, prompt=hi1_p, max_new_tokens=3, priority=0))
    carried = len(bg.out)
    for _ in range(50):
        srv.step()
        if bg.status == sched.RUNNING and len(bg.out) > carried:
            break
    else:
        pytest.fail("background request never resumed")
    srv.submit(Request(rid=2, prompt=hi2_p, max_new_tokens=3, priority=0))
    done = {r.rid: r for r in srv.run()}
    assert bg.preemptions == 2
    for rid, (q, n) in enumerate(((bg_p, 16), (hi1_p, 3), (hi2_p, 3))):
        assert done[rid].status == sched.FINISHED and done[rid].out == _solo(q, n, **kw)


def test_admission_preemption_needs_strictly_lower_victim():
    cfg, p = params()
    prompts = _prompts([5, 5, 5])
    for policy, peer_prio, expect in [("priority", 1, 0), ("priority", 0, 1), ("fifo", 0, 0)]:
        srv = BatchedServer(cfg, p, batch_slots=1, max_seq=64, prefill_chunk=4,
                            scheduler=policy, device=CPU)
        srv.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=12, priority=1))
        srv.step()
        srv.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=2, priority=peer_prio))
        srv.step()
        assert srv.metrics.preemptions == expect, (policy, peer_prio)
        srv.run()


def test_deferral_episodes_count_blocked_requests_not_head_swaps():
    cfg, p = params()
    srv = BatchedServer(cfg, p, batch_slots=2, max_seq=24, kv="paged", block_size=4,
                        prefill_chunk=1, kv_blocks=6, device=CPU)
    srv.submit(Request(rid=0, prompt=[5, 6, 7, 8], max_new_tokens=16, priority=0))
    srv.step()
    srv.submit(Request(rid=1, prompt=[1, 2, 3, 4], max_new_tokens=4, priority=2))
    for _ in range(3):
        srv.step()
    assert srv.metrics.deferrals == 1 and srv.metrics.deferral_steps == 3
    srv.submit(Request(rid=2, prompt=[4, 3, 2, 1], max_new_tokens=4, priority=1))
    for _ in range(3):
        srv.step()
    assert srv.metrics.deferrals == 2
    done = {r.rid: r.status for r in srv.run(max_steps=100)}
    assert done == {0: sched.FINISHED, 1: sched.FINISHED, 2: sched.FINISHED}
    assert srv.metrics.deferrals == 2 and srv.metrics.deferral_steps > 2


def test_deadline_cancels_running_and_queued():
    cfg, p = params()
    prompts = _prompts([5, 5, 5])
    clk = VirtualClock()
    srv = BatchedServer(cfg, p, batch_slots=1, max_seq=64, prefill_chunk=4, kv="paged",
                        block_size=8, clock=clk, device=CPU)
    reqs = (Request(rid=0, prompt=prompts[0], max_new_tokens=40, deadline_s=1.0),
            Request(rid=1, prompt=prompts[1], max_new_tokens=4, deadline_ttft_s=0.5),
            Request(rid=2, prompt=prompts[2], max_new_tokens=4))
    for r in reqs:
        srv.submit(r)
    srv.step()
    clk.advance(2.0)
    assert {r.rid: r.status for r in srv.run()} == {
        0: sched.CANCELLED_DEADLINE, 1: sched.CANCELLED_DEADLINE, 2: sched.FINISHED}
    assert srv.metrics.deadline_misses == 2 and srv._paged.pool.blocks_in_use == 0


def test_priority_class_ttft_beats_fifo():
    cfg, p = params()
    bg_prompts, hi_prompts = _prompts([6, 6, 6, 6], seed=1), _prompts([4, 4], seed=2)

    def drive(policy):
        srv = BatchedServer(cfg, p, batch_slots=2, max_seq=64, prefill_chunk=4, kv="paged",
                            block_size=8, scheduler=policy, device=CPU)
        bg = [Request(rid=i, prompt=q, max_new_tokens=24, priority=2)
              for i, q in enumerate(bg_prompts)]
        for r in bg:
            srv.submit(r)
        for _ in range(3):
            srv.step()
        for i, q in enumerate(hi_prompts):
            srv.submit(Request(rid=100 + i, prompt=q, max_new_tokens=2, priority=0))
        srv.run()
        return srv, bg

    pre, pre_bg = drive("priority")
    fifo, fifo_bg = drive("fifo")
    assert pre.metrics.preemptions > 0 and fifo.metrics.preemptions == 0
    assert pre.metrics.mean_prio_ttft_e2e_steps(0) < fifo.metrics.mean_prio_ttft_e2e_steps(0)
    for a, b in zip(pre_bg, fifo_bg):
        assert a.out == b.out


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent(0, "melt_pool", 1)
    with pytest.raises(ValueError, match="heal_step"):
        FaultPlan([FaultEvent(5, "shrink_pool", 1)], heal_step=3)
    a, b = FaultPlan.random(11, horizon=12).events, FaultPlan.random(11, horizon=12).events
    assert a == b and len(a) > 0
