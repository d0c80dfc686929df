"""Admission scheduling for the serving engine: priorities, deadlines, victims.

DAnA's striders and execution engine share the database's buffer pool across
concurrent queries (PAPER.md); sharing only works in production when
contention degrades *gracefully* — a blocked head-of-line request must not
stall forever behind long-running tenants, and memory pressure must shed or
reshuffle load instead of crashing. This module is the host-side policy layer
``serve.serving.BatchedServer`` delegates those decisions to:

  * ``AdmissionScheduler`` — the admission queue. ``"priority"`` policy
    orders by ``(priority, submission order)``: **lower ``priority`` value =
    more important** (0 is the interactive class), FIFO within a class.
    ``"fifo"`` is the pre-scheduler ablation: pure submission order, no
    preemption — what ``benchmarks/bench_serve.py``'s ``serve_preempt`` rung
    measures against. A preempted request re-enters with its *original*
    submission sequence, so it resumes at the front of its class instead of
    behind every later arrival. ``"wdrr"`` layers weighted deficit round
    robin over *tenants* underneath the priority classes: within the most
    important backlogged class, tenants are visited in first-seen rotation,
    each visit replenishes the tenant's deficit counter by
    ``quantum * weight`` and the head request is admitted once the deficit
    covers its cost (``len(prompt) + max_new_tokens`` — stable across
    preemption resumes, so an evicted tenant pays for its recompute). The
    rotation pointer stays on a tenant while its deficit lasts, deficits
    reset when a tenant's backlog drains (no hoarding while idle), and a
    backlogged tenant is always served within ``ceil(cost / (quantum *
    weight))`` rotation laps — weighted shares with starvation freedom.
    ``fifo`` and ``priority`` ignore tenants entirely (the ablations).
  * request lifecycle statuses — ``QUEUED -> RUNNING -> FINISHED`` is the
    happy path; ``PREEMPTED`` (evicted, requeued, will resume), terminal
    ``CANCELLED_DEADLINE`` (deadline missed: load shed, blocks freed
    immediately) and ``REJECTED`` (impossible at submit: fails loudly AND
    carries the status). ``TERMINAL`` is the set every request must reach —
    the chaos suite's core assertion.
  * deadlines — per-request wall-clock budgets measured on the server's
    clock from ``submit_s``: ``deadline_ttft_s`` (to first token; moot once
    one is emitted) and ``deadline_s`` (end to end). ``deadline_missed``
    is the single definition both the queued-side sweep (``expired``) and
    the running-side sweep in the server use.
  * ``pick_victim`` — the preemption policy: lowest priority class first
    (highest numeric value), most recently admitted within it, so the
    longest-running work of the least important tenant is disturbed last
    and the freshly admitted is recomputed cheapest.

Pure host-side policy over ``Request`` objects — no device state, no jax.

Copy of ``repro.serve.scheduler``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Sequence

# -- request lifecycle statuses ------------------------------------------------
QUEUED = "QUEUED"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"  # evicted mid-flight, requeued; resumes via prefill
FINISHED = "FINISHED"
CANCELLED_DEADLINE = "CANCELLED_DEADLINE"
REJECTED = "REJECTED"

#: statuses a request can end in; everything else must eventually leave
TERMINAL = frozenset({FINISHED, CANCELLED_DEADLINE, REJECTED})

POLICIES = ("priority", "fifo", "wdrr")

#: deficit replenished per rotation visit, per unit of tenant weight, in
#: cost units (prompt + max_new tokens). Small enough that unit-weight
#: tenants interleave at request granularity, large enough that a typical
#: request is admittable within a few laps.
DEFAULT_QUANTUM = 32


def deadline_missed(req, now: float) -> bool:
    """True when ``req`` has blown a deadline at wall-clock ``now``.

    The end-to-end budget applies until the request is terminal; the TTFT
    budget only until the first token lands (``ttft_s`` set)."""
    if req.submit_s is None:
        return False
    waited = now - req.submit_s
    if req.deadline_s is not None and waited > req.deadline_s:
        return True
    return (req.deadline_ttft_s is not None and req.ttft_s is None
            and waited > req.deadline_ttft_s)


def _tenant(req):
    """Tenant id of a request; objects predating multi-tenancy (the query
    executor's scheduler-protocol items) fold into a single tenant 0."""
    return getattr(req, "tenant", 0)


def pick_victim(active: Sequence, below: int | None = None) -> int | None:
    """Preemption victim among ``active`` slot occupants (None = empty slot):
    the slot holding the lowest-priority (largest ``priority`` value), most
    recently admitted request. ``below`` restricts candidates to classes
    strictly less important than it (``priority > below``) — admission-driven
    preemption must never evict a peer or better; fault-forced preemption
    passes ``below=None`` and may evict anyone. Returns the slot index."""
    best: int | None = None
    best_key = None
    for slot, req in enumerate(active):
        if req is None or (below is not None and req.priority <= below):
            continue
        key = (req.priority, req.admit_seq)
        if best_key is None or key > best_key:
            best, best_key = slot, key
    return best


class AdmissionScheduler:
    """Admission queue with a pluggable ordering policy (see module doc).

    Keeps insertion cheap and ordering lazy: queues are tiny (bounded by the
    request stream, not tokens), so an O(n) min-scan per admission beats
    maintaining a heap with arbitrary removal (deadline expiry pulls from
    the middle). Iteration order is submission order — stable for tests and
    ``BatchedServer.queue`` truthiness."""

    def __init__(self, policy: str = "priority",
                 tenant_weights: dict | None = None,
                 quantum: int = DEFAULT_QUANTUM):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if tenant_weights is not None and any(
                w <= 0 for w in tenant_weights.values()):
            raise ValueError("tenant weights must be > 0 (a zero-weight "
                             "tenant would starve forever)")
        self.policy = policy
        self.tenant_weights = dict(tenant_weights or {})
        self.quantum = int(quantum)
        self._q: list = []
        self._next_seq = 0
        # wdrr state: per-tenant deficit counters, first-seen rotation order,
        # and the rotation pointer (index into _rr of the tenant being served)
        self._deficit: dict = {}
        self._rr: list = []
        self._rr_pos = 0
        # True when the rotation pointer just arrived at _rr_pos and that
        # tenant has not been replenished yet this visit
        self._rr_fresh = True

    # -- queue protocol ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)

    def _key(self, req):
        # fifo ignores class: pure submission order. A preempted request
        # keeps its original seq in both policies, so it resumes ahead of
        # later arrivals (of its class, under priority ordering).
        if self.policy == "fifo":
            return (req.seq,)
        return (req.priority, req.seq)

    def push(self, req) -> None:
        """Enqueue ``req``; first-time pushes get the next submission
        sequence number, re-pushes (preempted requests) keep theirs."""
        if req.seq < 0:
            req.seq = self._next_seq
            self._next_seq += 1
        if self.policy == "wdrr":
            t = _tenant(req)
            if t not in self._deficit:
                self._deficit[t] = 0.0
                self._rr.append(t)
        self._q.append(req)

    # -- weighted deficit round robin ----------------------------------------
    def _weight(self, tenant) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    @staticmethod
    def _cost(req) -> int:
        """Admission cost in tokens. Uses the request's *full* footprint
        (prompt + generation budget), not the resume remainder: a preempted
        tenant is re-charged on resume, so eviction-and-recompute spends that
        tenant's share rather than everyone else's."""
        return len(req.prompt) + req.max_new_tokens

    def _wdrr_pick(self, commit: bool):
        """One weighted-DRR selection over the most important backlogged
        priority class. Pure when ``commit`` is False (``peek``); with
        ``commit`` the deficit counters and rotation pointer advance
        (``pop``). Both run the identical deterministic scan, so peek always
        shows what pop admits."""
        if not self._q:
            return None
        lo = min(r.priority for r in self._q)
        by_tenant: dict = {}
        for r in sorted((r for r in self._q if r.priority == lo),
                        key=lambda r: r.seq):
            by_tenant.setdefault(_tenant(r), []).append(r)
        deficits = dict(self._deficit)
        nrr = len(self._rr)
        pos = self._rr_pos % nrr
        fresh = self._rr_fresh
        # a backlogged tenant gains quantum*weight once per lap, so laps are
        # bounded by the largest head cost over the smallest per-lap gain
        max_cost = max(self._cost(q[0]) for q in by_tenant.values())
        min_gain = self.quantum * min(self._weight(t) for t in by_tenant)
        max_hops = (nrr + 1) * (int(max_cost / min_gain) + 2)
        chosen = None
        for _ in range(max_hops):
            t = self._rr[pos % nrr]
            if t not in by_tenant:
                pos, fresh = pos + 1, True
                continue
            head = by_tenant[t][0]
            cost = self._cost(head)
            if deficits[t] < cost and fresh:
                # replenish exactly once per rotation arrival — the pointer
                # parking on a tenant mid-service must not keep minting
                # deficit, or one tenant would drain before the next is seen
                deficits[t] += self.quantum * self._weight(t)
                fresh = False
            if deficits[t] >= cost:
                # serve and keep the pointer on t: continued service drains
                # the banked deficit before the rotation moves on
                deficits[t] -= cost
                chosen = head
                break
            pos, fresh = pos + 1, True
        assert chosen is not None, "wdrr scan failed to converge (bug)"
        if commit:
            self._deficit = deficits
            self._rr_pos = pos % nrr
            self._rr_fresh = fresh
        return chosen

    def peek(self):
        """The request the policy admits next, or None."""
        if not self._q:
            return None
        if self.policy == "wdrr":
            return self._wdrr_pick(commit=False)
        return min(self._q, key=self._key)

    def pop(self):
        """Remove and return what ``peek`` showed."""
        if not self._q:
            return None
        if self.policy == "wdrr":
            req = self._wdrr_pick(commit=True)
        else:
            req = min(self._q, key=self._key)
        self._q.remove(req)
        self._drain_reset(req)
        return req

    def _drain_reset(self, req) -> None:
        """Classic DRR anti-hoarding: a tenant whose backlog just drained
        forfeits its remaining deficit — an idle tenant must not bank
        service and later burst past its weighted share."""
        if self.policy != "wdrr":
            return
        t = _tenant(req)
        if not any(_tenant(r) == t for r in self._q):
            self._deficit[t] = 0.0

    def expired(self, now: float) -> list:
        """Remove and return every queued request whose deadline has passed
        (the queued-side sweep; the server cancels what this returns)."""
        out = [r for r in self._q if deadline_missed(r, now)]
        for r in out:
            self._q.remove(r)
            self._drain_reset(r)
        return out
