"""Seeded fault injection + synthetic production traces for the serving engine.

Nothing in a green test suite proves the engine survives the conditions the
robustness machinery exists for — pool pressure mid-decode, forced evictions,
a stalled admission path, deadline storms. ``FaultPlan`` scripts those
conditions as *deterministic, seeded* schedules the server applies at chosen
steps, so every chaos failure is a replayable unit test, not a flake:

  * ``shrink_pool n`` — quarantine up to ``n`` blocks out of the paged pool's
    free list (``KVBlockPool.shrink``). Capacity vanishes out from under
    outstanding reservations, so a later ``ensure_step`` can hit
    ``PoolExhausted`` mid-run — exercising the server's preempt-on-pressure
    path. No-op on dense servers.
  * ``grow_pool n`` — return quarantined blocks.
  * ``force_preempt k`` — evict up to ``k`` victims via the server's victim
    policy regardless of priority (``pick_victim(below=None)``): the
    recompute-on-resume path under fire.
  * ``stall_admission k`` — admission skipped for the next ``k`` steps
    (deadline sweeps keep running): head-of-line pressure without pool
    involvement.
  * ``advance_clock dt`` — tick the plan's ``VirtualClock`` by ``dt``
    seconds. A plan that carries clock events owns the server's clock, so
    deadline pressure fires at *chosen steps* instead of wherever a real
    runner's wall clock happens to land.

Every plan **heals**: at ``heal_step`` (default: one past the last event) all
quarantined blocks return and stalls clear, so a bounded ``run(max_steps=)``
always drains — the chaos suite's termination guarantee. ``applied`` logs
each event's observed effect for debugging a failing seed.

The second half of this module is the **production-trace harness** the
``serve_prefix`` bench and the fairness tests measure against. Real serving
traffic is not what ad-hoc test loops generate: arrivals are bursty per
tenant, lengths are heavy-tailed, and most prompts open with one of a few
shared templates (system prompts, few-shot preambles — the structure the
prefix cache exists to exploit). ``synth_trace`` generates exactly that shape
from a seed:

  * per-tenant Poisson arrivals (requests per server step) with seeded burst
    windows during which the tenant's rate multiplies;
  * heavy-tailed (lognormal, clipped) prompt-suffix and output lengths —
    a few whales among many minnows, the distribution that stresses both
    block budgets and fairness;
  * per-tenant template pools: each request opens with one of the tenant's
    shared prompt templates with probability ``p_shared`` (templates are
    tenant-private — cross-tenant prompts never collide, so sharing wins
    come from *within*-tenant traffic, the realistic case).

``replay_trace`` feeds a trace through a ``BatchedServer`` against the
server's own fused-step clock (``server.step_no``): a request is submitted
the step it "arrives", so two configurations replaying the same seed see the
*identical* offered load — the controlled-experiment property every A/B in
``benchmarks/bench_serve.py`` leans on.

Copy of ``repro.serve.faults``, which it is held against; the port imports nothing of
``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("shrink_pool", "grow_pool", "force_preempt", "stall_admission",
         "advance_clock")


class VirtualClock:
    """Deterministic stand-in for ``time.perf_counter``: returns a manually
    advanced value, so wall-clock deadlines become scriptable."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str
    arg: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.step < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")


class FaultPlan:
    """A replayable fault schedule (see module doc).

    ``clock`` is created automatically when any ``advance_clock`` event is
    present (pass one explicitly to share it with the request generator);
    ``BatchedServer`` adopts it as the server clock when set."""

    def __init__(self, events: list[FaultEvent], heal_step: int | None = None,
                 clock: VirtualClock | None = None):
        self.events = sorted(events, key=lambda e: (e.step, KINDS.index(e.kind)))
        last = max((e.step for e in self.events), default=-1)
        self.heal_step = last + 1 if heal_step is None else int(heal_step)
        if self.heal_step <= last:
            raise ValueError(
                f"heal_step {self.heal_step} must come after the last "
                f"event (step {last}): an unhealed plan can wedge the server"
            )
        if clock is None and any(e.kind == "advance_clock" for e in self.events):
            clock = VirtualClock()
        self.clock = clock
        self.applied: list[tuple[int, str, float, float]] = []
        self._healed = False

    @classmethod
    def random(cls, seed: int, horizon: int = 24, *,
               p_shrink: float = 0.18, p_grow: float = 0.10,
               p_preempt: float = 0.15, p_stall: float = 0.10,
               p_clock: float = 0.35, max_blocks: int = 4,
               clock: VirtualClock | None = None) -> "FaultPlan":
        """Seeded-random schedule over ``horizon`` steps; identical seed =
        identical chaos, which is what makes a chaos failure debuggable."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        for step in range(horizon):
            if rng.random() < p_shrink:
                events.append(FaultEvent(step, "shrink_pool",
                                         int(rng.integers(1, max_blocks + 1))))
            if rng.random() < p_grow:
                events.append(FaultEvent(step, "grow_pool",
                                         int(rng.integers(1, max_blocks + 1))))
            if rng.random() < p_preempt:
                events.append(FaultEvent(step, "force_preempt",
                                         int(rng.integers(1, 3))))
            if rng.random() < p_stall:
                events.append(FaultEvent(step, "stall_admission",
                                         int(rng.integers(1, 4))))
            if rng.random() < p_clock:
                events.append(FaultEvent(step, "advance_clock",
                                         float(rng.uniform(0.05, 0.6))))
        return cls(events, heal_step=horizon, clock=clock)

    def events_at(self, step: int) -> list[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def apply(self, server, step: int) -> None:
        """Apply this plan's events for ``step`` to ``server`` (called at the
        top of ``BatchedServer.step``). Idempotent healing at ``heal_step``."""
        from repro_torch.serve import scheduler as sched

        for ev in self.events_at(step):
            effect = 0.0
            if ev.kind == "shrink_pool":
                if server._paged is not None:
                    effect = server._paged.shrink(int(ev.arg))
            elif ev.kind == "grow_pool":
                if server._paged is not None:
                    effect = server._paged.grow(int(ev.arg))
            elif ev.kind == "force_preempt":
                for _ in range(int(ev.arg)):
                    victim = sched.pick_victim(server.active, below=None)
                    if victim is None:
                        break
                    server._preempt(victim)
                    effect += 1
            elif ev.kind == "stall_admission":
                server._admit_stall = max(server._admit_stall, int(ev.arg))
                effect = server._admit_stall
            elif ev.kind == "advance_clock":
                if self.clock is not None:
                    self.clock.advance(ev.arg)
                    effect = ev.arg
            self.applied.append((step, ev.kind, float(ev.arg), float(effect)))
        if step >= self.heal_step and not self._healed:
            self._healed = True
            if server._paged is not None:
                healed = server._paged.grow(None)
                self.applied.append((step, "heal", 0.0, float(healed)))
            server._admit_stall = 0


# ---------------------------------------------------------------------------
# Synthetic production traces (see module doc, second half)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival in a synthetic trace: everything ``replay_trace`` needs to
    build a ``serve.serving.Request``. ``template_id`` records which of the
    tenant's shared templates (if any) opens the prompt — analysis metadata,
    not replayed state."""
    rid: int
    arrival_step: int
    tenant: int
    priority: int
    prompt: tuple
    max_new_tokens: int
    template_id: int = -1


@dataclasses.dataclass(frozen=True)
class Trace:
    """A seeded synthetic workload: arrivals sorted by ``arrival_step`` (rid
    order == arrival order), plus the tenant weights the generator assigned —
    hand these to ``BatchedServer(tenant_weights=...)`` so the wdrr scheduler
    competes tenants at the shape the trace was built for."""
    requests: tuple
    tenant_weights: dict
    seed: int

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def tenants(self) -> list:
        return sorted({r.tenant for r in self.requests})

    def shared_fraction(self) -> float:
        """Fraction of requests opening with a shared template."""
        if not self.requests:
            return 0.0
        return sum(r.template_id >= 0 for r in self.requests) / len(self.requests)


def _clipped_lognormal(rng, mean: float, sigma: float, lo: int, hi: int) -> int:
    """Heavy-tailed length draw: lognormal scaled to ``mean``, clipped into
    ``[lo, hi]`` — most draws land well under the mean, a few whales push
    against ``hi`` (the tail the block budget has to survive)."""
    # median = mean / exp(sigma^2/2) keeps the configured mean after the
    # lognormal's tail inflation
    mu = float(np.log(max(mean, 1.0)) - 0.5 * sigma * sigma)
    return int(np.clip(round(float(rng.lognormal(mu, sigma))), lo, hi))


def synth_trace(seed: int, *, steps: int = 48, tenants: int = 3,
                vocab: int = 64, rate: float = 0.25, burst_mult: float = 4.0,
                p_burst: float = 0.12, burst_len: int = 4,
                templates_per_tenant: int = 2, template_len: int = 12,
                p_shared: float = 0.7, mean_suffix: int = 4,
                mean_new: float = 6.0, sigma: float = 0.6,
                max_prompt: int = 32, max_new: int = 16,
                weights: dict | None = None) -> Trace:
    """Generate a seeded synthetic production trace (see module doc).

    Each tenant arrives as an independent Poisson process at ``rate``
    requests per step, multiplied by ``burst_mult`` inside seeded burst
    windows (each step opens a ``burst_len``-step window with probability
    ``p_burst``). A request opens with one of the tenant's
    ``templates_per_tenant`` shared ``template_len``-token templates with
    probability ``p_shared``, followed by a heavy-tailed unique suffix;
    non-template prompts are fully unique. Lengths are clipped lognormals
    (``sigma`` controls the tail). ``weights`` defaults to ``2**t`` — tenant
    0 lightest — so weighted-fairness runs have real shares to enforce.

    Same seed, same kwargs -> identical trace, independent of the server it
    later replays through.
    """
    if tenants < 1 or steps < 1:
        raise ValueError(f"need tenants >= 1 and steps >= 1, got "
                         f"{tenants}, {steps}")
    if template_len >= max_prompt:
        raise ValueError(f"template_len {template_len} must leave room under "
                         f"max_prompt {max_prompt}")
    rng = np.random.default_rng(seed)
    # tenant-private template pools: disjoint across tenants by construction
    # (independent random draws over vocab make cross-tenant collisions
    # astronomically unlikely; prefix keys are exact, so a collision would
    # only merge genuinely identical token blocks anyway)
    pools = [
        [tuple(int(t) for t in rng.integers(0, vocab, template_len))
         for _ in range(templates_per_tenant)]
        for _ in range(tenants)
    ]
    burst_until = [0] * tenants
    reqs: list[TraceRequest] = []
    rid = 0
    for step in range(steps):
        for t in range(tenants):
            if step >= burst_until[t] and rng.random() < p_burst:
                burst_until[t] = step + burst_len
            lam = rate * (burst_mult if step < burst_until[t] else 1.0)
            for _ in range(int(rng.poisson(lam))):
                tid = -1
                head: tuple = ()
                if rng.random() < p_shared:
                    tid = int(rng.integers(0, templates_per_tenant))
                    head = pools[t][tid]
                suffix_room = max_prompt - len(head)
                n_suffix = _clipped_lognormal(rng, mean_suffix, sigma,
                                              1, suffix_room)
                suffix = tuple(int(x) for x in rng.integers(0, vocab, n_suffix))
                n_new = _clipped_lognormal(rng, mean_new, sigma, 1, max_new)
                reqs.append(TraceRequest(
                    rid=rid, arrival_step=step, tenant=t,
                    priority=0, prompt=head + suffix,
                    max_new_tokens=n_new, template_id=tid,
                ))
                rid += 1
    if weights is None:
        weights = {t: float(2 ** t) for t in range(tenants)}
    return Trace(requests=tuple(reqs), tenant_weights=dict(weights),
                 seed=int(seed))


def replay_trace(server, trace: Trace, max_steps: int = 2000,
                 priority: int | None = None) -> list:
    """Replay ``trace`` through ``server`` against its fused-step clock:
    each ``TraceRequest`` is submitted at the step it arrives (arrivals for
    step ``k`` land just before the server takes step ``k``), then the
    server drains. Returns the terminal requests, rid order.

    The request stream is identical for every server configuration replaying
    the same trace — offered load is a property of the trace, admission and
    scheduling decide what happens to it. ``max_steps`` bounds the drain so
    a wedged configuration fails a test instead of hanging it; raises if the
    trace did not drain."""
    from repro_torch.serve.serving import Request

    pending = sorted(trace.requests, key=lambda r: (r.arrival_step, r.rid))
    i = 0
    while i < len(pending) or server.queue or \
            any(r is not None for r in server.active):
        if server.step_no >= max_steps:
            raise RuntimeError(
                f"trace replay did not drain in {max_steps} steps "
                f"({len(pending) - i} arrivals unsubmitted, "
                f"{len(server.queue)} queued)"
            )
        while i < len(pending) and pending[i].arrival_step <= server.step_no:
            tr = pending[i]
            server.submit(Request(
                rid=tr.rid, prompt=list(tr.prompt),
                max_new_tokens=tr.max_new_tokens, tenant=tr.tenant,
                priority=tr.priority if priority is None else priority,
            ))
            i += 1
        server.step()
    return sorted(server.finished, key=lambda r: r.rid)
