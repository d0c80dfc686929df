"""Serving metrics rollup: saturation you can assert on, not eyeball.

``ServeMetrics`` accumulates per-step counters inside ``BatchedServer`` and
derives the numbers the benchmarks and tests gate on:

  * ``occupancy_pct``  — active slot-steps / total slot-steps. The whole point
    of continuous batching is keeping this near 100 under a request stream;
    the drain-then-refill baseline collapses it as slots empty out.
  * ``tok_per_s``      — generated tokens per wall second across the batch.
  * ``admitted`` / ``finished`` / ``deferrals`` / ``deferral_steps`` —
    request throughput accounting. ``deferrals`` counts *distinct deferral
    episodes*: a request pushed back by the paged KV pool counts once, no
    matter how many steps it stays blocked at the head of the queue (OOM
    surfaces as deferred admission, never a crash). ``deferral_steps``
    counts every blocked step, so ``deferral_steps / max(deferrals, 1)``
    is the mean episode length.
  * ``batched_tokens`` — token rows the fused step computed, summed over
    steps. Chunked stepping pays ``slots x chunk`` rows every step whether
    or not a slot is live; token-level stepping pays only the scheduled
    (live) tokens. ``tok_s_per_batched_tok`` normalises throughput by this
    compute — the number the ``serve_tokbatch`` bench floor gates on.
  * ``ttft_s`` / ``ttft_steps`` — per-request time-to-first-token.
    ``ttft_s`` counts wall seconds from *submission*, so it includes queue
    wait — the component drain-then-refill's waves inflate. ``ttft_steps``
    counts decode steps from admission: ``ceil(prompt_len / prefill_chunk)``
    under chunked prefill (== prompt length at chunk 1).
  * ``prompt_tokens`` vs ``tokens_generated`` — prefill vs decode token
    counts (``prefill_tokens`` / ``decode_tokens`` in the JSON rollup).
  * ``kv_blocks_total`` / ``kv_blocks_peak`` — paged-KV pool pressure
    (``kv_blocks_peak_pct`` is the blocks-in-use high-water mark).
  * ``preemptions`` / ``recompute_tokens`` — robustness accounting for the
    scheduler (serve/scheduler.py): how many times a victim was evicted to
    make room, and how many already-computed positions its resumes had to
    re-prefill (the recompute-on-resume tax — preemption trades this
    compute for reclaimed blocks/slots).
  * ``deadline_misses`` / ``rejected`` — load shed: requests cancelled for
    blowing a TTFT or end-to-end deadline (their blocks freed immediately)
    and requests refused at submit as impossible for the pool.
  * ``per_priority`` — per-priority-class rollup: ``admitted`` /
    ``finished`` / ``preemptions`` / ``deadline_misses`` counters plus raw
    ``ttft_steps`` (steps since last admission) and ``ttft_e2e_steps``
    (steps since *submission*, queue wait included — the number the
    ``serve_preempt`` bench ratio gates on, since it is what preemptive
    scheduling buys the interactive class).
  * ``prefix_hits`` / ``prefix_tokens`` — prefix-cache wins: requests
    admitted with at least one shared KV block, and the total prompt
    positions those admissions skipped (prefill the pool served from
    resident blocks instead of recomputing). ``prefix_tokens`` is why
    ``prompt_tokens`` drops under shared-prefix traffic — the
    ``serve_prefix`` bench gates on the prefill-per-request ratio.
  * ``kv_bytes_written`` — bytes of KV cache the engine scattered: written
    positions (prefill + decode, all cache regions) times the per-row byte
    cost, plus copy-on-write block splits (a split copies a whole block).
    ``kv_bytes_per_token`` normalises by generated tokens — the
    memory-bandwidth-per-user number; prefix sharing lowers it by not
    re-writing shared prompt KV. ``cow_splits`` counts the splits.
  * ``per_tenant`` — per-tenant rollup mirroring ``per_priority``
    (``admitted`` / ``finished`` / ``preemptions`` / ``deadline_misses`` /
    ``prefix_hits`` counters, ``prompt_tokens`` / ``tokens_generated`` /
    ``prefix_tokens`` token counts, raw ``ttft_e2e_steps``) — what the
    weighted-fairness tests assert shares on. JSON object keys are strings
    (tenant ids may be ints or strings; ``from_dict`` keeps them as the
    JSON gave them).

Zero-request edge cases are defined, not exceptions: with nothing finished,
``tok_per_s``/``occupancy_pct`` report 0.0 and the TTFT means report None.

``as_dict()`` is the JSON rollup ``benchmarks/bench_serve.py`` writes and
``benchmarks/check_regression.py`` gates in CI; ``from_dict`` round-trips it
(raw TTFT samples ride along in the dict precisely so nothing derived is
lost), so archived bench artifacts can be reloaded for analysis.

Copy of ``repro.serve.metrics``, which it is held against; the port imports nothing of
``repro``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServeMetrics:
    slots: int
    steps: int = 0
    active_slot_steps: int = 0
    admitted: int = 0
    finished: int = 0
    deferrals: int = 0
    deferral_steps: int = 0
    batched_tokens: int = 0
    tokens_generated: int = 0
    prompt_tokens: int = 0
    wall_s: float = 0.0
    kv_blocks_total: int = 0
    kv_blocks_peak: int = 0
    preemptions: int = 0
    recompute_tokens: int = 0
    deadline_misses: int = 0
    rejected: int = 0
    prefix_hits: int = 0
    prefix_tokens: int = 0
    kv_bytes_written: int = 0
    cow_splits: int = 0
    ttft_s: list[float] = dataclasses.field(default_factory=list)
    ttft_steps: list[int] = dataclasses.field(default_factory=list)
    # priority class -> counters dict (see `prio`); int-keyed here, str-keyed
    # in the JSON rollup
    per_priority: dict = dataclasses.field(default_factory=dict)
    # tenant id -> counters dict (see `tenant`); keyed by the raw tenant id
    per_tenant: dict = dataclasses.field(default_factory=dict)

    def prio(self, priority: int) -> dict:
        """The rollup dict for one priority class, created on first touch."""
        return self.per_priority.setdefault(int(priority), {
            "admitted": 0, "finished": 0, "preemptions": 0,
            "deadline_misses": 0, "ttft_steps": [], "ttft_e2e_steps": [],
        })

    def tenant(self, tenant) -> dict:
        """The rollup dict for one tenant, created on first touch."""
        return self.per_tenant.setdefault(tenant, {
            "admitted": 0, "finished": 0, "preemptions": 0,
            "deadline_misses": 0, "prefix_hits": 0, "prompt_tokens": 0,
            "tokens_generated": 0, "prefix_tokens": 0, "ttft_e2e_steps": [],
        })

    def mean_prio_ttft_e2e_steps(self, priority: int) -> float | None:
        """Mean submission-to-first-token steps for one class (None before
        any token) — queue wait included, the preemption win metric."""
        xs = self.per_priority.get(int(priority), {}).get("ttft_e2e_steps", [])
        return sum(xs) / len(xs) if xs else None

    @property
    def slot_steps(self) -> int:
        """Total slot-step capacity the server spent (steps x batch slots)."""
        return self.steps * self.slots

    @property
    def occupancy_pct(self) -> float:
        return 100.0 * self.active_slot_steps / self.slot_steps if self.slot_steps else 0.0

    @property
    def tok_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_ttft_s(self) -> float | None:
        """Mean submission-to-first-token wall seconds; None before any
        request produced a token (0.0 would read as an impossibly great
        TTFT in dashboards)."""
        return sum(self.ttft_s) / len(self.ttft_s) if self.ttft_s else None

    @property
    def mean_ttft_steps(self) -> float | None:
        return sum(self.ttft_steps) / len(self.ttft_steps) if self.ttft_steps else None

    @property
    def step_batched_tokens(self) -> float:
        """Mean token rows computed per fused step (the step's FLOP scale)."""
        return self.batched_tokens / self.steps if self.steps else 0.0

    @property
    def tok_s_per_batched_tok(self) -> float:
        """Throughput per unit of step compute: tok/s divided by mean token
        rows per step. Rises when the engine stops paying for dead rows."""
        return self.tok_per_s / self.step_batched_tokens \
            if self.step_batched_tokens else 0.0

    @property
    def kv_blocks_peak_pct(self) -> float:
        """Blocks-in-use high-water mark as % of the paged pool (0 = dense)."""
        return 100.0 * self.kv_blocks_peak / self.kv_blocks_total \
            if self.kv_blocks_total else 0.0

    @property
    def kv_bytes_per_token(self) -> float:
        """KV bytes written per *generated* token — memory traffic per unit
        of useful output. Prefill writes are amortised over the request's
        decode, so prefix sharing (skipping shared prompt writes) pushes
        this down even though each written row costs the same."""
        return self.kv_bytes_written / self.tokens_generated \
            if self.tokens_generated else 0.0

    def as_dict(self) -> dict:
        return {
            "slots": self.slots,
            "steps": self.steps,
            "slot_steps": self.slot_steps,
            "active_slot_steps": self.active_slot_steps,
            "occupancy_pct": self.occupancy_pct,
            "admitted": self.admitted,
            "finished": self.finished,
            "deferrals": self.deferrals,
            "deferral_steps": self.deferral_steps,
            "batched_tokens": self.batched_tokens,
            "step_batched_tokens": self.step_batched_tokens,
            "tok_s_per_batched_tok": self.tok_s_per_batched_tok,
            "tokens_generated": self.tokens_generated,
            "prompt_tokens": self.prompt_tokens,
            # prefill vs decode split under the names the bench JSON uses
            "prefill_tokens": self.prompt_tokens,
            "decode_tokens": self.tokens_generated,
            "wall_s": self.wall_s,
            "tok_per_s": self.tok_per_s,
            "mean_ttft_s": self.mean_ttft_s,
            "mean_ttft_steps": self.mean_ttft_steps,
            "kv_blocks_total": self.kv_blocks_total,
            "kv_blocks_peak": self.kv_blocks_peak,
            "kv_blocks_peak_pct": self.kv_blocks_peak_pct,
            "preemptions": self.preemptions,
            "recompute_tokens": self.recompute_tokens,
            "deadline_misses": self.deadline_misses,
            "rejected": self.rejected,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens": self.prefix_tokens,
            "kv_bytes_written": self.kv_bytes_written,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "cow_splits": self.cow_splits,
            "ttft_s": list(self.ttft_s),
            "ttft_steps": list(self.ttft_steps),
            # JSON object keys are strings; from_dict restores the int keys
            "per_priority": {str(k): dict(v)
                             for k, v in self.per_priority.items()},
            "per_tenant": {str(k): dict(v)
                           for k, v in self.per_tenant.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServeMetrics":
        """Rebuild from ``as_dict()`` output (e.g. a bench JSON artifact);
        derived fields are recomputed, so round-tripping is lossless."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["ttft_s"] = list(d.get("ttft_s", ()))
        kw["ttft_steps"] = list(d.get("ttft_steps", ()))
        kw["per_priority"] = {int(k): dict(v)
                              for k, v in d.get("per_priority", {}).items()}
        # tenant ids may be ints or strings; JSON stringified them and there
        # is no way back, so the restored rollup keeps the string keys
        kw["per_tenant"] = {k: dict(v)
                            for k, v in d.get("per_tenant", {}).items()}
        return cls(**kw)
