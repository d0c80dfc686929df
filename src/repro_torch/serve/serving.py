"""Continuous-batching serving engine over the per-slot decode step
(counterpart of ``repro.serve.serving``, which it is held against).

The decode step (``models/transformer.lm_decode_step``) takes per-slot
positions, so every batch row advances through its own request
independently. This module adds the request-level machinery a serving
deployment needs, vLLM-style but reduced to its core:

  * slot allocation for a fixed decode batch with **mid-run admission**: a
    slot freed by a finished request is refilled from the queue on the next
    step (dense KV rows zeroed, and invalidated logically by the per-row
    validity masks in models/attention.py), so batch occupancy stays
    saturated under a request stream instead of draining to one straggler;
  * **paged KV** (``kv="paged"``): attention caches become a pool of
    fixed-size token blocks (serve/kv_pool.py) shared by every slot. Memory
    scales with tokens actually resident, not slots x worst-case
    ``max_seq``. Admission is reservation-gated: a request the pool cannot
    guarantee is *deferred*, never admitted into a future OOM. The dense
    layout stays as the token-for-token reference;
  * **chunked stepping** (``prefill_chunk=C``): each fused step advances
    every active slot by up to C tokens (C masked sub-steps). Prefilling
    slots chew C prompt tokens per step, so time-to-first-token drops ~C x
    in steps; decoding slots emit up to C tokens per step (the host
    truncates at ``max_new_tokens``). C=1 is the one-token engine, and any C
    is token-exact against it because each sub-step IS a one-token step;
  * **token-level stepping** (``step_mode="tokens"``): each fused step runs
    ONE variable-composition batch of live tokens: prefilling slots
    contribute ``min(C, remaining prompt)`` rows, decoding slots one row
    each. Step work scales with scheduled tokens, not ``slots x C``.
    Token-exact against chunked stepping because every scheduled row is the
    same one-token decode at the same position;
  * **the paged-attention kernel** (``attn_impl="kernel"``, paged KV only):
    the block-table kernel B5 in ``kernels/paged_attn`` walks each token's
    mapped blocks instead of gathering the padded ``(B, nb*bs)`` K/V view;
    ``attn_impl="gather"`` (the default) stays as the reference. ``repro``
    calls this backend ``"pallas"``;
  * prefill-as-decode per slot with per-slot stop handling (max_new_tokens /
    max_seq), greedy or temperature sampling over the true (unpadded)
    vocab;
  * **preemptive scheduling** (serve/scheduler.py): a priority queue with
    per-request deadlines. A blocked higher-priority request evicts a victim
    (lowest class, most recently admitted), whose blocks are released and
    which is requeued carrying its generated tokens, resuming by re-prefill
    over ``prompt + generated`` (token-exact under greedy decoding).
    Deadline misses are cancelled (``CANCELLED_DEADLINE``); every request
    ends in a terminal status (``FINISHED`` / ``CANCELLED_DEADLINE`` /
    ``REJECTED``);
  * **decode-time pool pressure never raises out of ``run()``**: mid-run
    ``ensure_step`` failures (a fault plan shrinking the pool) evict victims
    until the write fits, the failing slot itself last;
  * **fault injection** (serve/faults.py): a seeded ``FaultPlan`` applies
    pool shrinkage, forced preemptions, admission stalls and virtual-clock
    deadline pressure at chosen steps; ``debug_checks=`` (default: on under
    pytest) asserts the block-pool invariants after every step;
  * **prefix sharing** (``prefix_cache``, paged KV): fully-written feed
    blocks register content keys in the pool's ``PrefixIndex``; a new
    request whose prompt starts with a resident chain maps those blocks
    shared (refcount bump, no copy) and starts prefill at its first
    divergent position. Writes into a still-shared block copy it first
    (``cow_step``; the device rows are duplicated before the fused step), so
    sharers never observe another request's writes;
  * **multi-tenant fairness** (``scheduler="wdrr"`` + ``tenant_weights``):
    weighted deficit round robin over ``Request.tenant`` queues inside each
    priority class;
  * a ``serve.metrics.ServeMetrics`` rollup (occupancy, tok/s, TTFT,
    prefill vs decode tokens, blocks in use, prefix hits, KV bytes written,
    preemption and deadline counters, per-priority and per-tenant rollups).

Where the port differs from ``repro``:

  * **Eager stepping, caches in place.** ``repro`` jits each step and
    donates the cache; here each step runs eagerly and writes the caches in
    place, so no second copy of the KV pool is ever live. The chunked
    step's C sub-steps are a Python loop.
  * **One host read per fused step**, as in ``repro``: the step packs the
    sampled tokens and emit flags (and the advanced positions and last
    tokens) into one int32 tensor read back with one copy. Nothing inside a
    step calls ``.item()``, ``nonzero`` or boolean indexing, and the host
    state goes up through pinned memory without synchronising.
  * **Runs.** A token step also uploads, in its one upload, the runs of its
    batch: (first row, row count) for the rows of each scheduled slot and
    one per padding row. On the kernel path they reach the paged-attention
    kernel, which then reads each slot's context once for all its rows
    (``token_runs``; ``repro`` walks each row's context on its own).
  * **Gated-off writes** land in a spare cache row or block (see
    models/attention.py); chunked dense steps gate the rows that do not run
    the same way, where ``repro`` reverts them with a select afterwards.
  * **Temperature sampling** is Gumbel-max, as ``jax.random.categorical``
    is, on a ``torch.Generator`` seeded with ``seed``: the same distribution,
    not the same numbers.
  * **Families.** The port serves the dense attention families (GQA or
    MLA: MLA's caches are the latent ``c``/``kr`` leaves, which every cache
    walk here reaches as it reaches ``k``/``v``), MoE (olmoe; deepseek-v3,
    MLA beside its experts), RWKV6 and the hybrid family (hymba:
    sliding-window layers read a ring of ``swa_window`` rows, paged from
    the ring pool through its own block table, beside a Mamba mixer).
    Recurrent state (``_PER_SLOT_KEYS``) stays per slot under paged KV too:
    it is zeroed on admission, written only on the rows that run a
    sub-step, and left out of block copies and KV byte counts. As in
    ``repro``: a pure recurrent model (``ssm``) serves dense under
    ``kv="paged"``; token stepping on segments that are not all
    ``attn_mlp`` falls back to chunked stepping (``serve_step``), and an
    explicit ``prefix_cache=True`` without paged attention-only segments
    falls back to unshared serving (``serve_prefix``), both recorded in
    ``meshes.fallbacks()``.
  * **On a mesh** (``mesh=``, ``param_specs=``): ``sharded_path`` decides
    as ``repro`` does (slots or blocks over the data axes, KV heads over the
    model axis, its ``serve_cache`` fallbacks), and each cache leaf is
    placed by ``meshes.tree_shardings`` under ``SERVE_CACHE_RULES`` (or
    ``SERVE_KERNEL_CACHE_RULES`` on the kernel path, which keeps the pool
    replicated over the data axes) as a DTensor of the rank's own slice and
    landing row (``meshes.place_serve``). ``repro`` places the caches and
    lets GSPMD keep the program's meaning; here each layer's decode reads
    the placement (models/attention.py, ``transformer._state_decode``): the
    attention over a rank's slot rows and KV heads runs on that rank and one
    exact ``all_reduce`` joins the parts, a block pool over the data axes
    and recurrent state are made whole for the layer. The weights stay
    whole on every rank (``param_specs`` is resolved for its fallbacks, a
    placed leaf made whole once): every rank runs the projections, MLP, MoE
    and head on all rows. Every rank runs the same host loop, and global
    rank 0 broadcasts each fused step's sampled tokens and clock reading
    (``meshes.agree``), so that every rank books the same tokens and sweeps
    deadlines at the same time.
  * **MoE's idle rows.** A decode sub-step routes the whole batch as one
    group, so the rows that do not run it (empty slots, finished or parked
    rows, fed token 0 at their frozen position as in ``repro``) claim
    expert capacity in slot order, before the live rows below them. What
    an idle row's attention reads therefore reaches the live rows' tokens,
    and it is ``repro``'s on both layouts: on dense caches its own new
    entry at its position (``attention._dense_write``), on paged caches the
    blocks its table row maps (unmapped entries read block 0), its write
    dropped.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device
from repro_torch.dist import meshes
from repro_torch.models import model_zoo
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import segments_for
from repro_torch.serve import scheduler as sched
from repro_torch.serve.kv_pool import PagedKV, PoolExhausted, prefix_keys
from repro_torch.serve.metrics import ServeMetrics


# cache leaves that stay per slot ((L, B, ...)) under paged KV too: recurrent
# state is O(1) a slot, not a token. The other leaves carry a landing row or
# block after their slots or blocks (models/attention.py)
_PER_SLOT_KEYS = frozenset({"wkv", "shift_t", "shift_c", "ssm", "conv"})


def _logical(cache):
    """Shape-only stand-ins for the cache leaves as ``repro`` shapes them:
    without the landing row or block, which the resolver must not count."""
    return [{k: torch.empty((c.shape[0], c.shape[1] - (k not in _PER_SLOT_KEYS),
                             *c.shape[2:]), device="meta") for k, c in seg.items()}
            for seg in cache]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # fused steps consumed since the LAST admission; one step advances a slot
    # by up to ``prefill_chunk`` tokens, so TTFT in steps is
    # ceil(prompt_len / chunk) for a never-preempted request
    steps: int = 0
    submit_s: float | None = None  # server clock at submission (queue entry)
    admit_s: float | None = None  # server clock at FIRST admission into a slot
    # wall seconds from submission to first generated token, queue wait included
    ttft_s: float | None = None
    # scheduling: lower priority value = more important (0 = interactive
    # class); deadlines are wall budgets from submission on the server clock
    # (deadline_ttft_s until the first token, deadline_s end to end); a miss
    # cancels the request and frees its blocks immediately
    priority: int = 1
    deadline_ttft_s: float | None = None
    deadline_s: float | None = None
    # lifecycle: QUEUED -> RUNNING -> FINISHED, with PREEMPTED (requeued,
    # will resume), CANCELLED_DEADLINE, REJECTED (see serve/scheduler.py)
    status: str = sched.QUEUED
    preemptions: int = 0  # times evicted; resume re-prefills prompt+out
    seq: int = -1  # submission order (scheduler-assigned; kept across resumes)
    admit_seq: int = -1  # admission order, which drives victim selection
    submit_step: int | None = None  # server step counter at submission
    # tenant id for weighted fairness (scheduler="wdrr") and the per-tenant
    # metrics rollup; the default folds everything into one tenant
    tenant: int | str = 0
    # prompt positions the prefix cache served from resident shared blocks
    # at the LAST admission (prefill starts at this offset)
    prefix_shared_tokens: int = 0


def _cache_row_bytes(cache) -> int:
    """Bytes of cache one written position costs, summed over every leaf but
    the per-slot recurrent state (an O(1) update, not a token's KV; a pure
    recurrent family reports 0) and all layers: leaves are layer-stacked
    ``(L, B_or_NB, S_or_bs, tail...)``, so one row is ``L * prod(tail)``
    elements per leaf."""
    return sum(int(c.shape[0]) * int(np.prod(c.shape[3:], dtype=np.int64)) * c.element_size()
               for seg in cache for k, c in seg.items() if k not in _PER_SLOT_KEYS)


def _reset_slot_rows(cache, slots, paged: bool, upload) -> None:
    """Zero the slot rows ``slots`` (host ints) of the cache leaves in place,
    with no host read (``index_fill_`` on an index ``upload`` made, where
    indexed assignment would synchronise); leaves are layer-stacked
    (L, B, ...), and a leaf placed on a mesh zeroes the rows of its own
    slice. Under paged KV only the per-slot recurrent leaves have slot rows:
    block pools need no reset, recycled blocks are hidden by the validity
    masks alone."""
    index = {}
    for seg in cache:
        for k, c in seg.items():
            if paged and k not in _PER_SLOT_KEYS:
                continue
            rows = meshes.region(c)[1]
            if (rows.start, rows.stop) not in index:
                mine = [i - rows.start for i in slots if rows.start <= i < rows.stop]
                index[rows.start, rows.stop] = upload(np.asarray(mine, np.int64)) if mine \
                    else None
            if index[rows.start, rows.stop] is not None:
                meshes.local(c).index_fill_(1, index[rows.start, rows.stop], 0)


def place_cache(cache, mesh, *, paged: bool, kernel: bool):
    """The cache's leaves placed on ``mesh`` by their logical axes
    (``model_zoo.cache_specs``) under ``SERVE_KERNEL_CACHE_RULES`` on the
    kernel path (``kernel``; the pool stays replicated over the data axes)
    or ``SERVE_CACHE_RULES``, each resolved on ``repro``'s shape: a leaf
    that shards a dim becomes a DTensor of this rank's own slice and
    landing row (``meshes.place_serve``), any other stays as it is."""
    with meshes.use_mesh(mesh):
        shardings = meshes.tree_shardings(
            model_zoo.cache_specs(cache, paged=paged), _logical(cache), mesh,
            rules=meshes.SERVE_KERNEL_CACHE_RULES if kernel else meshes.SERVE_CACHE_RULES)
    return [{k: meshes.place_serve(c, shardings[i][k], k not in _PER_SLOT_KEYS)
             for k, c in seg.items()} for i, seg in enumerate(cache)]


def _copy_blocks_across(pool, pairs) -> None:
    """The copy-on-write splits ``pairs`` (old, new) of a block pool split
    over the data axes: where one rank holds both blocks it copies its own;
    else the old block's owner broadcasts it over the group and the new
    block's owner writes it."""
    mesh, axes = pool.device_mesh, meshes.split_axes(pool, {1})
    group, members = meshes.axis_group(mesh, axes), meshes.axis_ranks(mesh, axes)
    me, loc, n = dist.get_rank(), pool.to_local(), meshes.region(pool)[1].stop \
        - meshes.region(pool)[1].start
    for old, new in pairs:
        (src, i), (dst, j) = divmod(old, n), divmod(new, n)
        if members[src] == members[dst]:
            if members[src] == me:
                loc[:, j] = loc[:, i]
            continue
        block = loc[:, i].contiguous() if members[src] == me else \
            torch.empty_like(loc[:, 0], memory_format=torch.contiguous_format)
        meshes.broadcast(block, src=members[src], group=group)
        if members[dst] == me:
            loc[:, j] = block


def _whole_tree(tree):
    """Each leaf of ``tree`` whole on this rank: a leaf placed on a mesh made
    whole (``meshes.whole``), any other as it is."""
    if isinstance(tree, dict):
        return {k: _whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole_tree(v) for v in tree)
    return meshes.whole(tree)


def token_runs(counts, t_pad: int) -> np.ndarray:
    """The runs of a token batch, (R, 2) int32 (first row, row count): one
    per scheduled slot, ``counts`` rows each in batch order, then one per
    padding row up to ``t_pad``."""
    counts = np.asarray(counts, np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    live = int(counts.sum())
    pad = np.arange(live, t_pad)
    return np.concatenate([np.stack([first, counts], 1),
                           np.stack([pad, np.ones_like(pad)], 1)]).astype(np.int32)


def check_runs(runs: np.ndarray, slot_ids: np.ndarray) -> None:
    """The paged-attention kernel's precondition on ``runs``, held on the
    host before they cross to the device: (first row, count) pairs, counts
    >= 1, that cover the rows of the batch in order, once each, with one
    slot (so one table row) per run."""
    t = len(slot_ids)
    if runs.ndim != 2 or runs.shape[1] != 2 or runs.dtype != np.int32 or len(runs) == 0:
        raise ValueError(f"runs must be (R, 2) int32, got {runs.shape} {runs.dtype}")
    first, count = runs[:, 0].astype(np.int64), runs[:, 1].astype(np.int64)
    ends = np.cumsum(count)
    if count.min() < 1 or ends[-1] != t or np.any(first != ends - count):
        raise ValueError(f"runs do not cover the {t} rows in order, once each: "
                         f"{runs.tolist()}")
    run_slot = np.repeat(slot_ids[first], count)
    if np.any(run_slot != slot_ids):
        raise ValueError(f"a run spans rows of different slots: {runs.tolist()}, "
                         f"slots {slot_ids.tolist()}")


class BatchedServer:
    """Fixed-slot continuous-batching server; see module docstring.

    ``admission`` picks the scheduling discipline: ``"continuous"`` (default)
    refills freed slots mid-run; ``"drain"`` is the static-batch ablation that
    only admits when every slot is empty.

    ``kv`` picks the cache layout: ``"dense"`` (reference; every slot owns a
    ``max_seq`` row) or ``"paged"`` (block pool, ``block_size`` tokens per
    block, ``kv_blocks`` total, by default dense-equivalent capacity).
    ``prefill_chunk`` sets the chunk width C (1 = one-token prefill).

    ``step_mode`` picks the fused-step composition: ``"chunked"`` (default,
    the reference) runs C uniform sub-steps across all slots; ``"tokens"``
    flattens live prefill chunks and decode tokens into one
    variable-size token batch per step.

    ``attn_impl`` picks the paged decode-attention read path: ``"gather"``
    (default, the reference) or ``"kernel"`` (the block-table kernel B5;
    requires ``kv="paged"``, otherwise falls back to gather with a recorded
    fallback). The effective backend is ``server.attn_impl``.

    ``scheduler`` picks the admission policy: ``"priority"`` (default:
    priority classes, deadlines and preemption; with uniform priorities and
    no deadlines it behaves exactly like FIFO), ``"fifo"`` (submission
    order, no preemption) or ``"wdrr"`` (tenant shares under the priority
    classes). ``preemption`` overrides the policy default.

    ``debug_checks`` asserts the paged-pool allocator invariants after every
    step (``KVBlockPool.check``); default None resolves to the
    ``REPRO_SERVE_DEBUG_CHECKS`` env var ("0"/"1") or, absent that, to
    "running under pytest".

    ``fault_plan`` installs a ``serve.faults.FaultPlan`` applied at the top
    of each step; a plan carrying a ``VirtualClock`` also becomes the server
    ``clock`` (the callable behind every timestamp and deadline; defaults to
    ``time.perf_counter``).

    ``device`` is where the caches live and the steps run (``None``: the
    card, which raises ``RuntimeError`` when there is none); ``params`` must
    already be there.

    ``mesh`` (a ``meshes.Mesh`` over the ranks of the default process
    group, each rank running this server on the same stream) shards the
    caches (see the module docstring); ``param_specs`` is the weights'
    logical-axis tree (``init_params``' second value), resolved as
    ``repro`` resolves it. ``last_sharded_path`` is ``sharded_path(mesh)``'s
    answer; ``rank_disagreements`` counts the fused steps where this rank's
    own sampled tokens differed from rank 0's.
    """

    def __init__(self, cfg: ModelConfig, params, batch_slots: int, max_seq: int,
                 temperature: float = 0.0, seed: int = 0, mesh=None,
                 param_specs=None, admission: str = "continuous", kv: str = "dense",
                 block_size: int = 16, kv_blocks: int | None = None,
                 prefill_chunk: int = 1, step_mode: str = "chunked",
                 attn_impl: str = "gather", scheduler: str = "priority",
                 preemption: bool | None = None, debug_checks: bool | None = None,
                 fault_plan=None, clock=None, prefix_cache: bool | None = None,
                 tenant_weights: dict | None = None, device=None):
        if mesh is not None and not isinstance(mesh, meshes.Mesh):
            raise TypeError(
                f"mesh must be a meshes.Mesh (make_mesh, make_host_mesh), not "
                f"{type(mesh).__name__}: a server places its caches on ranks (an "
                "AbstractMesh sizes sharded_path() alone)"
            )
        if cfg.family == "encdec":
            raise ValueError(
                "BatchedServer serves decoder-only families; enc-dec decode "
                "needs per-request encoder output"
            )
        if admission not in ("continuous", "drain"):
            raise ValueError(f"admission must be continuous|drain, got {admission!r}")
        if kv not in ("dense", "paged"):
            raise ValueError(f"kv must be dense|paged, got {kv!r}")
        if step_mode not in ("chunked", "tokens"):
            raise ValueError(f"step_mode must be chunked|tokens, got {step_mode!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be gather|kernel, got {attn_impl!r}")
        if scheduler not in sched.POLICIES:
            raise ValueError(
                f"scheduler must be one of {sched.POLICIES}, got {scheduler!r}"
            )
        # explicit >= 1 checks, not truthiness: a falsy 0 must fail loudly
        if max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {max_seq}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if kv == "paged" and block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"params are on {params['embed']['table'].device}, "
                             f"the server on {self.device}")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a server on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.temperature = float(temperature)
        self.admission = admission
        self.prefill_chunk = int(prefill_chunk)
        # a pure recurrent model has no per-token cache to page
        self.kv_mode = "dense" if kv == "paged" and cfg.family == "ssm" else kv
        # prefix sharing needs (a) a paged pool without a SWA ring (ring rows
        # wrap: a sharer skipping prefill would miss the skipped positions'
        # window writes) and (b) attention-only segments (skipped positions
        # carry recurrent or MoE-capacity state that blocks don't hold). None = on wherever
        # eligible; an explicit True on an ineligible shape records a
        # fallback instead of serving wrong KV.
        kinds = {s.kind for s in segments_for(cfg)}
        prefix_ok = self.kv_mode == "paged" and kinds == {"attn_mlp"}
        if prefix_cache is None:
            prefix_cache = prefix_ok
        elif prefix_cache and not prefix_ok:
            meshes.record_fallback(
                "serve_prefix", "prefix_cache", 0,
                f"prefix sharing needs paged KV over attention-only segments "
                f"(kv={self.kv_mode!r}, kinds={sorted(kinds)}); serving unshared",
            )
            prefix_cache = False
        self.prefix_cache = bool(prefix_cache)
        if self.kv_mode == "paged":
            self._paged = PagedKV.for_model(cfg, batch_slots, max_seq, block_size,
                                            kv_blocks, prefix_cache=self.prefix_cache)
            ring = self._paged.ring
            self.cache = model_zoo.make_paged_cache(
                cfg, self._paged.pool.num_blocks, block_size, self.device,
                slots=batch_slots, ring_num_blocks=ring.num_blocks if ring is not None else 0,
                ring_width=self._paged.ring_width)
        else:
            self._paged = None
            self.cache = model_zoo.make_cache(cfg, batch_slots, max_seq, self.device)
        if attn_impl == "kernel" and self._paged is None:
            meshes.record_fallback(
                "serve_attn", "impl", 0,
                "attn_impl='kernel' needs kv='paged' (the kernel walks block "
                "tables); dense layout falls back to gather attention",
            )
            attn_impl = "gather"
        if step_mode == "tokens" and kinds != {"attn_mlp"}:
            meshes.record_fallback(
                "serve_step", "token_batch", 0,
                f"token-level stepping needs attention-only segments, got "
                f"{sorted(kinds)}: recurrent state is per slot and MoE capacity "
                "groups see padding rows; falling back to chunked stepping",
            )
            step_mode = "chunked"
        self.attn_impl = attn_impl
        self.step_mode = step_mode
        self._decode = model_zoo.decode_fn(cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.active: list[Request | None] = [None] * batch_slots
        # the admission queue IS the scheduler; `finished` holds every
        # TERMINAL request (FINISHED and CANCELLED_DEADLINE) so run() drains
        self.scheduler = scheduler
        self.preemption = (scheduler in ("priority", "wdrr")) \
            if preemption is None else bool(preemption)
        self.queue = sched.AdmissionScheduler(scheduler, tenant_weights=tenant_weights)
        self.finished: list[Request] = []
        # rids of requests in an OPEN deferral episode: blocked at the head
        # at least once since they last entered a slot. The episode ends on
        # admission or cancellation, NOT when another head takes over the
        # blockage (two heads alternating under preemption is two episodes)
        self._deferring: set[int] = set()
        # fault injection + timekeeping: the clock is THE time source for
        # submit/TTFT/deadline/wall accounting, so a fault plan's
        # VirtualClock makes deadline pressure deterministic
        self._faults = fault_plan
        self._admit_stall = 0  # steps admission stays stalled (fault)
        self._step_no = 0  # monotonic fused-step counter (fault schedule key)
        self._admit_seq = 0  # admission counter behind Request.admit_seq
        if clock is None and fault_plan is not None \
                and getattr(fault_plan, "clock", None) is not None:
            clock = fault_plan.clock
        self._clock = clock if clock is not None else time.perf_counter
        if debug_checks is None:
            env = os.environ.get("REPRO_SERVE_DEBUG_CHECKS")
            if env in ("0", "1"):
                debug_checks = env == "1"
            else:
                debug_checks = "PYTEST_CURRENT_TEST" in os.environ
        self.debug_checks = bool(debug_checks)
        # wall seconds the latest step spent inside _admit
        self.last_admit_s = 0.0
        self.metrics = ServeMetrics(slots=batch_slots)
        if self._paged is not None:
            self.metrics.kv_blocks_total = self._paged.pool.num_blocks

        # per-slot program state, held as host numpy and shipped up each step
        # (the caches stay resident on the device)
        self._positions = np.zeros(batch_slots, np.int32)
        self._prompt_buf = np.zeros((batch_slots, max_seq), np.int32)
        self._prompt_len = np.zeros(batch_slots, np.int32)
        self._last_tok = np.zeros(batch_slots, np.int32)
        self._active_mask = np.zeros(batch_slots, bool)
        # the prompt buffer is the one per-slot array that is not O(slots):
        # its device copy is refreshed only on admission
        self._prompt_buf_dev = self._upload(self._prompt_buf)
        # the slot block tables (the full pool's and, with sliding-window
        # layers, the ring pool's), refreshed only when the allocator maps or
        # releases blocks
        self._table_dev = self._ring_dev = None
        self._tables_fresh = False
        # prefix-sharing bookkeeping: each occupied slot's feed-block content
        # keys and the watermark of blocks already registered in the index
        self._slot_keys: list[list | None] = [None] * batch_slots
        self._reg_upto = np.zeros(batch_slots, np.int32)
        # on a mesh: the decision, the caches placed by their resolved specs
        # (each rank's slice and landing row), the weights whole on every
        # rank, and the clock every rank reads (rank 0's, broadcast each
        # fused step)
        self.mesh = mesh
        self.last_sharded_path: tuple | None = None
        self.rank_disagreements = 0
        self._agreeing = meshes.is_multi_rank(mesh)
        if mesh is not None:
            self.last_sharded_path = self.sharded_path(mesh)
            self.cache = place_cache(self.cache, mesh, paged=self._paged is not None,
                                     kernel=self.attn_impl == "kernel")
            if param_specs is not None:
                with meshes.use_mesh(mesh):
                    meshes.tree_shardings(param_specs, params, mesh)
            self.params = _whole_tree(params)
        if self._agreeing:
            self._raw_clock, self._clock = self._clock, self._agreed_clock
            self._agree(np.zeros(0, np.int32))
        # bytes one written cache row costs across every leaf but the per-slot
        # state, and every layer (the logical cache, not a rank's slice): the
        # unit behind metrics.kv_bytes_written
        self._kv_row_bytes = _cache_row_bytes(self.cache)

    # -- sharding ------------------------------------------------------------
    def sharded_path(self, mesh) -> tuple:
        """Decide how the serving caches shard on ``mesh``: returns
        ``("gspmd", data_axes, model_axis)``, ``repro``'s tuple. The cache
        slot dim, or the block-pool dim under paged KV, goes over the data
        axes when it divides them (``batch_slots`` and the pool's
        ``num_blocks``: the landing row or block is not counted); head and
        feature dims go over the model axis when the family has a
        head-partitioned cache tensor that divides it. Drops are recorded in
        ``meshes.fallbacks()`` with ``repro``'s texts, and the dropped dim
        stays replicated (each leaf still follows the resolver's own
        answer)."""
        data = meshes.mesh_data_axes(mesh)
        n_data = meshes.mesh_axis_size(mesh, *data) if data else 1
        if self._paged is not None:
            nb = self._paged.pool.num_blocks
            if data and self.attn_impl == "kernel":
                meshes.record_fallback(
                    "serve_cache", "kv_blocks", 1,
                    "paged-attention kernel walks the whole block pool "
                    "through its scalar-prefetched table (any token may map "
                    "any physical block); block pool stays replicated",
                )
                data = ()
            elif data and nb % n_data != 0:
                meshes.record_fallback(
                    "serve_cache", "kv_blocks", 1,
                    f"paged pool of {nb} blocks not divisible by data axes "
                    f"{data}={n_data}; block pool stays replicated",
                )
                data = ()
        elif data and self.slots % n_data != 0:
            meshes.record_fallback(
                "serve_cache", "batch", 0,
                f"batch slots {self.slots} not divisible by data axes "
                f"{data}={n_data}; cache slots stay replicated",
            )
            data = ()
        model_axis = None
        m_size = meshes.mesh_axis_size(mesh, "model")
        if m_size > 1:
            heads = self._cache_head_dim()
            if heads is None:
                meshes.record_fallback(
                    "serve_cache", "kv_heads", 2,
                    "no head-partitioned cache tensor in this family "
                    "(latent/recurrent cache); model axis shards params only",
                )
            elif heads % m_size != 0:
                meshes.record_fallback(
                    "serve_cache", "kv_heads", 2,
                    f"cache head dim {heads} not divisible by mesh axis "
                    f"'model'={m_size}; cache heads stay replicated",
                )
            else:
                model_axis = "model"
        return "gspmd", data, model_axis

    def _cache_head_dim(self) -> int | None:
        """Size of the cache dim the model axis would partition, if any."""
        cfg = self.cfg
        if cfg.family == "ssm":  # rwkv wkv state: (B, heads, hd, hd)
            return cfg.d_model // cfg.rwkv_head_size
        if cfg.attn_kind == "mla":  # latent cache has no head dim
            return None
        return cfg.n_kv_heads

    def _agreed_clock(self) -> float:
        """The server's clock on a mesh: rank 0's reading at the latest
        ``_agree``."""
        return self._now

    def _agree(self, values: np.ndarray) -> np.ndarray:
        """Global rank 0's ``values`` (the step's sampled tokens, read back
        on every rank) and clock reading, one broadcast; counts a step whose
        own tokens differed in ``rank_disagreements``."""
        got, self._now = meshes.agree(values, self._raw_clock())
        if not np.array_equal(got, values):
            self.rank_disagreements += 1
        return got

    def _mesh_block(self):
        """``meshes.use_mesh(self.mesh)`` on a mesh (the steps and copies
        run under it, as in ``repro``), else nothing."""
        return meshes.use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext()

    # -- host <-> device ------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of ``arr`` on the server's device. To a card it goes through
        pinned memory without synchronising: the caching host allocator keeps
        the pinned block until the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _refresh_tables(self):
        full, ring = self._paged.tables()
        self._table_dev = self._upload(full)
        self._ring_dev = self._upload(ring) if ring is not None else None
        self._tables_fresh = True

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        try:
            if not req.prompt:
                raise ValueError(f"request {req.rid}: empty prompt")
            if req.max_new_tokens < 1:
                raise ValueError(
                    f"request {req.rid}: max_new_tokens must be >= 1, "
                    f"got {req.max_new_tokens}"
                )
            if len(req.prompt) >= self.max_seq:
                raise ValueError(
                    f"request {req.rid}: prompt len {len(req.prompt)} >= "
                    f"max_seq {self.max_seq}"
                )
            for name in ("deadline_ttft_s", "deadline_s"):
                d = getattr(req, name)
                if d is not None and d <= 0:
                    raise ValueError(
                        f"request {req.rid}: {name} must be > 0, got {d}"
                    )
            if self._paged is not None:
                full, _ = self._paged.required(
                    len(req.prompt), req.max_new_tokens, self.prefill_chunk,
                    token_step=self.step_mode == "tokens",
                )
                if full > self._paged.pool.num_blocks:
                    # an impossible request must fail loudly, not defer forever
                    raise ValueError(
                        f"request {req.rid}: needs {full} KV blocks but the "
                        f"pool only has {self._paged.pool.num_blocks}"
                    )
        except ValueError:
            # fail loudly AND leave the request inspectable: callers that
            # catch the raise still see a terminal status on it
            req.status = sched.REJECTED
            self.metrics.rejected += 1
            raise
        req.submit_s = self._clock()
        req.submit_step = self._step_no
        req.status = sched.QUEUED
        self.queue.push(req)

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _head_admissible(self, head: Request) -> bool:
        """Can the paged pool cover ``head``'s worst-case reservation right
        now? Resumes reserve for ``prompt + carried output``. With the prefix
        cache the reservation is net of resident shared blocks, re-planned on
        every check: evictions between checks can free shared blocks."""
        if self._paged is None:
            return True
        feed_len = len(head.prompt) + len(head.out)
        max_new = head.max_new_tokens - len(head.out)
        token_step = self.step_mode == "tokens"
        if self.prefix_cache:
            return self._paged.can_admit_shared(
                self._feed_keys(head), feed_len, max_new,
                self.prefill_chunk, token_step=token_step,
            )
        return self._paged.can_admit(feed_len, max_new, self.prefill_chunk,
                                     token_step=token_step)

    def _feed_keys(self, req: Request) -> list[tuple]:
        """Content keys of ``req``'s full feed blocks (prompt + carried
        output: a resume shares whatever prefix of its recompute is still
        resident, its own pre-eviction blocks included)."""
        return prefix_keys(req.prompt + req.out, self._paged.block_size)

    def _admit_into(self, slot: int, req: Request, now: float):
        """Bind ``req`` to ``slot``. A resumed (preempted) request feeds
        ``prompt + out`` as its prompt: the re-prefill recomputes exactly the
        KV prefix its evicted cache held, and the emit boundary
        (``positions + 1 >= prompt_len``) restarts emission right after the
        carried tokens."""
        feed = req.prompt + req.out
        plen = len(feed)
        start = 0
        if self._paged is not None:
            max_new = req.max_new_tokens - len(req.out)
            token_step = self.step_mode == "tokens"
            if self.prefix_cache:
                keys = self._feed_keys(req)
                start, n_shared = self._paged.admit_shared(
                    slot, keys, plen, max_new, self.prefill_chunk,
                    token_step=token_step,
                )
                self._slot_keys[slot] = keys
                self._reg_upto[slot] = n_shared
                self._tables_fresh = False  # shared blocks mapped host-side
                if n_shared:
                    self.metrics.prefix_hits += 1
                    self.metrics.prefix_tokens += start
                    ten = self.metrics.tenant(req.tenant)
                    ten["prefix_hits"] += 1
                    ten["prefix_tokens"] += start
            else:
                self._paged.admit(slot, plen, max_new, self.prefill_chunk,
                                  token_step=token_step)
        req.prefix_shared_tokens = start
        self.active[slot] = req
        req.steps = 0
        req.status = sched.RUNNING
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        if req.admit_s is None:
            # first admission only: resumes must not inflate the counts
            req.admit_s = now
            self.metrics.admitted += 1
            self.metrics.prio(req.priority)["admitted"] += 1
            self.metrics.tenant(req.tenant)["admitted"] += 1
        # prefill starts past the shared prefix; the final prompt position is
        # never shared (plan_shared caps start at plen-1), so the emission
        # boundary is reached by computation
        self._positions[slot] = start
        self._prompt_buf[slot] = 0
        self._prompt_buf[slot, :plen] = feed
        self._prompt_len[slot] = plen
        self._last_tok[slot] = 0
        self._active_mask[slot] = True

    def _preempt(self, slot: int):
        """Evict the request in ``slot``: release its blocks and requeue it
        carrying its generated tokens. The recompute-on-resume tax is
        recorded in ``metrics.recompute_tokens``."""
        req = self.active[slot]
        if self._paged is not None:
            self._paged.release(slot)
            self._tables_fresh = False
        self._slot_keys[slot] = None
        self.active[slot] = None
        self._active_mask[slot] = False
        req.status = sched.PREEMPTED
        req.preemptions += 1
        self.metrics.preemptions += 1
        self.metrics.prio(req.priority)["preemptions"] += 1
        self.metrics.tenant(req.tenant)["preemptions"] += 1
        self.metrics.recompute_tokens += int(self._positions[slot])
        self.queue.push(req)  # keeps its original seq: front of its class

    def _cancel(self, req: Request, slot: int | None):
        """Deadline miss: cancel ``req`` (terminal), freeing its slot and
        blocks immediately."""
        if slot is not None:
            if self._paged is not None:
                self._paged.release(slot)
                self._tables_fresh = False
            self._slot_keys[slot] = None
            self.active[slot] = None
            self._active_mask[slot] = False
        req.status = sched.CANCELLED_DEADLINE
        self.finished.append(req)
        self.metrics.deadline_misses += 1
        self.metrics.prio(req.priority)["deadline_misses"] += 1
        self.metrics.tenant(req.tenant)["deadline_misses"] += 1
        self._deferring.discard(req.rid)  # episode over: cancelled

    def _sweep_deadlines(self, now: float):
        """Cancel every queued or running request past a deadline."""
        for req in self.queue.expired(now):
            self._cancel(req, slot=None)
        for i, req in enumerate(self.active):
            if req is not None and sched.deadline_missed(req, now):
                self._cancel(req, slot=i)

    def _record_first_token(self, req: Request, now: float):
        req.ttft_s = now - req.submit_s
        self.metrics.ttft_s.append(req.ttft_s)
        self.metrics.ttft_steps.append(req.steps)
        rollup = self.metrics.prio(req.priority)
        rollup["ttft_steps"].append(req.steps)
        # e2e steps: fused steps since SUBMISSION, queue wait included
        e2e = (self._step_no - req.submit_step + 1
               if req.submit_step is not None else req.steps)
        rollup["ttft_e2e_steps"].append(e2e)
        self.metrics.tenant(req.tenant)["ttft_e2e_steps"].append(e2e)

    def _finish(self, req: Request, slot: int):
        req.done = True
        req.status = sched.FINISHED
        self.finished.append(req)
        self.active[slot] = None
        self._active_mask[slot] = False
        self.metrics.finished += 1
        self.metrics.prio(req.priority)["finished"] += 1
        self.metrics.tenant(req.tenant)["finished"] += 1
        self._slot_keys[slot] = None
        if self._paged is not None:
            self._paged.release(slot)  # free-on-finish
            self._tables_fresh = False

    def _admit(self):
        now = self._clock()
        self._sweep_deadlines(now)
        if not self.queue:
            return
        if self.admission == "drain" and any(r is not None for r in self.active):
            return  # static batching: refill only once the batch has drained
        newly = []
        while self.queue:
            head = self.queue.peek()
            free = self._free_slot()
            ok = self._head_admissible(head)
            if free is None or not ok:
                # head is blocked. Preemption may clear the blockage by
                # evicting a STRICTLY lower-priority victim; the strict
                # inequality is the termination argument (heads pop in
                # non-decreasing priority)
                victim = (sched.pick_victim(self.active, below=head.priority)
                          if self.preemption and self.admission == "continuous"
                          else None)
                if victim is not None:
                    self._preempt(victim)
                    continue  # retry the head against the freed capacity
                if not ok:
                    # pool-blocked with nobody to evict: defer (head-of-line)
                    # until finish-time releases free capacity; one deferral
                    # episode per request per blocked period
                    if head.rid not in self._deferring:
                        self._deferring.add(head.rid)
                        self.metrics.deferrals += 1
                    self.metrics.deferral_steps += 1
                break
            req = self.queue.pop()
            self._deferring.discard(req.rid)  # episode over: admitted
            self._admit_into(free, req, now)
            newly.append(free)
        if newly:
            # the admitted slots' rows start from zeros (recurrent state on
            # either layout, dense KV rows on top of the validity masks)
            _reset_slot_rows(self.cache, newly, self._paged is not None, self._upload)
            self._prompt_buf_dev = self._upload(self._prompt_buf)

    # -- the fused device step -------------------------------------------------
    def _forward(self, tok, pos, write_ok, table=None, slot=None, runs=None):
        """One decode over the caches, gated by ``write_ok`` (KV rows and
        recurrent state alike), then sampling over the true vocab: (T,) int32
        next tokens on the device. ``runs`` reaches the paged-attention
        kernel (the kernel path only)."""
        if self._paged is not None:
            ctx = {"table": table, "ring_table": self._ring_dev,
                   "ring_width": self._paged.ring_width, "write_ok": write_ok,
                   "block_size": self._paged.block_size, "max_seq": self.max_seq,
                   "impl": self.attn_impl,
                   "runs": runs if self.attn_impl == "kernel" else None}
            logits, _ = self._decode(self.params, tok, self.cache, pos, paged=ctx)
        else:
            logits, _ = self._decode(self.params, tok, self.cache, pos, slot=slot,
                                     write_ok=write_ok)
        logits = logits[:, : self.cfg.vocab_size].to(torch.float32)
        if self.temperature > 0:
            # Gumbel-max: jax.random.categorical's construction
            u = torch.rand(logits.shape, generator=self._gen, device=logits.device)
            u = u.clamp_(min=torch.finfo(torch.float32).tiny)
            logits = logits / self.temperature - torch.log(-torch.log(u))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _chunked_program(self) -> np.ndarray:
        """C masked sub-steps, each a full one-token decode for every running
        slot (prefill feeds the prompt buffer, decode the last sample). Rows
        that do not run a sub-step (empty slots, rows at the ``max_seq``
        horizon) idle with KV rows, recurrent state and positions frozen, so
        C=1 is the one-token engine and any C is token-exact against it.
        Returns the (2C + 2, B) host array: sampled tokens (C, B), emit flags
        (C, B), then the advanced positions and last tokens."""
        state = self._upload(np.stack([self._positions, self._prompt_len, self._last_tok,
                                       self._active_mask.astype(np.int32)]))
        positions, prompt_len, last_tok = state[0], state[1], state[2]
        active = state[3].bool()
        rows = torch.arange(self.slots, device=self.device)
        toks, emits = [], []
        for _ in range(self.prefill_chunk):
            run = active & (positions < self.max_seq)
            in_prompt = positions < prompt_len
            idx = positions.clamp(0, self.max_seq - 1)
            tok = torch.where(in_prompt, self._prompt_buf_dev[rows, idx], last_tok)
            tok = torch.where(run, tok, 0)
            nxt = self._forward(tok, positions, run, table=self._table_dev)
            # the sample is a real generation once the prompt is consumed
            emits.append((run & (positions + 1 >= prompt_len)).to(torch.int32))
            toks.append(nxt)
            positions = torch.where(run, positions + 1, positions)
            last_tok = torch.where(run, nxt, last_tok)
        packed = torch.cat([torch.stack(toks), torch.stack(emits), positions[None],
                            last_tok[None]])
        return self._read(packed)

    def _token_program(self, tokens, slot_ids, pos, live, runs) -> np.ndarray:
        """One decode over a flattened (T,) token batch: ``slot_ids`` maps
        each row onto its cache slot, ``live`` gates padding rows out of the
        cache writes, ``runs`` (R, 2) groups the rows of each slot. One
        upload carries all of them. Returns the (T,) host array of per-row
        samples."""
        t = len(tokens)
        flat = self._upload(np.concatenate([
            np.stack([tokens, slot_ids, pos, live.astype(np.int32)]).ravel(), runs.ravel()]))
        batch = flat[:4 * t].view(4, t)
        live_d = batch[3].bool()
        tok = torch.where(live_d, batch[0], 0)
        slot = batch[1]
        table = self._table_dev[slot] if self._paged is not None else None
        nxt = self._forward(tok, batch[2], live_d, table=table, slot=slot,
                            runs=flat[4 * t:].view(-1, 2))
        return self._read(nxt)

    def _read(self, out: torch.Tensor) -> np.ndarray:
        """The step's one host read; on a mesh, rank 0's values
        (``_agree``)."""
        host = out.cpu().numpy()
        return self._agree(host) if self._agreeing else host

    # -- stepping ---------------------------------------------------------------
    @property
    def step_no(self) -> int:
        """Monotonic fused-step count so far, the clock trace replay
        (``serve.faults.replay_trace``) schedules arrivals against."""
        return self._step_no

    def step(self):
        """Apply scheduled faults, admit into free slots (unless stalled),
        then one fused decode step. Wall time (``metrics.wall_s``) covers the
        whole step, admission included; ``last_admit_s`` records the
        admission portion."""
        t0 = self._clock()
        if self._faults is not None:
            self._faults.apply(self, self._step_no)
        if self._admit_stall > 0:
            # admission stalled by a fault: deadlines still sweep
            self._admit_stall -= 1
            self._sweep_deadlines(self._clock())
        else:
            self._admit()
        self.last_admit_s = self._clock() - t0
        if self.step_mode == "tokens":
            self._step_tokens(t0)
        else:
            self._step_chunked(t0)
        self._step_no += 1
        if self.debug_checks and self._paged is not None:
            # allocator invariants checked at the step that broke them
            self._paged.check()

    def _ensure_or_preempt(self, slot: int, pos: int, n: int,
                           cow_pairs: list | None = None) -> bool:
        """``ensure_step`` + copy-on-write that never lets ``PoolExhausted``
        escape: mid-run pressure evicts victims until the write fits, the
        failing slot itself last. Shared blocks in the write range are split
        here; ``cow_pairs`` accumulates the (old, new) splits the caller must
        copy on the device before the step. Returns True when any table
        changed (mapping, split OR eviction)."""
        changed = False
        while True:
            try:
                changed |= self._paged.ensure_step(slot, pos, n)
                if cow_pairs is not None and self.prefix_cache:
                    before = len(cow_pairs)
                    self._paged.cow_step(slot, pos, n, out=cow_pairs)
                    changed |= len(cow_pairs) > before
                return changed
            except PoolExhausted:
                # a partial mapping/split may have landed before the raise
                changed = True
                victim = sched.pick_victim(self.active, below=None)
                if victim is None or victim == slot:
                    # nobody else to evict: the failing slot yields
                    self._preempt(slot)
                    return changed
                self._preempt(victim)

    def _apply_cow(self, pairs: list[tuple[int, int]]):
        """The device half of the copy-on-write splits: copy each old block's
        rows into its new private block before the fused step writes it."""
        self.metrics.cow_splits += len(pairs)
        self.metrics.kv_bytes_written += (
            len(pairs) * self._paged.block_size * self._kv_row_bytes
        )
        src = self._upload(np.asarray([p[0] for p in pairs], np.int64))
        dst = self._upload(np.asarray([p[1] for p in pairs], np.int64))
        with self._mesh_block():
            for seg in self.cache:
                for k, c in seg.items():
                    if k in _PER_SLOT_KEYS:
                        continue
                    if meshes.split_axes(c, {1}):
                        _copy_blocks_across(c, pairs)
                    else:
                        c = meshes.local(c)
                        c[:, dst] = c[:, src]

    def _register_prefix(self, slot: int):
        """Advance ``slot``'s prefix-index registration watermark: feed
        blocks whose last row the slot's position has passed are fully
        written and become shareable. Runs before any finish-time release."""
        keys = self._slot_keys[slot]
        if keys is None:
            return
        upto = min(int(self._positions[slot]) // self._paged.block_size, len(keys))
        if upto > self._reg_upto[slot]:
            self._reg_upto[slot] = self._paged.register_blocks(
                slot, keys, int(self._reg_upto[slot]), upto
            )

    def _step_chunked(self, t0: float):
        """C uniform masked sub-steps across all slots (the reference)."""
        if self._paged is not None:
            # alloc-on-write: map blocks for the rows each slot writes this
            # step (admission reserved the worst case; under injected
            # shrinkage _ensure_or_preempt evicts to fit), splitting any
            # block still shared with another slot before the write lands
            changed = False
            cow_pairs: list[tuple[int, int]] = []
            for i in range(self.slots):
                if self.active[i] is None:
                    continue
                pos = int(self._positions[i])
                n = min(self.prefill_chunk, self.max_seq - pos)
                if n > 0:
                    changed |= self._ensure_or_preempt(i, pos, n, cow_pairs)
            if cow_pairs:
                self._apply_cow(cow_pairs)
            if changed or not self._tables_fresh:
                self._refresh_tables()
            self.metrics.kv_blocks_peak = max(
                self.metrics.kv_blocks_peak, self._paged.pool.blocks_in_use
            )
        old_pos = self._positions.copy()
        with self._mesh_block():
            out = self._chunked_program()
        c = self.prefill_chunk
        toks, emits = out[:c], out[c:2 * c]
        # np.array (not a view): _admit writes these in place on admission
        self._positions = np.array(out[2 * c])
        self._last_tok = np.array(out[2 * c + 1])
        now = self._clock()

        n_active = 0
        generated = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            n_active += 1
            req.steps += 1
            plen = int(self._prompt_len[i])
            # prefill vs decode token split: prompt tokens fed this step
            fed = (min(int(self._positions[i]), plen)
                   - min(int(old_pos[i]), plen))
            self.metrics.prompt_tokens += fed
            ten = self.metrics.tenant(req.tenant)
            ten["prompt_tokens"] += fed
            emitted = 0
            for j in range(toks.shape[0]):
                # truncate at max_new: the device may over-generate up to
                # C-1 tokens in the final chunk of a request
                if not emits[j, i] or len(req.out) >= req.max_new_tokens:
                    continue
                req.out.append(int(toks[j, i]))
                emitted += 1
                if req.ttft_s is None:
                    self._record_first_token(req, now)
            generated += emitted
            ten["tokens_generated"] += emitted
            # index the newly completed feed blocks BEFORE any finish-time
            # release: freed blocks must never enter the index
            self._register_prefix(i)
            if (len(req.out) >= req.max_new_tokens
                    or int(self._positions[i]) >= self.max_seq):
                self._finish(req, i)
        self.metrics.steps += 1
        self.metrics.active_slot_steps += n_active
        self.metrics.tokens_generated += generated
        # the step computes every slot row for all C sub-steps, live or not
        self.metrics.batched_tokens += self.slots * self.prefill_chunk
        # KV traffic: every advanced position wrote one row into each cache
        self.metrics.kv_bytes_written += (
            int((self._positions - old_pos).sum()) * self._kv_row_bytes
        )
        self.metrics.wall_s += now - t0

    def _step_tokens(self, t0: float):
        """One variable-composition token batch: prefilling slots schedule
        ``min(C, remaining prompt)`` rows, decoding slots one row each,
        flattened into a single decode. Token-exact against chunked
        stepping: every scheduled row is the same one-token decode at the
        same position; prompt-overshoot rows are never scheduled, and idle
        slots contribute no rows."""
        chunk = self.prefill_chunk
        work: list[tuple[int, int, int]] = []  # (slot, start_pos, n_rows)
        for i, req in enumerate(self.active):
            if req is None:
                continue
            p = int(self._positions[i])
            plen = int(self._prompt_len[i])
            n = min(chunk, plen - p) if p < plen else 1
            n = min(n, self.max_seq - p)
            work.append((i, p, n))
        if self._paged is not None:
            # map blocks BEFORE building the flat batch: an evicted slot must
            # not schedule rows this step. Copy-on-write splits land here too,
            # before the per-token tables are read
            changed = False
            cow_pairs: list[tuple[int, int]] = []
            for i, p, n in work:
                if self.active[i] is not None:
                    changed |= self._ensure_or_preempt(i, p, n, cow_pairs)
            if cow_pairs:
                self._apply_cow(cow_pairs)
            work = [(i, p, n) for i, p, n in work if self.active[i] is not None]
            if changed or not self._tables_fresh:
                self._refresh_tables()
        t_live = sum(n for _, _, n in work)
        if t_live == 0:
            # nothing runnable this step (empty batch); still a step, and on a
            # mesh still a clock reading every rank shares
            if self._agreeing:
                self._agree(np.zeros(0, np.int32))
            self.metrics.steps += 1
            self.metrics.wall_s += self._clock() - t0
            return
        # pad to an 8-token bucket, as the reference does to bound its
        # compiled shapes; padding rows are dead (live False gates their
        # writes, their samples are never read)
        t_pad = max(8, -(-t_live // 8) * 8)
        tokens = np.zeros(t_pad, np.int32)
        slot_ids = np.zeros(t_pad, np.int32)
        pos = np.zeros(t_pad, np.int32)
        live = np.zeros(t_pad, bool)
        last_row: dict[int, int] = {}
        runs = token_runs([n for _, _, n in work], t_pad)
        k = 0
        for i, p, n in work:
            plen = int(self._prompt_len[i])
            if p < plen:
                tokens[k:k + n] = self._prompt_buf[i, p:p + n]
            else:
                tokens[k] = self._last_tok[i]
            slot_ids[k:k + n] = i
            pos[k:k + n] = np.arange(p, p + n, dtype=np.int32)
            live[k:k + n] = True
            last_row[i] = k + n - 1
            k += n
        if self._paged is not None:
            self.metrics.kv_blocks_peak = max(
                self.metrics.kv_blocks_peak, self._paged.pool.blocks_in_use
            )
        check_runs(runs, slot_ids)
        with self._mesh_block():
            nxt = self._token_program(tokens, slot_ids, pos, live, runs)
        now = self._clock()

        n_active = 0
        generated = 0
        for i, p, n in work:
            req = self.active[i]
            n_active += 1
            req.steps += 1
            plen = int(self._prompt_len[i])
            new_p = p + n
            self._positions[i] = new_p
            fed = min(new_p, plen) - min(p, plen)
            self.metrics.prompt_tokens += fed
            ten = self.metrics.tenant(req.tenant)
            ten["prompt_tokens"] += fed
            if new_p >= plen:
                # the slot's last scheduled row sits at the final prompt
                # position or beyond: its sample is a real generation
                tok = int(nxt[last_row[i]])
                self._last_tok[i] = tok
                if len(req.out) < req.max_new_tokens:
                    req.out.append(tok)
                    generated += 1
                    ten["tokens_generated"] += 1
                    if req.ttft_s is None:
                        self._record_first_token(req, now)
            # index the newly completed feed blocks BEFORE any finish-time
            # release: freed blocks must never enter the index
            self._register_prefix(i)
            if len(req.out) >= req.max_new_tokens or new_p >= self.max_seq:
                self._finish(req, i)
        self.metrics.steps += 1
        self.metrics.active_slot_steps += n_active
        self.metrics.tokens_generated += generated
        self.metrics.batched_tokens += t_live
        # KV traffic: every live row wrote once into each cache
        self.metrics.kv_bytes_written += t_live * self._kv_row_bytes
        self.metrics.wall_s += now - t0

    def reset_metrics(self):
        kv_total = self.metrics.kv_blocks_total
        self.metrics = ServeMetrics(slots=self.slots, kv_blocks_total=kv_total)

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Step until queue and slots drain (or ``max_steps``); returns ALL
        terminal requests so far (``FINISHED`` and ``CANCELLED_DEADLINE``),
        in ``rid`` order."""
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) and (
            max_steps is None or steps < max_steps
        ):
            self.step()
            steps += 1
        return sorted(self.finished, key=lambda r: r.rid)


def generate_greedy(cfg: ModelConfig, params, prompts: list[list[int]],
                    max_new_tokens: int, max_seq: int | None = None, device=None):
    """Convenience: run a batch of prompts to completion, return token lists
    (prompt order)."""
    # `is None`, not `or`: max_seq=0 must reach BatchedServer's >= 1 check
    if max_seq is None:
        max_seq = max(len(p) for p in prompts) + max_new_tokens + 1
    server = BatchedServer(cfg, params, batch_slots=len(prompts), max_seq=max_seq,
                           device=device)
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, prompt=list(p), max_new_tokens=max_new_tokens))
    return [r.out for r in server.run()]


def score_tokens(cfg: ModelConfig, params, prompts: list[list[int]],
                 max_new_tokens: int, batch_slots: int | None = None,
                 max_seq: int | None = None, **server_kwargs):
    """Batch-scoring session: run all prompts to completion on a short-lived
    server and return ``(outputs, metrics)``: token lists in prompt order and
    the session's ``ServeMetrics`` (None when there were no prompts). The
    slot count is capped at 8 by default; continuous batching refills slots
    as prompts finish. ``server_kwargs`` (``device`` among them) go to
    ``BatchedServer``."""
    if not prompts:
        return [], None
    if max_seq is None:
        max_seq = max(len(p) for p in prompts) + max_new_tokens + 1
    if batch_slots is None:
        batch_slots = min(len(prompts), 8)
    server = BatchedServer(
        cfg, params, batch_slots=batch_slots, max_seq=max_seq, **server_kwargs
    )
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, prompt=list(p), max_new_tokens=max_new_tokens))
    outs = [r.out for r in server.run()]
    return outs, server.metrics
