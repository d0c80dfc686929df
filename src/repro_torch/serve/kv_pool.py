"""Paged KV-cache block pool: fixed-size token blocks behind the serving engine.

DAnA's Striders replace dense hand-routed buffer access with an access engine
that walks page layouts directly (PAPER.md §Striders); the serving analogue is
vLLM-style paged attention. Instead of every decode slot owning a dense
``max_seq`` cache row — memory scaling with the *worst case* sequence — the
cache is a pool of fixed-size token blocks:

  * ``KVBlockPool`` — the allocator. A free list of physical block ids, a
    per-slot block table (logical block index -> physical block id),
    alloc-on-write (a block is mapped the first time a token position inside
    it is written), free-on-finish (a finished request returns its blocks),
    and reservation-based admission: a request is admitted only when the pool
    can cover its worst-case block demand, so a running request can never hit
    pool exhaustion mid-flight — OOM surfaces as *deferred admission*, never
    as a crash. Blocks are *refcounted*: several slots may map the same
    physical block read-only (``map_prefix``), ``release`` decrements and a
    block returns to the free list only when its count reaches zero, and a
    writer splits a shared block first (``cow`` — copy-on-write). Invariants
    (``free + in_use + quarantined == total`` over *distinct* blocks,
    refcount == number of table entries mapping a block, zero-refcount
    blocks live on exactly one free/quarantine list, table/length
    consistency) are pinned by ``tests/test_kv_pool.py``.
  * ``PrefixIndex`` — content hash of fully-written *feed* (prompt + carried
    output) blocks -> resident physical block id. A newly admitted request
    whose prompt starts with an indexed chain maps those blocks shared with
    a refcount bump and pays prefill only from its first divergent block.
    Keys are exact chained token tuples (no hash-collision exposure).
  * ``PagedKV`` — the serving-side composite: one pool for the full-width
    cache regions (GQA K/V, MLA latent) and, for models with sliding-window
    layers, a second pool whose logical rows are *ring* positions
    (``pos % ring_width``), so SWA ring semantics map onto blocks with the
    same validity story as the dense ring. With ``prefix_cache=True`` (full
    pool only — ring rows wrap, so a shared ring block would be missing the
    skipped positions' writes) it owns the prefix index and the shared
    admission / copy-on-write planning.

The device-side layout lives in ``models/attention.py``
(``gqa_decode_paged`` / ``mla_decode_paged``): cache leaves are block pools
``(num_blocks, block_size, ...)`` shared by every slot, and decode gathers a
slot's K/V through its block-table row. The pool here is pure host-side
bookkeeping (numpy) — the tables ship to the device as tiny int32 arrays.

Copy of ``repro.serve.kv_pool``, which it is held against; the port imports nothing of
``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


class PoolExhausted(RuntimeError):
    """A block was demanded that the free list cannot supply. Never raised
    when admission goes through ``can_admit``/``admit`` (reservations cover
    the worst case); reaching it means the admission protocol was bypassed."""


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to cover ``n_tokens`` token rows (ceil division)."""
    return -(-max(0, n_tokens) // block_size)


def prefix_keys(tokens, block_size: int) -> list[tuple]:
    """Chained content keys for every *full* block of ``tokens``.

    ``keys[j]`` identifies block ``j``'s contents *and* everything before it:
    ``keys[j] = (keys[j-1], tuple(tokens[j*bs:(j+1)*bs]))``. Chaining means a
    block id found under ``keys[j]`` is reusable only when the whole prefix
    matches — exactly the condition under which its KV rows are bit-identical
    to what the new request would write (KV at a position depends only on the
    token, the position and the params; see ``tests/test_serve_prefix.py``).
    Keys are exact nested tuples, not hashes, so collisions are impossible.
    """
    out: list[tuple] = []
    key: tuple = ()
    for j in range(len(tokens) // block_size):
        key = (key, tuple(int(t) for t in tokens[j * block_size:(j + 1) * block_size]))
        out.append(key)
    return out


class PrefixIndex:
    """Content key -> resident physical block id, maintained by the pool's
    refcount lifecycle: blocks register once fully written, evict the moment
    their refcount hits zero (the block id goes back to the free list and its
    contents will be overwritten by the next mapper). First writer wins —
    a duplicate key (another slot recomputing the same prefix privately) is
    ignored, as is a second key for an already-indexed block."""

    def __init__(self) -> None:
        self._by_key: dict[tuple, int] = {}
        self._by_block: dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def lookup(self, keys: list[tuple]) -> list[int]:
        """Longest chain of resident block ids matching ``keys`` head-first."""
        hits: list[int] = []
        for key in keys:
            bid = self._by_key.get(key)
            if bid is None:
                break
            hits.append(bid)
        return hits

    def register(self, key: tuple, bid: int) -> bool:
        if key in self._by_key or bid in self._by_block:
            return False
        self._by_key[key] = bid
        self._by_block[bid] = key
        return True

    def evict_block(self, bid: int) -> None:
        key = self._by_block.pop(bid, None)
        if key is not None:
            del self._by_key[key]

    def blocks(self) -> set[int]:
        return set(self._by_block)


class KVBlockPool:
    """Fixed-size token-block allocator with a free list, per-slot block
    tables, alloc-on-write and reservation-based admission.

    Logical rows (cache row indices: token positions for full regions, ring
    positions for SWA regions) map onto logical block indices ``row //
    block_size``; the table maps those to physical block ids. Unmapped table
    entries hold ``-1``.
    """

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 blocks_per_slot: int):
        if num_blocks < 0 or block_size < 1 or slots < 1 or blocks_per_slot < 1:
            raise ValueError(
                f"bad pool shape: num_blocks={num_blocks} "
                f"block_size={block_size} slots={slots} "
                f"blocks_per_slot={blocks_per_slot}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.slots = int(slots)
        self.blocks_per_slot = int(blocks_per_slot)
        self.table = np.full((slots, blocks_per_slot), -1, np.int32)
        self.n_mapped = np.zeros(slots, np.int32)
        # LIFO free list: recycled blocks are re-mapped first, which is what
        # the parity tests lean on to prove stale contents are harmless
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._reserved = np.zeros(slots, np.int64)
        # fault-injection quarantine (serve/faults.py): blocks pulled out of
        # the free list by `shrink`, invisible to allocation until `grow`
        self._quarantined: list[int] = []
        # how many table entries map each physical block: 1 for a private
        # block, >1 when map_prefix shares it, 0 on the free/quarantine lists
        self.refcount = np.zeros(num_blocks, np.int32)
        # called with the block id whenever a refcount hits zero (PagedKV
        # wires this to PrefixIndex.evict_block: freed contents are dead)
        self.on_zero = None

    # -- accounting ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """Blocks mapped into slot tables (quarantined blocks are withheld
        by a fault plan, not in use — they must not inflate the peak-usage
        metric or read as a leak after a drain)."""
        return self.num_blocks - len(self._free) - len(self._quarantined)

    @property
    def reserved_blocks(self) -> int:
        """Outstanding worst-case demand of admitted slots not yet mapped."""
        return int(self._reserved.sum())

    @property
    def quarantined_blocks(self) -> int:
        """Blocks a fault plan has shrunk out of the pool (0 normally)."""
        return len(self._quarantined)

    # -- fault injection -----------------------------------------------------
    def shrink(self, n: int) -> int:
        """Quarantine up to ``n`` free blocks (fault injection: capacity
        vanishes out from under outstanding reservations, so a later
        ``ensure`` may raise ``PoolExhausted`` mid-run — the *server's*
        preemption path, not this class, restores the admission invariant).
        Returns how many blocks were actually quarantined."""
        take = min(int(n), len(self._free))
        for _ in range(take):
            self._quarantined.append(self._free.pop())
        return take

    def grow(self, n: int | None = None) -> int:
        """Return up to ``n`` quarantined blocks (all when None) to the free
        list; returns how many came back."""
        back = len(self._quarantined) if n is None else min(int(n),
                                                            len(self._quarantined))
        for _ in range(back):
            self._free.append(self._quarantined.pop())
        return back

    # -- admission -----------------------------------------------------------
    @property
    def headroom(self) -> int:
        """Blocks admission may still promise: free minus outstanding
        reservations, floored at zero. A fault-plan ``shrink`` can pull
        ``free`` below ``reserved`` while admitted slots still hold their
        promises — that deficit must read as *no capacity* (admission stays
        closed until the server preempts or the plan heals), never as a
        negative number fed into a comparison."""
        return max(0, self.free_blocks - self.reserved_blocks)

    def can_admit(self, n_blocks: int) -> bool:
        """True iff ``n_blocks`` can be guaranteed on top of every admitted
        slot's outstanding reservation (so admission never overcommits).
        Closed under quarantine pressure: see ``headroom``."""
        if n_blocks > self.blocks_per_slot:
            return False
        return n_blocks <= self.headroom

    def admit(self, slot: int, n_blocks: int) -> None:
        """Reserve ``n_blocks`` of worst-case demand for ``slot``. Blocks are
        mapped lazily by ``ensure`` (alloc-on-write)."""
        if self.n_mapped[slot] or self._reserved[slot]:
            raise ValueError(f"slot {slot} already holds blocks; release first")
        if not self.can_admit(n_blocks):
            raise PoolExhausted(
                f"cannot admit {n_blocks} blocks: {self.free_blocks} free, "
                f"{self.reserved_blocks} reserved"
            )
        self._reserved[slot] = n_blocks

    # -- alloc-on-write ------------------------------------------------------
    def ensure(self, slot: int, last_row: int) -> bool:
        """Map blocks so logical rows ``[0, last_row]`` of ``slot`` are
        backed; returns True when the table changed. Mapping consumes the
        slot's reservation first."""
        need = last_row // self.block_size + 1
        if need > self.blocks_per_slot:
            raise ValueError(
                f"row {last_row} needs {need} blocks > blocks_per_slot "
                f"{self.blocks_per_slot}"
            )
        changed = False
        while self.n_mapped[slot] < need:
            if not self._free:
                raise PoolExhausted(
                    f"pool exhausted mapping block {self.n_mapped[slot]} of "
                    f"slot {slot} (admission bypassed?)"
                )
            bid = self._free.pop()
            self.table[slot, self.n_mapped[slot]] = bid
            self.refcount[bid] = 1
            self.n_mapped[slot] += 1
            if self._reserved[slot] > 0:
                self._reserved[slot] -= 1
            changed = True
        return changed

    # -- prefix sharing ------------------------------------------------------
    def map_prefix(self, slot: int, block_ids: list[int]) -> None:
        """Map already-resident blocks at the *front* of ``slot``'s table,
        read-only shared: each gets a refcount bump, none leaves the owning
        tables, and nothing is taken from the free list or the slot's
        reservation. Must run on an empty slot, before any ``ensure`` — the
        shared prefix is logical blocks ``0..len(block_ids)-1`` and private
        alloc-on-write continues from there."""
        if self.n_mapped[slot]:
            raise ValueError(f"slot {slot} already holds blocks; map_prefix "
                             "must precede alloc-on-write")
        if len(block_ids) > self.blocks_per_slot:
            raise ValueError(f"{len(block_ids)} shared blocks > "
                             f"blocks_per_slot {self.blocks_per_slot}")
        for j, bid in enumerate(block_ids):
            if self.refcount[bid] < 1:
                raise ValueError(f"block {bid} is not resident (refcount 0); "
                                 "stale prefix-index entry?")
            self.table[slot, j] = bid
            self.refcount[bid] += 1
        self.n_mapped[slot] = len(block_ids)

    def cow(self, slot: int, logical: int) -> tuple[int, int]:
        """Copy-on-write split: give ``slot`` a private copy of its shared
        logical block ``logical`` before a scatter touches it. Pops a free
        block (consuming the slot's reservation — shared admission reserves
        one extra block when the first write lands inside the shared prefix),
        swaps the table entry, and drops the old block's refcount — the other
        holders keep reading it unchanged. Returns ``(old_bid, new_bid)`` so
        the server can copy the device rows before the next fused step."""
        old = int(self.table[slot, logical])
        if old < 0 or self.refcount[old] < 2:
            raise ValueError(f"slot {slot} logical block {logical} is not "
                             "shared; cow() is only for refcount > 1")
        if not self._free:
            raise PoolExhausted(
                f"pool exhausted COW-splitting block {logical} of slot {slot}"
            )
        new = self._free.pop()
        self.table[slot, logical] = new
        self.refcount[new] = 1
        self.refcount[old] -= 1
        if self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        return old, new

    # -- free-on-finish ------------------------------------------------------
    def release(self, slot: int) -> int:
        """Drop ``slot``'s claim on its blocks and its reservation. Each
        block's refcount is decremented; a block returns to the free list
        only at zero (another slot sharing it keeps it resident — the old
        unconditional append was a double-free under sharing). Returns how
        many blocks actually went back to the free list."""
        n = int(self.n_mapped[slot])
        freed = 0
        for i in range(n):
            bid = int(self.table[slot, i])
            self.refcount[bid] -= 1
            if self.refcount[bid] == 0:
                self._free.append(bid)
                freed += 1
                if self.on_zero is not None:
                    self.on_zero(bid)
        self.table[slot] = -1
        self.n_mapped[slot] = 0
        self._reserved[slot] = 0
        return freed

    # -- views / invariants --------------------------------------------------
    def table_array(self) -> np.ndarray:
        """Device-shippable copy of the block table with unmapped entries
        clamped to block 0: tensor gathers wrap negative indices, and a ``-1``
        would silently read the *last* block. Reads through clamped entries
        are masked out by the validity masks; writes are gated by the
        write-ok sentinel."""
        return np.maximum(self.table, 0).astype(np.int32)

    def check(self) -> None:
        """Assert the allocator invariants (test hook / ``debug_checks``):
        distinct-mapped + free + quarantined == total, every block's refcount
        equals the number of table entries mapping it, zero-refcount blocks
        sit on exactly one of the free/quarantine lists (and refcounted
        blocks on neither — a freed shared block would be a double-free),
        mapped entries form a contiguous prefix of each table row, and
        reservations never exceed free + quarantined capacity. The
        reservation bound counts quarantined blocks on purpose: a fault-plan
        ``shrink`` may push ``reserved`` above ``free`` transiently (that is
        the injected pressure the server must preempt its way out of), but
        admission itself never promises more than the pool ever held."""
        mapped = [int(b) for row in self.table for b in row if b >= 0]
        counts = np.bincount(mapped, minlength=self.num_blocks) if mapped \
            else np.zeros(self.num_blocks, np.int64)
        assert (counts == self.refcount).all(), (
            f"refcount drift: table maps {counts.tolist()} but refcount is "
            f"{self.refcount.tolist()}"
        )
        distinct = set(mapped)
        q = len(self._quarantined)
        assert len(distinct) + len(self._free) + q == self.num_blocks, (
            f"conservation broken: {len(distinct)} distinct mapped + "
            f"{len(self._free)} free + {q} quarantined != {self.num_blocks}"
        )
        idle = [int(b) for b in self._free] + \
            [int(b) for b in self._quarantined]
        assert len(set(idle)) == len(idle), (
            "block id on a free/quarantine list twice (double-free)"
        )
        assert not distinct.intersection(idle), (
            "refcounted block on a free/quarantine list (use-after-free)"
        )
        for s in range(self.slots):
            n = int(self.n_mapped[s])
            assert (self.table[s, :n] >= 0).all() and (
                self.table[s, n:] == -1
            ).all(), f"slot {s} table not a contiguous mapped prefix"
        assert self.reserved_blocks <= self.free_blocks + q, (
            f"reservations {self.reserved_blocks} exceed free "
            f"{self.free_blocks} + quarantined {q}: admission overcommitted"
        )


# ---------------------------------------------------------------------------
# Serving-side composite: full-width pool + optional SWA ring pool
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PagedKV:
    """Block pools + table bookkeeping for one ``BatchedServer``.

    ``pool`` backs the full-width cache regions (GQA K/V, MLA latent): logical
    rows are token positions ``0..max_seq-1``. ``ring`` (models with
    sliding-window layers only) backs the SWA ring regions: logical rows are
    ring positions ``pos % ring_width`` — a bounded region, sized per slot.

    With ``prefix_cache=True`` the full pool additionally feeds a
    ``PrefixIndex``: fully-written feed blocks register their content keys,
    ``admit_shared`` maps a matching resident chain with a refcount bump and
    returns the first position the new request actually has to compute, and
    ``cow_step`` splits shared blocks ahead of any write. Incompatible with a
    ring pool (ring rows wrap: a shared ring block would be missing the
    skipped positions' window writes), so the server only enables it for
    attention-only families.
    """

    block_size: int
    max_seq: int
    pool: KVBlockPool
    ring_width: int = 0
    ring: KVBlockPool | None = None
    prefix_cache: bool = False
    index: PrefixIndex | None = dataclasses.field(default=None, init=False)

    def __post_init__(self) -> None:
        if self.prefix_cache:
            if self.ring is not None:
                raise ValueError(
                    "prefix_cache is unsound with a SWA ring pool: ring rows "
                    "wrap, so a sharer skipping prefill would be missing the "
                    "skipped positions' ring writes"
                )
            self.index = PrefixIndex()
            self.pool.on_zero = self.index.evict_block

    @classmethod
    def for_model(cls, cfg: ModelConfig, slots: int, max_seq: int,
                  block_size: int, kv_blocks: int | None = None,
                  prefix_cache: bool = False) -> "PagedKV":
        """Build pools sized for ``cfg``. ``kv_blocks`` caps the full-region
        pool (default: ``slots * ceil(max_seq/block_size)``, i.e. dense-
        equivalent capacity — pass less to oversubscribe slots against a
        fixed memory budget). The ring pool is always fully provisioned: the
        window bounds it, so it is not the memory lever."""
        from repro_torch.models.transformer import segments_for

        if cfg.family in ("encdec", "ssm"):
            raise ValueError(
                f"family {cfg.family!r} has no paged attention cache "
                "(recurrent/enc-dec state is per-slot, not per-token)"
            )
        per_slot = blocks_for(max_seq, block_size)
        num_blocks = slots * per_slot if kv_blocks is None else int(kv_blocks)
        pool = KVBlockPool(num_blocks, block_size, slots, per_slot)
        ring_width, ring = 0, None
        if any(s.kind == "hybrid_swa" for s in segments_for(cfg)):
            ring_width = min(cfg.swa_window, max_seq)
            ring_per_slot = blocks_for(ring_width, block_size)
            ring = KVBlockPool(slots * ring_per_slot, block_size, slots,
                               ring_per_slot)
        return cls(block_size=block_size, max_seq=max_seq, pool=pool,
                   ring_width=ring_width, ring=ring,
                   prefix_cache=prefix_cache)

    # -- request lifetime ----------------------------------------------------
    def required(self, prompt_len: int, max_new: int, chunk: int = 1,
                 token_step: bool = False) -> tuple[int, int]:
        """Worst-case (full, ring) block demand of a request: it writes
        ``min(max_seq, prompt_len + max_new - 1)`` positions (prefill-as-
        decode: the first generation lands on the final prompt step),
        rounded up to the chunk boundary when the server steps ``chunk``
        uniform tokens at a time (the host retires a slot at step end, so the
        last chunk may overshoot by up to ``chunk - 1`` discarded positions).
        Token-level stepping (``token_step=True``) schedules exactly the
        tokens a request needs — prefill rows are capped at the prompt end
        and decode emits one token per step — so no chunk rounding applies
        and the reservation is exactly the written positions."""
        positions = self._end_positions(0, prompt_len, max_new, chunk,
                                        token_step)
        full = blocks_for(positions, self.block_size)
        ring = blocks_for(min(self.ring_width, positions), self.block_size) \
            if self.ring is not None else 0
        return full, ring

    def _end_positions(self, start: int, prompt_len: int, max_new: int,
                       chunk: int, token_step: bool) -> int:
        """Worst-case written horizon of a request stepping from ``start``:
        chunk rounding counts from ``start`` (the server advances the slot in
        ``chunk`` increments from wherever prefill begins), and the floor is
        one step's writes past ``start`` — an admitted slot always runs at
        least one chunk, so a degenerate request must not slip in with a
        zero reservation and then steal blocks."""
        positions = prompt_len + max_new - 1
        if not token_step:
            positions = start + -(-(positions - start) // chunk) * chunk
        floor = start + (1 if token_step else min(chunk, self.max_seq - start))
        return min(self.max_seq, max(positions, floor))

    def plan_shared(self, keys: list[tuple], prompt_len: int, max_new: int,
                    chunk: int = 1, token_step: bool = False
                    ) -> tuple[list[int], int, int]:
        """Shared-admission plan for a request whose full prompt blocks hash
        to ``keys``: ``(shared_block_ids, start, reserve)``.

        ``start`` is the first position the request computes itself,
        ``min(shared_tokens, prompt_len - 1)`` — the *final* prompt position
        is always recomputed so the first-token emission (and greedy
        sampling) runs through the normal step path. ``reserve`` is the
        worst-case demand net of the shared blocks, plus one extra when
        ``start`` lands *inside* the shared prefix: that first write must
        COW-split the block it touches (the split consumes the reservation).
        Sharing never reserves more than the unshared ``required``."""
        hits = self.index.lookup(keys) if self.index is not None else []
        k = len(hits)
        start = min(k * self.block_size, prompt_len - 1)
        end = self._end_positions(start, prompt_len, max_new, chunk,
                                  token_step)
        total = blocks_for(end, self.block_size)
        reserve = total - k + (1 if start < k * self.block_size else 0)
        return hits, start, reserve

    def can_admit_shared(self, keys: list[tuple], prompt_len: int,
                         max_new: int, chunk: int = 1,
                         token_step: bool = False) -> bool:
        if self.index is None:
            return self.can_admit(prompt_len, max_new, chunk, token_step)
        _, _, reserve = self.plan_shared(keys, prompt_len, max_new, chunk,
                                         token_step)
        return self.pool.can_admit(reserve)

    def admit_shared(self, slot: int, keys: list[tuple], prompt_len: int,
                     max_new: int, chunk: int = 1, token_step: bool = False
                     ) -> tuple[int, int]:
        """Admit ``slot`` mapping the longest resident prefix chain shared;
        returns ``(start, n_shared_blocks)``. Falls back to a plain unshared
        admission (``start=0``) when the prefix cache is off."""
        if self.index is None:
            self.admit(slot, prompt_len, max_new, chunk, token_step)
            return 0, 0
        hits, start, reserve = self.plan_shared(keys, prompt_len, max_new,
                                                chunk, token_step)
        self.pool.admit(slot, reserve)
        self.pool.map_prefix(slot, hits)
        return start, len(hits)

    def cow_step(self, slot: int, pos: int, n_tokens: int,
                 out: list | None = None) -> list[tuple[int, int]]:
        """Copy-on-write for one fused step: split every *shared* block
        covering the rows ``pos .. pos+n_tokens-1`` that ``slot`` is about to
        write. Appends ``(old_bid, new_bid)`` pairs to ``out`` (so a caller
        looping ensure-or-preempt keeps the pairs already split when a later
        split raises ``PoolExhausted``) and returns it; the server must copy
        those device rows before the step's scatter runs."""
        pairs = out if out is not None else []
        if self.index is None:
            return pairs
        last = min(pos + n_tokens - 1, self.max_seq - 1)
        for j in range(pos // self.block_size, last // self.block_size + 1):
            if j >= int(self.pool.n_mapped[slot]):
                break
            bid = int(self.pool.table[slot, j])
            if int(self.pool.refcount[bid]) > 1:
                pairs.append(self.pool.cow(slot, j))
        return pairs

    def register_blocks(self, slot: int, keys: list[tuple], j0: int,
                        j1: int) -> int:
        """Register ``slot``'s fully-written feed blocks ``j0..j1-1`` in the
        prefix index (first writer wins; re-registering a key or an indexed
        block is a no-op). Returns ``j1`` as the caller's new watermark."""
        if self.index is not None:
            for j in range(j0, min(j1, len(keys))):
                self.index.register(keys[j], int(self.pool.table[slot, j]))
        return j1

    def can_admit(self, prompt_len: int, max_new: int, chunk: int = 1,
                  token_step: bool = False) -> bool:
        full, ring = self.required(prompt_len, max_new, chunk, token_step)
        if not self.pool.can_admit(full):
            return False
        return self.ring is None or self.ring.can_admit(ring)

    def admit(self, slot: int, prompt_len: int, max_new: int,
              chunk: int = 1, token_step: bool = False) -> None:
        full, ring = self.required(prompt_len, max_new, chunk, token_step)
        self.pool.admit(slot, full)
        if self.ring is not None:
            self.ring.admit(slot, ring)

    def release(self, slot: int) -> int:
        n = self.pool.release(slot)
        if self.ring is not None:
            n += self.ring.release(slot)
        return n

    def ensure_step(self, slot: int, pos: int, n_tokens: int) -> bool:
        """Alloc-on-write for one fused step: map blocks covering the rows
        this slot will write — positions ``pos .. pos+n_tokens-1`` in the
        full region, their ring images in the ring region."""
        last = min(pos + n_tokens - 1, self.max_seq - 1)
        changed = self.pool.ensure(slot, last)
        if self.ring is not None:
            changed |= self.ring.ensure(slot, min(last, self.ring_width - 1))
        return changed

    def shrink(self, n: int) -> int:
        """Fault injection: quarantine up to ``n`` blocks from the full-width
        pool (the memory lever; the SWA ring is window-bounded and stays
        fully provisioned — shrinking it would break ring semantics, not
        model memory pressure)."""
        return self.pool.shrink(n)

    def grow(self, n: int | None = None) -> int:
        return self.pool.grow(n)

    def check(self) -> None:
        """Assert both pools' allocator invariants (``debug_checks`` hook),
        plus the prefix-index lifecycle: an indexed block is always resident
        (refcount >= 1 — eviction-on-zero must never lag a free)."""
        self.pool.check()
        if self.ring is not None:
            self.ring.check()
        if self.index is not None:
            for bid in self.index.blocks():
                assert int(self.pool.refcount[bid]) >= 1, (
                    f"prefix index holds freed block {bid}"
                )

    def tables(self) -> tuple[np.ndarray, np.ndarray | None]:
        return (self.pool.table_array(),
                self.ring.table_array() if self.ring is not None else None)

    def token_tables(self, slot_ids) -> tuple[np.ndarray, np.ndarray | None]:
        """Per-token block tables for a flattened token batch: row ``i`` is
        the table of the slot token ``i`` maps to (what the paged-attention
        kernel scalar-prefetches). ``slot_ids`` is any int sequence; padding
        tokens may point at any live slot — their reads are masked and their
        writes are gated off by ``write_ok``."""
        ids = np.asarray(slot_ids, np.int32)
        full = self.pool.table_array()[ids]
        ring = self.ring.table_array()[ids] if self.ring is not None else None
        return full, ring
