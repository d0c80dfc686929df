"""PREDICT executor on PyTorch: SQL-driven batch scoring through the strider
path (counterpart of ``repro.db.scoring``, which it is held against).

A scoring query streams the table's heap pages through the *projected*
strider decode (``kernels/strider``, kernel B3) directly into batched model
evaluation (``kernels/engine``, kernel B4 for GLMs). Where ``repro`` jits one
XLA program per chunk, the port runs a short eager sequence per chunk on the
scan's device: decode, reshape, the WHERE tree on the decoded tensors,
``index_select`` of the model's columns, scoring, and in aggregate mode one
masked sum per aggregate plus the kept count. Nothing in that sequence reads
the card back, so decoded tuples never bounce through the host between the
access engine and the execution engine, and the scan joins the card once
(``_device_join``), after its last chunk. Kept rows are filtered on the host
after that join, as ``repro`` does.

Pushdown is compiled, not simulated: the query's projection, filter, and
aggregate columns (plus the model's input columns) define a ProjectionPlan,
and both the Strider ISA program and the decode restrict themselves to those
payload words — dropped columns are never read off the page, and
:class:`PushdownStats` carries the static byte/cycle accounting that proves
it (cross-checked against the ISA interpreter's FIFO in tests).

Aggregate queries (COUNT/SUM/AVG over columns, ``label``, or the model's
``prediction``) reduce per chunk ON DEVICE: the chunk returns only a partial
(sums, count) pair, and the host combines the partials in float32 after the
scan's single join. Scoring is skipped when no aggregate reads
``prediction`` (``repro`` gets the same from XLA's dead-code elimination).

Model families:
  GLM (linear / logistic / svm)  structural template match on the UDF's hDFG
      (core.engine.match_glm_template); scores via the row-parallel predict
      kernel. The model reads the FIRST d feature columns of the scoring
      table (schema-prefix convention).
  LRMF  single 2-D model (n_items, rank); the prediction is the per-row
      reconstruction error ||x - (xM)Mᵀ|| of the rating row, by
      ``torch.matmul`` (``repro`` computes it outside any Pallas kernel too).
  LM    waits for the port's serving slice (ROADMAP A16): ``execute_predict``
      raises ``NotImplementedError``.

Row-returning results flow back as result pages — the projected schema with
a `prediction` column appended — and ``INSERT INTO t SELECT ...`` (or
``into=``) registers them as a catalog table, rejecting a name collision
unless ``OR REPLACE`` is given.

:class:`PredictScan` is the prepared form of a GLM/LRMF statement and
``PredictScan.units`` its double-buffered scan, a generator that yields after
each chunk dispatch: ``execute_predict`` drains it, and the concurrent
executor (``db/executor.py``) steps it one chunk per scheduling unit.

Device policy: ``execute_predict`` and ``PredictScan`` take ``device=None``,
meaning the card, and raise ``RuntimeError`` when there is none. On the card
pages travel through two pinned buffers per scan (``PinnedStager``); on the
CPU every kernel runs its plain version. JAX's ``use_kernel=`` has no
counterpart.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time

import numpy as np
import torch

from repro_torch.core import striders
from repro_torch.core.engine import PinnedStager, match_glm_template, resolve_device
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import HeapFile, write_table
from repro_torch.db.page import PageLayout, build_pages
from repro_torch.kernels.engine import ops as engine_ops
from repro_torch.kernels.strider import kernel as strider_kernel
from repro_torch.kernels.strider import ops as strider_ops

CHUNK_PAGES = 512  # pages decoded per device chunk (matches solver's)


@dataclasses.dataclass(frozen=True)
class PushdownStats:
    """Static pushdown bookkeeping for one PREDICT query.

    ``bytes_decoded`` is what the projected strider streams off the pages
    (``n_tuples * plan.bytes_per_tuple``); ``bytes_full_decode`` is what a
    full decode of the same rows would have streamed. ``strider_cycles`` is
    the access-engine cycle model (hwgen's) summed over the scan, assuming
    full pages.
    """

    columns_decoded: tuple[int, ...]
    n_columns_total: int
    include_label: bool
    bytes_per_tuple: int
    bytes_per_tuple_full: int
    bytes_decoded: int
    bytes_full_decode: int
    strider_cycles: int
    strider_cycles_full: int

    @property
    def decode_bytes_ratio(self) -> float:
        """full-decode bytes / projected bytes (>= 1; the pushdown win)."""
        return self.bytes_full_decode / max(self.bytes_decoded, 1)


def _pushdown_stats(heap: HeapFile, plan: striders.ProjectionPlan) -> PushdownStats:
    layout = heap.layout
    n = heap.n_tuples
    return PushdownStats(
        columns_decoded=plan.columns,
        n_columns_total=layout.n_features,
        include_label=plan.include_label,
        bytes_per_tuple=plan.bytes_per_tuple,
        bytes_per_tuple_full=plan.bytes_per_tuple_full,
        bytes_decoded=n * plan.bytes_per_tuple,
        bytes_full_decode=n * plan.bytes_per_tuple_full,
        strider_cycles=heap.n_pages * striders.strider_cycles_per_page(layout, plan),
        strider_cycles_full=heap.n_pages * striders.strider_cycles_per_page(layout),
    )


def _column_index(name: str, layout: PageLayout) -> int | None:
    """'c<i>' -> feature index (validated), 'label' -> None."""
    if name == "label":
        return None
    m = re.match(r"^c(\d+)$", name)
    if not m:
        raise ValueError(f"unknown column {name!r}")
    idx = int(m.group(1))
    if idx >= layout.n_features:
        raise ValueError(
            f"column {name!r} out of range: table has {layout.n_features} "
            f"feature columns (c0..c{layout.n_features - 1})"
        )
    return idx


def _glm_family(artifact: dict, udf: str) -> str:
    """Map a UDF artifact to a scorable family: linear/logistic/svm/lrmf."""
    g, part = artifact["hdfg"], artifact["partition"]
    act = match_glm_template(g, part)
    if act is not None:
        return act
    if len(g.model_ids) == 1 and len(g.node(g.model_ids[0]).shape) == 2:
        return "lrmf"  # single 2-D factor model: reconstruction-error scoring
    raise ValueError(
        f"UDF {udf!r} does not match a scorable template "
        f"(GLM gradient or 2-D factor model)"
    )


def _scoring_model(artifact: dict, udf: str) -> np.ndarray:
    if "model" not in artifact:
        raise ValueError(
            f"UDF {udf!r} has no trained model; run the TRAIN query "
            f"(SELECT * FROM dana.{udf}('<table>')) first"
        )
    if "strider_program" not in artifact or "design_point" not in artifact:
        raise ValueError(
            f"UDF {udf!r} was registered without a page layout — no strider "
            f"program / design point was compiled; re-register with "
            f"register_udf_from_trace(..., layout=heap.layout)"
        )
    return np.asarray(artifact["model"][0])


class _ChunkProgram:
    """One chunk's decode + WHERE keep-mask + scoring, queued on ``device``.

    Row mode returns (preds, keep, feats, labels) flattened over tuples;
    aggregate mode returns only (partial_sums, kept_count). Everything stays
    on the device: no call here reads a value back, so the card runs the
    chunks from its queue and the scan joins it once. Model weights, column
    indices and the decode's plan table move to the device once, here."""

    def __init__(self, layout, plan, family, model, where, where_pos, device,
                 aggregates=None, agg_pos=None):
        self.layout, self.plan, self.family = layout, plan, family
        self.where, self.where_pos = where, where_pos
        self.aggregates, self.agg_pos = aggregates, agg_pos
        self.device = device
        pos = [plan.columns.index(c) for c in range(model.shape[0])]
        # the model reads a prefix of the plan's columns: no gather needed
        # when that prefix is the whole plan
        self.model_pos = (
            None if pos == list(range(plan.n_columns))
            else torch.tensor(pos, dtype=torch.long).to(device)
        )
        self.w = torch.from_numpy(np.array(model, dtype=np.float32)).to(device)
        self.need_preds = aggregates is None or any(
            a.arg == "prediction" for a in aggregates
        )
        if device.type == "cuda":
            self.stage = PinnedStager(device)
            self.src = torch.tensor(
                strider_kernel.plan_sources(plan), dtype=torch.int32
            ).to(device)
        else:
            self.stage = self.src = None

    def __call__(self, pages_np: np.ndarray):
        if self.stage is not None:
            pages = self.stage(pages_np)
        else:
            pages = strider_ops.pages_tensor(pages_np)
        feats, labels, mask = strider_ops.decode_pages_projected(
            pages, self.layout, self.plan, self.src
        )
        p, t, c = feats.shape
        f2 = feats.reshape(p * t, c)
        lab = labels.reshape(p * t)
        keep = mask.reshape(p * t) > 0
        if self.where is not None:
            def lookup(name):
                pos = self.where_pos[name]
                return lab if pos is None else f2[:, pos]

            keep = keep & self.where.evaluate(lookup)
        preds = None
        if self.need_preds:
            x = f2 if self.model_pos is None else f2.index_select(1, self.model_pos)
            w = self.w
            if self.family == "lrmf":
                # prediction = per-row reconstruction error ||x - (xM)Mᵀ||
                recon = (x @ w) @ w.T
                d = torch.where(keep[:, None], x - recon, 0.0)
                preds = torch.sqrt(torch.sum(d * d, dim=1))
            else:
                preds = engine_ops.glm_predict(
                    x, w, keep.to(torch.float32), act=self.family
                )
        if self.aggregates is not None:
            sums = []
            for a in self.aggregates:
                if a.arg is None:  # COUNT(*): the count output covers it
                    sums.append(torch.zeros((), dtype=torch.float32, device=self.device))
                    continue
                if a.arg == "prediction":
                    val = preds
                elif a.arg == "label":
                    val = lab
                else:
                    val = f2[:, self.agg_pos[a.arg]]
                sums.append(torch.sum(torch.where(keep, val, 0.0)))
            return torch.stack(sums), keep.sum()
        return preds, keep, f2, lab


def _device_join(outs: list, aggregate: bool) -> list[np.ndarray]:
    """The scan's single host↔device join (tests instrument this).

    The chunk outputs are stacked (aggregate partials) or concatenated (rows)
    on their device, copied into pinned host memory without blocking, and the
    host waits once, on an event recorded after the copies. Returns one host
    array per output."""
    join = torch.stack if aggregate else torch.cat
    parts = [join(list(col)) for col in zip(*outs)]
    device = parts[0].device
    if device.type != "cuda":
        return [t.numpy() for t in parts]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in parts]
    for h, t in zip(host, parts):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    done.synchronize()
    return [h.numpy() for h in host]


def combine_aggregates(aggregates, outs) -> tuple[dict, int]:
    """Host-side combine of per-chunk partials -> (values, count).

    Accumulates in np.float32, chunk by chunk, so a multi-chunk scan is
    bit-exact against an oracle performing the same per-chunk combine. AVG
    over zero kept rows is NaN (SQL would say NULL).
    """
    total = np.zeros(len(aggregates), np.float32)
    count = 0
    for sums, cnt in outs:
        total = (total + np.asarray(sums, np.float32)).astype(np.float32)
        count += int(cnt)
    values: dict = {}
    for i, a in enumerate(aggregates):
        if a.func == "COUNT":
            values[a.label] = count
        elif a.func == "SUM":
            values[a.label] = float(total[i])
        else:  # AVG: one f32 divide, matching what the device would emit
            values[a.label] = (
                float(np.float32(total[i]) / np.float32(count))
                if count else float("nan")
            )
    return values, count


class PredictScan:
    """A prepared GLM/LRMF PREDICT statement: resolved artifacts, projection
    plan, the chunk program, and the finalizer that turns the joined chunk
    outputs into a QueryResult.

    ``units`` is the scan itself; ``execute_predict`` drains it and the
    concurrent executor steps it one chunk at a time, so PREDICT scans
    interleave with TRAIN epochs over the shared pool without changing
    per-query results.
    """

    def __init__(self, stmt, catalog, pool=None, *, chunk_pages=None,
                 into=None, or_replace=False, device=None):
        self.device = resolve_device(device)
        self.stmt = stmt
        self.catalog = catalog
        self.into = into
        self.or_replace = or_replace
        self.artifact = catalog.udf(stmt.udf)
        if self.artifact.get("kind") == "lm":
            raise NotImplementedError(
                f"UDF {stmt.udf!r} is a language model: LM PREDICT waits for the "
                f"port's serving slice (ROADMAP A16)"
            )
        self.heap = HeapFile(catalog.table(stmt.table)["heap"])
        layout = self.layout = self.heap.layout
        self.chunk = chunk_pages or CHUNK_PAGES
        self.pool = pool or BufferPool(
            pool_bytes=self.chunk * layout.page_bytes,
            page_bytes=layout.page_bytes,
        )

        family = self.family = _glm_family(self.artifact, stmt.udf)
        model = self.model = _scoring_model(self.artifact, stmt.udf)
        dm = model.shape[0]
        if dm > layout.n_features:
            raise ValueError(
                f"UDF {stmt.udf!r} reads {dm} feature columns but table "
                f"{stmt.table!r} has only {layout.n_features}"
            )
        if self.into is not None and stmt.aggregates is not None:
            raise ValueError(
                "aggregate queries reduce on device and never materialize "
                "result pages; they cannot be INSERTed into a table"
            )

        # ---- pushdown plan: model ∪ projection ∪ filter ∪ aggregate cols ---
        if stmt.aggregates is not None:
            proj_names: list[str] = []  # reductions project no row columns
        elif stmt.columns is None:
            proj_names = [f"c{i}" for i in range(layout.n_features)] + ["label"]
        else:
            proj_names = list(stmt.columns)
        self.proj_names = proj_names
        proj_idx = self.proj_idx = [
            _column_index(n, layout) for n in proj_names
        ]
        include_label = None in proj_idx
        decode_cols = set(range(dm)) | {i for i in proj_idx if i is not None}
        where_map: dict[str, int | None] = {}
        if stmt.where is not None:
            for name in stmt.where.columns():
                where_map[name] = _column_index(name, layout)
            include_label = include_label or None in where_map.values()
            decode_cols |= {i for i in where_map.values() if i is not None}
        agg_map: dict[str, int | None] = {}
        for a in stmt.aggregates or ():
            if a.arg is None or a.arg == "prediction":
                continue
            agg_map[a.arg] = _column_index(a.arg, layout)
            include_label = include_label or agg_map[a.arg] is None
            if agg_map[a.arg] is not None:
                decode_cols.add(agg_map[a.arg])
        plan = self.plan = striders.projection_plan(
            layout, decode_cols, include_label=bool(include_label)
        )
        self.pushdown = _pushdown_stats(self.heap, plan)

        # plan positions (not table indices) for the tree and the aggregates
        where_pos = {
            name: (None if idx is None else plan.columns.index(idx))
            for name, idx in where_map.items()
        }
        agg_pos = {
            name: plan.columns.index(idx)
            for name, idx in agg_map.items() if idx is not None
        }
        self.run_chunk = _ChunkProgram(
            layout, plan, family, model, stmt.where, where_pos, self.device,
            aggregates=stmt.aggregates, agg_pos=agg_pos,
        )
        self.page_chunks = [
            np.arange(s, min(s + self.chunk, self.heap.n_pages))
            for s in range(0, self.heap.n_pages, self.chunk)
        ]

    # -- the scan ------------------------------------------------------------
    def units(self, t_start: float | None = None):
        """Double-buffered page scan: fetch chunk k+1 on the pool's
        background thread while the device runs chunk k, yielding after each
        chunk dispatch; ONE host↔device join after the last. Returns the
        QueryResult via ``StopIteration.value``."""
        t_start = time.perf_counter() if t_start is None else t_start
        outs: list = []
        exposed = overlapped = 0.0
        t0 = time.perf_counter()
        chunks = self.page_chunks
        if chunks:
            handle = self.pool.prefetch_batch(self.heap, chunks[0])
            try:
                for k in range(len(chunks)):
                    t_wait = time.perf_counter()
                    pages_np = handle.result()
                    waited = time.perf_counter() - t_wait
                    exposed += waited
                    overlapped += max(handle.fetch_s - waited, 0.0)
                    if k + 1 < len(chunks):
                        handle = self.pool.prefetch_batch(self.heap, chunks[k + 1])
                    outs.append(self.run_chunk(pages_np))
                    yield  # chunk dispatched: the scheduling point
            finally:
                # leave the pool quiescent on every exit: a chunk that raised
                # or a generator closed early (deadline cancel) included
                if not handle.cancel():
                    try:
                        handle.result()
                    except Exception:
                        pass
        joined = _device_join(outs, self.stmt.aggregates is not None) if outs else None
        compute = time.perf_counter() - t0 - exposed
        return self.finalize(joined, exposed, overlapped, compute, t_start)

    # -- finalization --------------------------------------------------------
    def finalize(self, joined, exposed, overlapped, compute, t_start):
        """Joined chunk outputs (host arrays, or None for an empty heap) ->
        QueryResult."""
        from repro_torch.db import query as q

        stmt, heap, plan = self.stmt, self.heap, self.plan
        if stmt.aggregates is not None:
            outs = list(zip(*joined)) if joined is not None else []
            values, count = combine_aggregates(stmt.aggregates, outs)
            return q.QueryResult(
                verb="PREDICT",
                udf=stmt.udf,
                table=stmt.table,
                schema=tuple(a.label for a in stmt.aggregates),
                n_rows=1,
                rows_scanned=heap.n_tuples,
                rows_filtered=heap.n_tuples - count,
                total_s=time.perf_counter() - t_start,
                exposed_io_s=exposed,
                overlapped_io_s=overlapped,
                compute_s=compute,
                device_syncs=1,
                pushdown=self.pushdown,
                aggregates=values,
            )

        # ---- host-side result assembly (dynamic row count) -----------------
        if joined is not None:
            preds, keep, f2, lab = joined
        else:
            preds = np.zeros(0, np.float32)
            keep = np.zeros(0, bool)
            f2 = np.zeros((0, plan.n_columns), np.float32)
            lab = np.zeros(0, np.float32)
        preds, f2, lab = preds[keep], f2[keep], lab[keep]
        n_kept = int(keep.sum())

        cols = []
        for idx in self.proj_idx:
            cols.append(lab if idx is None else f2[:, plan.columns.index(idx)])
        result_feats = (
            np.stack(cols, axis=1).astype(np.float32)
            if cols else np.zeros((n_kept, 0), np.float32)
        )
        schema = tuple(self.proj_names) + ("prediction",)
        result_layout = PageLayout(
            n_features=len(self.proj_names), page_bytes=self.layout.page_bytes,
            quantized=False,
        )
        if n_kept:
            result_pages = build_pages(result_feats, preds, result_layout)
        else:
            result_pages = np.zeros((0, result_layout.page_words), np.uint32)

        if self.into is not None:
            catalog = self.catalog
            if not self.or_replace and catalog.has_table(self.into):
                # refuse BEFORE touching the heap file: the colliding name
                # may own that very path, and a clobbered heap is data loss
                raise ValueError(
                    f"catalog: table {self.into!r} already exists; use "
                    f"INSERT OR REPLACE INTO (or or_replace=True) to "
                    f"overwrite"
                )
            path = os.path.join(catalog.root, f"{self.into}.heap")
            write_table(path, result_feats, preds, page_bytes=self.layout.page_bytes)
            catalog.register_table(
                self.into, path,
                {"n_features": len(self.proj_names), "columns": list(schema)},
                or_replace=self.or_replace,
            )

        return q.QueryResult(
            verb="PREDICT",
            udf=stmt.udf,
            table=stmt.table,
            schema=schema,
            n_rows=n_kept,
            predictions=preds,
            rows_scanned=heap.n_tuples,
            rows_filtered=heap.n_tuples - n_kept,
            total_s=time.perf_counter() - t_start,
            exposed_io_s=exposed,
            overlapped_io_s=overlapped,
            compute_s=compute,
            device_syncs=1,
            pushdown=self.pushdown,
            result_pages=result_pages,
            result_layout=result_layout,
        )


def execute_predict(
    stmt,
    catalog,
    pool: BufferPool | None = None,
    *,
    chunk_pages: int | None = None,
    into: str | None = None,
    or_replace: bool = False,
    device=None,
):
    """Run a parsed PREDICT statement on ``device`` (``None``: the card);
    returns a query.QueryResult.

    ``into=`` additionally materializes the result pages as a heap table
    registered in the catalog under that name, so a scoring query's output
    is itself queryable — an existing name is rejected unless ``or_replace``.
    """
    t_start = time.perf_counter()
    scan = PredictScan(
        stmt, catalog, pool, chunk_pages=chunk_pages, into=into,
        or_replace=or_replace, device=device,
    )
    gen = scan.units(t_start)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value
