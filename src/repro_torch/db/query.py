"""Query layer: the SQL surface over accelerated UDFs (paper §4.3), on
PyTorch (counterpart of ``repro.db.query``, which it is held against).

Verbs that close the in-RDBMS loop:

    TRAIN      SELECT * FROM dana.linearR('training_data_table');
    PREDICT    SELECT c0, c3 FROM dana.predict('linearR', 'scoring_table')
               WHERE (c2 > 0.5 AND c0 <= 1.0) OR NOT label == 0;
    AGGREGATE  SELECT COUNT(*), AVG(prediction) FROM dana.predict('m', 't')
               WHERE c1 > 0;
    INSERT     INSERT [OR REPLACE] INTO scored
               SELECT c0 FROM dana.predict('m', 't') WHERE c1 > 0;

``parse`` turns SQL into a typed :class:`Statement` (verb, UDF, table,
projection, aggregates, predicate tree, insert target) via a real tokenizer +
recursive-descent parser — malformed SQL raises ``ValueError`` naming the
offending token. ``execute`` resolves the catalog artifacts and hands TRAIN
to the solver and PREDICT to the scoring executor (``db/scoring.py``),
returning a typed :class:`QueryResult`.

WHERE clauses are arbitrary AND/OR/NOT trees over comparisons (``NOT`` binds
tightest, then ``AND``, then ``OR``; parentheses group). The whole tree is
evaluated on the card's tensors inside each chunk's decode+filter+score
sequence, as the keep-mask — no extra decode passes — and every column the
tree touches joins the :class:`~repro_torch.core.striders.ProjectionPlan`,
so pushdown bookkeeping (``QueryResult.pushdown``) still cross-checks
against the Strider ISA FIFO.

Aggregates (``COUNT(*)``/``COUNT(col)``/``SUM(col)``/``AVG(col)``, ``col``
a table column, ``label``, or ``prediction``) reduce per chunk *on device*:
only partial (sum, count) scalars cross to the host, result pages are never
materialized, and the scan still joins the card exactly once.

``INSERT INTO t SELECT ...`` materializes a scoring query's result pages as
catalog table ``t`` (the existing result-page round-trip), so
train-on-predictions pipelines are expressible in SQL. A name collision is
rejected unless ``OR REPLACE`` (or ``or_replace=True``) is given.

Use :class:`repro_torch.db.Database` / ``Session.sql`` (the documented
entry point) or this module's typed ``parse``/``execute`` lower layer.

Device policy: ``execute`` takes ``device=None``, meaning the card, and
raises ``RuntimeError`` when there is none; callers ask for the CPU with
``device="cpu"``. JAX's ``use_kernel=`` has no counterpart: the tensors'
device picks each kernel or its plain version.

LM PREDICT: ``register_lm_udf`` registers a language model as a scoring UDF,
its weights in a file beside the catalog's index (``db/catalog.py``), and
``SELECT * FROM dana.predict('lm', 'prompts') WHERE label >= 8`` decodes a
token table (``db/heap.py::write_token_table``) through the strider path,
filters it on the card (``c<i>`` compare as token ids, ``label`` as the
prompt length), and generates for the kept prompts on a short-lived
continuous-batching session (``max_new_tokens=``, ``batch_slots=``);
``INSERT INTO`` stores the generated tokens as a token table.

Column naming: feature columns are positional — ``c0 .. c<D-1>`` — plus the
``label`` column; a PREDICT's result schema is its projected columns with a
``prediction`` column appended.
"""
from __future__ import annotations

import dataclasses
import functools
import operator
import re

import numpy as np

from repro_torch.core import solver
from repro_torch.core.engine import resolve_device
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.catalog import Catalog
from repro_torch.db.heap import HeapFile

# normalized comparison operators a WHERE clause may use
_OPS = ("<=", ">=", "==", "!=", "<", ">")
_OP_ALIASES = {"=": "==", "<>": "!="}

_COLUMN_RE = re.compile(r"^(c\d+|label)$")

_AGG_FUNCS = ("COUNT", "SUM", "AVG")


# ---------------------------------------------------------------------------
# predicate trees
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Predicate:
    """Leaf comparison: ``column <op> value`` (a one-node predicate tree)."""

    column: str  # "c<i>" (feature, by table position) or "label"
    op: str  # normalized: < <= > >= == !=
    value: float

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unsupported WHERE operator {self.op!r}")
        if not _COLUMN_RE.match(self.column):
            raise ValueError(
                f"unsupported WHERE column {self.column!r} (use c<i> or label)"
            )

    def columns(self) -> tuple[str, ...]:
        return (self.column,)

    def mask(self, vals):
        """Elementwise keep-mask over a column of values (np or torch). An f32
        column compares with the literal cast to f32, as JAX's weak typing
        does: ``c1 > 0.1`` is False where c1 holds float32(0.1)."""
        if self.op == "<":
            return vals < self.value
        if self.op == "<=":
            return vals <= self.value
        if self.op == ">":
            return vals > self.value
        if self.op == ">=":
            return vals >= self.value
        if self.op == "==":
            return vals == self.value
        return vals != self.value

    def evaluate(self, lookup):
        """Keep-mask given ``lookup(column) -> value array`` (np or torch —
        on card tensors it launches work and never reads back)."""
        return self.mask(lookup(self.column))


@dataclasses.dataclass(frozen=True)
class And:
    """Conjunction node: every child mask must hold."""

    children: tuple

    def __post_init__(self):
        if len(self.children) < 2:
            raise ValueError("And needs at least two children")

    def columns(self) -> tuple[str, ...]:
        return _tree_columns(self.children)

    def evaluate(self, lookup):
        return functools.reduce(
            operator.and_, (c.evaluate(lookup) for c in self.children)
        )


@dataclasses.dataclass(frozen=True)
class Or:
    """Disjunction node: any child mask may hold."""

    children: tuple

    def __post_init__(self):
        if len(self.children) < 2:
            raise ValueError("Or needs at least two children")

    def columns(self) -> tuple[str, ...]:
        return _tree_columns(self.children)

    def evaluate(self, lookup):
        return functools.reduce(
            operator.or_, (c.evaluate(lookup) for c in self.children)
        )


@dataclasses.dataclass(frozen=True)
class Not:
    """Negation node."""

    child: object

    def columns(self) -> tuple[str, ...]:
        return self.child.columns()

    def evaluate(self, lookup):
        return ~self.child.evaluate(lookup)


def _tree_columns(nodes) -> tuple[str, ...]:
    """Deduplicated columns of a node list, in first-reference order."""
    out: list[str] = []
    for n in nodes:
        for c in n.columns():
            if c not in out:
                out.append(c)
    return tuple(out)


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Aggregate:
    """One aggregate select item: ``COUNT(*)``, ``SUM(col)``, ``AVG(col)``.

    ``arg`` is a table column (``c<i>``/``label``), the ``prediction``
    column, or ``None`` for ``COUNT(*)``. Aggregates reduce on device per
    chunk; only partial scalars ever reach the host.
    """

    func: str  # COUNT | SUM | AVG
    arg: str | None

    def __post_init__(self):
        if self.func not in _AGG_FUNCS:
            raise ValueError(
                f"unsupported aggregate {self.func!r} (use {_AGG_FUNCS})"
            )
        if self.arg is None:
            if self.func != "COUNT":
                raise ValueError(f"{self.func}(*) is not defined; name a column")
        elif self.arg != "prediction" and not _COLUMN_RE.match(self.arg):
            raise ValueError(
                f"unsupported aggregate argument {self.arg!r} "
                f"(use c<i>, label, or prediction)"
            )

    @property
    def label(self) -> str:
        """Result-schema name, e.g. ``count(*)`` / ``avg(prediction)``."""
        return f"{self.func.lower()}({self.arg if self.arg else '*'})"


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Statement:
    """A parsed query: what to run, on what, returning which columns.

    ``verb`` is "TRAIN" or "PREDICT". A PREDICT carries either ``columns``
    (row projection; None = SELECT *) or ``aggregates`` (reduction verbs) —
    never both — plus an optional ``where`` predicate tree and an optional
    ``insert_into`` target (the INSERT…SELECT form; ``or_replace`` allows
    overwriting an existing catalog table).
    """

    verb: str  # "TRAIN" | "PREDICT"
    udf: str
    table: str
    columns: tuple[str, ...] | None  # None = SELECT * (all columns)
    where: object | None  # Predicate | And | Or | Not
    sql: str
    aggregates: tuple[Aggregate, ...] | None = None
    insert_into: str | None = None
    or_replace: bool = False


@dataclasses.dataclass
class QueryResult:
    """Typed result of ``execute``.

    TRAIN fills ``coefficients`` (the trained model arrays, also written back
    to the catalog artifact) and ``train`` (the full TrainResult). PREDICT
    fills ``predictions`` — a float32 vector — plus ``result_pages``/``result_layout``
    (the projected schema with the prediction column appended, packed as heap
    pages) and ``pushdown`` (byte/cycle bookkeeping of the projection/filter
    pushdown). Aggregate queries fill ``aggregates`` (label -> value, one
    logical result row) instead, and never materialize result pages. I/O
    accounting follows the pipelined executor's contract: ``exposed_io_s``
    is what the loop blocked on, ``overlapped_io_s`` hid under device
    compute. Every array is on the host.
    """

    verb: str
    udf: str
    table: str
    schema: tuple[str, ...]
    n_rows: int
    predictions: object | None = None
    coefficients: list | None = None
    rows_scanned: int = 0
    rows_filtered: int = 0
    total_s: float = 0.0
    exposed_io_s: float = 0.0
    overlapped_io_s: float = 0.0
    compute_s: float = 0.0
    device_syncs: int = 0
    pushdown: object | None = None  # scoring.PushdownStats
    result_pages: np.ndarray | None = None
    result_layout: object | None = None  # page.PageLayout
    train: solver.TrainResult | None = None
    serve_metrics: object | None = None  # serve.metrics.ServeMetrics (LM)
    aggregates: dict | None = None  # label -> value (aggregate queries)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<str>'[^']*')
    | (?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)
    | (?P<op><=|>=|==|!=|<>|=|<|>)
    | (?P<punct>[(),;.*])
    | (?P<word>[A-Za-z_]\w*)
    | (?P<bad>\S)
    )""",
    re.VERBOSE,
)

_KEYWORDS = frozenset(
    {"SELECT", "FROM", "WHERE", "AND", "OR", "NOT", "INSERT", "INTO",
     "REPLACE"}
)


def _tokenize(sql: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None or m.end() == pos:
            break  # only trailing whitespace left
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "bad":
            raise ValueError(
                f"unexpected character {text!r} in query: {sql!r}"
            )
        if kind == "str":
            text = text[1:-1]
        toks.append((kind, text))
    return toks


class _Parser:
    """Recursive-descent parser over the token stream. Every rejection names
    the offending token (or reports unexpected end of input)."""

    def __init__(self, sql: str):
        self.sql = sql
        self.toks = _tokenize(sql)
        self.i = 0

    # -- stream primitives ---------------------------------------------------
    def peek(self) -> tuple[str, str]:
        return self.toks[self.i] if self.i < len(self.toks) else ("end", "")

    def advance(self) -> tuple[str, str]:
        tok = self.peek()
        if tok[0] != "end":
            self.i += 1
        return tok

    def fail(self, expected: str):
        kind, text = self.peek()
        got = "end of input" if kind == "end" else f"token {text!r}"
        raise ValueError(f"expected {expected}, got {got}: {self.sql!r}")

    def _at_keyword(self, kw: str) -> bool:
        kind, text = self.peek()
        return kind == "word" and text.upper() == kw

    def accept_keyword(self, kw: str) -> bool:
        if self._at_keyword(kw):
            self.advance()
            return True
        return False

    def expect_keyword(self, kw: str) -> None:
        if not self.accept_keyword(kw):
            self.fail(kw)

    def accept_punct(self, p: str) -> bool:
        kind, text = self.peek()
        if kind == "punct" and text == p:
            self.advance()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        if not self.accept_punct(p):
            self.fail(f"{p!r}")

    def expect_word(self, what: str) -> str:
        kind, text = self.peek()
        if kind != "word" or text.upper() in _KEYWORDS:
            self.fail(what)
        self.advance()
        return text

    # -- grammar -------------------------------------------------------------
    def statement(self) -> Statement:
        if self._at_keyword("INSERT"):
            stmt = self._insert()
        elif self._at_keyword("SELECT"):
            stmt = self._select()
        else:
            raise ValueError(
                "unsupported query (expected SELECT ... FROM dana.udf('t'), "
                "SELECT ... FROM dana.predict('udf', 't'), or INSERT INTO "
                f"... SELECT): {self.sql!r}"
            )
        self.accept_punct(";")
        if self.peek()[0] != "end":
            self.fail("end of statement")
        return stmt

    def _insert(self) -> Statement:
        self.expect_keyword("INSERT")
        or_replace = False
        if self.accept_keyword("OR"):
            self.expect_keyword("REPLACE")
            or_replace = True
        self.expect_keyword("INTO")
        target = self.expect_word("a target table name after INTO")
        inner = self._select()
        if inner.verb != "PREDICT":
            raise ValueError(
                f"INSERT INTO chains a dana.predict(...) SELECT only: "
                f"{self.sql!r}"
            )
        if inner.aggregates is not None:
            raise ValueError(
                "aggregate results are a single logical row and are never "
                f"materialized as a table; drop the INSERT INTO: {self.sql!r}"
            )
        return dataclasses.replace(
            inner, insert_into=target, or_replace=or_replace
        )

    def _select(self) -> Statement:
        self.expect_keyword("SELECT")
        columns, aggregates = self._select_list()
        self.expect_keyword("FROM")
        udf, table, is_predict = self._source()
        where = None
        if self.accept_keyword("WHERE"):
            where = self._or_expr()
        if not is_predict:
            if columns is not None or aggregates is not None:
                raise ValueError(
                    f"TRAIN queries must SELECT * (the whole training "
                    f"table): {self.sql!r}"
                )
            if where is not None:
                raise ValueError(
                    f"TRAIN queries take no WHERE clause: {self.sql!r}"
                )
            return Statement(
                verb="TRAIN", udf=udf, table=table, columns=None,
                where=None, sql=self.sql,
            )
        return Statement(
            verb="PREDICT", udf=udf, table=table, columns=columns,
            where=where, sql=self.sql, aggregates=aggregates,
        )

    def _select_list(self):
        """-> (columns|None, aggregates|None); SELECT * is (None, None)."""
        if self.accept_punct("*"):
            return None, None
        columns: list[str] = []
        aggregates: list[Aggregate] = []
        while True:
            kind, text = self.peek()
            if kind != "word" or text.upper() in _KEYWORDS:
                self.fail("a column or aggregate in the select list")
            if text.upper() in _AGG_FUNCS:
                aggregates.append(self._aggregate())
            else:
                self.advance()
                if not _COLUMN_RE.match(text):
                    raise ValueError(
                        f"unknown column {text!r} in projection (use c<i>, "
                        f"label, or *): {self.sql!r}"
                    )
                columns.append(text)
            if not self.accept_punct(","):
                break
        if columns and aggregates:
            raise ValueError(
                f"aggregates and plain columns cannot mix in one select "
                f"list (no GROUP BY): {self.sql!r}"
            )
        if aggregates:
            return None, tuple(aggregates)
        return tuple(columns), None

    def _aggregate(self) -> Aggregate:
        func = self.advance()[1].upper()
        self.expect_punct("(")
        if self.accept_punct("*"):
            arg = None
        else:
            kind, text = self.peek()
            if kind != "word" or not (
                _COLUMN_RE.match(text) or text == "prediction"
            ):
                self.fail(f"a column, prediction, or * inside {func}(...)")
            self.advance()
            arg = text
        self.expect_punct(")")
        return Aggregate(func=func, arg=arg)

    def _source(self):
        """``dana.<udf>('t')`` or ``dana.predict('udf', 't')``
        -> (udf, table, is_predict)."""
        kind, text = self.peek()
        if kind != "word" or text.lower() != "dana":
            self.fail("a dana.<udf>(...) table source after FROM")
        self.advance()
        self.expect_punct(".")
        fn = self.expect_word("a UDF name after dana.")
        self.expect_punct("(")
        args: list[str] = []
        if self.peek()[0] == "str":
            args.append(self.advance()[1])
            while self.accept_punct(","):
                if self.peek()[0] != "str":
                    self.fail("a quoted name")
                args.append(self.advance()[1])
        self.expect_punct(")")
        if fn.lower() == "predict":
            if len(args) != 2:
                raise ValueError(
                    f"dana.predict takes ('udf', 'table') — two arguments: "
                    f"{self.sql!r}"
                )
            return args[0], args[1], True
        if len(args) != 1:
            raise ValueError(
                f"dana.{fn} takes one argument — the training table: "
                f"{self.sql!r}"
            )
        return fn, args[0], False

    # WHERE expression grammar: OR < AND < NOT < (comparison | parens)
    def _or_expr(self):
        node = self._and_expr()
        children = [node]
        while self.accept_keyword("OR"):
            children.append(self._and_expr())
        return children[0] if len(children) == 1 else Or(tuple(children))

    def _and_expr(self):
        node = self._not_expr()
        children = [node]
        while self.accept_keyword("AND"):
            children.append(self._not_expr())
        return children[0] if len(children) == 1 else And(tuple(children))

    def _not_expr(self):
        if self.accept_keyword("NOT"):
            return Not(self._not_expr())
        if self.accept_punct("("):
            node = self._or_expr()
            self.expect_punct(")")
            return node
        return self._comparison()

    def _comparison(self) -> Predicate:
        kind, text = self.peek()
        if kind != "word" or text.upper() in _KEYWORDS:
            self.fail("a WHERE comparison (column <op> literal)")
        if not _COLUMN_RE.match(text):
            raise ValueError(
                f"unsupported WHERE column {text!r} (use c<i> or label): "
                f"{self.sql!r}"
            )
        self.advance()
        kind, op = self.peek()
        if kind != "op":
            self.fail("a comparison operator (< <= > >= = == != <>)")
        self.advance()
        kind, lit = self.peek()
        if kind != "num":
            self.fail("a numeric literal")
        self.advance()
        return Predicate(
            column=text.lower(), op=_OP_ALIASES.get(op, op), value=float(lit)
        )


def parse(sql: str) -> Statement:
    """SQL -> :class:`Statement`; raises ValueError (naming the offending
    token) on anything else."""
    return _Parser(sql).statement()


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
def execute(
    stmt: Statement | str,
    catalog: Catalog,
    pool: BufferPool | None = None,
    mode: str = "dana",
    *,
    max_epochs: int | None = None,
    seed: int = 0,
    pipelined: bool = True,
    chunk_pages: int | None = None,
    max_new_tokens: int = 32,
    batch_slots: int | None = None,
    into: str | None = None,
    or_replace: bool = False,
    device=None,
) -> QueryResult:
    """Run a parsed statement against the catalog, on ``device`` (``None``:
    the card).

    TRAIN resolves the UDF's compiled artifact, trains through the solver's
    pipelined executor, and writes the trained model back into the catalog
    artifact (so a later PREDICT on the same UDF scores with it). PREDICT
    streams the table's heap pages through the projected strider decode
    straight into batched model evaluation (see ``db/scoring.py``); an
    ``INSERT INTO`` statement (or ``into=``) materializes the result pages
    as a catalog table — rejecting an existing name unless ``OR REPLACE``
    (or ``or_replace=True``). A PREDICT on an LM UDF generates
    ``max_new_tokens`` tokens a kept prompt on ``batch_slots`` server slots.
    A shared ``pool`` gives mixed train+score workloads one BufferPool.
    """
    device = resolve_device(device)
    if isinstance(stmt, str):
        stmt = parse(stmt)
    if stmt.verb == "TRAIN":
        artifact = catalog.udf(stmt.udf)
        heap = HeapFile(catalog.table(stmt.table)["heap"])
        res = solver.train(
            artifact["hdfg"],
            artifact["partition"],
            heap,
            pool=pool,
            mode=mode,
            max_epochs=max_epochs,
            seed=seed,
            pipelined=pipelined,
            device=device,
        )
        return _train_result(catalog, stmt, heap, artifact, res)
    from repro_torch.db import scoring

    return scoring.execute_predict(
        stmt,
        catalog,
        pool=pool,
        chunk_pages=chunk_pages,
        max_new_tokens=max_new_tokens,
        batch_slots=batch_slots,
        into=stmt.insert_into if stmt.insert_into is not None else into,
        or_replace=stmt.or_replace or or_replace,
        device=device,
    )


def _train_result(catalog, stmt, heap, artifact, res) -> QueryResult:
    """Write a TRAIN's model back into the catalog artifact and wrap the
    TrainResult (shared by ``execute`` and the concurrent executor)."""
    artifact["model"] = res.models
    catalog.register_udf(stmt.udf, artifact)
    return QueryResult(
        verb="TRAIN",
        udf=stmt.udf,
        table=stmt.table,
        schema=("model",),
        n_rows=heap.n_tuples,
        rows_scanned=heap.n_tuples,
        coefficients=res.models,
        total_s=res.total_s,
        exposed_io_s=res.exposed_io_s,
        overlapped_io_s=res.overlapped_io_s,
        compute_s=res.compute_s,
        device_syncs=res.device_syncs,
        train=res,
    )


def register_udf_from_trace(catalog: Catalog, name: str, fn, layout=None) -> dict:
    """Compile a DSL UDF end to end and store the artifact in the catalog:
    hDFG, partition, strider program, design point, and the page layout it
    was compiled for — what the paper keeps in the RDBMS catalog for the
    query executor.

    ``layout=None`` registers a train-only artifact (no strider program /
    design point); a later PREDICT on it fails with a clear "registered
    without a page layout" error instead of a KeyError deep in the executor.
    """
    from repro_torch.core import hwgen
    from repro_torch.core.striders import compile_strider_program
    from repro_torch.core.translator import trace

    g, part = trace(fn)
    artifact = {"hdfg": g, "partition": part}
    if layout is not None:
        artifact["layout"] = layout
        artifact["strider_program"] = compile_strider_program(layout)
        artifact["design_point"] = hwgen.explore(
            g, part, layout, n_tuples=layout.tuples_per_page
        )
    catalog.register_udf(name, artifact)
    return artifact


def set_udf_model(catalog: Catalog, name: str, models) -> dict:
    """Store trained coefficients (``TrainResult.models``, or a ``repro``
    UDF artifact's ``model``) in UDF ``name``'s artifact, as f32 numpy
    arrays, so that a PREDICT scores with exactly those numbers."""
    artifact = catalog.udf(name)
    artifact["model"] = [np.array(m, dtype=np.float32) for m in models]
    catalog.register_udf(name, artifact)
    return artifact


def register_lm_udf(catalog: Catalog, name: str, cfg, params) -> dict:
    """Register a language model as a scoring UDF: PREDICT on a token table
    decodes prompts through the strider path and generates via a short-lived
    BatchedServer session. The parameter tree goes to a weights file beside
    the catalog's index (``Catalog.save_weights``, replaced on
    re-registration); the pickled artifact holds only its
    :class:`~repro_torch.db.catalog.WeightsFile`."""
    artifact = {
        "kind": "lm",
        "cfg": cfg,
        "params": catalog.save_weights(name, params),
    }
    catalog.register_udf(name, artifact)
    return artifact
