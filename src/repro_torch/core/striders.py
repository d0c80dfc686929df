"""Strider program compiler: PageLayout -> assembled Strider ISA program.

This is the compiler half of the paper's access engine: 'The compiler converts
the database page configuration into a set of Strider instructions that
process the page and tuple headers and transform user data into a floating
point format.' The generated program is stored in the catalog and (a) executed
by the ISA interpreter as the bit-level oracle, (b) its derived static
geometry parameterizes the Pallas strider kernel.

Projection/filter pushdown (scoring queries): a :class:`ProjectionPlan`
restricts the program's tuple-extraction phase to the payload words a query
actually needs — the loop body emits one ``writeB`` per contiguous selected
word run instead of streaming the whole payload, so dropped columns are never
read out of the page buffer. The plan is the single source of truth for both
the ISA program and the Pallas/jnp decode kernels, and its static byte
accounting (``bytes_per_tuple`` vs ``bytes_per_tuple_full``) is what scoring
queries report as pushdown bookkeeping.

Copy of ``repro.core.striders``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import isa
from repro_torch.db.page import HEADER_BYTES, PageLayout, TUPLE_HEADER_BYTES


@dataclasses.dataclass(frozen=True)
class ProjectionPlan:
    """Static pushdown geometry for one table layout: which payload words a
    query's Strider actually decodes.

    ``columns`` are the (sorted, unique) feature columns the query needs —
    the union of the model's input columns, the SELECT projection, and the
    WHERE filter column. Decoded feature tensors come back in this column
    order. ``words`` are the payload words (4-byte units from the payload
    start) covering those columns; ``runs`` are the merged contiguous byte
    ranges relative to the tuple start (header skipped) that the ISA program
    streams — one ``writeB`` each.
    """

    layout: PageLayout
    columns: tuple[int, ...]
    include_label: bool
    words: tuple[int, ...]
    runs: tuple[tuple[int, int], ...]

    @property
    def n_columns(self) -> int:
        return len(self.columns)

    @property
    def bytes_per_tuple(self) -> int:
        """Payload + label bytes the projected Strider streams per tuple."""
        return sum(nb for _, nb in self.runs)

    @property
    def bytes_per_tuple_full(self) -> int:
        """What a full decode of the same layout streams per tuple."""
        return self.layout.payload_bytes + 4

    def row_byte_offset(self, tuple_off: int) -> int:
        """Position of tuple byte ``tuple_off`` within the streamed row."""
        pos = 0
        for off, nb in self.runs:
            if off <= tuple_off < off + nb:
                return pos + (tuple_off - off)
            pos += nb
        raise ValueError(f"tuple byte {tuple_off} is not in the projection")

    def column_positions(self) -> list[int]:
        """Index of each selected column's word within the decoded word set
        (f32 layouts) — identity when every selected word is a column word."""
        return [self.words.index(self._col_word(c)) for c in self.columns]

    def column_byte_positions(self) -> list[int]:
        """Quantized layouts: byte index of each column within the decoded
        word set after byte-splitting (word_pos * 4 + byte-in-word)."""
        return [
            self.words.index(c // 4) * 4 + (c % 4) for c in self.columns
        ]

    def _col_word(self, col: int) -> int:
        return col // 4 if self.layout.quantized else col


def projection_plan(
    layout: PageLayout, columns, include_label: bool = True
) -> ProjectionPlan:
    """Build the pushdown plan for ``columns`` (feature indices) of ``layout``.

    Columns are deduplicated and sorted — decoded tensors and result schemas
    come back in table order. The label word is appended as a final run when
    ``include_label``; adjacent selected words merge into single ``writeB``
    runs.
    """
    cols = sorted(set(int(c) for c in columns))
    if not cols and not include_label:
        raise ValueError("projection selects no columns and no label")
    for c in cols:
        if not 0 <= c < layout.n_features:
            raise ValueError(
                f"projected column {c} out of range for a "
                f"{layout.n_features}-feature layout"
            )
    if layout.quantized:
        words = sorted({c // 4 for c in cols})
    else:
        words = cols
    # byte runs relative to the tuple start (header included in the offset)
    offs = [TUPLE_HEADER_BYTES + 4 * w for w in words]
    if include_label:
        offs.append(TUPLE_HEADER_BYTES + layout.payload_bytes)
    runs: list[tuple[int, int]] = []
    for off in offs:
        if runs and runs[-1][0] + runs[-1][1] == off:
            runs[-1] = (runs[-1][0], runs[-1][1] + 4)
        else:
            runs.append((off, 4))
    return ProjectionPlan(
        layout=layout,
        columns=tuple(cols),
        include_label=include_label,
        words=tuple(words),
        runs=tuple(runs),
    )


def full_plan(layout: PageLayout) -> ProjectionPlan:
    """The no-pushdown plan: every column + label, one contiguous run —
    byte-identical FIFO output to the classic full-decode program."""
    return projection_plan(layout, range(layout.n_features), include_label=True)


# spare registers the compiler may burn on run offset/length constants that
# do not fit a 5-bit immediate (cr0-8 and t0-t3 are reserved by the walk)
_CONST_REG_POOL = tuple(f"%cr{i}" for i in range(9, 16)) + tuple(
    f"%t{i}" for i in range(4, 16)
)


def _program_parts(
    layout: PageLayout, plan: ProjectionPlan | None
) -> tuple[list[tuple], list[tuple]]:
    """(prefix, loop_body) instruction lists shared by the assembler and the
    static cycle model. ``plan=None`` emits the classic full-payload walk."""
    prefix: list[tuple] = []
    # -- page header processing (paper's first phase) -------------------------
    prefix += [
        ("readB", 16, 4, "%cr0"),  # n_tuples   (header word 4)
        ("readB", 12, 4, "%cr1"),  # upper      (header word 3)
        ("readB", 20, 4, "%cr2"),  # special    (header word 5)
    ]
    # -- tuple pointer processing: only the first line pointer (paper §5.1.2:
    #    'all the training data tuples are expected to be identical') ----------
    prefix += isa.load_imm("%cr8", HEADER_BYTES)
    prefix += [
        ("readB", "%cr8", 4, "%t0"),  # line pointer 0
        ("extrB", "%t0", 2, "%cr3"),  # slot 0 offset (MAXALIGN units)
        ("mul", "%cr3", 8, "%cr3"),  # -> bytes
        ("cln", "%t0", 16, "%cr4"),  # allocated length (units)
        ("mul", "%cr4", 8, "%cr4"),  # -> bytes (== stride)
    ]
    # -- static constants derived from the catalog's schema -------------------
    prefix += isa.load_imm("%cr5", layout.stride)

    body: list[tuple] = []
    if plan is None:
        prefix += isa.load_imm("%cr6", TUPLE_HEADER_BYTES)
        prefix += isa.load_imm("%cr7", layout.payload_bytes + 4)
        body += [
            ("ad", "%t1", "%cr6", "%t3"),  # skip tuple header
            ("writeB", "%t3", "%cr7", 0),  # stream payload + label to FIFO
        ]
    else:
        # projected walk: one writeB per selected word run; offsets/lengths
        # that fit a 5-bit immediate cost nothing, larger constants are
        # preloaded into the spare register pool (dedup'd by value)
        const_regs: dict[int, str] = {}

        def field(value: int):
            if 0 <= value < 32:
                return value
            reg = const_regs.get(value)
            if reg is None:
                if len(const_regs) >= len(_CONST_REG_POOL):
                    raise ValueError(
                        f"projection needs {len(const_regs) + 1} large "
                        f"constants but the Strider register file has "
                        f"{len(_CONST_REG_POOL)} spare registers; decode "
                        f"fully or widen the projection runs"
                    )
                reg = const_regs[value] = _CONST_REG_POOL[len(const_regs)]
            return reg

        for off, nb in plan.runs:
            body += [
                ("ad", "%t1", field(off), "%t3"),
                ("writeB", "%t3", field(nb), 0),
            ]
        for value, reg in const_regs.items():
            prefix += isa.load_imm(reg, value)
    # -- tuple extraction loop (downward packing: descend by stride) ----------
    prefix += [
        ("ad", "%cr3", 0, "%t1"),  # cursor = slot 0 offset
        ("ins", "%t2", 0, 0),  # count = 0
    ]
    body += [
        ("sub", "%t1", "%cr5", "%t1"),  # next tuple (lower address)
        ("ad", "%t2", 1, "%t2"),
    ]
    return prefix, body


def compile_strider_program(
    layout: PageLayout, plan: ProjectionPlan | None = None
) -> np.ndarray:
    """Emit the page-walk program for one page of ``layout``.

    Register map:
      %cr0 n_tuples   %cr1 upper       %cr2 special     %cr3 slot0 offset
      %cr4 tuple_len  %cr5 stride      %cr6 hdr bytes   %cr7 payload+label bytes
      %cr8 line-ptr base address       %cr9+/%t4+ projection constants
      %t0 scratch     %t1 cursor       %t2 count        %t3 payload addr

    ``plan`` restricts the extraction loop to the projected word runs
    (pushdown); ``None`` streams the whole payload + label per tuple.
    """
    prefix, body = _program_parts(layout, plan)
    prog = prefix + [("bentr",)] + body + [("bexit", 0, "%t2", "%cr0")]
    return isa.assemble(prog)


def run_strider(
    program: np.ndarray,
    page_words: np.ndarray,
    layout: PageLayout,
    plan: ProjectionPlan | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Interpret ``program`` over one page -> (features, labels, cycles).

    The FIFO holds n_tuples x (payload + label) raw bytes — or, with a
    projection ``plan``, n_tuples x ``plan.bytes_per_tuple`` — and the
    post-stage converts to float32 (dequantizing int8 payloads with the scale
    stored in the page's special space) — the ISA's 'transform user data into
    a floating point format' step. With a plan, only the projected columns
    come back (in ``plan.columns`` order); the label is zeros unless
    ``plan.include_label``.
    """
    interp = isa.StriderInterpreter(program)
    page_bytes = np.asarray(page_words, dtype=np.uint32).view(np.uint8)
    st = interp.run(page_bytes)
    width = plan.bytes_per_tuple if plan is not None else layout.payload_bytes + 4
    raw = np.asarray(st.fifo, dtype=np.uint8)
    if raw.size % width:
        raise ValueError("FIFO is not a whole number of tuples")
    raw = raw.reshape(-1, width)
    n = raw.shape[0]

    if layout.quantized:
        hdr_special = int(np.asarray(page_words).reshape(-1)[5])  # header word 5
        scale = page_bytes[hdr_special : hdr_special + 4].view(np.float32)[0]

    if plan is None:
        labels = raw[:, layout.payload_bytes :].copy().view(np.float32).reshape(-1)
        if layout.quantized:
            q = raw[:, : layout.n_features].astype(np.int32) - 128
            feats = q.astype(np.float32) * scale
        else:
            feats = (
                raw[:, : layout.payload_bytes].copy().view(np.float32)
                [:, : layout.n_features]
            )
        return feats, labels, st.cycles

    if plan.include_label:
        lp = plan.row_byte_offset(TUPLE_HEADER_BYTES + layout.payload_bytes)
        labels = raw[:, lp : lp + 4].copy().view(np.float32).reshape(-1)
    else:
        labels = np.zeros(n, dtype=np.float32)
    if layout.quantized:
        pos = [
            plan.row_byte_offset(TUPLE_HEADER_BYTES + c) for c in plan.columns
        ]
        q = raw[:, pos].astype(np.int32) - 128
        feats = q.astype(np.float32) * scale
    else:
        pos = [
            plan.row_byte_offset(TUPLE_HEADER_BYTES + 4 * c)
            for c in plan.columns
        ]
        idx = np.array(pos)[:, None] + np.arange(4)[None, :]
        feats = (
            np.ascontiguousarray(raw[:, idx])
            .view(np.float32)
            .reshape(n, len(plan.columns))
        )
    return feats, labels, st.cycles


def strider_cycles_per_page(
    layout: PageLayout, plan: ProjectionPlan | None = None
) -> int:
    """Static cycle estimate for the access engine (hwgen's model): header +
    per-tuple loop body. Matches the interpreter's count for full pages —
    for the classic program and for projected (pushdown) programs alike."""
    prefix, body = _program_parts(layout, plan)
    # prefix + bentr + tuples x (body + bexit)
    return len(prefix) + 1 + layout.tuples_per_page * (len(body) + 1)
