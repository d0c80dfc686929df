"""Strider ISA (paper §5.1.2, Table 2): assembler, 22-bit encoder, interpreter.

Instruction word (22 bits)::

    [21:18] opcode   [17:12] field a   [11:6] field b   [5:0] field c

Each 6-bit field is either a small immediate (0..31) or a register reference
(bit 5 set; regs 0-15 = configuration registers %cr0-15, regs 16-31 = temporary
registers %t0-15). Large constants are built in registers with ``ins`` (insert
bits at an offset), exactly the paper's stated use of Insert for adding
auxiliary bits. Byte addresses therefore always flow through registers, which
matches the paper's examples (``readB %cr, 4, %treg``).

Opcodes (Table 2): 0 readB, 1 extrB, 2 writeB, 3 extrBi, 4 cln, 5 ins,
6 ad, 7 sub, 8 mul, 9 bentr, 10 bexit.

Semantics implemented by the interpreter (the oracle the Pallas strider kernel
is validated against):

  readB  a=addr(reg/imm) b=nbytes    c=dst     dst <- LE uint from page[addr:addr+n]
  extrB  a=src           b=byte off  c=dst     dst <- (src >> 8b) & 0xFFFF
  writeB a=addr(reg)     b=nbytes    c=fifo    page[addr:addr+n] -> output FIFO c
  extrBi a=src           b=bit off   c=dst     dst <- (src >> b) & 1
  cln    a=src           b=#bits     c=dst     dst <- src & ((1<<b)-1)
  ins    a=dst           b=value     c=offset  dst <- dst | (value << offset)
  ad     a, b -> c                             c <- a + b
  sub    a, b -> c                             c <- a - b
  mul    a, b -> c                             c <- a * b
  bentr                                        push loop entry
  bexit  a=cond  b, c                          cond(b,c) ? fall through : jump to entry
           cond 0: b >= c     cond 1: b <= c    cond 2: b == c

``writeB`` with a register byte count streams a whole tuple payload per loop
iteration — one instruction per tuple body, the ISA's page-walk efficiency
argument.

Copy of ``repro.core.isa``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

OPCODES = {
    "readB": 0, "extrB": 1, "writeB": 2, "extrBi": 3, "cln": 4,
    "ins": 5, "ad": 6, "sub": 7, "mul": 8, "bentr": 9, "bexit": 10,
}
OPNAMES = {v: k for k, v in OPCODES.items()}
REG_BIT = 0x20
N_CR, N_T = 16, 16


def reg(name: str) -> int:
    """%cr0..%cr15 -> 0..15, %t0..%t15 -> 16..31, tagged with REG_BIT."""
    if name.startswith("%cr"):
        idx = int(name[3:] or 0)
    elif name.startswith("%t"):
        idx = 16 + int(name[2:] or 0)
    else:
        raise ValueError(f"bad register {name}")
    return REG_BIT | idx


def _field(x) -> int:
    if isinstance(x, str):
        return reg(x)
    x = int(x)
    if not 0 <= x < 32:
        raise ValueError(f"immediate {x} out of 5-bit range; build it with ins")
    return x


def encode(op: str, a=0, b=0, c=0) -> int:
    word = (OPCODES[op] << 18) | (_field(a) << 12) | (_field(b) << 6) | _field(c)
    assert word < (1 << 22)
    return word


def decode(word: int) -> tuple[str, int, int, int]:
    return (
        OPNAMES[(word >> 18) & 0xF],
        (word >> 12) & 0x3F,
        (word >> 6) & 0x3F,
        word & 0x3F,
    )


def assemble(program: list[tuple]) -> np.ndarray:
    """[('readB', 0, 4, '%cr0'), ...] -> uint32 instruction words."""
    return np.array([encode(*insn) for insn in program], dtype=np.uint32)


def load_imm(dst: str, value: int) -> list[tuple]:
    """Emit `ins` chunks to build an arbitrary constant in a register."""
    out = [("ins", dst, value & 0x1F, 0)]
    value >>= 5
    off = 5
    while value:
        out.append(("ins", dst, value & 0x1F, off))
        value >>= 5
        off += 5
    return out


@dataclasses.dataclass
class StriderState:
    regs: np.ndarray  # 32 x uint64 (cr0-15, t0-15)
    fifo: list[int]  # output bytes
    cycles: int = 0


class StriderInterpreter:
    """Executes an assembled Strider program over one page's bytes.

    This is the bit-level oracle: tests assert the Pallas kernel's decoded
    features equal the FIFO contents of this interpreter.
    """

    MAX_CYCLES = 4_000_000

    def __init__(self, instructions: np.ndarray):
        self.instructions = [decode(int(w)) for w in np.asarray(instructions)]

    def run(self, page_bytes: np.ndarray) -> StriderState:
        page = np.asarray(page_bytes, dtype=np.uint8)
        st = StriderState(regs=np.zeros(32, dtype=np.uint64), fifo=[])
        loop_stack: list[int] = []
        pc = 0
        n = len(self.instructions)

        def val(f):
            return int(st.regs[f & 0x1F]) if f & REG_BIT else f

        while pc < n:
            st.cycles += 1
            if st.cycles > self.MAX_CYCLES:
                raise RuntimeError("strider program did not terminate")
            op, a, b, c = self.instructions[pc]
            if op == "readB":
                addr, nb = val(a), val(b)
                st.regs[c & 0x1F] = int.from_bytes(page[addr : addr + nb], "little")
            elif op == "extrB":
                st.regs[c & 0x1F] = (val(a) >> (8 * val(b))) & 0xFFFF
            elif op == "writeB":
                addr, nb = val(a), val(b)
                st.fifo.extend(page[addr : addr + nb].tolist())
            elif op == "extrBi":
                st.regs[c & 0x1F] = (val(a) >> val(b)) & 1
            elif op == "cln":
                st.regs[c & 0x1F] = val(a) & ((1 << val(b)) - 1)
            elif op == "ins":
                st.regs[a & 0x1F] = val(a) | (val(b) << val(c))
            elif op == "ad":
                st.regs[c & 0x1F] = val(a) + val(b)
            elif op == "sub":
                st.regs[c & 0x1F] = val(a) - val(b)
            elif op == "mul":
                st.regs[c & 0x1F] = val(a) * val(b)
            elif op == "bentr":
                loop_stack.append(pc)
            elif op == "bexit":
                cond, x, y = a, val(b), val(c)
                done = (
                    x >= y if cond == 0 else x <= y if cond == 1 else x == y
                )
                if done:
                    loop_stack.pop()
                else:
                    pc = loop_stack[-1]
            pc += 1
        return st
