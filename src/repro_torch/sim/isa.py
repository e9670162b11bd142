"""lockVM ISA — micro-op programs for lock algorithms.

Lock algorithms (ticket, TWA, MCS, ...) are expressed as tiny register
programs over a flat shared memory; the engine (engine.py, or the CUDA
kernel in ``csrc/lockvm.cu``) executes one micro-op per event under a
MESI-style cost model.  The opcode, register and layout constants below
are also compiled into that kernel (see ``repro_torch._build``).  Spin loops use fused
SPIN_* ops: the thread sleeps and is woken by any committed write to the
watched address (it then pays the refill miss and re-evaluates) — this is
both faithful (every waiter re-fetches after every invalidation) and keeps
the event count per handover at O(#sharers) instead of O(poll rate).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# --- opcodes ---------------------------------------------------------------
NOP = 0
LOAD = 1      # regs[a] <- mem[regs[b]+imm]
STORE = 2     # mem[regs[a]+imm] <- regs[b]          (delayed visibility)
STOREI = 3    # mem[regs[a]+imm] <- b                (delayed visibility)
FADD = 4      # regs[a] <- old; mem[regs[b]+imm] += c          (atomic)
SWAP = 5      # regs[a] <- old; mem[regs[b]+imm] <- regs[c]    (atomic)
CASZ = 6      # regs[a] <- old; if old==regs[c]: mem[regs[b]+imm] <- 0
ADDI = 7      # regs[a] <- regs[b] + imm
MOVI = 8      # regs[a] <- imm
MOV = 9       # regs[a] <- regs[b]
SUB = 10      # regs[a] <- regs[b] - regs[c]
MULI = 11     # regs[a] <- regs[b] * imm
ANDI = 12     # regs[a] <- regs[b] & imm
HASH = 13     # regs[a] <- wa_base + ((regs[b]*127 ^ regs[c]) & wa_mask)
HASHP = 14    # regs[a] <- wa_base + regs[c]*wa_size + ((regs[b]*127) & wa_mask)
BEQ = 15      # if regs[a]==regs[b]: pc=imm
BNE = 16
BLE = 17      # if regs[a]<=regs[b]: pc=imm
BGT = 18
BEQI = 19     # if regs[a]==c: pc=imm
BNEI = 20
BLEI = 21     # if regs[a]<=c: pc=imm
BGTI = 22
JMP = 23      # pc=imm
WORKI = 24    # local work, cost=imm
WORKR = 25    # local work, cost=max(regs[a],0)
PRNG = 26     # regs[a] <- lcg() % imm
SPIN_EQ = 27  # proceed when mem[regs[b]+imm]==regs[a]; else sleep-on-line
SPIN_NE = 28  # proceed when mem[regs[b]+imm]!=regs[a]
SPIN_EQI = 29 # proceed when mem[regs[b]+imm]==c
SPIN_NEI = 30 # proceed when mem[regs[b]+imm]!=c
ACQ = 31      # lock acquired; a=lockidx reg, c=1 if this acquisition waited
REL = 32      # about to hand over; b=lockidx reg (timestamps handover)
HALT = 33
SPIN_GE = 34  # proceed when mem[regs[b]+imm] - regs[a] >= 0 in int32 wrap
#               arithmetic (semaphore/frontier compare; a direct >= would
#               deadlock when tickets wrap past INT32_MAX)
TSTART = 35   # mark acquisition start: the NEXT executed ACQ on this thread
#               records (now - mark) into the log2 acquire-latency histogram
#               and clears the mark; an ACQ with no mark records nothing

N_OPS = 36


class OpInfo(NamedTuple):
    """Static metadata for one opcode — the single source of truth for
    operand roles (the reference package's random-program generator and
    NumPy oracle read the same table).

    Operand roles (one per instruction field):
      * ``rdst``  — register written by the op
      * ``rsrc``  — register read by the op
      * ``raddr`` — register read as a memory-address base (``+ imm`` offset)
      * ``lidx``  — register read as a lock-table index (must be in range)
      * ``const`` — the field is used as a raw constant, not a register index
      * ``""``    — the field is ignored
    ``imm`` roles: ``"off"`` (address offset), ``"val"`` (ALU constant),
    ``"target"`` (branch target pc), ``"cost"`` (work cycles), ``"mod"``
    (PRNG modulus), ``""`` (ignored).
    """

    name: str
    a: str = ""
    b: str = ""
    c: str = ""
    imm: str = ""
    kind: str = "alu"  # alu | mem | rmw | branch | work | spin | lock | halt


OPCODES: dict[int, OpInfo] = {
    NOP: OpInfo("NOP"),
    LOAD: OpInfo("LOAD", a="rdst", b="raddr", imm="off", kind="mem"),
    STORE: OpInfo("STORE", a="raddr", b="rsrc", imm="off", kind="mem"),
    STOREI: OpInfo("STOREI", a="raddr", b="const", imm="off", kind="mem"),
    FADD: OpInfo("FADD", a="rdst", b="raddr", c="const", imm="off", kind="rmw"),
    SWAP: OpInfo("SWAP", a="rdst", b="raddr", c="rsrc", imm="off", kind="rmw"),
    CASZ: OpInfo("CASZ", a="rdst", b="raddr", c="rsrc", imm="off", kind="rmw"),
    ADDI: OpInfo("ADDI", a="rdst", b="rsrc", imm="val"),
    MOVI: OpInfo("MOVI", a="rdst", imm="val"),
    MOV: OpInfo("MOV", a="rdst", b="rsrc"),
    SUB: OpInfo("SUB", a="rdst", b="rsrc", c="rsrc"),
    MULI: OpInfo("MULI", a="rdst", b="rsrc", imm="val"),
    ANDI: OpInfo("ANDI", a="rdst", b="rsrc", imm="val"),
    HASH: OpInfo("HASH", a="rdst", b="rsrc", c="rsrc"),
    HASHP: OpInfo("HASHP", a="rdst", b="rsrc", c="rsrc"),
    BEQ: OpInfo("BEQ", a="rsrc", b="rsrc", imm="target", kind="branch"),
    BNE: OpInfo("BNE", a="rsrc", b="rsrc", imm="target", kind="branch"),
    BLE: OpInfo("BLE", a="rsrc", b="rsrc", imm="target", kind="branch"),
    BGT: OpInfo("BGT", a="rsrc", b="rsrc", imm="target", kind="branch"),
    BEQI: OpInfo("BEQI", a="rsrc", c="const", imm="target", kind="branch"),
    BNEI: OpInfo("BNEI", a="rsrc", c="const", imm="target", kind="branch"),
    BLEI: OpInfo("BLEI", a="rsrc", c="const", imm="target", kind="branch"),
    BGTI: OpInfo("BGTI", a="rsrc", c="const", imm="target", kind="branch"),
    JMP: OpInfo("JMP", imm="target", kind="branch"),
    WORKI: OpInfo("WORKI", imm="cost", kind="work"),
    WORKR: OpInfo("WORKR", a="rsrc", kind="work"),
    PRNG: OpInfo("PRNG", a="rdst", imm="mod"),
    SPIN_EQ: OpInfo("SPIN_EQ", a="rsrc", b="raddr", imm="off", kind="spin"),
    SPIN_NE: OpInfo("SPIN_NE", a="rsrc", b="raddr", imm="off", kind="spin"),
    SPIN_EQI: OpInfo("SPIN_EQI", b="raddr", c="const", imm="off", kind="spin"),
    SPIN_NEI: OpInfo("SPIN_NEI", b="raddr", c="const", imm="off", kind="spin"),
    SPIN_GE: OpInfo("SPIN_GE", a="rsrc", b="raddr", imm="off", kind="spin"),
    ACQ: OpInfo("ACQ", a="lidx", c="const", kind="lock"),
    REL: OpInfo("REL", b="lidx", kind="lock"),
    HALT: OpInfo("HALT", kind="halt"),
    TSTART: OpInfo("TSTART", kind="lock"),
}
assert len(OPCODES) == N_OPS and sorted(OPCODES) == list(range(N_OPS))

OP_NAMES = {op: info.name for op, info in OPCODES.items()}


def disasm(program: np.ndarray) -> list[str]:
    """Human-readable listing of a packed ``(n, 5)`` program (debug aid)."""
    out = []
    for i, (op, a, b, c, imm) in enumerate(np.asarray(program)):
        info = OPCODES[int(op)]
        fields = []
        for role, val in ((info.a, a), (info.b, b), (info.c, c)):
            if role:
                fields.append(f"{'r' if role != 'const' else '#'}{int(val)}")
        if info.imm:
            fields.append(f"{info.imm}={int(imm)}")
        out.append(f"{i:3d}: {info.name:<9s} " + " ".join(fields))
    return out


# --- registers ---------------------------------------------------------------
R_TID, R_NODE, R_LOCK, R_LIDX = 0, 1, 2, 3
R_TX, R_G, R_DX, R_AT = 4, 5, 6, 7
R_U, R_V, R_K, R_W = 8, 9, 10, 11
R_T1, R_T2, R_NX, R_Z = 12, 13, 14, 15
N_REGS = 16

# --- memory layout (word = 8 modeled bytes; 16 words = one 128B sector) ------
WORDS_PER_SECTOR = 16
LINE_SHIFT = 4  # addr >> 4 = sector/line index

# per-lock region (sector-aligned fields, matching the paper's sequestering)
OFF_TICKET = 0
OFF_GRANT = 16
OFF_LGRANT = 32      # TKT-Dual long-term grant (own sector)
OFF_TAIL = 48        # MCS tail pointer
OFF_PGRANTS = 64     # partitioned ticket: 16 grant slots, one per sector
OFF_RD = OFF_PGRANTS  # twa-rw reader count (one algorithm per program, so
#                       the pgrant sector is free — same trick as the CLH
#                       sentinel)
LOCK_STRIDE = 64 + 16 * WORDS_PER_SECTOR  # 320 words = 20 sectors

MCS_FLAG = 0         # queue-node: flag sector ...
MCS_NEXT = 16        # ... next-pointer sector
MCS_NODE_STRIDE = 32

# The per-thread node sector doubles as the queue cell for MCS/CLH/Hemlock
# (word 0 = flag / CLH "locked" / Hemlock grant) and, for the TWA family under
# ``Layout.count_collisions``, as private wakeup counters (the TWA programs
# never touch their node otherwise):
CC_WAKES = 0         # long-term wakeups observed (slot changed under me)
CC_FUTILE = 1        # ... that left me still > threshold from the grant
#                      (a colliding notify meant for another ticket, paper §3)


class Asm:
    """Tiny assembler with labels."""

    def __init__(self) -> None:
        self.rows: list[list] = []
        self.labels: dict[str, int] = {}
        self.fixups: list[tuple[int, str]] = []

    def label(self, name: str) -> None:
        self.labels[name] = len(self.rows)

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0, imm=0) -> None:
        if isinstance(imm, str):  # label reference
            self.fixups.append((len(self.rows), imm))
            imm = -1
        self.rows.append([op, a, b, c, imm])

    def finish(self, pad_to: int = 0) -> np.ndarray:
        for row, name in self.fixups:
            self.rows[row][4] = self.labels[name]
        prog = np.asarray(self.rows, dtype=np.int32)
        if pad_to and len(prog) < pad_to:
            pad = np.zeros((pad_to - len(prog), 5), dtype=np.int32)
            pad[:, 0] = HALT
            prog = np.concatenate([prog, pad], axis=0)
        return prog
