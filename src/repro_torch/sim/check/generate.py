"""Structured random scenario generators for the differential fuzzer.

Two scenario families:

  * **random** — random-but-well-formed ISA programs.  Well-formedness is
    enforced structurally from the :data:`repro_torch.sim.isa.OPCODES` metadata
    table: branch targets stay inside the generated body, every memory
    operand is ``addr-register + small offset`` where address registers are
    init-time constants the random instructions can never overwrite (HASH
    may rewrite one, but HASH output is in the waiting array by
    construction), and the body is wrapped in a guaranteed-HALT harness (a
    protected iteration counter) so programs terminate even without the
    horizon.  SPINs watch the same shared lines the stores/RMWs hit, so
    wakeup paths are exercised rather than deadlocking immediately.

  * **composed** — every ``SIM_LOCKS`` generator wrapped in a randomized
    critical section touching shared occupancy counters
    (:func:`repro_torch.sim.programs.build_occupancy_probe`; ``twa-rw``
    uses the weighted :func:`repro_torch.sim.programs.build_rw_probe` since
    reader overlap is legal), over random lock/thread/wa_size/permits/threshold/
    reader-fraction/cost geometries, with one case in four seeding the
    ticket/grant counters near ``INT32_MAX`` to cross the int32 wrap
    mid-run.  These carry lock semantics, so the invariant layer can check
    exclusion/permit caps, conservation, ticket FIFO, liveness and
    deadlock-freedom on top of the oracle-vs-engine differential.

Every scenario in a batch is padded to the same shapes (``PAD_THREADS``,
``PAD_MEM_WORDS``, ``PAD_LOCKS``, ``PROG_LEN``) so one fuzz run costs ONE
engine dispatch per placement group, exactly like a figure sweep.  A
:class:`~repro_torch.sim.corpus.Scenario` is the corpus's own record, so a
generated case saves and replays as a corpus entry.
"""

from __future__ import annotations

import numpy as np

from .. import isa
from ..corpus import Scenario
from ..costs import Costs
from ..faults import FaultSchedule, draw_schedule
from ..isa import LOCK_STRIDE, OFF_GRANT, OFF_LGRANT, OFF_TICKET
from ..programs import (INIT_MEM_GEN, Layout, SIM_LOCKS,
                        build_mutexbench, build_occupancy_probe,
                        build_rw_probe, init_state, pad_mem, pad_program,
                        pad_threads)

# Shared padded shapes for a fuzz batch (one engine compile per mode).
PAD_THREADS = 8
PAD_LOCKS = 2
_WA_SIZES = (8, 16, 32, 64)
PAD_MEM_WORDS = max(
    Layout(n_threads=PAD_THREADS, n_locks=PAD_LOCKS, wa_size=max(_WA_SIZES),
           private_arrays=pa).mem_words for pa in (False, True))

# Ticket-family mutexes: ACQ events must observe strictly increasing R_TX
# per lock (FIFO hand-off).  twa-sem is ticket-based but admits K concurrent
# owners, so its ACQ order is only K-bounded, not strict.  twa-rw grants
# ENTRY in strict ticket order for readers and writers alike (readers then
# overlap in the CS, but their ACQs are still FIFO).  fissile-twa is
# deliberately NOT FIFO: the TAS fast path barges.
TICKET_FIFO_LOCKS = frozenset(
    {"ticket", "twa", "twa-id", "twa-staged", "tkt-dual", "partitioned",
     "anderson", "twa-rw", "twa-timo"})
# Locks whose releases advance the shared OFF_GRANT word (partitioned uses
# per-sector grant slots, anderson uses waiting-array flags instead;
# fissile-twa's inner grant is handled by its own conservation branch).
GRANT_WORD_LOCKS = frozenset(
    {"ticket", "twa", "twa-id", "twa-staged", "tkt-dual", "twa-sem",
     "twa-rw"})
# Locks whose ticket/grant words can be seeded near INT32_MAX to fuzz the
# wrap: free-running OFF_TICKET/OFF_GRANT counters with wrap-safe compares
# (partitioned/anderson derive slot indices from the raw ticket, so their
# init state is position-dependent and stays at zero).  twa-timo is
# excluded: its abandonment marker ``~tk`` relies on live tickets being
# non-negative, which a near-INT32_MAX seed breaks mid-run.
WRAP_SEED_LOCKS = (GRANT_WORD_LOCKS | {"fissile-twa"}) - {"twa-timo"}
INT32_MAX = 2**31 - 1


# The padded shapes every scenario of a fuzz batch carries.
PADDED_SHAPES = dict(n_threads=PAD_THREADS, mem_words=PAD_MEM_WORDS,
                     n_locks=PAD_LOCKS)


def scenario_faults(scenario) -> FaultSchedule | None:
    """The scenario's fault schedule (``meta["faults"]``), or ``None``.

    Schedules ride in ``meta`` as JSON-serializable row lists, so they
    survive the ``.npz`` corpus round-trip unchanged.
    """
    return scenario.faults()


def gen_costs(rng: np.random.Generator) -> np.ndarray:
    """Random-but-plausible coherence costs (C_LOCAL >= 1 so time advances)."""
    return Costs(
        C_LOCAL=int(rng.integers(1, 4)),
        C_HIT=int(rng.integers(1, 5)),
        C_MISS=int(rng.integers(20, 81)),
        C_XFER=int(rng.integers(30, 121)),
        C_STORE_OWNED=int(rng.integers(1, 7)),
        C_STORE_SHARED=int(rng.integers(5, 31)),
        C_INV=int(rng.integers(0, 25)),
        C_ATOMIC=int(rng.integers(0, 41)),
        C_WAKE=int(rng.integers(1, 9)),
    ).to_array()


def gen_geometry(rng: np.random.Generator, lock: str | None = None) -> dict:
    """Random lock/thread/wa_size/permits/cost geometry within pad limits."""
    n_threads = int(rng.integers(2, PAD_THREADS + 1))
    n_locks = int(rng.integers(1, PAD_LOCKS + 1))
    private_arrays = bool(rng.integers(0, 2))
    if lock == "anderson" and n_locks > 1:
        private_arrays = True  # cross-lock aliasing on bool flags is unsound
    # one case in four starts its ticket/grant counters a few draws below
    # INT32_MAX, so the run wraps them mid-flight (only consumed for
    # WRAP_SEED_LOCKS)
    ticket_base = (int(INT32_MAX - rng.integers(0, 12))
                   if rng.integers(0, 4) == 0 else 0)
    return dict(
        n_threads=n_threads,
        n_locks=n_locks,
        wa_size=int(rng.choice(_WA_SIZES)),
        private_arrays=private_arrays,
        long_term_threshold=int(rng.integers(1, 4)),
        sem_permits=int(rng.integers(1, n_threads + 1)),
        reader_fraction=int(rng.choice((0, 10, 30, 50, 70, 90, 100))),
        timo_patience=int(rng.integers(1, 49)),
        ticket_base=ticket_base,
        horizon=int(rng.integers(1_500, 4_000)),
        max_events=6_000,
        seed=int(rng.integers(1, 2**31 - 1)),
        costs=gen_costs(rng),
    )


# ---------------------------------------------------------------------------
# Random ISA programs
# ---------------------------------------------------------------------------

# Register partition for random programs.  Address registers are written
# only at init (or by HASH, whose output is a valid waiting-array address);
# random instructions may only write DATA_REGS.
ADDR_REGS = (isa.R_LOCK, isa.R_NODE, isa.R_AT)
DATA_REGS = (isa.R_TX, isa.R_G, isa.R_DX, isa.R_U, isa.R_V, isa.R_K,
             isa.R_W, isa.R_T1, isa.R_T2)
# R_LIDX stays 0 (valid lock index for ACQ/REL); R_NX is the harness
# iteration counter; R_Z stays 0 by convention.
_CTR = isa.R_NX

# Opcode pool with sampling weights: memory traffic and branches dominate,
# spins are present but rare enough that full-batch deadlocks stay uncommon.
_POOL = (
    (isa.LOAD, 10), (isa.STORE, 9), (isa.STOREI, 5),
    (isa.FADD, 8), (isa.SWAP, 3), (isa.CASZ, 3),
    (isa.ADDI, 6), (isa.MOVI, 4), (isa.MOV, 3), (isa.SUB, 3),
    (isa.MULI, 2), (isa.ANDI, 2), (isa.HASH, 3),
    (isa.BEQ, 2), (isa.BNE, 2), (isa.BLE, 2), (isa.BGT, 2),
    (isa.BEQI, 2), (isa.BNEI, 2), (isa.BLEI, 2), (isa.BGTI, 2),
    (isa.JMP, 1),
    (isa.WORKI, 3), (isa.WORKR, 2), (isa.PRNG, 3),
    (isa.SPIN_EQ, 1), (isa.SPIN_NE, 2), (isa.SPIN_EQI, 1),
    (isa.SPIN_NEI, 2), (isa.SPIN_GE, 1),
    (isa.ACQ, 2), (isa.REL, 2),
    (isa.NOP, 1), (isa.HALT, 1),
)
_POOL_OPS = np.asarray([op for op, _ in _POOL])
_POOL_P = np.asarray([w for _, w in _POOL], np.float64)
_POOL_P /= _POOL_P.sum()


def _rand_mem_operand(rng: np.random.Generator) -> tuple[int, int]:
    """(addr_reg, imm) pairs guaranteed in-bounds.

    R_LOCK-based offsets hit the first three lock sectors (shared, contended
    — this is where SPINs get their wakeups), R_NODE the thread's own node
    sector (private), R_AT offset 0 (R_AT always holds a waiting-array
    address: wa_base initially, HASH output afterwards).
    """
    base = int(rng.choice((isa.R_LOCK, isa.R_LOCK, isa.R_NODE, isa.R_AT)))
    if base == isa.R_LOCK:
        return base, int(rng.integers(0, 3 * isa.WORDS_PER_SECTOR))
    if base == isa.R_NODE:
        return base, int(rng.integers(0, isa.MCS_NODE_STRIDE))
    return base, 0


def gen_random_program(rng: np.random.Generator, body_len: int = 40,
                       iters: int = 3) -> np.ndarray:
    """A well-formed random program: harness(iters) { random body }.

    Structure::

        0:            MOVI R_NX, iters
        1 .. 1+body:  random instructions (branch targets confined here)
        epilogue:     ADDI R_NX, R_NX, -1 ; BGTI R_NX, 0 -> 1 ; HALT

    Any internal loop still terminates at the horizon (every op costs >= 1
    cycle), and a body with no backward branches HALTs after ``iters``
    passes — the guaranteed-HALT property random fuzzing needs so that the
    "stalled forever" engine state is reachable only through SPINs, never
    through runaway straight-line execution.
    """
    body_lo, body_hi = 1, 1 + body_len  # branch targets live in [lo, hi)
    rows = [[isa.MOVI, _CTR, 0, 0, iters]]
    for _ in range(body_len):
        op = int(rng.choice(_POOL_OPS, p=_POOL_P))
        info = isa.OPCODES[op]
        a = b = c = imm = 0
        for field_name, role in (("a", info.a), ("b", info.b), ("c", info.c)):
            if role == "rdst":
                val = int(rng.choice(DATA_REGS))
            elif role == "rsrc":
                val = int(rng.choice(DATA_REGS + (isa.R_Z, isa.R_TID)))
            elif role == "lidx":
                val = isa.R_LIDX  # always 0, always valid
            elif role == "const":
                val = int(rng.integers(-4, 5))
            else:
                val = 0
            if field_name == "a":
                a = val
            elif field_name == "b":
                b = val
            else:
                c = val
        if info.kind in ("mem", "rmw", "spin"):
            base, imm = _rand_mem_operand(rng)
            if info.a == "raddr":
                a = base
            else:
                b = base
        elif info.imm == "target":
            imm = int(rng.integers(body_lo, body_hi))
        elif info.imm == "val":
            imm = int(rng.integers(-16, 17))
        elif info.imm == "cost":
            imm = int(rng.integers(1, 25))
        elif info.imm == "mod":
            imm = int(rng.integers(1, 17))
        if op == isa.HASH:
            a = isa.R_AT  # HASH output is a valid waiting-array address
        rows.append([op, a, b, c, imm])
    rows.append([isa.ADDI, _CTR, _CTR, 0, -1])
    rows.append([isa.BGTI, _CTR, 0, 0, body_lo])
    rows.append([isa.HALT, 0, 0, 0, 0])
    return np.asarray(rows, np.int32)


def gen_random_scenario(rng: np.random.Generator) -> Scenario:
    """A random-program cell on a minimal single-lock layout."""
    geo = gen_geometry(rng)
    layout = Layout(n_threads=geo["n_threads"], n_locks=1,
                    wa_size=geo["wa_size"])
    prog = gen_random_program(rng, body_len=int(rng.integers(12, 48)),
                              iters=int(rng.integers(1, 5)))
    pc, regs = init_state(layout)
    regs[:, isa.R_AT] = layout.wa_base  # R_AT starts as a valid wa address
    pc, regs = pad_threads(pc, regs, PAD_THREADS)
    return Scenario(
        **PADDED_SHAPES,
        kind="random", lock=None,
        program=pad_program(prog),
        init_pc=pc, init_regs=regs,
        init_mem=pad_mem(np.zeros(layout.mem_words, np.int32),
                         PAD_MEM_WORDS),
        n_active=geo["n_threads"],
        wa_base=layout.wa_base, wa_size=layout.wa_size,
        horizon=geo["horizon"], max_events=geo["max_events"],
        seed=geo["seed"], costs=geo["costs"],
        meta={"layout": {"n_threads": geo["n_threads"], "n_locks": 1,
                         "wa_size": geo["wa_size"]}},
    )


# ---------------------------------------------------------------------------
# Composed lock scenarios
# ---------------------------------------------------------------------------

def gen_composed_scenario(rng: np.random.Generator,
                          lock: str | None = None,
                          **overrides) -> Scenario:
    """A ``SIM_LOCKS`` program in a randomized occupancy-probed workload.

    ``overrides`` pin any :func:`gen_geometry` field (plus
    ``count_collisions``) — used by the corpus builder to force rare
    geometries deterministically.
    """
    if lock is None:
        lock = str(rng.choice(SIM_LOCKS))
    geo = gen_geometry(rng, lock)
    count_collisions = (lock in ("twa", "twa-sem")
                        and bool(rng.integers(0, 2)))
    if "count_collisions" in overrides:
        count_collisions = overrides.pop("count_collisions")
    unknown = set(overrides) - set(geo)
    assert not unknown, unknown
    geo.update(overrides)
    layout = Layout(n_threads=geo["n_threads"], n_locks=geo["n_locks"],
                    wa_size=geo["wa_size"],
                    private_arrays=geo["private_arrays"],
                    long_term_threshold=geo["long_term_threshold"],
                    sem_permits=geo["sem_permits"],
                    reader_fraction=geo["reader_fraction"],
                    count_collisions=count_collisions,
                    timo_patience=geo["timo_patience"])
    cs_work = int(rng.integers(0, 7))
    ncs_max = int(rng.integers(0, 33))
    rw = lock == "twa-rw"
    if lock == "tkt-dual":
        # the probe words live in the lgrant sector tkt-dual itself uses
        prog = build_mutexbench(lock, layout, cs_work=cs_work,
                                ncs_max=ncs_max)
        probed = False
    elif rw:
        # weighted reader/writer probe: overlap among readers is legal
        prog = build_rw_probe(layout, cs_work=cs_work, ncs_max=ncs_max)
        probed = True
    else:
        prog = build_occupancy_probe(lock, layout, cs_work=cs_work,
                                     ncs_max=ncs_max)
        probed = True
    pc, regs = init_state(layout)
    pc, regs = pad_threads(pc, regs, PAD_THREADS)
    gen_mem = INIT_MEM_GEN.get(lock)
    init_mem = (gen_mem(layout) if gen_mem
                else np.zeros(layout.mem_words, np.int32))
    ticket_base = geo["ticket_base"] if lock in WRAP_SEED_LOCKS else 0
    if ticket_base:
        for base in range(0, geo["n_locks"] * LOCK_STRIDE, LOCK_STRIDE):
            init_mem[base + OFF_TICKET] = ticket_base
            init_mem[base + OFF_GRANT] = ticket_base
            if lock == "tkt-dual":
                init_mem[base + OFF_LGRANT] = ticket_base
    cap = layout.sem_permits if lock == "twa-sem" else 1
    return Scenario(
        **PADDED_SHAPES,
        kind="composed", lock=lock,
        program=pad_program(prog),
        init_pc=pc, init_regs=regs,
        init_mem=pad_mem(init_mem, PAD_MEM_WORDS),
        n_active=geo["n_threads"],
        wa_base=layout.wa_base, wa_size=layout.wa_size,
        horizon=geo["horizon"], max_events=geo["max_events"],
        seed=geo["seed"], costs=geo["costs"],
        meta={
            "cap": cap, "probed": probed, "rw": rw,
            "fissile": lock == "fissile-twa",
            "count_collisions": count_collisions,
            "ticket_fifo": lock in TICKET_FIFO_LOCKS,
            "grant_word": lock in GRANT_WORD_LOCKS,
            "ticket_base": ticket_base,
            "layout": {"n_threads": geo["n_threads"],
                       "n_locks": geo["n_locks"],
                       "wa_size": geo["wa_size"],
                       "private_arrays": geo["private_arrays"],
                       "long_term_threshold": geo["long_term_threshold"],
                       "sem_permits": geo["sem_permits"],
                       "reader_fraction": geo["reader_fraction"],
                       "count_collisions": count_collisions,
                       "timo_patience": geo["timo_patience"]},
        },
    )


class _SynthTrace:
    """Duck-typed stand-in for ``repro_torch.serve.trace.LockTrace``.

    The fuzzer exercises the trace *pipeline* (quantizer → compiler)
    without importing the serve layer — sim must stay below serve in the
    dependency order.  Only the attributes ``quantize_trace`` reads.
    """

    def __init__(self, arrival_s, grant_s, release_s, n_reads, name):
        self.arrival_s = np.asarray(arrival_s, np.float64)
        self.grant_s = np.asarray(grant_s, np.float64)
        self.release_s = np.asarray(release_s, np.float64)
        self.n_reads = int(n_reads)
        self.name = name

    @property
    def hold_s(self):
        return self.release_s - self.grant_s

    @property
    def inter_acquire_s(self):
        g = np.sort(self.grant_s)
        return np.diff(g) if len(g) > 1 else np.zeros(0)

    @property
    def reader_fraction(self):
        total = self.n_reads + len(self.arrival_s)
        return int(round(100.0 * self.n_reads / total)) if total else 0


def gen_trace_scenario(rng: np.random.Generator,
                       lock: str | None = None) -> Scenario:
    """A trace-compiled workload in the fuzz pool.

    Synthesizes a small serve-like arrival/hold process, quantizes it
    through the real pipeline (:func:`repro_torch.sim.traces.quantize_trace`)
    and compiles with :func:`~repro_torch.sim.traces.build_trace_bench` —
    so the differential and the invariant catalog cover the trace path's
    table loads and arrival preamble, not just the synthetic-axes
    programs.
    Durations are drawn small (unit_s=1, holds ≤ 20 units) so every fuzz
    horizon still sees acquisitions from every thread.
    """
    from ..traces import (build_trace_bench, quantize_trace, trace_init_mem,
                          trace_layout_for)
    if lock is None:
        lock = str(rng.choice(SIM_LOCKS))
    geo = gen_geometry(rng, lock)
    geo["n_locks"] = 1   # trace programs replay a single admission lock
    n_req = int(rng.integers(8, 33))
    arrival = np.sort(rng.uniform(0.0, 40.0, n_req))
    grant = arrival + rng.uniform(0.0, 5.0, n_req)
    release = grant + rng.uniform(1.0, 20.0, n_req)
    trace = _SynthTrace(arrival, grant, release,
                        n_reads=int(rng.integers(0, n_req)),
                        name=f"fuzz-{geo['seed']}")
    tw = quantize_trace(trace, n_threads=geo["n_threads"], table_size=8,
                        max_steps=24, unit_s=1.0)
    layout = trace_layout_for(tw, Layout(
        n_threads=geo["n_threads"], n_locks=1,
        wa_size=geo["wa_size"], private_arrays=geo["private_arrays"],
        long_term_threshold=geo["long_term_threshold"],
        sem_permits=geo["sem_permits"],
        reader_fraction=geo["reader_fraction"],
        timo_patience=geo["timo_patience"]))
    assert layout.mem_words <= PAD_MEM_WORDS, layout.mem_words
    collect_latency = bool(rng.integers(0, 2))
    prog = build_trace_bench(lock, layout, tw,
                             collect_latency=collect_latency)
    pc, regs = init_state(layout)
    pc, regs = pad_threads(pc, regs, PAD_THREADS)
    init_mem = trace_init_mem(lock, layout, tw)
    return Scenario(
        **PADDED_SHAPES,
        kind="composed", lock=lock,
        program=pad_program(prog),
        init_pc=pc, init_regs=regs,
        init_mem=pad_mem(init_mem, PAD_MEM_WORDS),
        n_active=geo["n_threads"],
        wa_base=layout.wa_base, wa_size=layout.wa_size,
        horizon=geo["horizon"], max_events=geo["max_events"],
        seed=geo["seed"], costs=geo["costs"],
        meta={
            "cap": layout.sem_permits if lock == "twa-sem" else 1,
            "probed": False, "rw": lock == "twa-rw",
            "fissile": lock == "fissile-twa",
            "count_collisions": False,
            "ticket_fifo": lock in TICKET_FIFO_LOCKS,
            "grant_word": lock in GRANT_WORD_LOCKS,
            "ticket_base": 0,
            "workload": "trace",
            "trace": tw.as_meta(),
            "layout": {"n_threads": geo["n_threads"],
                       "n_locks": 1,
                       "wa_size": geo["wa_size"],
                       "private_arrays": geo["private_arrays"],
                       "long_term_threshold": geo["long_term_threshold"],
                       "sem_permits": geo["sem_permits"],
                       "reader_fraction": geo["reader_fraction"],
                       "count_collisions": False,
                       "timo_patience": geo["timo_patience"]},
        },
    )


def _harness_body_span(program: np.ndarray) -> tuple[int, int] | None:
    """``[lo, hi)`` of a random program's harness body, or ``None``.

    Recovers the :func:`gen_random_program` structure from the rows alone:
    row 0 is the counter MOVI and the epilogue is the unique
    ``ADDI R_NX, R_NX, -1`` / ``BGTI R_NX -> 1`` pair.  Anything that does
    not match (composed lock programs, hand-built cases) returns ``None``
    and is not spliced.
    """
    prog = np.asarray(program)
    if len(prog) < 4 or prog[0][0] != isa.MOVI or prog[0][1] != _CTR:
        return None
    for i in range(1, len(prog) - 2):
        if (tuple(prog[i]) == (isa.ADDI, _CTR, _CTR, 0, -1)
                and prog[i + 1][0] == isa.BGTI and prog[i + 1][1] == _CTR
                and prog[i + 1][4] == 1 and prog[i + 2][0] == isa.HALT):
            return (1, i) if i > 1 else None
    return None


def splice_programs(target: np.ndarray, donor: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray | None:
    """Copy an instruction range from ``donor``'s body into ``target``'s.

    Both programs must carry the guaranteed-HALT harness
    (:func:`_harness_body_span`); the spliced rows keep their position
    relative to the body start and every branch target among them is
    remapped into the *target* body, so the result is still well-formed:
    harness rows untouched, all control flow confined to the body, HALT
    reached after the counter runs out.  Returns ``None`` when either
    program has no recoverable harness.
    """
    tspan, dspan = _harness_body_span(target), _harness_body_span(donor)
    if tspan is None or dspan is None:
        return None
    tlo, thi = tspan
    dlo, dhi = dspan
    max_len = min(thi - tlo, dhi - dlo)
    if max_len < 1:
        return None
    n = int(rng.integers(1, max_len + 1))
    dst = tlo + int(rng.integers(0, (thi - tlo) - n + 1))
    src = dlo + int(rng.integers(0, (dhi - dlo) - n + 1))
    out = np.asarray(target).copy()
    rows = np.asarray(donor)[src:src + n].copy()
    for r in rows:
        if isa.OPCODES[int(r[0])].imm == "target":
            r[4] = tlo + (int(r[4]) - tlo) % (thi - tlo)
    out[dst:dst + n] = rows
    return out


def mutate_scenario(scenario: Scenario, rng: np.random.Generator,
                    n_mutations: int = 1,
                    pool: list | None = None) -> Scenario:
    """Coverage-steering mutation: perturb a promoted case's neighbourhood.

    The program (and with it the layout/addresses it was generated against)
    is what made the case's coverage signature novel; the mutations search
    the *neighbourhood* of that behaviour — PRNG seed, coherence costs,
    horizon, active-thread count (reduce-only, so the probed layout stays an
    upper bound for every invariant), the pinned torch-chunk/cuda-state
    placement,
    a redraw of the fault schedule when the case carries one,
    and — for ticket-family locks — re-seeding the ticket/grant counters
    just below ``INT32_MAX`` so the mutant crosses the wrap even if its
    parent did not.

    With a donor ``pool``, *random* scenarios additionally admit program
    **splicing** (:func:`splice_programs`): an instruction range from
    another random pool member's harness body replaces part of this one's,
    branch targets fixed up, guaranteed-HALT preserved — the one mutation
    that makes new control-flow shapes reachable without a uniform redraw.
    Composed lock programs are never spliced (their meta invariants assume
    the lock assembly is intact).
    """
    # deferred import: runner imports generate at module level
    from .runner import CUDA_STATE_POOL, TORCH_CHUNK_POOL
    s = scenario
    ops = ["seed", "costs", "horizon", "torch_chunk", "cuda_state"]
    if s.n_active > 2:
        ops.append("n_active")
    if s.kind == "composed" and s.lock in WRAP_SEED_LOCKS:
        ops.append("ticket_base")
    if s.meta.get("faults"):
        ops.append("faults")
    donors = [d for d in (pool or [])
              if d.kind == "random" and d is not scenario] \
        if s.kind == "random" else []
    if donors:
        ops.append("splice")
    for _ in range(max(1, n_mutations)):
        op = str(rng.choice(ops))
        if op == "seed":
            s = s.replace(seed=int(rng.integers(1, 2**31 - 1)))
        elif op == "costs":
            s = s.replace(costs=gen_costs(rng))
        elif op == "horizon":
            s = s.replace(horizon=int(rng.integers(1_500, 4_000)))
        elif op == "n_active":
            if s.n_active > 2:  # an earlier mutation may have hit the floor
                s = s.replace(n_active=int(rng.integers(2, s.n_active)))
        elif op == "torch_chunk":
            ch = TORCH_CHUNK_POOL[int(rng.integers(len(TORCH_CHUNK_POOL)))]
            s = s.replace(meta={**s.meta, "torch_chunk": int(ch)})
        elif op == "cuda_state":
            st = CUDA_STATE_POOL[int(rng.integers(len(CUDA_STATE_POOL)))]
            s = s.replace(meta={**s.meta, "cuda_state": str(st)})
        elif op == "faults":
            s = with_fault_schedule(s, rng)
        elif op == "splice":
            donor = donors[int(rng.integers(len(donors)))]
            spliced = splice_programs(s.program, donor.program, rng)
            if spliced is not None:
                s = s.replace(program=spliced)
        else:  # ticket_base: same words gen_composed_scenario itself seeds
            tb = int(INT32_MAX - rng.integers(0, 12))
            init_mem = np.asarray(s.init_mem).copy()
            n_locks = s.meta["layout"]["n_locks"]
            for base in range(0, n_locks * LOCK_STRIDE, LOCK_STRIDE):
                init_mem[base + OFF_TICKET] = tb
                init_mem[base + OFF_GRANT] = tb
                if s.lock == "tkt-dual":
                    init_mem[base + OFF_LGRANT] = tb
            s = s.replace(init_mem=init_mem,
                          meta={**s.meta, "ticket_base": tb})
    return s


def with_fault_schedule(scenario: Scenario,
                        rng: np.random.Generator) -> Scenario:
    """Attach (or redraw) a random fault schedule on ``scenario``.

    Draws 0-3 preemptions, 0-3 spurious wakes and 0-1 aborts (at least one
    fault total), confined to the first ~2000 events so schedules bite even
    on cells that exit early, and stores the schedule as JSON-serialisable
    rows in ``meta["faults"]`` — the canonical carrier every execution path
    (:meth:`Scenario.engine_kwargs`, the batch oracle, the sweep runner)
    reads via :func:`scenario_faults`.
    """
    n_pre = int(rng.integers(0, 4))
    n_spur = int(rng.integers(0, 4))
    n_abort = int(rng.integers(0, 2))
    if n_pre + n_spur + n_abort == 0:
        n_pre = 1
    sched = draw_schedule(rng, n_active=scenario.n_active,
                          max_events=scenario.max_events,
                          n_preempt=n_pre, n_spurious=n_spur,
                          n_abort=n_abort,
                          evt_span=min(scenario.max_events, 2000))
    return scenario.replace(meta={**scenario.meta,
                                  "faults": sched.to_lists()})


def generate_batch(n_cases: int, seed: int,
                   composed_fraction: float = 0.6,
                   fault_fraction: float = 0.0,
                   trace_fraction: float = 0.0) -> list[Scenario]:
    """A deterministic mixed batch: ``composed_fraction`` of the cases wrap
    the ``SIM_LOCKS`` generators round-robin (so any batch of >= 14/0.6 =
    24 cases covers every lock at least once), the rest are random ISA
    programs.

    ``fault_fraction`` of the cases additionally carry a random fault
    schedule (:func:`with_fault_schedule`).  ``trace_fraction`` of the
    cases are *replaced* by trace-compiled workloads
    (:func:`gen_trace_scenario`, round-robin over the locks too).  Both
    come from *separate* PRNG streams keyed off ``seed``, so leaving a
    fraction at 0 reproduces historical batches byte-for-byte and raising
    one never perturbs the scenarios the other streams produce.
    """
    rng = np.random.default_rng(seed)
    fault_rng = np.random.default_rng((int(seed) ^ 0xFA017) & 0xFFFFFFFF)
    trace_rng = np.random.default_rng((int(seed) ^ 0x7AACE) & 0xFFFFFFFF)
    out = []
    n_composed = min(n_cases, int(round(n_cases * composed_fraction)))
    for i in range(n_cases):
        if i < n_composed:
            lock = SIM_LOCKS[i % len(SIM_LOCKS)]
            out.append(gen_composed_scenario(rng, lock))
        else:
            out.append(gen_random_scenario(rng))
    if trace_fraction > 0:
        out = [gen_trace_scenario(trace_rng, SIM_LOCKS[i % len(SIM_LOCKS)])
               if trace_rng.random() < trace_fraction else s
               for i, s in enumerate(out)]
    if fault_fraction > 0:
        out = [with_fault_schedule(s, fault_rng)
               if fault_rng.random() < fault_fraction else s
               for s in out]
    return out
