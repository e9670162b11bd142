"""Differential runner: oracle vs ``run_sweep`` in both engine modes,
invariant checking, greedy shrinking, and the replayable corpus.

A fuzz batch is executed exactly like a figure sweep: every scenario is
padded to the batch-shared shapes at generation time, so each engine mode
costs one dispatch per placement group for the whole batch (on a GPU, one
kernel launch per group for ``"cuda"``).  The oracle then re-executes each
cell on the host in NumPy (or its compiled C path) and every stat the
engine returns must match bit for bit.

The port's two engine modes (:func:`repro_torch.sim.engine.run_sweep`):

  * ``"torch"`` — the plain PyTorch engine, on any device.  Its placement
    knob is ``chunk``, the steps between termination checks; each case
    draws one from :data:`TORCH_CHUNK_POOL`, pinned into
    ``meta["torch_chunk"]``.
  * ``"cuda"`` — the hand-written lockVM kernel, on a CUDA device only.
    Its placement is where a cell's state lives: shared memory, or the
    global scratch buffer (rows in memory rather than registers); each
    case draws one from :data:`CUDA_STATE_POOL`, pinned into
    ``meta["cuda_state"]``.

Results must not depend on either placement, so any difference between
them IS a bug.  Scenarios written by the reference package carry its own
pins (``sched_geometry``, ``pallas_chunk``); they are kept as they are, so
a re-saved entry still replays there.

Every engine dispatch takes ``device``: the default is ``cuda``, and with
no GPU and no device given the dispatch raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import engine
from ..corpus import load_scenario
from ..faults import FaultSchedule, stack_schedules
from . import _fastcase
from .batch_oracle import run_batch_oracle
from .generate import Scenario, scenario_faults
from .invariants import check_invariants
from .oracle import Trace, run_oracle

MODES = ("torch", "cuda")

# Stats compared bit-identically between oracle and every engine mode.
STAT_KEYS = engine.STAT_KEYS

# Termination-check intervals for the plain engine.  chunk=1 checks (and
# compacts finished cells out of the batch) after every single step, 7
# overshoots on nearly every cell, and the default amortizes the check;
# a step on a finished cell is an exact identity, so any chunk-dependent
# difference IS a bug.
TORCH_CHUNK_POOL = (1, 7, engine.DEFAULT_TORCH_CHUNK)

# Where the kernel keeps a cell's state.  Fuzz cells are small enough for
# shared memory, so "global" forces the scratch path that only very large
# cells would otherwise reach.
CUDA_STATE_POOL = ("smem", "global")


def _draws(pool, n_cases: int, seed: int, salt: int) -> list:
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(salt))
    return [pool[int(i)] for i in rng.integers(0, len(pool), n_cases)]


def torch_chunks(n_cases: int, seed: int) -> list[int]:
    """Deterministic per-case ``chunk`` draws for a fuzz batch.

    Cases sharing a chunk dispatch together, so a batch costs at most
    ``len(TORCH_CHUNK_POOL)`` dispatches of the plain engine.
    """
    return _draws(TORCH_CHUNK_POOL, n_cases, seed, 0x70C4C)


def cuda_states(n_cases: int, seed: int) -> list[str]:
    """Deterministic per-case state placements for a fuzz batch (one
    kernel launch per placement present)."""
    return _draws(CUDA_STATE_POOL, n_cases, seed, 0xC0DA5)


def _stamp(scenarios, key: str, values) -> list[Scenario]:
    """Pin ``values`` into ``meta[key]``; a scenario that already carries
    one (a replayed artifact) keeps it."""
    return [s if s.meta.get(key) is not None
            else s.replace(meta={**s.meta, key: v})
            for s, v in zip(scenarios, values)]


def stamp_torch_chunk(scenarios: list[Scenario],
                      sched_seed: int) -> list[Scenario]:
    """Pin each scenario's drawn chunk into ``meta["torch_chunk"]``.

    The draw otherwise depends on batch length, case index and seed, so a
    chunk-dependent failure would be unreproducible from its own artifact:
    the shrinker and ``--replay`` run single-case batches whose position-0
    draw differs from the failing one.
    """
    return _stamp(scenarios, "torch_chunk",
                  [int(c) for c in torch_chunks(len(scenarios), sched_seed)])


def stamp_cuda_state(scenarios: list[Scenario],
                     sched_seed: int) -> list[Scenario]:
    """Pin each scenario's drawn state placement into
    ``meta["cuda_state"]`` (same replayability story as
    :func:`stamp_torch_chunk`)."""
    return _stamp(scenarios, "cuda_state",
                  cuda_states(len(scenarios), sched_seed))


def run_engine_batch(scenarios: list[Scenario], mode: str,
                     sched_seed: int = 0, device=None) -> list[dict]:
    """Run a padded batch through ``engine.run_sweep`` in ``mode``.

    ``mode="torch"`` runs each case at its pinned ``meta["torch_chunk"]``
    (falling back to a fresh :func:`torch_chunks` draw seeded by
    ``sched_seed``); ``mode="cuda"`` likewise at its pinned
    ``meta["cuda_state"]`` (fallback :func:`cuda_states`).  Both dispatch
    one sub-batch per distinct placement, reassembling results in input
    order.
    """
    s0 = scenarios[0]
    for s in scenarios:
        assert (s.n_threads, s.mem_words, s.n_locks) == \
            (s0.n_threads, s0.mem_words, s0.n_locks), "batch not padded"
    if mode == "torch":
        keys = [int(s.meta["torch_chunk"])
                if s.meta.get("torch_chunk") is not None else ch
                for s, ch in zip(scenarios,
                                 torch_chunks(len(scenarios), sched_seed))]
        return _dispatch_grouped(scenarios, keys, lambda ch: dict(
            mode="torch", chunk=ch, device=device))
    if mode == "cuda":
        keys = [str(s.meta["cuda_state"])
                if s.meta.get("cuda_state") is not None else st
                for s, st in zip(scenarios,
                                 cuda_states(len(scenarios), sched_seed))]
        return _dispatch_grouped(scenarios, keys, lambda st: dict(
            mode="cuda", cuda_state=st, device=device))
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _dispatch_grouped(scenarios, keys, kwargs_of) -> list[dict]:
    """Dispatch one sub-batch per distinct placement key, in input order."""
    out: list = [None] * len(scenarios)
    for key in sorted(set(keys)):
        idxs = [i for i, k in enumerate(keys) if k == key]
        sub = _dispatch_batch([scenarios[i] for i in idxs], **kwargs_of(key))
        for i, res in zip(idxs, sub):
            out[i] = res
    return out


def _dispatch_batch(scenarios: list[Scenario], **kw) -> list[dict]:
    s0 = scenarios[0]
    scheds = [scenario_faults(s) for s in scenarios]
    if any(sc is not None for sc in scheds):
        kw["faults"] = stack_schedules(
            [sc if sc is not None else FaultSchedule.empty()
             for sc in scheds])
    raw = engine.run_sweep(
        np.stack([s.program for s in scenarios]),
        mem_words=s0.mem_words, n_locks=s0.n_locks,
        init_pc=np.stack([s.init_pc for s in scenarios]),
        init_regs=np.stack([s.init_regs for s in scenarios]),
        n_active=np.asarray([s.n_active for s in scenarios]),
        seeds=np.asarray([s.seed for s in scenarios], np.uint32),
        wa_base=np.asarray([s.wa_base for s in scenarios]),
        wa_size=np.asarray([s.wa_size for s in scenarios]),
        horizon=np.asarray([s.horizon for s in scenarios], np.int32),
        max_events=np.asarray([s.max_events for s in scenarios], np.int32),
        costs=np.stack([s.costs for s in scenarios]),
        init_mem=np.stack([s.init_mem for s in scenarios]), **kw)
    return [{k: raw[k][i] for k in STAT_KEYS}
            for i in range(len(scenarios))]


def oracle_impl(batch_oracle: bool) -> str:
    """Which referee a run uses: the batch oracle's compiled C path
    (``"c"``) or its NumPy path (``"numpy"``), else the sequential oracle
    (``"sequential"``)."""
    if not batch_oracle:
        return "sequential"
    return "c" if _fastcase.HAVE_FAST else "numpy"


def run_oracle_case(scenario: Scenario, mutate: tuple = ()) -> tuple[dict,
                                                                     Trace]:
    trace = Trace()
    out = run_oracle(scenario.program, trace=trace, mutate=mutate,
                     **scenario.engine_kwargs())
    return out, trace


def diff_stats(oracle_out: dict, engine_out: dict, label: str) -> list[str]:
    """First bit-level mismatch per stat key (empty = identical)."""
    problems = []
    for k in STAT_KEYS:
        a, b = np.asarray(oracle_out[k]), np.asarray(engine_out[k])
        if not np.array_equal(a, b):
            if a.ndim:
                i = int(np.argmax(a != b))
                detail = f"[{i}]: oracle={a.flat[i]} engine={b.flat[i]}"
            else:
                detail = f": oracle={a} engine={b}"
            problems.append(f"differential[{label}]: {k}{detail}")
    return problems


def check_case(scenario: Scenario, oracle_out: dict, trace: Trace,
               engine_outs: dict[str, dict]) -> list[str]:
    """All problems for one case: mode differentials + invariants."""
    problems = []
    for mode, out in engine_outs.items():
        problems += diff_stats(oracle_out, out, mode)
    problems += check_invariants(scenario, oracle_out, trace)
    return problems


@dataclass
class FuzzReport:
    n_cases: int
    total_events: int = 0
    failures: list = field(default_factory=list)  # (index, scenario, [msgs])
    novel: list = field(default_factory=list)     # coverage-novel indices
    oracle_impl: str = ""   # the referee that ran (see oracle_impl())
    # cases per (mode, placement) the engines ran, e.g. {"cuda:global": 9}
    placements: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        head = (f"fuzz: {self.n_cases} cases, {self.total_events} oracle "
                f"events, {len(self.failures)} failing")
        lines = [head]
        for idx, scenario, msgs in self.failures:
            tag = scenario.lock or scenario.kind
            lines.append(f"  case {idx} ({tag}): " + "; ".join(msgs[:3]))
        return "\n".join(lines)


def fuzz(scenarios: list[Scenario], modes: tuple = MODES,
         oracle_mutate: tuple = (), sched_seed: int = 0,
         batch_oracle: bool = False, coverage=None,
         device=None) -> FuzzReport:
    """Differential + invariant sweep over a padded scenario batch.

    ``sched_seed`` seeds the per-case placement draws of the ``"torch"``
    mode (chunk) and the ``"cuda"`` mode (state placement).  The drawn
    placement is stamped into each scenario's meta up front, so a failing
    case's artifact — and every shrink candidate derived from it — replays
    at exactly the placement that failed.  The engines run on ``device``
    (default ``cuda``).

    ``batch_oracle=True`` runs the oracle side through
    :func:`run_batch_oracle` (one vectorized pass instead of B sequential
    interpreter runs) — the checks, mutations and failure reports are
    unchanged because the batch oracle is bit-identical to the sequential
    one.  With a :class:`~repro_torch.sim.check.coverage.CoverageMap` passed as
    ``coverage`` (batch oracle only), per-case coverage is folded into the
    map and the indices of signature-novel cases land in ``report.novel``.
    """
    scenarios = stamp_torch_chunk(scenarios, sched_seed)
    scenarios = stamp_cuda_state(scenarios, sched_seed)
    engine_outs = {mode: run_engine_batch(scenarios, mode,
                                          sched_seed=sched_seed,
                                          device=device)
                   for mode in modes}
    report = FuzzReport(n_cases=len(scenarios),
                        oracle_impl=oracle_impl(batch_oracle),
                        placements=_placements(scenarios, modes))
    if batch_oracle:
        bres = run_batch_oracle(scenarios, mutate=oracle_mutate,
                                collect_trace=True,
                                collect_coverage=coverage is not None)
        oracle_runs = list(zip(bres.stats, bres.traces))
        if coverage is not None:
            report.novel = coverage.add_batch(scenarios, bres)
    else:
        assert coverage is None, "coverage feedback needs batch_oracle=True"
        oracle_runs = [run_oracle_case(s, mutate=oracle_mutate)
                       for s in scenarios]
    for i, scenario in enumerate(scenarios):
        oracle_out, trace = oracle_runs[i]
        report.total_events += int(oracle_out["events"])
        problems = check_case(scenario, oracle_out, trace,
                              {m: outs[i] for m, outs in engine_outs.items()})
        if problems:
            report.failures.append((i, scenario, problems))
    return report


def _placements(scenarios, modes) -> dict:
    """Cases per ``"mode:placement"`` for the pinned scenarios."""
    key = {"torch": "torch_chunk", "cuda": "cuda_state"}
    out: dict = {}
    for m in modes:
        for s in scenarios:
            tag = f"{m}:{s.meta[key[m]]}"
            out[tag] = out.get(tag, 0) + 1
    return out


@dataclass
class SteerResult:
    """Outcome of a coverage-steered fuzz run."""

    report: FuzzReport      # aggregated over every round (global indices)
    coverage: object        # the CoverageMap after all rounds
    pool: list              # promoted (coverage-novel) scenarios
    n_mutants: int = 0      # cases produced by mutation rather than redraw


def steer(n_cases: int, seed: int, modes: tuple = MODES,
          coverage=None, pool: list | None = None, batch_size: int = 256,
          mutate_fraction: float = 0.5, pool_cap: int = 512,
          composed_fraction: float = 0.6,
          fault_fraction: float = 0.0,
          trace_fraction: float = 0.0, device=None) -> SteerResult:
    """Coverage-guided fuzzing: novel cases are promoted and mutated.

    Runs ``n_cases`` through :func:`fuzz` (batch oracle + coverage) in
    rounds of ``batch_size``.  Cases whose coverage signature is new to the
    map are promoted into ``pool``; once the pool is non-empty, each round
    draws ``mutate_fraction`` of its cases by mutating pool members
    (:func:`~repro_torch.sim.check.generate.mutate_scenario` — geometry,
    seeds, costs, ticket wrap seeding, engine placement, fault schedules,
    and program splicing between pool members) in preference to uniform
    redraw.  The pool is FIFO-capped at ``pool_cap`` so long runs keep
    mutating *recent* frontier cases.

    ``fault_fraction`` of each freshly generated round is decorated with a
    drawn fault schedule (see ``generate_batch``); mutation then keeps
    redrawing those schedules on promoted cases.  ``trace_fraction``
    replaces that share of each round with trace-compiled workloads
    (``gen_trace_scenario``), putting the trace pipeline's table loads and
    arrival preambles under the same differential.

    Passing an existing ``coverage`` map (e.g. loaded from a previous
    nightly's artifact) makes novelty judgments cumulative across runs.
    """
    from .coverage import CoverageMap
    from .generate import generate_batch, mutate_scenario
    coverage = coverage if coverage is not None else CoverageMap()
    pool = list(pool) if pool else []
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(0x57EE2))
    out = SteerResult(report=FuzzReport(n_cases=0,
                                        oracle_impl=oracle_impl(True)),
                      coverage=coverage, pool=pool)
    done = 0
    for round_i in range(1 << 30):
        if done >= n_cases:
            break
        n = min(batch_size, n_cases - done)
        n_mut = min(int(round(n * mutate_fraction)), n) if pool else 0
        batch = [mutate_scenario(pool[int(rng.integers(len(pool)))], rng,
                                 n_mutations=int(rng.integers(1, 4)),
                                 pool=pool)
                 for _ in range(n_mut)]
        batch += generate_batch(n - n_mut,
                                seed=int((np.uint32(seed)
                                          + np.uint32(7919 * round_i))
                                         & np.uint32(0x7FFFFFFF)),
                                composed_fraction=composed_fraction,
                                fault_fraction=fault_fraction,
                                trace_fraction=trace_fraction)
        # stamp before fuzz so promoted scenarios carry their placement
        # pins (fuzz re-stamps idempotently)
        batch = stamp_torch_chunk(batch, seed + round_i)
        batch = stamp_cuda_state(batch, seed + round_i)
        sub = fuzz(batch, modes=modes, sched_seed=seed + round_i,
                   batch_oracle=True, coverage=coverage, device=device)
        pool.extend(batch[i] for i in sub.novel)
        if len(pool) > pool_cap:
            del pool[: len(pool) - pool_cap]
        out.report.failures += [(done + i, s, msgs)
                                for i, s, msgs in sub.failures]
        out.report.novel += [done + i for i in sub.novel]
        out.report.total_events += sub.total_events
        for tag, n in sub.placements.items():
            out.report.placements[tag] = out.report.placements.get(tag, 0) + n
        out.report.n_cases += sub.n_cases
        out.n_mutants += n_mut
        done += n
    return out


def replay_corpus(paths, modes: tuple = MODES, oracle_mutate: tuple = (),
                  batch_oracle: bool = True, device=None) -> list[list[str]]:
    """Replay corpus entries as padded batches: ``problems`` per path.

    Entries are grouped by their padded shapes and each group costs ONE
    engine dispatch per mode (plus one geometry sub-batch per distinct
    pinned placement) instead of one dispatch per entry — the same batching
    a fresh fuzz run gets.  The oracle side runs through the batch oracle
    by default (sequential fallback still applies per case).
    """
    scens = [load_scenario(p) for p in paths]
    results: list = [None] * len(paths)
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(scens):
        key = (s.n_threads, s.mem_words, s.n_locks,
               int(np.asarray(s.program).shape[0]))
        groups.setdefault(key, []).append(i)
    for key in sorted(groups):
        idxs = groups[key]
        batch = [scens[i] for i in idxs]
        engine_outs = {m: run_engine_batch(batch, m, device=device)
                       for m in modes}
        if batch_oracle:
            bres = run_batch_oracle(batch, mutate=oracle_mutate)
            oracle_runs = list(zip(bres.stats, bres.traces))
        else:
            oracle_runs = [run_oracle_case(s, mutate=oracle_mutate)
                           for s in batch]
        for j, i in enumerate(idxs):
            oracle_out, trace = oracle_runs[j]
            results[i] = check_case(
                batch[j], oracle_out, trace,
                {m: outs[j] for m, outs in engine_outs.items()})
    return results


# ---------------------------------------------------------------------------
# Shrinking
# ---------------------------------------------------------------------------

def count_instructions(program: np.ndarray) -> int:
    """Rows that still do something: neither NOP nor HALT."""
    ops = np.asarray(program)[:, 0]
    from ..isa import HALT, NOP
    return int(((ops != NOP) & (ops != HALT)).sum())


def failure_classes(problems: list[str]) -> set:
    """Collapse problem strings to their class: ``differential``,
    ``exclusion``, ``conservation``, ``fifo``, ``liveness``, ``deadlock``,
    ``progress``, ``collision``."""
    return {p.split(":", 1)[0].split("[", 1)[0] for p in problems}


def case_problems(scenario: Scenario, modes: tuple = ("torch",),
                  oracle_mutate: tuple = (), device=None) -> list[str]:
    """All problems for a single case (one engine dispatch per mode).

    A candidate that crashes the oracle (e.g. a shrink step broke program
    well-formedness) is reported as a ``malformed`` problem so the shrinker
    can discard it rather than chase it.
    """
    try:
        oracle_out, trace = run_oracle_case(scenario, mutate=oracle_mutate)
        engine_outs = {m: run_engine_batch([scenario], m, device=device)[0]
                       for m in modes}
        return check_case(scenario, oracle_out, trace, engine_outs)
    except Exception as e:  # noqa: BLE001 - anything the candidate broke
        return [f"malformed: {e!r}"]


def reference_stall(scenario: Scenario, problems: list[str]) -> bool:
    """Whether a failing case is the reference's known ``twa-staged`` stall.

    The reference's ``twa-staged`` lock can end with every thread parked on
    its waiting-array slot when a thread is preempted between drawing its
    ticket and reading the grant (its successor parks, and it then finds
    itself next in line, where it has no duty to promote): the
    ``recovery`` invariant fails, in the reference's checker as in this
    one, with no differential (ROADMAP.md §3).  Such a case is a composed
    ``twa-staged`` case with a drawn transient fault schedule, its only
    problems are ``recovery`` ones, and the sequential oracle, run on its
    own, finds exactly those.  A differential never qualifies.
    """
    if (scenario.kind, scenario.lock) != ("composed", "twa-staged"):
        return False
    if (not scenario.meta.get("faults")
            or failure_classes(problems) != {"recovery"}):
        return False
    return case_problems(scenario, modes=()) == problems


def case_fails(scenario: Scenario, modes: tuple = ("torch",),
               oracle_mutate: tuple = (), device=None) -> bool:
    problems = case_problems(scenario, modes=modes,
                             oracle_mutate=oracle_mutate, device=device)
    return bool(problems) and failure_classes(problems) != {"malformed"}


def shrink(scenario: Scenario, failing=None, modes: tuple = ("torch",),
           oracle_mutate: tuple = (), program_passes: bool = True,
           device=None) -> Scenario:
    """Greedy minimization of a failing case.

    The predicate preserves the original FAILURE CLASS: a candidate counts
    as still-failing only if it reproduces at least one of the original
    problem classes (shrinking a differential mismatch must not wander off
    into, say, a horizon-starved ``progress`` violation).

    Passes, each keeping a candidate only if it still fails:
      1. horizon/max_events halving (cheapest first — shortens every later
         oracle run);
      2. dropping threads from the top (``n_active`` reduction);
      3. fault-schedule minimization: drop ``meta["faults"]`` rows
         one at a time (last first), then halve surviving preemption
         stall widths — a fault-injected failure shrinks toward the one
         fault that matters, or proves fault-independent by losing them
         all;
      4. replacing program rows with HALT (kills whole suffix behaviour),
         then with NOP (keeps control flow), to a fixed point.

    ``program_passes=False`` keeps the program untouched (passes 1-3 only)
    — used for corpus entries whose *program semantics* are the point (a
    broken lock must stay a recognizable broken lock, not collapse into a
    two-instruction store to the violation word).

    Shapes are left untouched, so every engine call during a shrink runs
    the same padded shapes.
    """
    from ..isa import HALT, NOP
    if failing is None:
        target = failure_classes(case_problems(
            scenario, modes=modes, oracle_mutate=oracle_mutate,
            device=device))
        target.discard("malformed")
        assert target, "shrink() needs a failing scenario"

        def failing(s):
            got = failure_classes(case_problems(
                s, modes=modes, oracle_mutate=oracle_mutate, device=device))
            return bool(got & target)
    assert failing(scenario), "shrink() needs a failing scenario"

    improved = False

    def attempt(cand):
        nonlocal scenario, improved
        if failing(cand):
            scenario = cand
            improved = True
            return True
        return False

    def fault_rows():
        return [list(r) for r in (scenario.meta.get("faults") or [])]

    def with_faults(rows):
        meta = {k: v for k, v in scenario.meta.items() if k != "faults"}
        if rows:
            meta["faults"] = rows
        return scenario.replace(meta=meta)

    def size():
        rows = fault_rows()
        return (count_instructions(scenario.program), scenario.n_active,
                len(rows), sum(r[3] for r in rows), scenario.horizon)

    while True:
        before = size()
        improved = False
        for _ in range(24):  # 1. horizon / event budget
            h = scenario.horizon // 2
            if h < 50 or not attempt(scenario.replace(
                    horizon=h, max_events=min(scenario.max_events, 4 * h))):
                break
        while scenario.n_active > 1:  # 2. threads
            if not attempt(scenario.replace(n_active=scenario.n_active - 1)):
                break
        # 3. fault schedule: drop rows last-first (dropping keeps the
        # earlier rows' event indices meaningful), then halve the stall
        # width of surviving preemptions toward the minimal repro
        for i in reversed(range(len(fault_rows()))):
            rows = fault_rows()
            if i < len(rows):
                attempt(with_faults(rows[:i] + rows[i + 1:]))
        from ..faults import F_PREEMPT
        for i in range(len(fault_rows())):
            while True:
                rows = fault_rows()
                if not (rows[i][0] == F_PREEMPT and rows[i][3] > 1):
                    break
                rows[i][3] //= 2
                if not attempt(with_faults(rows)):
                    break
        if not program_passes:
            if not improved and size() == before:
                return scenario
            continue
        for fill_op in (HALT, NOP):  # 4. program rows (tail-first for HALT)
            changed = True
            while changed:
                changed = False
                prog = np.asarray(scenario.program)
                for i in reversed(range(len(prog))):
                    if prog[i, 0] in (NOP, HALT):
                        continue
                    cand_prog = prog.copy()
                    cand_prog[i] = (fill_op, 0, 0, 0, 0)
                    if attempt(scenario.replace(program=cand_prog)):
                        changed = True
                        prog = np.asarray(scenario.program)
        # 5. branch short-circuit: a conditional branch becomes JMP (always
        # taken) so its dead fall-through path can die in the next pass
        from ..isa import BEQ, BGTI, JMP
        prog = np.asarray(scenario.program)
        for i in range(len(prog)):
            if BEQ <= prog[i, 0] <= BGTI:
                cand_prog = np.asarray(scenario.program).copy()
                cand_prog[i] = (JMP, 0, 0, 0, cand_prog[i, 4])
                attempt(scenario.replace(program=cand_prog))
        # 6. pair elimination: escape local minima where two rows (e.g. a
        # branch and its target) are only jointly removable
        live = [i for i in range(len(np.asarray(scenario.program)))
                if int(np.asarray(scenario.program)[i, 0]) not in (NOP, HALT)]
        if len(live) <= 24:
            for i in live:
                for j in live:
                    if j <= i:
                        continue
                    cand_prog = np.asarray(scenario.program).copy()
                    if int(cand_prog[i, 0]) in (NOP, HALT):
                        continue  # already gone via an earlier kept pair
                    cand_prog[i] = (NOP, 0, 0, 0, 0)
                    cand_prog[j] = (NOP, 0, 0, 0, 0)
                    attempt(scenario.replace(program=cand_prog))
        # joint fixed point: nothing shrank AND no size-neutral rewrite
        # (e.g. a pass-4 branch->JMP) happened that could unlock more
        if not improved and size() == before:
            return scenario
