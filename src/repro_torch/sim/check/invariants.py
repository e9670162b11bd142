"""Engine-independent invariants over oracle runs of composed scenarios.

The differential layer (oracle == engine, bit for bit) catches *divergence*;
this layer catches bugs both sides could share.  Every check is derived from
lock semantics, not from engine internals:

  * ``exclusion``    — the occupancy probe's violation word stays 0 per lock
    (critical-section occupancy never exceeded the cap: 1 for mutexes,
    ``sem_permits`` for twa-sem) and final occupancy is in ``[0, cap]``.
    For ``twa-rw`` the weighted rw probe applies instead: readers may
    overlap each other, but never a writer, and a writer is always alone.
  * ``conservation`` — ticket-family counters balance: per lock,
    ``grant <= sum(acquisitions) <= ticket`` and the in-flight window
    ``ticket - grant`` never exceeds the thread count.  All differences are
    taken in int32 wrap arithmetic against the scenario's OWN initial
    memory, so tickets seeded near ``INT32_MAX`` account correctly across
    the wrap.  ``fissile-twa`` draws tickets only on its slow path, so its
    draws balance against WAITED acquisitions instead.
  * ``fifo``         — ticket-family mutexes grant in strictly increasing
    ticket order per lock (from the oracle's ACQ trace; "increasing" is the
    wrapped difference, so the order survives the int32 wrap).
  * ``liveness``     — under FIFO locks, a thread that has drawn a ticket
    is granted within a bounded number of subsequent handovers on that lock
    (at most ``n_threads`` can be ahead of it).  This catches
    starving-but-not-deadlocked locks — e.g. a release that occasionally
    skips a grant strands ONE waiter while everyone else keeps cycling,
    which ``deadlock``/``progress`` never notice.  Ticket draws come from
    the oracle's FADD trace (``Trace.fadds``).
  * ``deadlock``     — a composed scenario (infinite-loop workload) must be
    cut by the horizon or event budget, never reach the "stalled" state
    where every thread is parked and no store is pending.  Gated OFF when
    the scenario carries a fault schedule: an aborted lock holder
    legitimately stalls every strict-FIFO waiter behind it.
  * ``progress``     — at least one acquisition within the horizon.  Also
    gated OFF under faults (a preemption burst can eat the whole horizon).
  * ``collision``    — with ``count_collisions``, per-thread futile wakeups
    never exceed total wakeups.
  * ``lost_grant``   — universal wakeup soundness, *including* under
    faults: a thread still parked at exit must have a genuinely
    unsatisfied SPIN predicate against final committed memory.  Any
    committed write to the watched word wakes its watchers (a spurious
    wake merely re-checks, a preemption only delays the resume), so a
    parked thread whose predicate holds witnesses a lost wakeup.
  * ``recovery``     — bounded recovery: a composed scenario whose fault
    schedule contains no aborts (preemptions and spurious wakes only —
    every thread stays schedulable) must still never stall; transient
    faults may slow the lock down but must not wedge it.
  * ``abandoned``    — ``twa-timo`` ticket accounting: timed-out waiters
    abandon their tickets, so the ticket family's books gain an
    ``abandoned`` column (every draw is either acquired, abandoned, or
    still in flight) and the releaser-side ``skipped`` counter never
    exceeds abandonments plus in-flight markers.

Each check returns a list of human-readable violation strings (empty = ok).
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np

from .. import isa
from ..faults import F_ABORT, FaultSchedule
from ..isa import LOCK_STRIDE, OFF_GRANT, OFF_TICKET
from ..programs import (Layout, OCC_OFF, RW_WRITER_W,
                        TIMO_ABANDONED_OFF, TIMO_SKIPPED_OFF, VIOL_OFF,
                        read_collision_counters)
from .oracle import Trace, _w32


def scenario_fault_schedule(scenario) -> FaultSchedule | None:
    """The scenario's fault schedule from ``meta["faults"]``, or ``None``.

    Duplicated from ``generate.scenario_faults`` only to keep this module
    import-light (it must not pull the generator stack in); both read the
    same canonical ``meta`` rows.
    """
    rows = scenario.meta.get("faults")
    if not rows:
        return None
    sched = FaultSchedule.from_lists(rows)
    return sched if len(sched) else None


def _lock_bases(n_locks: int) -> list[int]:
    return [lidx * LOCK_STRIDE for lidx in range(n_locks)]


def check_exclusion(scenario, mem: np.ndarray) -> list[str]:
    if not scenario.meta.get("probed"):
        return []
    cap = scenario.meta["cap"]
    rw = scenario.meta.get("rw", False)
    n_threads = scenario.meta["layout"]["n_threads"]
    problems = []
    for lidx, base in enumerate(_lock_bases(
            scenario.meta["layout"]["n_locks"])):
        viol = int(mem[base + VIOL_OFF])
        occ = int(mem[base + OCC_OFF])
        if rw:
            # weighted probe: readers weigh 1, a writer RW_WRITER_W.  The
            # violation word convicts any overlap involving a writer; the
            # final snapshot must be readers-only (<= T) or a lone writer.
            if viol != 0:
                problems.append(
                    f"exclusion: lock {lidx} rw overlap involving a writer "
                    f"(violation word = {viol})")
            if not (0 <= occ <= n_threads or occ == RW_WRITER_W):
                problems.append(
                    f"exclusion: lock {lidx} final rw occupancy {occ} is "
                    f"neither readers-only (<= {n_threads}) nor a lone "
                    f"writer ({RW_WRITER_W})")
            continue
        if viol != 0:
            problems.append(
                f"exclusion: lock {lidx} occupancy exceeded cap {cap} "
                f"(violation word = {viol})")
        if not 0 <= occ <= cap:
            problems.append(
                f"exclusion: lock {lidx} final occupancy {occ} outside "
                f"[0, {cap}]")
    return problems


def check_conservation(scenario, mem: np.ndarray,
                       stats: dict) -> list[str]:
    """Ticket-draw / grant / acquisition accounting for the ticket family.

    Draws and grants are wrapped int32 differences against the scenario's
    initial memory (tickets may be seeded near ``INT32_MAX``), so the
    accounting holds across the wrap.  Every ticket-family lock draws from
    ``OFF_TICKET`` and each live thread holds at most one undrawn-into-ACQ
    ticket: ``0 <= draws - total_acq <= T``.  Locks that advance the shared
    ``OFF_GRANT`` word (not partitioned/anderson, whose grants live
    elsewhere) additionally expose the in-flight window per lock
    (``0 <= ticket - grant <= T``) and ``grants <= total_acq`` — a
    committed grant/release implies a completed acquisition.
    ``fissile-twa`` draws only on the slow path, so its draws balance
    against *waited* acquisitions (every TAS-fast acquisition is
    ticketless) and its inner grant advances once per slow release.
    """
    fissile = scenario.meta.get("fissile", False)
    if (not scenario.meta.get("ticket_fifo") and scenario.lock != "twa-sem"
            and not fissile):
        return []
    if scenario.lock == "twa-timo":
        return []  # abandoned tickets break these books; see check_abandoned
    init_mem = np.asarray(scenario.init_mem)
    n_threads = scenario.meta["layout"]["n_threads"]
    total_acq = int(np.asarray(stats["acquisitions"]).sum())
    waited_acq = int(np.asarray(stats["waited_acquisitions"]).sum())
    grant_word = scenario.meta.get("grant_word", False) or fissile
    problems = []
    draws = grants = 0
    for lidx, base in enumerate(_lock_bases(
            scenario.meta["layout"]["n_locks"])):
        draws_l = _w32(int(mem[base + OFF_TICKET])
                       - int(init_mem[base + OFF_TICKET]))
        grants_l = _w32(int(mem[base + OFF_GRANT])
                        - int(init_mem[base + OFF_GRANT]))
        draws += draws_l
        grants += grants_l
        if grant_word and not 0 <= draws_l - grants_l <= n_threads:
            problems.append(
                f"conservation: lock {lidx} in-flight window "
                f"ticket-grant = {draws_l}-{grants_l} outside "
                f"[0, {n_threads}]")
    entered = waited_acq if fissile else total_acq
    what = "waited acquisitions" if fissile else "acquisitions"
    if not 0 <= draws - entered <= n_threads:
        problems.append(
            f"conservation: ticket draws {draws} vs {what} {entered}: "
            f"drawn-but-not-entered outside [0, {n_threads}]")
    if grant_word and grants > entered:
        problems.append(
            f"conservation: grants {grants} exceed {what} {entered}")
    return problems


def check_fifo(scenario, trace: Trace) -> list[str]:
    if not scenario.meta.get("ticket_fifo"):
        return []
    last: dict[int, int] = {}
    problems = []
    for (_ev, _now, thread, lidx, _waited, ticket) in trace.acquires:
        prev = last.get(lidx)
        # wrapped comparison: ticket order survives the int32 wrap
        if prev is not None and _w32(ticket - prev) <= 0:
            problems.append(
                f"fifo: lock {lidx} granted ticket {ticket} (thread "
                f"{thread}) after ticket {prev}")
        last[lidx] = ticket
    return problems


def check_liveness(scenario, trace: Trace) -> list[str]:
    """Bounded handovers between a ticket draw and that thread's grant.

    Under a FIFO lock at most ``n_threads - 1`` waiters can be ahead of a
    freshly drawn ticket, so more than ``n_threads`` subsequent
    acquisitions on the same lock without the drawer being granted means
    it is being starved (skipped grant, lost wakeup, barging bug) even
    though the system as a whole keeps making progress.
    """
    if not scenario.meta.get("ticket_fifo"):
        return []
    if scenario.lock == "twa-timo":
        return []  # a timed-out drawer legitimately watches grants go by
    layout = scenario.meta["layout"]
    n_locks, n_threads = layout["n_locks"], layout["n_threads"]
    bound = n_threads
    # per-lock ACQ sequence (trace order == event order)
    acqs: dict[int, list] = {l: [] for l in range(n_locks)}
    for (ev, _now, thread, lidx, _waited, _tk) in trace.acquires:
        if lidx in acqs:
            acqs[lidx].append((ev, thread))
    problems = []
    for (ev, _now, t, addr, _old) in trace.fadds:
        if addr % LOCK_STRIDE != OFF_TICKET:
            continue
        lidx = addr // LOCK_STRIDE
        if not 0 <= lidx < n_locks:
            continue
        intervening = 0
        # events are strictly increasing, so bisect to the first ACQ after
        # the draw and stop counting one past the bound — each draw costs
        # O(log A + n_threads), not a full rescan
        start = bisect_right(acqs[lidx], (ev, float("inf")))
        for (_aev, athread) in acqs[lidx][start:]:
            if athread == t:
                break
            intervening += 1
            if intervening > bound:
                problems.append(
                    f"liveness: thread {t} drew a ticket on lock {lidx} "
                    f"at event {ev} and watched more than {bound} other "
                    f"grants go by without being granted")
                break
        if problems:
            break  # one witness per run is enough
    return problems


def check_deadlock(scenario, trace: Trace) -> list[str]:
    if scenario.kind != "composed":
        return []  # random programs may legitimately park forever
    if scenario_fault_schedule(scenario) is not None:
        return []  # an aborted holder stalls FIFO waiters; see recovery
    if trace.exit_reason == "stalled":
        return ["deadlock: every thread parked with no pending store "
                f"before the horizon (exit={trace.exit_reason})"]
    return []


def check_progress(scenario, stats: dict) -> list[str]:
    if scenario.kind != "composed":
        return []
    if scenario_fault_schedule(scenario) is not None:
        return []  # a preemption burst may eat the whole horizon
    if int(np.asarray(stats["acquisitions"]).sum()) < 1:
        return [f"progress: no acquisition within horizon "
                f"{scenario.horizon}"]
    return []


def check_recovery(scenario, trace: Trace) -> list[str]:
    """Bounded recovery from transient faults (no-abort schedules).

    Preemptions and spurious wakes leave every thread schedulable: a
    preempted thread resumes after its window, a spuriously woken one
    re-executes its SPIN.  A composed workload must therefore still never
    reach the "stalled" terminal state — transient faults may slow the
    lock down, never wedge it.  (Abort schedules fall outside the gate:
    killing a lock holder legitimately stalls strict-FIFO waiters.)
    """
    if scenario.kind != "composed":
        return []
    sched = scenario_fault_schedule(scenario)
    if sched is None or (sched.kind == F_ABORT).any():
        return []
    if trace.exit_reason == "stalled":
        return ["recovery: stalled under a transient-only fault schedule "
                "(preempt/spurious faults must never wedge a composed "
                "workload)"]
    return []


_SPIN_OPS = (isa.SPIN_EQ, isa.SPIN_NE, isa.SPIN_EQI, isa.SPIN_NEI,
             isa.SPIN_GE)


def check_lost_grant(scenario, mem: np.ndarray, trace: Trace) -> list[str]:
    """No lost grants: every still-parked thread's predicate is really false.

    Sound for every scenario kind, fault schedule or not: a thread parks
    only when its SPIN predicate fails, any committed write to the watched
    word wakes all its watchers (clearing their parked state *at wake
    time*, before they re-execute the SPIN), a spurious wake merely
    re-checks, and a preemption only delays the resume.  So a thread still
    parked at exit watched a word that was never subsequently written —
    if final committed memory satisfies its predicate anyway, a wakeup was
    lost somewhere between the store path and the waiting array.

    Re-evaluates the predicate exactly as the oracle does (same wrap-safe
    compare, same Python-list negative indexing for the one pathological
    negative-address case random programs can build).
    """
    spin = getattr(trace, "final_spin_addr", None)
    if not spin:
        return []  # trace predates the fault work or thread state elided
    pcs, regs = trace.final_pc, trace.final_regs
    prog = np.asarray(scenario.program)
    mem = np.asarray(mem)
    M = len(mem)
    problems = []
    for t, addr in enumerate(spin):
        addr = int(addr)
        if addr < 0 or t >= len(pcs):
            continue
        pc_t = int(pcs[t])
        if not 0 <= pc_t < len(prog):
            continue
        op, a, _b, c_, _imm = (int(x) for x in prog[pc_t])
        if op not in _SPIN_OPS or addr >= M:
            continue  # deferred/OOB cell: predicate not re-derivable here
        ra = int(regs[t][a])
        val = int(mem[addr])
        satisfied = {isa.SPIN_EQ: val == ra, isa.SPIN_NE: val != ra,
                     isa.SPIN_EQI: val == c_, isa.SPIN_NEI: val != c_,
                     isa.SPIN_GE: _w32(val - ra) >= 0}[op]
        if satisfied:
            problems.append(
                f"lost_grant: thread {t} parked at pc {pc_t} on word "
                f"{addr} whose final value {val} satisfies its SPIN "
                f"predicate — its wakeup was lost")
    return problems


def check_abandoned(scenario, mem: np.ndarray, stats: dict) -> list[str]:
    """``twa-timo`` ticket books, with an ``abandoned`` column.

    Every drawn ticket is acquired, abandoned, or still in flight; the
    releaser's skip loop consumes at most one marker per abandonment (plus
    markers whose abandoner has SWAPped but not yet bumped the abandoned
    counter — at most one per thread); grants trail draws.  All
    differences are wrapped int32 against the scenario's own initial
    memory, mirroring ``check_conservation``.
    """
    if scenario.lock != "twa-timo":
        return []
    init_mem = np.asarray(scenario.init_mem)
    n_threads = scenario.meta["layout"]["n_threads"]
    total_acq = int(np.asarray(stats["acquisitions"]).sum())
    problems = []
    draws = grants = abandoned = skipped = 0
    for lidx, base in enumerate(_lock_bases(
            scenario.meta["layout"]["n_locks"])):
        draws_l = _w32(int(mem[base + OFF_TICKET])
                       - int(init_mem[base + OFF_TICKET]))
        grants_l = _w32(int(mem[base + OFF_GRANT])
                        - int(init_mem[base + OFF_GRANT]))
        ab_l = _w32(int(mem[base + TIMO_ABANDONED_OFF])
                    - int(init_mem[base + TIMO_ABANDONED_OFF]))
        sk_l = _w32(int(mem[base + TIMO_SKIPPED_OFF])
                    - int(init_mem[base + TIMO_SKIPPED_OFF]))
        if ab_l < 0 or sk_l < 0:
            problems.append(
                f"abandoned: lock {lidx} negative counter "
                f"(abandoned={ab_l}, skipped={sk_l})")
        if draws_l - grants_l < 0:
            problems.append(
                f"abandoned: lock {lidx} grant {grants_l} ran past "
                f"ticket {draws_l}")
        draws += draws_l
        grants += grants_l
        abandoned += ab_l
        skipped += sk_l
    if not (total_acq + abandoned <= draws
            <= total_acq + abandoned + n_threads):
        problems.append(
            f"abandoned: draws {draws} vs acquisitions {total_acq} + "
            f"abandoned {abandoned}: drawn-but-unresolved outside "
            f"[0, {n_threads}]")
    if skipped > abandoned + n_threads:
        problems.append(
            f"abandoned: releaser skipped {skipped} markers but only "
            f"{abandoned} abandonments completed (+{n_threads} in-flight "
            f"max)")
    if grants > draws:
        problems.append(
            f"abandoned: grants {grants} exceed draws {draws}")
    return problems


def check_collisions(scenario, mem: np.ndarray) -> list[str]:
    if not scenario.meta.get("count_collisions"):
        return []
    layout = Layout(**scenario.meta["layout"])
    wakes, futile = read_collision_counters(
        np.asarray(mem)[:layout.mem_words], layout)
    problems = []
    bad = futile > wakes
    if bad.any():
        t = int(np.argmax(bad))
        problems.append(
            f"collision: thread {t} futile wakeups {int(futile[t])} exceed "
            f"total wakeups {int(wakes[t])}")
    if (wakes < 0).any() or (futile < 0).any():
        problems.append("collision: negative wakeup counter")
    return problems


def active_classes(scenario) -> tuple[str, ...]:
    """Invariant classes whose gate this scenario passes (sorted).

    Mirrors the early-return guards of the ``check_*`` functions above —
    the coverage layer keys its lock x invariant-class histogram on this,
    so a steered corpus can be audited for *which* semantics it actually
    exercises, not just which locks it runs.  ``differential`` (oracle ==
    engine on every stat) applies to every case and is included for all.
    """
    meta = scenario.meta
    sched = scenario_fault_schedule(scenario)
    classes = ["differential", "lost_grant"]
    if meta.get("probed"):
        classes.append("exclusion")
    fissile = meta.get("fissile", False)
    if ((meta.get("ticket_fifo") or scenario.lock == "twa-sem" or fissile)
            and scenario.lock != "twa-timo"):
        classes.append("conservation")
    if meta.get("ticket_fifo"):
        classes.append("fifo")
        if scenario.lock != "twa-timo":
            classes.append("liveness")
    if scenario.kind == "composed":
        if sched is None:
            classes += ["deadlock", "progress"]
        elif not (sched.kind == F_ABORT).any():
            classes.append("recovery")
    if meta.get("count_collisions"):
        classes.append("collision")
    if scenario.lock == "twa-timo":
        classes.append("abandoned")
    return tuple(sorted(classes))


def check_invariants(scenario, stats: dict, trace: Trace) -> list[str]:
    """All invariant violations for one oracle run (empty list = pass)."""
    mem = np.asarray(stats["grant_value"])
    problems = []
    problems += check_exclusion(scenario, mem)
    problems += check_conservation(scenario, mem, stats)
    problems += check_fifo(scenario, trace)
    problems += check_liveness(scenario, trace)
    problems += check_deadlock(scenario, trace)
    problems += check_progress(scenario, stats)
    problems += check_collisions(scenario, mem)
    problems += check_recovery(scenario, trace)
    problems += check_lost_grant(scenario, mem, trace)
    problems += check_abandoned(scenario, mem, stats)
    return problems
