"""Build the fuzz corpus (the entries of ``tests/corpus/*.npz``).

    PYTHONPATH=src python -m repro_torch.sim.check.make_corpus OUT_DIR [DEVICE]

Each entry is a shrunk scenario pinned with the failure classes the checker
must report for it (``meta["expect_classes"]``).  This is the port's copy of
the reference's corpus builder, with the same seeds: it writes only into
the directory it is given, and on a correct engine it writes the
same entries as the reference's builder, array for array.  The engine side
of every check runs on ``DEVICE`` (default ``cuda``): the kernel there
(``mode="cuda"``), or with ``cpu`` the plain engine (``mode="torch"``):

  * ``diff_*`` — shrunk under an injected oracle mutation (store
    visibility, lost wakeups, free invalidation).  On the CORRECT engine
    they must replay with NO differential divergence — these pin exactly
    the engine behaviours each mutation would break.  Their composed-lock
    metadata is stripped (`kind="corpus-diff"`), because a shrunk program
    is no longer a semantically meaningful lock.
  * ``inv_*`` — deliberately broken lock programs (double-granting
    releases, double-drawn tickets, skipped grants, a dropped wakeup
    tally, a probabilistically grant-skipping starver).  The checker must
    KEEP flagging them with the recorded invariant classes — these pin the
    checker's own sensitivity.
  * ``wrap_*`` — composed scenarios whose ticket/grant counters start a
    couple of draws below ``INT32_MAX`` and wrap mid-run.  They must
    replay with ZERO problems — these pin the
    wrap-safe ``SPIN_GE`` frontier compare and the wrap-aware
    conservation/FIFO accounting.

Regeneration is deterministic (fixed seeds); rerun after any intended
engine/oracle semantics change and commit the diff.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import isa
from ..programs import (Asm, Layout, WORK_SCALE, gen_ticket_acquire,
                        pad_program)
from .generate import (INT32_MAX, gen_composed_scenario, generate_batch)
from ..corpus import save_scenario
from .runner import case_problems, failure_classes, shrink

SEED = 20260731
DIFF_MUTATIONS = ("eager_store", "lost_wake", "free_invalidation")


def build_starving_ticket(layout: Layout, *, cs_work: int = 1,
                          ncs_max: int = 4, skip_mod: int = 8) -> np.ndarray:
    """A ticket lock whose release occasionally (1 in ``skip_mod``) writes
    ``grant = tx + 2``, stranding the waiter holding ticket ``tx + 1`` on
    its exact-equality spin while every other thread keeps cycling.

    This is the starving-but-NOT-deadlocked shape the liveness bound
    exists for: the run keeps making global progress (``progress`` and
    ``deadlock`` both pass until nearly every thread has been stranded),
    but the first victim watches unboundedly many grants go by after its
    draw — exactly what ``check_liveness`` convicts.
    """
    asm = Asm()
    asm.label("top")
    gen_ticket_acquire(asm, "a")
    if cs_work:
        asm.emit(isa.WORKI, 0, 0, 0, cs_work * WORK_SCALE)
    asm.emit(isa.PRNG, isa.R_T1, 0, 0, skip_mod)
    asm.emit(isa.ADDI, isa.R_K, isa.R_TX, 0, 1)
    asm.emit(isa.BGTI, isa.R_T1, 0, 0, "nskip")
    asm.emit(isa.ADDI, isa.R_K, isa.R_TX, 0, 2)   # skip: strand tx + 1
    asm.label("nskip")
    asm.emit(isa.REL, 0, isa.R_LIDX, 0, 0)
    asm.emit(isa.STORE, isa.R_LOCK, isa.R_K, 0, isa.OFF_GRANT)
    if ncs_max:
        asm.emit(isa.PRNG, isa.R_W, 0, 0, ncs_max)
        asm.emit(isa.MULI, isa.R_W, isa.R_W, 0, WORK_SCALE)
        asm.emit(isa.WORKR, isa.R_W, 0, 0, 0)
    asm.emit(isa.JMP, 0, 0, 0, "top")
    return asm.finish()


def starving_ticket_scenario(rng, skip_mod: int = 8):
    """A composed-scenario wrapper around :func:`build_starving_ticket`
    (shared by the corpus builder and the checker self-tests)."""
    s = gen_composed_scenario(rng, "ticket", n_threads=8, n_locks=1,
                              ticket_base=0, horizon=8_000)
    layout = Layout(**s.meta["layout"])
    prog = build_starving_ticket(layout, skip_mod=skip_mod)
    # the probe program was replaced, so drop the probe expectation
    return s.replace(program=pad_program(prog),
                     meta={**s.meta, "probed": False})


def _problems(scenario, device, oracle_mutate=()):
    """The checker's problems with ``scenario`` on ``device``'s engine: the
    kernel on a CUDA device, else the plain engine."""
    modes = ("cuda",) if str(device).startswith("cuda") else ("torch",)
    return case_problems(scenario, modes=modes, oracle_mutate=oracle_mutate,
                         device=device)


def _first_failing(scenarios, mutate, device):
    for s in scenarios:
        if _problems(s, device, oracle_mutate=mutate):
            return s
    raise AssertionError(f"no case caught mutation {mutate}")


def _neutralize(scenario):
    """Strip composed-lock semantics from a shrunk differential case."""
    return scenario.replace(
        kind="corpus-diff", lock=None,
        meta={"layout": scenario.meta["layout"]})


def _class_preserving(want, device, oracle_mutate=()):
    """Shrink predicate: every wanted class must survive the candidate."""
    def failing(s):
        got = failure_classes(_problems(s, device,
                                        oracle_mutate=oracle_mutate))
        return want <= got
    return failing


def make_diff_entry(out_dir, mutation: str, device="cuda"):
    """The ``diff_<mutation>`` entry: the first of the seeded batch's cases
    that the oracle mutation breaks, shrunk while it does."""
    s = _first_failing(generate_batch(16, SEED), (mutation,), device)
    s = _neutralize(shrink(
        s, failing=_class_preserving({"differential"}, device,
                                     oracle_mutate=(mutation,))))
    probs = _problems(s, device)
    assert not probs, (mutation, probs)
    s = s.replace(meta={**s.meta, "expect_classes": []})
    save_scenario(os.path.join(out_dir, f"diff_{mutation}.npz"), s,
                  note=f"shrunk under oracle mutation {mutation!r}; "
                       "must replay with zero divergence")
    return f"diff_{mutation}", s


def make_diff_entries(out_dir, device="cuda"):
    for mutation in DIFF_MUTATIONS:
        yield make_diff_entry(out_dir, mutation, device)


def _patch_rows(scenario, match, patch):
    """Patch every program row for which ``match(row)`` holds."""
    prog = np.asarray(scenario.program).copy()
    hits = 0
    for i, row in enumerate(prog):
        if match(row):
            prog[i] = patch(row)
            hits += 1
    assert hits, "patch matched nothing"
    return scenario.replace(program=prog)


def _gen_until(rng, device, lock, patch_fn, want, accept=None, attempts=60,
               gen=gen_composed_scenario):
    """Generate composed scenarios, apply a breaking patch, keep the first
    one on which the checker reports the wanted classes."""
    for _ in range(attempts):
        s = gen(rng, lock)
        if accept is not None and not accept(s):
            continue
        try:
            broken = patch_fn(s)
        except AssertionError:
            continue  # patch matched nothing for this geometry
        got = failure_classes(_problems(broken, device))
        if want <= got:
            return broken
    raise AssertionError(f"no {lock} geometry produced {want}")


def make_invariant_entries(out_dir, device="cuda"):
    rng = np.random.default_rng(SEED)

    # exclusion: twa-sem releases bump the grant by TWO, admitting entrants
    # beyond the permit cap
    s = _gen_until(
        rng, device, "twa-sem",
        lambda s: _patch_rows(
            s, lambda row: (row[0] == isa.FADD and row[2] == isa.R_LOCK
                            and row[3] == 1 and row[4] == isa.OFF_GRANT),
            lambda row: np.asarray([isa.FADD, row[1], row[2], 2, row[4]],
                                   np.int32)),
        want={"exclusion"},
        accept=lambda s: (s.meta["cap"] + 2 <= s.meta["layout"]["n_threads"]
                          and s.meta["layout"]["n_locks"] == 1))
    yield from _finish(out_dir, "inv_exclusion_sem_double_release", s, device,
                       want={"exclusion"})

    # conservation: ticket acquires draw tickets two at a time
    s = _gen_until(
        rng, device, "ticket",
        lambda s: _patch_rows(
            s, lambda row: (row[0] == isa.FADD and row[3] == 1
                            and row[4] == isa.OFF_TICKET),
            lambda row: np.asarray([isa.FADD, row[1], row[2], 2, row[4]],
                                   np.int32)),
        want={"conservation"})
    yield from _finish(out_dir, "inv_conservation_double_ticket", s, device,
                       want={"conservation"})

    # deadlock: ticket releases skip a grant (write ticket+2) — the skipped
    # waiter can never match its exact-equality spin
    s = _gen_until(
        rng, device, "ticket",
        lambda s: _patch_rows(
            s, lambda row: (row[0] == isa.ADDI and row[1] == isa.R_K
                            and row[2] == isa.R_TX and row[4] == 1),
            lambda row: np.asarray([isa.ADDI, isa.R_K, isa.R_TX, 0, 2],
                                   np.int32)),
        want={"deadlock"})
    yield from _finish(out_dir, "inv_deadlock_skipped_grant", s, device,
                       want={"deadlock"})

    # collision: drop the CC_WAKES tally so futile wakeups exceed total —
    # needs a collision-prone geometry (tiny array, saturated camper pool)
    s = _gen_until(
        rng, device, "twa",
        lambda s: _patch_rows(
            s, lambda row: (row[0] == isa.STORE and row[1] == isa.R_NODE
                            and row[4] == isa.CC_WAKES),
            lambda row: np.asarray([isa.NOP, 0, 0, 0, 0], np.int32)),
        want={"collision"},
        gen=lambda rng, lock: gen_composed_scenario(
            rng, lock, count_collisions=True, wa_size=8, n_threads=8,
            n_locks=2, long_term_threshold=1, private_arrays=False))
    yield from _finish(out_dir, "inv_collision_untallied_wakes", s, device,
                       want={"collision"})

    # liveness: a probabilistically grant-skipping ticket lock strands one
    # waiter at a time while the rest keep cycling — starving but NOT
    # deadlocked, the case the liveness bound exists for
    for _ in range(60):
        s = starving_ticket_scenario(rng)
        if "liveness" in failure_classes(_problems(s, device)):
            break
    else:  # pragma: no cover - deterministic seed finds one quickly
        raise AssertionError("no starving-ticket geometry convicted")
    yield from _finish(out_dir, "inv_liveness_skipped_waiter", s, device,
                       want={"liveness"})


def make_wrap_entries(out_dir, device="cuda"):
    """Near-wrap scenarios (tickets seeded just below ``INT32_MAX``) that
    must replay CLEAN — the regression pin for wrap-safe ``SPIN_GE`` and
    the wrap-aware conservation/FIFO/liveness accounting.  ``twa-sem`` is
    the ``SPIN_GE`` user; plain ``ticket`` pins the equality-spin family.
    """
    rng = np.random.default_rng(SEED + 1)
    for lock in ("ticket", "twa-sem"):
        for _ in range(40):
            s = gen_composed_scenario(rng, lock,
                                      ticket_base=INT32_MAX - 2,
                                      n_locks=1)
            probs = _problems(s, device)
            ticket = int(np.asarray(
                run_oracle_mem(s)[isa.OFF_TICKET]))
            # keep a case that actually CROSSED the wrap and stayed clean
            if not probs and ticket < 0:
                break
        else:  # pragma: no cover - deterministic seed finds one quickly
            raise AssertionError(f"no clean wrapping {lock} case found")
        s = s.replace(meta={**s.meta, "expect_classes": []})
        name = f"wrap_{lock.replace('-', '_')}_near_int32max"
        save_scenario(os.path.join(out_dir, f"{name}.npz"), s,
                      note="tickets seeded at INT32_MAX-2; must wrap "
                           "mid-run and replay with zero problems")
        yield name, s


def make_fault_entries(out_dir, device="cuda"):
    """Composed scenarios decorated with fault schedules that must replay
    CLEAN (``expect_classes=[]``) in every engine mode — the regression
    pins for the fault semantics themselves.  Each entry is kept only if
    every scheduled fault actually landed inside the run (an entry whose
    faults are scheduled past the executed-event count would pin nothing).
    One entry per fault kind, plus a timed-lock (``twa-timo``) entry whose
    abandonment accounting runs under preemption.
    """
    from ..faults import draw_schedule
    from .runner import run_oracle_case
    rng = np.random.default_rng(SEED + 2)
    recipes = (
        ("fault_preempt_ticket", "ticket", dict(n_preempt=3)),
        ("fault_spurious_twa", "twa", dict(n_spurious=3)),
        ("fault_abort_ticket", "ticket", dict(n_abort=1, n_preempt=1)),
        ("fault_preempt_twa_timo", "twa-timo", dict(n_preempt=2)),
    )
    for name, lock, kinds in recipes:
        for _ in range(80):
            s = gen_composed_scenario(rng, lock, n_locks=1)
            sched = draw_schedule(rng, n_active=s.n_active,
                                  max_events=s.max_events,
                                  evt_span=min(s.max_events, 1200), **kinds)
            s = s.replace(meta={**s.meta, "faults": sched.to_lists()})
            _out, trace = run_oracle_case(s)
            if len(trace.faults_applied) < len(sched):
                continue  # a fault landed past the run's end: pins nothing
            if _problems(s, device):
                continue
            s = s.replace(meta={**s.meta, "expect_classes": []})
            save_scenario(os.path.join(out_dir, f"{name}.npz"), s,
                          note=f"{lock} under scheduled faults {kinds}; "
                               "every fault lands in-run; must replay "
                               "with zero problems")
            yield name, s
            break
        else:  # pragma: no cover - deterministic seed finds one quickly
            raise AssertionError(f"no clean {name} case found")


def run_oracle_mem(scenario):
    from .oracle import run_oracle
    return np.asarray(
        run_oracle(scenario.program,
                   **scenario.engine_kwargs())["grant_value"])


def _finish(out_dir, name, scenario, device, want):
    probs = _problems(scenario, device)
    got = failure_classes(probs)
    assert want <= got, (name, want, got, probs[:3])
    shrunk = shrink(scenario, failing=_class_preserving(want, device),
                    program_passes=False)
    final = failure_classes(_problems(shrunk, device))
    assert want <= final, (name, want, final)
    shrunk = shrunk.replace(
        meta={**shrunk.meta, "expect_classes": sorted(final)})
    save_scenario(os.path.join(out_dir, f"{name}.npz"), shrunk,
                  note=f"broken-by-construction: must keep flagging "
                       f"{sorted(final)}")
    yield name, shrunk


def main(out_dir, device="cuda"):
    os.makedirs(out_dir, exist_ok=True)
    from .runner import count_instructions
    for name, s in (*make_diff_entries(out_dir, device),
                    *make_invariant_entries(out_dir, device),
                    *make_wrap_entries(out_dir, device),
                    *make_fault_entries(out_dir, device)):
        print(f"{name}: {count_instructions(s.program)} instrs, "
              f"{s.n_active} threads, horizon {s.horizon}, "
              f"expect={s.meta['expect_classes']}")


if __name__ == "__main__":
    if not 2 <= len(sys.argv) <= 3:
        sys.exit(__doc__)
    main(*sys.argv[1:])
