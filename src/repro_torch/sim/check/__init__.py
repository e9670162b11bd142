"""sim.check — differential fuzzing & model checking for the port's lockVM.

Layers:
  * :mod:`oracle`       — a pure-NumPy sequential reference interpreter for
    the full ISA, executing the *same* packed program/layout arrays as
    ``sim.engine`` under the same :data:`engine.EVENT_ORDER_CONTRACT`.  It,
    the batch oracle and the C fast path are the referees, carried over
    from the reference package unchanged but for imports.
  * :mod:`batch_oracle` — a vectorized lockstep interpreter (NumPy) plus a
    compiled per-case C fast path (:mod:`_fastcase`), both bit-identical to
    the sequential reference — the fuzz-scale throughput layer.
  * :mod:`generate`     — structured random generators: well-formed random
    ISA programs, random lock/thread/wa/permit/cost geometries, composed
    scenarios wrapping every ``SIM_LOCKS`` generator in randomized critical
    sections with shared occupancy counters, and coverage-steering
    mutations of promoted cases.
  * :mod:`coverage`     — per-case coverage signatures (opcode/branch/spin
    histograms, lock x invariant-class, wrap/collision events) accumulated
    into a run-level :class:`~repro_torch.sim.check.coverage.CoverageMap`.
  * :mod:`invariants` + :mod:`runner` — oracle vs ``run_sweep`` differential
    execution (bit-identical stats in ``mode="torch"`` and ``mode="cuda"``,
    with a per-case randomized torch chunk and kernel state placement,
    shared memory or global scratch), engine-independent
    invariants (exclusion incl. the weighted rw probe, wrap-aware
    conservation/FIFO, per-thread liveness bounds, deadlock, collision),
    a greedy shrinker, coverage-guided steering, batched corpus replay,
    and a replayable ``.npz`` corpus format.

:mod:`invariants` holds the invariant catalog; ``python -m
repro_torch.sim.check --help`` the reproduce/shrink workflow.  The checker's
engines run on ``cuda`` unless given ``device="cpu"`` (``--device cpu``).
"""

from ..corpus import load_scenario, save_scenario
from .batch_oracle import BatchOracleResult, run_batch_oracle
from .coverage import BUCKETS, CoverageMap, case_signature
from .generate import (PAD_LOCKS, PAD_MEM_WORDS, PAD_THREADS, Scenario,
                       gen_composed_scenario, gen_geometry,
                       gen_random_scenario, generate_batch, mutate_scenario,
                       scenario_faults, splice_programs, with_fault_schedule)
from .invariants import active_classes, check_invariants
from .oracle import ORACLE_MUTATIONS, Trace, run_oracle
from .runner import (CUDA_STATE_POOL, MODES, TORCH_CHUNK_POOL, FuzzReport,
                     SteerResult, case_fails, case_problems, check_case,
                     count_instructions, cuda_states, failure_classes, fuzz,
                     oracle_impl, reference_stall, replay_corpus,
                     run_engine_batch, run_oracle_case, shrink, steer,
                     torch_chunks)

__all__ = [
    "Scenario", "gen_geometry", "gen_random_scenario",
    "gen_composed_scenario", "generate_batch", "mutate_scenario",
    "scenario_faults", "splice_programs", "with_fault_schedule",
    "PAD_THREADS", "PAD_LOCKS", "PAD_MEM_WORDS",
    "run_oracle", "Trace", "ORACLE_MUTATIONS",
    "run_batch_oracle", "BatchOracleResult",
    "CoverageMap", "case_signature", "BUCKETS", "active_classes",
    "check_invariants", "check_case", "case_problems", "case_fails",
    "failure_classes", "fuzz", "FuzzReport", "shrink",
    "steer", "SteerResult", "replay_corpus",
    "count_instructions", "run_engine_batch", "run_oracle_case",
    "save_scenario", "load_scenario", "MODES",
    "torch_chunks", "TORCH_CHUNK_POOL", "cuda_states", "CUDA_STATE_POOL",
    "oracle_impl", "reference_stall",
]
