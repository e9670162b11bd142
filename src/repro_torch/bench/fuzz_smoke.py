"""Fuzz smoke — the ``sim.check`` differential fuzzer as a benchmark suite.

    python -m repro_torch.bench.fuzz_smoke [--device cuda|cpu] [--smoke]
                                           [--json PATH]

Three stages, as the reference's suite (``benchmarks/fuzz_smoke.py``), each
also callable alone:

  1. **Differential smoke** (:func:`run_differential`) — a small
     deterministic batch (composed lock scenarios + random ISA programs)
     through the oracle and every engine mode of the device
     (:data:`repro_torch.sim.check.MODES`: the plain engine, and on a GPU
     also the lockVM kernel), asserting zero differential/invariant
     failures; then (:func:`run_mutation`) mutation self-tests
     (``eager_store``, through BOTH the sequential and the batch oracle
     path, against the engine ``mode="auto"`` picks on the device)
     proving the checker still catches what it claims to catch.
  2. **Batch-oracle gate** (:func:`batch_gate`) — the sequential oracle
     and the batch oracle both run a fresh ≥1000-case batch (traces on —
     the fuzz config); every stat, trace row and exit reason must agree
     bit for bit there AND over the checked-in ``tests/corpus``, and the
     batch path must be ≥ ``SPEEDUP_GATE``× the sequential cases/sec.
     Timing runs with the GC disabled (standard ``timeit`` practice).
     This stage runs on the host alone.
  3. **JSON point** — both throughputs, the ratio, and the divergence
     counts, written where ``--json`` names a path.

Prints the reference suite's ``fuzz/*`` rows.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.sim.check import (MODES, fuzz, generate_batch,
                                   load_scenario, run_batch_oracle,
                                   run_oracle_case)
from repro_torch.sim.check import _fastcase
from repro_torch.sim.check.runner import STAT_KEYS
from repro_torch.sim.engine import choose_mode

from .common import emit

CASES = 48
SMOKE_CASES = 24  # 14/0.6 threshold: every SIM_LOCKS entry composed once
SEED = 20260731

# Batch-oracle gate config (the "CI CPU fuzz config"): fresh-batch size,
# required batch/sequential throughput ratio, and timing repeats.
BENCH_CASES = 1000
SMOKE_BENCH_CASES = 300
SPEEDUP_GATE = 50.0
BATCH_REPEATS = 5

CORPUS_DIR = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                          os.pardir, "tests", "corpus")


def device_modes(device) -> tuple:
    """The engine modes a device runs: ``("torch",)`` on the CPU, every
    one of :data:`MODES` on a GPU."""
    dev = resolve_device(device)
    return tuple(m for m in MODES if m != "cuda" or dev.type == "cuda")


def _diff_case(stats_a, trace_a, stats_b, trace_b) -> bool:
    """True when the two oracle runs differ in any stat or trace bit."""
    for k in STAT_KEYS:
        if not np.array_equal(np.asarray(stats_a[k]), np.asarray(stats_b[k])):
            return True
    return (trace_a.acquires != trace_b.acquires
            or trace_a.fadds != trace_b.fadds
            or trace_a.exit_reason != trace_b.exit_reason)


def _count_divergences(scenarios, seq_runs, bres) -> int:
    return sum(_diff_case(seq_runs[i][0], seq_runs[i][1],
                          bres.stats[i], bres.traces[i])
               for i in range(len(scenarios)))


def _corpus_divergences() -> tuple[int, int]:
    """(entries, divergences) of batch vs sequential over tests/corpus."""
    paths = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.npz")))
    n_div = 0
    for p in paths:
        s = load_scenario(p)
        seq = [run_oracle_case(s)]
        bres = run_batch_oracle([s])
        n_div += _count_divergences([s], seq, bres)
    return len(paths), n_div


def run_differential(scenarios, *, device=None):
    """Stage 1: oracle vs every engine mode of the device (randomized
    torch chunk and kernel state placement) + invariants."""
    modes = device_modes(device)
    t0 = time.time()
    report = fuzz(scenarios, modes=modes, sched_seed=SEED, device=device)
    dt = time.time() - t0
    emit("fuzz/cases", len(scenarios),
         f"composed+random, seed={SEED}, modes={'/'.join(modes)}")
    emit("fuzz/oracle_events", report.total_events,
         f"{report.total_events / max(dt, 1e-9):,.0f} events/s")
    emit("fuzz/failures", len(report.failures),
         "differential+invariants" if report.ok else report.summary())
    assert report.ok, report.summary()
    return report


def run_mutation(scenarios, *, batch_oracle: bool, device=None):
    """Stage 1's self-test: an injected store-visibility bug MUST be caught
    (through the sequential oracle, or with ``batch_oracle`` through the
    batch-oracle path)."""
    mode = choose_mode(resolve_device(device))
    mutated = fuzz(scenarios, modes=(mode,), oracle_mutate=("eager_store",),
                   batch_oracle=batch_oracle, device=device)
    if batch_oracle:
        emit("fuzz/mutation_caught_batch", len(mutated.failures),
             "eager_store through the batch oracle (must be > 0)")
        assert not mutated.ok, "eager_store not caught via batch oracle"
    else:
        emit("fuzz/mutation_caught", len(mutated.failures),
             "eager_store self-test (must be > 0)")
        assert not mutated.ok, "eager_store mutation was not caught"
    return mutated


def batch_gate(bench_cases: int) -> dict:
    """Stage 2's measurement: sequential and batch oracle over a fresh
    batch and the corpus; emits the rows and returns the numbers (the
    gate's assertions are :func:`check_batch_gate`)."""
    bench = generate_batch(bench_cases, SEED + 1)
    gc_was = gc.isenabled()
    gc.disable()
    try:
        t0 = time.time()
        seq_runs = [run_oracle_case(s) for s in bench]
        seq_dt = time.time() - t0
        # one untimed warmup (first call pays library page-in + allocator
        # growth), then fastest-of-N — the timeit rationale: slower repeats
        # measure scheduler noise, not the code
        bres = run_batch_oracle(bench, collect_trace=True,
                                collect_coverage=True)
        batch_dts = []
        for _ in range(BATCH_REPEATS):
            t0 = time.time()
            bres = run_batch_oracle(bench, collect_trace=True,
                                    collect_coverage=True)
            batch_dts.append(time.time() - t0)
        batch_dt = min(batch_dts)
    finally:
        if gc_was:
            gc.enable()
    divergences = _count_divergences(bench, seq_runs, bres)
    n_corpus, corpus_div = _corpus_divergences()
    seq_cps = bench_cases / seq_dt
    batch_cps = bench_cases / batch_dt
    speedup = batch_cps / seq_cps
    impl = "c" if _fastcase.HAVE_FAST else "numpy"
    emit("fuzz/seq_cases_per_sec", f"{seq_cps:.1f}",
         f"sequential oracle, {bench_cases} cases, traces on")
    emit("fuzz/batch_cases_per_sec", f"{batch_cps:.1f}",
         f"batch oracle (impl={impl}), traces+coverage on, "
         f"fastest of {BATCH_REPEATS}")
    emit("fuzz/batch_speedup", f"{speedup:.1f}",
         f"gate >= {SPEEDUP_GATE}x")
    emit("fuzz/batch_divergences", divergences,
         f"vs sequential over the {bench_cases}-case fresh batch")
    emit("fuzz/corpus_divergences", corpus_div,
         f"vs sequential over {n_corpus} tests/corpus entries")
    return {"bench_cases": bench_cases, "seq_cps": seq_cps,
            "batch_cps": batch_cps, "speedup": speedup,
            "divergences": divergences, "corpus_div": corpus_div,
            "n_corpus": n_corpus, "impl": impl}


def check_batch_gate(gate: dict) -> None:
    """Stage 2's assertions: no divergence, the C path, the speedup."""
    assert gate["divergences"] == 0, \
        f"{gate['divergences']} batch-vs-sequential divergences on the " \
        "fresh batch"
    assert gate["corpus_div"] == 0, \
        f"{gate['corpus_div']} batch-vs-sequential divergences on " \
        "tests/corpus"
    assert gate["impl"] == "c", \
        "no C compiler found — the batch-oracle fast path (and with it " \
        "the throughput gate) is unavailable"
    assert gate["speedup"] >= SPEEDUP_GATE, \
        f"batch oracle {gate['speedup']:.1f}x sequential, gate " \
        f"{SPEEDUP_GATE}x"


def run(smoke: bool = False, json_path: str | None = None, *,
        device=None) -> dict:
    n_cases = SMOKE_CASES if smoke else CASES
    scenarios = generate_batch(n_cases, SEED)
    report = run_differential(scenarios, device=device)
    mutated = run_mutation(scenarios, batch_oracle=False, device=device)
    mutated_b = run_mutation(scenarios, batch_oracle=True, device=device)

    # ---- batch-oracle throughput gate + bit-identity sweep ----
    gate = batch_gate(SMOKE_BENCH_CASES if smoke else BENCH_CASES)
    check_batch_gate(gate)

    point = {
        "suite": "fuzz_smoke",
        "config": {"bench_cases": gate["bench_cases"], "seed": SEED + 1,
                   "smoke": smoke, "traces": True, "coverage": True,
                   "batch_impl": gate["impl"],
                   "batch_repeats": BATCH_REPEATS,
                   "modes": list(device_modes(device))},
        "sequential_cases_per_sec": round(gate["seq_cps"], 2),
        "batch_cases_per_sec": round(gate["batch_cps"], 2),
        "speedup": round(gate["speedup"], 2),
        "speedup_gate": SPEEDUP_GATE,
        "divergences_fresh_batch": gate["divergences"],
        "divergences_corpus": gate["corpus_div"],
        "corpus_entries": gate["n_corpus"],
        "smoke_failures": len(report.failures),
        "mutation_caught": len(mutated.failures),
        "mutation_caught_batch": len(mutated_b.failures),
    }
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(point, f, indent=1)
        emit("fuzz/json", json_path, "fuzz point")
    return point


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.fuzz_smoke")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None,
                    help="write the throughput/divergence point here")
    args = ap.parse_args()
    run(smoke=args.smoke, json_path=args.json, device=args.device)
