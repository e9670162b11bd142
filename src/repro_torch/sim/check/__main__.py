"""CLI for the differential fuzzer — the CI entry point.

    PYTHONPATH=src python -m repro_torch.sim.check --cases 1024 \
        --batch-oracle --fault-fraction 0.25 --trace-fraction 0.1 --modes cuda
    PYTHONPATH=src python -m repro_torch.sim.check --device cpu --cases 200

Runs a mixed batch (composed lock scenarios + random ISA programs) through
the oracle and the engine modes named by ``--modes`` (``torch``, the plain
engine; ``cuda``, the lockVM kernel), checks the invariant catalog, and on
failure greedily shrinks the first failing case and writes it as a
replayable ``.npz`` under ``--artifact-dir`` before exiting nonzero.

The engines run on ``--device`` (default ``cuda``: with no GPU the run
raises).  ``--modes`` defaults to both modes on a CUDA device and to
``torch`` with ``--device cpu``; ``cuda`` never runs on the CPU.  The
oracle side always runs on the host.

``--seed from-run-id`` derives the seed from ``$GITHUB_RUN_ID`` (falling
back to 0), so every CI run explores a fresh region while staying exactly
reproducible from the run id.

``--mutate <name>`` injects a known oracle bug (see
``oracle.ORACLE_MUTATIONS``) — the run then MUST fail; this is the
self-test that proves the checker can catch what it claims to catch.

Fuzz-scale switches:

  * ``--batch-oracle``    — run the oracle side through the vectorized
    batch oracle (bit-identical, ~50-100x the cases/sec); the run prints
    which referee ran (its compiled C path, or NumPy without ``cc``).
  * ``--steer``           — coverage-guided generation: signature-novel
    cases are promoted into a pool and mutated in preference to uniform
    redraw (implies ``--batch-oracle``).
  * ``--coverage-report`` — write the run-level coverage map (report +
    signatures) as JSON; the nightly lane uploads it as an artifact.
  * ``--corpus-out``      — write every promoted pool scenario as a
    replayable ``.npz`` (the nightly's expanded-corpus artifact).
  * ``--replay``          — a ``.npz`` file replays one case; a directory
    replays every entry as padded batches (one engine dispatch per mode
    per shape group) and checks each against its ``expect_classes`` pin,
    printing the missing/unexpected classes per mismatching entry and
    exiting nonzero on any mismatch.
  * ``--promote DIR``     — with ``--replay``: triage mode.  Each replayed
    entry is re-saved into ``DIR`` (e.g. ``tests/torch_corpus/``) with its
    *observed* failure classes pinned as ``expect_classes``, turning a
    fresh fuzz artifact into a regression-pinned corpus entry.
  * ``--fault-fraction``  — decorate that fraction of generated cases with
    a drawn fault schedule (preemptions / spurious wakes / aborts); 0
    reproduces historical fault-free batches byte for byte.
  * ``--trace-fraction``  — replace that fraction of generated cases with
    trace-compiled workloads (quantized arrival/hold tables, see
    ``repro_torch.sim.traces``); 0 reproduces historical batches byte for byte.
  * ``--coverage-in``     — seed the coverage map from a previous run's
    ``--coverage-report`` JSON, so novelty judgments (and the promoted
    pool) are cumulative across nightly runs.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from ...device import resolve_device
from . import (MODES, count_instructions, failure_classes, fuzz,
               generate_batch, load_scenario, replay_corpus,
               save_scenario, shrink, steer)


def default_modes(device: str) -> tuple:
    """Both engine modes on a CUDA device; the plain engine on the CPU."""
    return MODES if device.startswith("cuda") else ("torch",)


def _resolve_seed(spec: str) -> int:
    if spec == "from-run-id":
        return int(os.environ.get("GITHUB_RUN_ID", "0")) & 0x7FFFFFFF
    return int(spec)


def _replay(args, modes, mutate) -> int:
    """Replay a corpus entry (file) or a whole corpus (directory)."""
    if os.path.isdir(args.replay):
        paths = sorted(glob.glob(os.path.join(args.replay, "*.npz")))
    else:
        paths = [args.replay]
    if not paths:
        print(f"no .npz entries under {args.replay}")
        return 2
    t0 = time.time()
    problems = replay_corpus(paths, modes=modes, oracle_mutate=mutate,
                             batch_oracle=args.batch_oracle,
                             device=args.device)
    bad = 0
    for path, probs in zip(paths, problems):
        expect = set(load_scenario(path).meta.get("expect_classes", []))
        got = failure_classes(probs)
        status = "ok" if got == expect else "MISMATCH"
        bad += status != "ok"
        print(f"  {os.path.basename(path)}: expect={sorted(expect)} "
              f"got={sorted(got)} {status}")
        if status != "ok":
            missing, unexpected = expect - got, got - expect
            if missing:
                print(f"    missing classes: {sorted(missing)} "
                      f"(pinned failure no longer reproduces)")
            if unexpected:
                print(f"    unexpected classes: {sorted(unexpected)}")
            for p in probs[:4]:
                print(f"    {p}")
    if args.promote:
        os.makedirs(args.promote, exist_ok=True)
        for path, probs in zip(paths, problems):
            s = load_scenario(path)
            classes = sorted(failure_classes(probs))
            s = s.replace(meta={**s.meta, "expect_classes": classes})
            dest = os.path.join(args.promote, os.path.basename(path))
            save_scenario(dest, s,
                          note=s.meta.get("note", "")
                          or "; ".join(probs[:4]))
            print(f"  promoted {os.path.basename(path)} -> {dest} "
                  f"(expect_classes={classes})")
        print(f"promoted {len(paths)} triaged entries into {args.promote}")
        return 0
    print(f"replayed {len(paths)} entries in {time.time() - t0:.1f}s, "
          f"{bad} mismatching")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sim.check")
    ap.add_argument("--device", default=None,
                    help="where the engines run: cuda (the default; with no "
                         "GPU the run raises) or cpu")
    ap.add_argument("--cases", type=int, default=200)
    ap.add_argument("--seed", default="0",
                    help="int, or 'from-run-id' to derive from "
                         "$GITHUB_RUN_ID")
    ap.add_argument("--modes", default="",
                    help="comma-separated engine modes to diff (torch, "
                         "cuda); default both on cuda, torch on cpu")
    ap.add_argument("--artifact-dir", default="",
                    help="where to write the shrunk failing case (.npz)")
    ap.add_argument("--mutate", default="",
                    help="inject a named oracle bug (self-test: must fail)")
    ap.add_argument("--replay", default="",
                    help="replay a corpus .npz (or a directory of them) "
                         "instead of generating")
    ap.add_argument("--promote", default="",
                    help="with --replay: re-save every replayed entry into "
                         "this directory with its observed failure classes "
                         "pinned as expect_classes")
    ap.add_argument("--fault-fraction", type=float, default=0.0,
                    help="fraction of generated cases decorated with a "
                         "drawn fault schedule (0 = fault-free batches, "
                         "byte-identical to historical runs)")
    ap.add_argument("--trace-fraction", type=float, default=0.0,
                    help="fraction of generated cases replaced with "
                         "trace-compiled workloads (0 = historical "
                         "batches, byte-identical)")
    ap.add_argument("--coverage-in", default="",
                    help="seed the coverage map from a previous run's "
                         "--coverage-report JSON (cumulative novelty)")
    ap.add_argument("--no-shrink", action="store_true")
    ap.add_argument("--batch-oracle", action="store_true",
                    help="vectorized batch oracle for the oracle side")
    ap.add_argument("--steer", action="store_true",
                    help="coverage-guided generation (implies "
                         "--batch-oracle)")
    ap.add_argument("--batch-size", type=int, default=256,
                    help="cases per steering round (with --steer)")
    ap.add_argument("--coverage-report", default="",
                    help="write the coverage map as JSON here")
    ap.add_argument("--corpus-out", default="",
                    help="write promoted (coverage-novel) scenarios here "
                         "(with --steer)")
    args = ap.parse_args(argv)

    args.device = str(resolve_device(args.device))
    seed = _resolve_seed(args.seed)
    modes = (tuple(m for m in args.modes.split(",") if m)
             or default_modes(args.device))
    mutate = tuple(m for m in args.mutate.split(",") if m)

    if args.replay:
        print(f"replaying {args.replay}")
        return _replay(args, modes, mutate)

    t0 = time.time()
    coverage = None
    if args.coverage_in:
        from .coverage import CoverageMap
        coverage = CoverageMap.load(args.coverage_in)
        print(f"seeded coverage map from {args.coverage_in} "
              f"({coverage.n_signatures} prior signatures)")
    if args.steer:
        res = steer(args.cases, seed, modes=modes,
                    batch_size=args.batch_size, coverage=coverage,
                    fault_fraction=args.fault_fraction,
                    trace_fraction=args.trace_fraction, device=args.device)
        report, coverage = res.report, res.coverage
        print(f"steered {report.n_cases} cases (seed={seed}): "
              f"{len(res.pool)} promoted, {res.n_mutants} mutants, "
              f"{coverage.n_signatures} signatures")
        if args.corpus_out and res.pool:
            os.makedirs(args.corpus_out, exist_ok=True)
            for i, s in enumerate(res.pool):
                save_scenario(
                    os.path.join(args.corpus_out,
                                 f"steer_seed{seed}_{i:05d}.npz"),
                    s, note=f"coverage-promoted (steer seed={seed})")
            print(f"wrote {len(res.pool)} promoted cases to "
                  f"{args.corpus_out}")
    else:
        if args.coverage_report and args.batch_oracle and coverage is None:
            from .coverage import CoverageMap
            coverage = CoverageMap()
        scenarios = generate_batch(args.cases, seed,
                                   fault_fraction=args.fault_fraction,
                                   trace_fraction=args.trace_fraction)
        print(f"generated {len(scenarios)} scenarios (seed={seed})")
        report = fuzz(scenarios, modes=modes, oracle_mutate=mutate,
                      sched_seed=seed, batch_oracle=args.batch_oracle,
                      coverage=coverage if args.batch_oracle else None,
                      device=args.device)
    dt = time.time() - t0
    print(report.summary())
    print(f"oracle: {report.oracle_impl}; engines: {','.join(modes)} on "
          f"{args.device}; placements: "
          + ", ".join(f"{k}={v}"
                      for k, v in sorted(report.placements.items())))
    print(f"elapsed {dt:.1f}s "
          f"({report.total_events / max(dt, 1e-9):,.0f} oracle events/s, "
          f"{report.n_cases / max(dt, 1e-9):,.1f} cases/s)")
    if args.coverage_report and coverage is not None:
        coverage.save(args.coverage_report)
        rep = coverage.report()
        print(f"coverage: {rep['n_signatures']} signatures over "
              f"{rep['n_cases']} cases -> {args.coverage_report}")
        if rep["opcodes_never_executed"]:
            print(f"  opcodes never executed: "
                  f"{','.join(rep['opcodes_never_executed'])}")

    if report.ok:
        if mutate:
            print(f"SELF-TEST FAILURE: mutation {mutate} was NOT caught")
            return 2
        return 0

    idx, scenario, problems = report.failures[0]
    print(f"\nfirst failing case {idx}: {problems[0]}")
    if not args.no_shrink:
        # shrink against the modes that actually diverged (a cuda-only
        # bug must stay visible to the shrink predicate); invariant-only
        # failures re-check with the first mode asked for
        failed_modes = tuple(sorted(
            {p.split("[", 1)[1].split("]", 1)[0] for p in problems
             if p.startswith("differential[")})) or modes[:1]
        print(f"shrinking (modes={','.join(failed_modes)} + invariants) ...")
        try:
            scenario = shrink(scenario, modes=failed_modes,
                              oracle_mutate=mutate, device=args.device)
            print(f"shrunk to {count_instructions(scenario.program)} "
                  f"instructions, {scenario.n_active} threads, "
                  f"horizon {scenario.horizon}")
        except Exception as e:  # noqa: BLE001 - still save the witness
            print(f"shrink failed ({e!r}); saving the unshrunk case")
    if args.artifact_dir:
        os.makedirs(args.artifact_dir, exist_ok=True)
        path = os.path.join(args.artifact_dir,
                            f"shrunk_seed{seed}_case{idx}.npz")
        save_scenario(path, scenario, note="; ".join(problems[:4]))
        print(f"wrote {path} — replay with: python -m repro_torch.sim.check "
              f"--replay {path}")
    if mutate:
        how = "caught (shrink skipped)" if args.no_shrink \
            else "caught and shrunk"
        print(f"self-test OK: mutation {mutate} {how}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
