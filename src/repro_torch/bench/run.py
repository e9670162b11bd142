"""Benchmark runner of the port — one module per paper table and figure,
the serve↔lockVM loop, the host-lock benchmarks (``table1``, ``threads``,
``admission``) and the fuzz smoke.  Prints ``name,value,derived`` CSV.

    PYTHONPATH=src python -m repro_torch.bench.run [--only fig3,fig5]
        [--smoke] [--results store.jsonl] [--device cuda|cpu]

The counterpart of the reference's runner (``benchmarks/run.py``), over the
suites the port has.  ``--smoke`` asks each suite that supports it (fig8,
fig9, fig10, fig12deg, fig13, admission, fuzz) for the reference's reduced
grid.
``--results PATH`` persists every figure's sweep cells into the JSONL
results store at PATH (the ``REPRO_RESULTS_STORE`` hook in
``repro_torch.sim.workloads.run_sweeps``), which ``python -m
repro_torch.sim.results`` then queries.  ``--device`` is where every suite
runs: ``cuda`` (the default; the lockVM sweeps launch the lockVM kernel)
or ``cpu`` (the plain engine).  A suite that raises is reported and the
rest still run; the run then exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import time

from .common import emit, header

SUITES = [
    ("table1", "repro_torch.bench.table1_complexity"),
    ("fig1", "repro_torch.bench.fig1_invalidation_diameter"),
    ("fig2", "repro_torch.bench.fig2_interlock_interference"),
    ("fig3", "repro_torch.bench.fig3_mutexbench"),
    ("fig5", "repro_torch.bench.fig5_throw"),
    ("fig6", "repro_torch.bench.fig6_rrc"),
    ("fig7", "repro_torch.bench.fig7_stress_latency"),
    ("fig8", "repro_torch.bench.fig8_collisions"),
    ("fig9", "repro_torch.bench.fig9_cost_grid"),
    ("fig10", "repro_torch.bench.fig10_rw_scaling"),
    ("fig11", "repro_torch.bench.fig11_locktorture"),
    ("fig12deg", "repro_torch.bench.fig12_degradation"),
    ("fig13", "repro_torch.bench.fig13_serve_e2e"),
    ("threads", "repro_torch.bench.threads_microbench"),
    ("admission", "repro_torch.bench.framework_admission"),
    ("fuzz", "repro_torch.bench.fuzz_smoke"),
]


def run_suite(name: str, *, smoke: bool = False, device=None):
    """Run one suite of :data:`SUITES` on ``device`` and return what its
    ``run`` returns; its CSV rows go to stdout."""
    mod = importlib.import_module(dict(SUITES)[name])
    kw = {"device": device}
    if smoke and "smoke" in inspect.signature(mod.run).parameters:
        kw["smoke"] = True
    return mod.run(**kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated suite prefixes to run")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grids for suites that support it")
    ap.add_argument("--results", default="",
                    help="persist every sweep into this JSONL results store")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    only = [s for s in args.only.split(",") if s]
    if args.results:
        from repro_torch.sim.workloads import RESULTS_STORE_ENV
        os.environ[RESULTS_STORE_ENV] = args.results

    header()
    t_start = time.time()
    failures = []
    for name, _ in SUITES:
        if only and not any(name.startswith(o) for o in only):
            continue
        t0 = time.time()
        try:
            run_suite(name, smoke=args.smoke, device=args.device)
            emit(f"{name}/_elapsed_s", f"{time.time() - t0:.1f}", "ok")
        except Exception as e:  # keep the suite going; report at the end
            failures.append((name, repr(e)))
            emit(f"{name}/_elapsed_s", f"{time.time() - t0:.1f}",
                 f"FAILED: {e!r}")
    emit("run/_total_s", f"{time.time() - t_start:.1f}",
         f"failures={len(failures)}")
    if failures:
        raise SystemExit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
