"""Shared plumbing of the port's figure scripts: CSV rows, a timing helper
and the command line of one script.

Importing this module also surfaces the engine's INFO log line stating
which engine ``mode="auto"`` resolved to (``repro_torch.sim.engine``:
``"cuda"``, the lockVM kernel, on a GPU; ``"torch"``, the plain engine, on
the CPU) — a figure's output must say which engine produced its numbers
(an explicit ``mode=`` still wins; the line then simply doesn't appear).
"""

from __future__ import annotations

import argparse
import inspect
import logging
import sys
import time

_sim_log = logging.getLogger("repro_torch.sim")
if not _sim_log.handlers:  # idempotent; respects an app-configured logger
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    _sim_log.addHandler(_handler)
    _sim_log.setLevel(logging.INFO)


def emit(name: str, value, derived: str = "") -> None:
    """One CSV row: name,value,derived."""
    print(f"{name},{value},{derived}", flush=True)


def header() -> None:
    print("name,value,derived", flush=True)


def time_us(fn, *args, repeats: int = 3, **kw) -> float:
    """Median wall time of fn in microseconds."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kw)
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def main(run, description: str) -> None:
    """Command line of one figure script: ``--device cuda|cpu`` (default
    ``cuda``) and, where ``run`` takes it, ``--smoke``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    smoke = "smoke" in inspect.signature(run).parameters
    if smoke:
        ap.add_argument("--smoke", action="store_true",
                        help="the reference script's reduced grid")
    opts = ap.parse_args()
    kw = {"smoke": opts.smoke} if smoke else {}
    run(device=opts.device, **kw)
