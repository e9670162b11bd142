"""``recommend_lock``: answer "which lock for this workload?" from data.

The advisor never extrapolates a model — it only reads measured sweep
cells out of the results store.  Resolution is two-stage:

1. **exact** — rows whose coordinates equal the query on every key the
   caller provided.  The recommendation is the best measured configuration
   at that exact point.
2. **nearest** — no exact point exists, so the query snaps to the closest
   measured point in log2 space over the provided keys (thread counts,
   work amounts and the reader fraction all live on roughly geometric
   grids, so log distance treats 8→16 threads like 64→128, not like
   64→72).  The confidence tag tells the caller the answer is a
   neighbouring measurement, not their workload.

An empty store raises ``ValueError``: with zero measurements every answer
would be fabrication.
"""

from __future__ import annotations

import math

import numpy as np

# Query keys: the workload-description subset of the coordinate space.
# Everything else (seed, costs, horizon, ...) is a measurement detail the
# advisor aggregates over rather than matches on.
WORKLOAD_KEYS = ("n_threads", "cs_work", "outside_work", "reader_fraction")


def _log_distance(row: dict, workload: dict) -> float:
    return sum(abs(math.log2(1 + int(row[k])) - math.log2(1 + int(v)))
               for k, v in workload.items())


def _best_config(rows: list) -> dict:
    """Best (lock, n_threads, wa_size) by median throughput over ``rows``."""
    groups = {}
    for r in rows:
        groups.setdefault(
            (r["lock"], r["n_threads"], r["wa_size"]), []).append(r)
    scored = {key: float(np.median([r["throughput"] for r in rs]))
              for key, rs in groups.items()}
    (lock, n_threads, wa_size), tput = max(scored.items(),
                                           key=lambda kv: kv[1])
    return {"lock": lock, "n_threads": n_threads, "wa_size": wa_size,
            "throughput": tput,
            "n_rows": len(groups[(lock, n_threads, wa_size)])}


def recommend_lock(store, workload: dict) -> dict:
    """Recommend a lock (+ thread count and wa_size) for ``workload``.

    ``workload`` maps any subset of :data:`WORKLOAD_KEYS` to the target
    values, e.g. ``{"n_threads": 16, "cs_work": 4, "outside_work": 20}``.
    Keys left out are free: the advisor then also optimizes over them
    (omit ``n_threads`` to ask "and how many threads should I run?").

    Returns ``{"lock", "n_threads", "wa_size", "throughput", "confidence",
    "matched", "n_rows"}`` where ``confidence`` is ``"exact"`` when the
    query point itself was measured and ``"nearest"`` when the answer
    comes from the closest measured point (reported in ``"matched"``).
    """
    unknown = [k for k in workload if k not in WORKLOAD_KEYS]
    if unknown:
        raise ValueError(f"unknown workload keys {unknown}; "
                         f"valid keys: {list(WORKLOAD_KEYS)}")
    rows = store.load()
    if not rows:
        raise ValueError(
            f"results store {store.path} is empty — the advisor only "
            "answers from measured sweeps. Run a benchmark with "
            "REPRO_RESULTS_STORE set (e.g. repro_torch.bench."
            "fig3_mutexbench) first.")

    matched = [r for r in rows
               if all(r.get(k) == v for k, v in workload.items())]
    if matched:
        confidence = "exact"
    else:
        confidence = "nearest"
        nearest = min(rows, key=lambda r: _log_distance(r, workload))
        point = {k: nearest[k] for k in workload}
        matched = [r for r in rows
                   if all(r.get(k) == v for k, v in point.items())]

    rec = _best_config(matched)
    rec["confidence"] = confidence
    rec["matched"] = {k: matched[0][k] for k in WORKLOAD_KEYS}
    return rec
