"""Row schema for the lockVM results store.

One row = one sweep cell, flattened to JSON scalars: the full cell
coordinates (every :class:`~repro_torch.sim.workloads.SweepSpec` axis plus
the shared knobs that change the measurement — horizon, n_locks, resolved
engine mode, coherence costs) and the measured values (throughput,
handover, event counts, and the log2 acquire-latency histogram with its
p50/p99/p999 summaries when the sweep collected latency).

Rows are stamped with ``schema_version``; :func:`migrate` upgrades any
older row to the current schema on read, so a store written by an earlier
checkout stays queryable forever without rewriting the file.
"""

from __future__ import annotations

import numpy as np

SCHEMA_VERSION = 2

# Coordinate keys: together they name WHERE in workload space the row was
# measured.  Every row must carry every one of them — the advisor's exact
# lookup and nearest-bin fallback both match on these.  ``workload``
# (schema v2) names the workload *generator*: "synthetic" for the scalar
# mutexbench axes, "trace:<name>" for a cell whose program was compiled
# from a recorded serve trace (repro_torch.sim.traces) — the cs_work /
# outside_work / reader_fraction coordinates of a trace row are the
# trace's representative medians, not program constants.
COORD_KEYS = (
    "lock", "n_threads", "seed", "cs_work", "outside_work",
    "private_arrays", "wa_size", "long_term_threshold", "sem_permits",
    "reader_fraction", "preempt_faults", "spurious_faults", "abort_faults",
    "n_locks", "horizon", "mode", "costs", "workload",
)

# Value keys: WHAT was measured there.  The lat_* columns are None for
# sweeps run with collect_latency=False (no TSTART marks -> no samples).
VALUE_KEYS = (
    "throughput", "avg_handover", "acquisitions", "waited_acquisitions",
    "events", "sleeping", "lat_p50", "lat_p99", "lat_p999", "lat_hist",
    "pad_stats",
)

ALL_KEYS = COORD_KEYS + VALUE_KEYS + ("schema_version",)

# Defaults filled in by migrate() for coordinates that predate their axis.
# Every pre-v2 row was a synthetic-axes sweep (the trace compiler did not
# exist), so "synthetic" is a fact about old rows, not a guess.
_V0_COORD_DEFAULTS = {
    "outside_work": 0,
    "preempt_faults": 0,
    "spurious_faults": 0,
    "abort_faults": 0,
    "mode": "unknown",
    "workload": "synthetic",
}


def _jsonify(v):
    """Coerce numpy scalars/arrays (and nested containers) to JSON types."""
    if isinstance(v, np.ndarray):
        return [_jsonify(x) for x in v.tolist()]
    if isinstance(v, (np.integer, np.bool_)):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, dict):
        return {k: _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    return v


def row_from_result(res: dict) -> dict:
    """Flatten one :func:`repro_torch.sim.workloads.run_sweep` result to a
    row.

    Per-thread arrays are totalled (the store keeps cell-level numbers; the
    per-thread breakdown stays with the in-memory result), ``costs``
    serializes as its 9-int array, and the latency columns ride along only
    when the sweep collected them.
    """
    row = {
        "schema_version": SCHEMA_VERSION,
        "lock": res["lock"],
        "n_threads": int(res["n_threads"]),
        "seed": int(res["seed"]),
        "cs_work": int(res["cs_work"]),
        "outside_work": int(res["outside_work"]),
        "private_arrays": bool(res["private_arrays"]),
        "wa_size": int(res["wa_size"]),
        "long_term_threshold": int(res["long_term_threshold"]),
        "sem_permits": int(res["sem_permits"]),
        "reader_fraction": int(res["reader_fraction"]),
        "preempt_faults": int(res["preempt_faults"]),
        "spurious_faults": int(res["spurious_faults"]),
        "abort_faults": int(res["abort_faults"]),
        "n_locks": int(res["n_locks"]),
        "horizon": int(res["horizon"]),
        "mode": str(res["mode"]),
        "costs": _jsonify(res["costs"].to_array()),
        "workload": str(res.get("workload", "synthetic")),
        "throughput": float(res["throughput"]),
        "avg_handover": float(res["avg_handover"]),
        "acquisitions": int(np.asarray(res["acquisitions"]).sum()),
        "waited_acquisitions": int(
            np.asarray(res["waited_acquisitions"]).sum()),
        "events": int(res["events"]),
        "sleeping": int(res["sleeping"]),
        "lat_p50": _jsonify(res.get("lat_p50")),
        "lat_p99": _jsonify(res.get("lat_p99")),
        "lat_p999": _jsonify(res.get("lat_p999")),
        "lat_hist": _jsonify(res.get("lat_hist")),
        "pad_stats": _jsonify(res.get("pad_stats")),
    }
    return row


def migrate(row: dict) -> dict:
    """Upgrade a stored row to ``SCHEMA_VERSION`` (no-op when current).

    Version 0 (rows written before the store grew a version stamp) lacked
    the ``outside_work`` and fault-count coordinates and every latency
    column; they migrate by filling the axis defaults — a v0 measurement
    IS the outside_work=0, fault-free point — with ``None`` latency
    columns (those sweeps sampled nothing, and inventing zeros would let
    percentile queries silently succeed on unmeasured data).  Version 1
    rows additionally lack the ``workload`` coordinate; they fill
    ``"synthetic"`` — every pre-v2 sweep was one (``setdefault`` makes the
    v0 fills no-ops on rows that already carry their axes).
    """
    version = int(row.get("schema_version", 0))
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"results row has schema_version={version}, newer than this "
            f"checkout's {SCHEMA_VERSION} — refusing to guess at a "
            "downgrade; update the code reading this store.")
    if version == SCHEMA_VERSION:
        return row
    out = dict(row)
    for key, default in _V0_COORD_DEFAULTS.items():
        out.setdefault(key, default)
    for key in ("lat_p50", "lat_p99", "lat_p999", "lat_hist", "pad_stats"):
        out.setdefault(key, None)
    out["schema_version"] = SCHEMA_VERSION
    missing = [k for k in COORD_KEYS if k not in out]
    if missing:
        raise ValueError(
            f"cannot migrate results row: coordinate keys {missing} are "
            "missing and have no v0 default — the row does not name a "
            "workload-space point.")
    return out
