"""Persistent results store + lock advisor for lockVM sweeps.

Every :func:`repro_torch.sim.workloads.run_sweep` call appends its cells
to the JSONL store named by the ``REPRO_RESULTS_STORE`` environment
variable (when set); :func:`recommend_lock` answers "which lock for this
workload?" from the accumulated measurements.  CLI:
``python -m repro_torch.sim.results --help``.

The port's copy of the reference's store: the same JSONL rows (schema v2),
so one file is readable by both packages.  The port's rows carry ``mode``
``"torch"`` or ``"cuda"`` (the engine that measured them); ``mode`` is not
a workload key, so the advisor aggregates over it.
"""

from .advisor import WORKLOAD_KEYS, recommend_lock
from .schema import (ALL_KEYS, COORD_KEYS, SCHEMA_VERSION, VALUE_KEYS,
                     migrate, row_from_result)
from .store import ResultsStore

__all__ = [
    "ALL_KEYS", "COORD_KEYS", "ResultsStore", "SCHEMA_VERSION",
    "VALUE_KEYS", "WORKLOAD_KEYS", "migrate", "recommend_lock",
    "row_from_result",
]
