"""Paper Table 1 — cyclomatic / NPath complexity of lock & unlock, computed
from the port's lock implementations' ASTs (same CFG-derived methodology
as the paper's oclint run; paper literals: Ticket 2/2, TWA 28/6,
QSpinLock 4320/18 for NPath/cyclomatic of lock; all unlocks are 1/1).

    python -m repro_torch.bench.table1_complexity

Prints the reference script's rows (``benchmarks/table1_complexity.py``).
The locks are host code: nothing runs on a device, and ``device`` is taken
only for ``bench.run``'s sake.
"""

from __future__ import annotations

from repro_torch.core.complexity import table1

from .common import emit, main


def run(*, device=None) -> list:
    rows = table1()
    for r in rows:
        emit(f"table1/{r.algorithm}/npath_lock", r.npath_lock, "")
        emit(f"table1/{r.algorithm}/npath_unlock", r.npath_unlock, "")
        emit(f"table1/{r.algorithm}/cyclomatic_lock", r.cyclomatic_lock, "")
        emit(f"table1/{r.algorithm}/cyclomatic_unlock", r.cyclomatic_unlock, "")
    by = {r.algorithm: r for r in rows}
    emit("table1/ordering_ok",
         int(by["ticket"].cyclomatic_lock < by["twa"].cyclomatic_lock),
         "paper: ticket < twa (and twa << qspinlock=18)")
    return rows


if __name__ == "__main__":
    main(run, "Table 1 (lock complexity)")
