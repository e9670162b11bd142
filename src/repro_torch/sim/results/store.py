"""Append-only JSONL results store.

One line per sweep cell (:mod:`repro_torch.sim.results.schema` rows).
JSONL keeps appends atomic-enough for the one-writer-at-a-time benchmark
flows (the figure scripts run sequentially), diffs cleanly in git, and
needs no dependency the container doesn't already have.

Writes validate; reads migrate.  A row that doesn't carry the full
coordinate set is rejected with ``ValueError`` at append time — a stored
point that can't be located in workload space would poison every advisor
query, and dropping it silently would mask the writer bug.  Old-version
rows are upgraded in memory by
:func:`~repro_torch.sim.results.schema.migrate` on every load, so the file
itself never needs rewriting (``rewrite()`` exists for when a persistent
upgrade is wanted anyway).
"""

from __future__ import annotations

import json
from pathlib import Path

from .schema import ALL_KEYS, COORD_KEYS, migrate, row_from_result


class ResultsStore:
    """A results store at ``path`` (created on first append)."""

    def __init__(self, path):
        self.path = Path(path)

    # -- writing -----------------------------------------------------------

    def validate_row(self, row: dict) -> None:
        """Reject rows that do not name a complete workload-space point."""
        missing = [k for k in COORD_KEYS if k not in row]
        if missing:
            raise ValueError(
                f"results row rejected: missing coordinate keys {missing} "
                "— every row must carry the full coordinate set "
                "(schema.COORD_KEYS) so advisor lookups can locate it.")
        unknown = [k for k in row if k not in ALL_KEYS]
        if unknown:
            raise ValueError(
                f"results row rejected: unknown keys {unknown} — the "
                "schema owns the column set; add new columns to "
                "schema.VALUE_KEYS (with a migrate() rule) instead of "
                "writing ad-hoc fields.")

    def append_rows(self, rows: list) -> int:
        """Append validated rows; returns the number written.

        All rows are validated before any is written, so a bad batch
        leaves the store untouched rather than half-appended.
        """
        rows = list(rows)
        for row in rows:
            self.validate_row(row)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
        return len(rows)

    def append_sweep(self, results: list) -> int:
        """Append one :func:`repro_torch.sim.workloads.run_sweep` result
        list."""
        return self.append_rows(row_from_result(r) for r in results)

    # -- reading -----------------------------------------------------------

    def load(self) -> list:
        """All rows, migrated to the current schema (empty if no file)."""
        if not self.path.exists():
            return []
        rows = []
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    rows.append(migrate(json.loads(line)))
        return rows

    def query(self, **coords) -> list:
        """Rows whose coordinates equal every given ``key=value``."""
        unknown = [k for k in coords if k not in COORD_KEYS]
        if unknown:
            raise ValueError(f"query on non-coordinate keys {unknown}; "
                             f"valid keys: {list(COORD_KEYS)}")
        return [r for r in self.load()
                if all(r.get(k) == v for k, v in coords.items())]

    def rewrite(self) -> int:
        """Persist the migrated view back to disk (atomic via temp file)."""
        rows = self.load()
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        with open(tmp, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
        tmp.replace(self.path)
        return len(rows)

    def __len__(self) -> int:
        return len(self.load())
