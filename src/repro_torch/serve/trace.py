"""LockTrace — recorded admission-lock behaviour, the serve→sim half of
the loop.

A :class:`LockTraceRecorder` hangs off :class:`~repro_torch.serve.engine.ServeEngine`
(``record_trace=True``) and timestamps the four admission events per
request — ticket draw (arrival), grant (admission), release (lane freed)
— plus every admission-metadata read.  ``to_trace()`` finalizes into a
:class:`LockTrace`: parallel per-request arrays, sorted by ticket, from
which the derived distributions the simulator needs fall out as
properties (hold times, grant waits, inter-acquire gaps, reader
fraction).

Traces serialize to a versioned ``.npz`` (``save`` / ``load_trace``) so a
recorded workload is a portable artifact: ``sim/traces.py`` quantizes one
into lockVM cost units and compiles it into a sweepable program — all 14
simulated locks replayable against a single recorded serve run.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np

TRACE_VERSION = 1

_ARRAYS = ("arrival_s", "grant_s", "release_s", "tickets", "read_s")


@dataclass(frozen=True)
class LockTrace:
    """One recorded admission-lock workload.

    ``arrival_s`` / ``grant_s`` / ``release_s`` are parallel float64
    arrays (seconds, relative to the first event), one entry per request
    that completed all three phases, sorted by ``tickets``.  ``read_s``
    timestamps metadata reads (the read-mostly traffic ``twa-rw``
    models).  ``lanes`` and ``gate`` record the geometry and the waiting
    policy active while recording.
    """

    arrival_s: np.ndarray
    grant_s: np.ndarray
    release_s: np.ndarray
    tickets: np.ndarray
    read_s: np.ndarray
    lanes: int
    gate: str = "twa"
    name: str = "serve"

    def __post_init__(self) -> None:
        n = len(self.tickets)
        assert len(self.arrival_s) == len(self.grant_s) == n
        assert len(self.release_s) == n
        assert np.all(self.grant_s >= self.arrival_s - 1e-12)
        assert np.all(self.release_s >= self.grant_s - 1e-12)

    def __len__(self) -> int:
        return len(self.tickets)

    # -- derived distributions (what the quantizer samples) ------------------
    @property
    def hold_s(self) -> np.ndarray:
        """Per-request lane hold duration (grant → release)."""
        return self.release_s - self.grant_s

    @property
    def grant_wait_s(self) -> np.ndarray:
        """Per-request admission wait (draw → grant)."""
        return self.grant_s - self.arrival_s

    @property
    def inter_acquire_s(self) -> np.ndarray:
        """Gaps between consecutive grants in grant order — the off-lock
        (outside_work) process the simulator replays between iterations."""
        g = np.sort(self.grant_s)
        return np.diff(g) if len(g) > 1 else np.zeros(0)

    @property
    def reader_fraction(self) -> int:
        """Metadata reads as a percentage of all lock operations — the
        value the ``reader_fraction`` sweep axis takes when this trace is
        replayed through ``twa-rw``."""
        reads, writes = len(self.read_s), len(self.tickets)
        if reads + writes == 0:
            return 0
        return int(round(100.0 * reads / (reads + writes)))

    # -- serialization --------------------------------------------------------
    def save(self, path) -> None:
        meta = {"version": TRACE_VERSION, "lanes": int(self.lanes),
                "gate": self.gate, "name": self.name}
        np.savez(path, meta=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8),
            **{k: np.asarray(getattr(self, k)) for k in _ARRAYS})


def load_trace(path) -> LockTrace:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] > TRACE_VERSION:
            raise ValueError(
                f"trace version {meta['version']} is newer than this "
                f"checkout's {TRACE_VERSION}; refusing to guess")
        return LockTrace(
            arrival_s=np.asarray(z["arrival_s"], dtype=np.float64),
            grant_s=np.asarray(z["grant_s"], dtype=np.float64),
            release_s=np.asarray(z["release_s"], dtype=np.float64),
            tickets=np.asarray(z["tickets"], dtype=np.int64),
            read_s=np.asarray(z["read_s"], dtype=np.float64),
            lanes=int(meta["lanes"]), gate=meta["gate"], name=meta["name"])


@dataclass
class LockTraceRecorder:
    """Thread-safe event sink the engine drives while serving.

    Requests that never complete all three phases (still decoding when
    the recorder finalizes) are dropped — a trace row must have the full
    arrival→grant→release triple to contribute a hold sample.
    """

    lanes: int
    gate: str = "twa"
    name: str = "serve"
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _draw: dict = field(default_factory=dict)
    _grant: dict = field(default_factory=dict)
    _release: dict = field(default_factory=dict)
    _reads: list = field(default_factory=list)

    @staticmethod
    def _now() -> float:
        return time.perf_counter()

    def on_draw(self, ticket: int) -> None:
        with self._lock:
            self._draw[ticket] = self._now()

    def on_grant(self, ticket: int) -> None:
        with self._lock:
            self._grant[ticket] = self._now()

    def on_release(self, ticket: int) -> None:
        with self._lock:
            self._release[ticket] = self._now()

    def on_read(self) -> None:
        with self._lock:
            self._reads.append(self._now())

    def to_trace(self) -> LockTrace:
        with self._lock:
            done = sorted(t for t in self._draw
                          if t in self._grant and t in self._release)
            if not done:
                raise ValueError("no completed requests recorded")
            t0 = min(self._draw[t] for t in done)
            return LockTrace(
                arrival_s=np.array([self._draw[t] - t0 for t in done]),
                grant_s=np.array([self._grant[t] - t0 for t in done]),
                release_s=np.array([self._release[t] - t0 for t in done]),
                tickets=np.array(done, dtype=np.int64),
                read_s=np.array(sorted(r - t0 for r in self._reads)),
                lanes=self.lanes, gate=self.gate, name=self.name)
