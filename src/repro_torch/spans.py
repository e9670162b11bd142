"""Spans and counters of the program's own layers, kept in memory.

    from repro_torch import spans
    spans.enable()
    ...                          # serve or sweep
    for s in spans.collect():    # the spans ended since, in that order
        print(s.name, s.end - s.start, s.counters)

A span is a named interval of the host's ``time.perf_counter``, entered as
a context manager (``with spans.span("serve.step") as sp:``), with its own
id, the id of the span that encloses it on the same thread (``parent``),
the request it serves (``rid``, where there is one) and counters set on it
(``sp.count(key, value)``).

Recording is off until :func:`enable`.  While it is off, :func:`span`
tests one flag and returns one shared object that does nothing and is
false, so a caller can skip work that only feeds counters (``if sp:``); no
clock is read and nothing is kept.

The spans name, in dotted form, the layer that holds them:

* ``serve.*`` (``serve/engine.py``): ``serve.step`` one engine step;
  ``serve.admit`` one admission (``rid`` the ticket) with its
  ``serve.prefill`` (the forward and the cache insert) and
  ``serve.first_token`` (the sample and its read back); ``serve.decode``
  the host's enqueue of one decode step over every lane;
  ``serve.next_tokens`` its sample, read back and per-lane loop.
* ``sweep.*`` (``sim/workloads.py``, ``sim/engine.py``): ``sweep.run`` one
  ``run_sweeps``, with ``cells``, ``sum_events`` and ``max_events`` (the
  padding report's); inside it ``sweep.build`` (programs built and
  packed), ``sweep.upload`` (numpy to tensors), ``sweep.kernel`` (the
  engine call), ``sweep.readback`` (the outputs copied back, which waits
  for the kernel), ``sweep.pad_stats`` (the padding report) and
  ``sweep.rows`` (the result rows and the results store).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field

_clock = time.perf_counter
_ids = itertools.count(1)
_local = threading.local()
_buffer: list = []
_on = False


@dataclass
class Span:
    name: str
    start: float
    end: float | None = None
    id: int = 0
    parent: int | None = None
    rid: int | None = None
    counters: dict = field(default_factory=dict)

    def count(self, key: str, value) -> None:
        self.counters[key] = value

    def __enter__(self) -> Span:
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _clock()
        _stack().pop()
        _buffer.append(self)


class _Off:
    """What :func:`span` returns while recording is off."""

    def count(self, key: str, value) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str, rid: int | None = None):
    """A span of ``name`` to enter with ``with``; the shared no-op object
    while recording is off."""
    if not _on:
        return _OFF
    return Span(name, 0.0, id=next(_ids), rid=rid)


def collect() -> list:
    """The spans ended since the last call, in the order they ended; the
    buffer is emptied."""
    global _buffer
    out, _buffer = _buffer, []
    return out
