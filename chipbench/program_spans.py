"""The program's own spans and counters in a traced run.

The program keeps spans of its layers in memory while its recorder is on
(``repro_torch.spans``): the serve engine's ``serve.*`` and the sweep
path's ``sweep.*``, on ``time.perf_counter``, the clock the device trace is
tied to (:mod:`chipbench.trace`).  A cell's loop calls :func:`start` before
the window and :func:`stop` after it, and derives its facts from what
:func:`stop` returns; a program without the recorder gives no spans, and
the facts and the metrics that read them are left out.

Each span comes back as a dict: ``name``, ``start``, ``end``, ``id``,
``parent`` (the enclosing span's id on the same thread), ``rid`` (the
request's ticket) and ``counters``.
"""

from __future__ import annotations

import bisect

from chipbench import trace as tr


def _recorder():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def start() -> bool:
    """Empty the program's recorder and turn it on; False where the
    program has none."""
    spans = _recorder()
    if spans is None:
        return False
    spans.collect()
    spans.enable()
    return True


def stop() -> list:
    """Turn the recorder off; the spans recorded since :func:`start`."""
    spans = _recorder()
    if spans is None:
        return []
    spans.disable()
    return [{"name": s.name, "start": s.start, "end": s.end, "id": s.id,
             "parent": s.parent, "rid": s.rid, "counters": dict(s.counters)}
            for s in spans.collect()]


def within(program: list, name: str, w0: float, w1: float) -> list:
    """The spans of ``name`` that lie in the window [w0, w1], by start."""
    return sorted((s for s in program if s["name"] == name
                   and s["start"] >= w0 and s["end"] <= w1),
                  key=lambda s: s["start"])


def labelled(own: tr.Spans, program: list) -> tr.Spans:
    """The benchmark's spans with the program's added, for
    :func:`chipbench.trace.breakdown`: each idle gap is named by the
    innermost span that holds it, so ``run_sweeps`` and ``step`` split
    into the program's parts."""
    out = tr.Spans(list(own.items))
    for s in program:
        out.add(s["name"], s["start"], s["end"])
    return out


class Busy:
    """The device's busy intervals in a window, to ask how much of an
    interval was busy and how many operations started in it."""

    def __init__(self, ops, w0: float, w1: float) -> None:
        clipped = tr.clip(ops, w0, w1)
        self.merged = tr.busy_intervals(clipped)
        self.ends = [e for _, e in self.merged]
        self.op_starts = sorted(s for _, s, _ in clipped)

    def busy_s(self, a: float, b: float) -> float:
        total = 0.0
        i = bisect.bisect_right(self.ends, a)
        while i < len(self.merged) and self.merged[i][0] < b:
            s, e = self.merged[i]
            total += min(e, b) - max(s, a)
            i += 1
        return total

    def ops_starting(self, a: float, b: float) -> int:
        return (bisect.bisect_left(self.op_starts, b)
                - bisect.bisect_left(self.op_starts, a))


def sweep_facts(program: list, w0: float, w1: float) -> dict:
    """The sweep path's facts in the window: ``sweep_build_s`` (the
    programs built and packed), and over the ``sweep.run`` calls the
    events of every cell (``sweep_events``) and the cells times the
    longest cell's events (``sweep_cell_slots``)."""
    runs = within(program, "sweep.run", w0, w1)
    if not runs:
        return {}
    return {"sweep_build_s": sum(s["end"] - s["start"] for s in
                                 within(program, "sweep.build", w0, w1)),
            "sweep_events": sum(s["counters"]["sum_events"] for s in runs),
            "sweep_cell_slots": sum(s["counters"]["max_events"]
                                    * s["counters"]["cells"] for s in runs)}


def serve_facts(program: list, ops, w0: float, w1: float) -> dict:
    """The serve engine's facts in the window.  A decode step runs from
    its ``serve.decode`` (the host's enqueue) to the end of its
    ``serve.next_tokens`` (the sample read back, the lanes' bookkeeping):
    the host ms of each enqueue, and over the steps the device's idle
    seconds and the operations that start inside; and the device's idle
    seconds inside the admissions (``serve.admit``: a prefill and its first
    token)."""
    steps = within(program, "serve.step", w0, w1)
    if not steps:
        return {}
    ids = {s["id"] for s in steps}
    parts: dict = {}
    for s in program:
        if s["parent"] in ids and s["name"] in ("serve.decode",
                                                "serve.next_tokens"):
            parts.setdefault(s["parent"], {})[s["name"]] = s
    decodes = [(p["serve.decode"], p["serve.next_tokens"])
               for p in parts.values() if len(p) == 2]
    busy = Busy(ops, w0, w1)
    span_s = sum(n["end"] - d["start"] for d, n in decodes)
    admits = within(program, "serve.admit", w0, w1)
    admit_s = sum(a["end"] - a["start"] for a in admits)
    return {"decode_steps": len(decodes),
            "decode_enqueue_ms": [(d["end"] - d["start"]) * 1e3
                                  for d, _ in decodes],
            "decode_span_s": span_s,
            "decode_idle_s": span_s - sum(busy.busy_s(d["start"], n["end"])
                                          for d, n in decodes),
            "decode_ops": sum(busy.ops_starting(d["start"], n["end"])
                              for d, n in decodes),
            "prefill_span_s": admit_s,
            "prefill_idle_s": admit_s - sum(busy.busy_s(a["start"], a["end"])
                                            for a in admits)}
