"""The median host time of the program's ``serve.decode`` spans in the
window: the host's enqueue of one decode step over every lane (program
spans, host clock)."""

from chipbench.trace import nearest_rank


def read(facts):
    return nearest_rank(facts.get("decode_enqueue_ms", []), 0.5)
