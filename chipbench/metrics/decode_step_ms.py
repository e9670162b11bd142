"""The median host time of the window's engine steps that admitted nobody
(one decode step over every lane; host clock)."""

from chipbench.trace import nearest_rank


def read(facts):
    return nearest_rank(facts.get("decode_only_step_ms", []), 0.5)
