"""The 95th percentile (nearest rank) of every gap between consecutive
tokens of a request that ends in the window; a gap holds every prefill
admitted between two decode steps (host clock)."""

from chipbench.trace import nearest_rank


def read(facts):
    return nearest_rank(facts.get("itl_ms", []), 0.95)
