"""The 90th percentile (nearest rank), over every request due in the
window, of first-token time less due time; a request not answered by the
window's end counts its wait until then (host clock)."""

from chipbench.trace import nearest_rank


def read(facts):
    return nearest_rank(facts.get("ttft_ms", []), 0.90)
