"""KV cache lane operations for continuous batching.

The engine keeps one batch-wide cache tree (lanes = batch rows).  A
finished lane is re-used by writing the new request's prefill cache into
its row; stale data past the new position is masked by the decode
attention (``ki <= pos``), so no explicit clearing is needed.
"""

from __future__ import annotations


def insert_prefill(batch_cache: dict, new_cache: dict, lane: int) -> dict:
    """Write a single-request prefill cache (B=1, seq Sp ≤ S_ctx) into
    positions [0, Sp) of lane ``lane`` of the batch cache, **in place**
    (slice assignment; the reference returns a new tree from a donated
    one).  Stacked leaves are (P, B, S, ...), tail leaves (B, S, ...).
    Returns ``batch_cache``."""
    def put(batch_leaf, new_leaf, stacked: bool):
        sp = new_leaf.shape[2 if stacked else 1]
        if sp > batch_leaf.shape[2 if stacked else 1]:
            raise ValueError(f"prefill of {sp} positions exceeds the cache's "
                             f"{batch_leaf.shape[2 if stacked else 1]}")
        src = new_leaf.to(batch_leaf.dtype)
        if stacked:
            batch_leaf[:, lane, :sp] = src[:, 0]
        else:
            batch_leaf[lane, :sp] = src[0]

    for j, slot in batch_cache["stack"].items():
        for k, leaf in slot.items():
            put(leaf, new_cache["stack"][j][k], True)
    for leaves, new in zip(batch_cache["tail"], new_cache["tail"]):
        for k, leaf in leaves.items():
            put(leaf, new[k], False)
    return batch_cache
