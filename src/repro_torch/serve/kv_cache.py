"""KV/SSM cache lane operations for continuous batching.

The engine keeps one batch-wide cache tree (lanes = batch rows).  A
finished lane is re-used by writing the new request's prefill cache into
its row.  Leaves with a sequence axis (attention keys and values) are
written over the prompt's positions only: stale data past the new position
is masked by the decode attention (``ki <= pos``), so no explicit clearing
is needed.  A sliding-window layer's ring takes the same write: a prompt
no longer than the window fills slots [0, Sp) (slot = position), and a
longer one arrives from the prefill already cut to the window's slots in
ring order (``model.apply_layer``); before the ring wraps, decode masks
the slots past its position as for a full cache.  State leaves (a Mamba
layer's SSM state and conv tail, an RG-LRU layer's ``h`` and conv tail)
have no sequence axis and are written whole, so a reused lane keeps
nothing of the request it held before.
"""

from __future__ import annotations

# cache leaves whose second axis (after the lane) is the sequence
SEQ_LEAVES = ("k", "v")


def insert_prefill(batch_cache: dict, new_cache: dict, lane: int) -> dict:
    """Write a single-request prefill cache (B=1) into lane ``lane`` of the
    batch cache, **in place** (slice assignment; the reference returns a
    new tree from a donated one): positions [0, Sp) of each sequence leaf
    (Sp ≤ S_ctx), the whole row of each state leaf.  Stacked leaves are
    (P, B, ...), tail leaves (B, ...).  Returns ``batch_cache``."""
    def put(key, batch_leaf, new_leaf, stacked: bool):
        row = batch_leaf[:, lane] if stacked else batch_leaf[lane]
        src = new_leaf[:, 0] if stacked else new_leaf[0]
        if key in SEQ_LEAVES:
            sp = src.shape[1 if stacked else 0]
            if sp > row.shape[1 if stacked else 0]:
                raise ValueError(f"prefill of {sp} positions exceeds the "
                                 f"cache's {row.shape[1 if stacked else 0]}")
            row = row[:, :sp] if stacked else row[:sp]
        elif src.shape != row.shape:
            raise ValueError(f"state leaf {key!r} of shape "
                             f"{tuple(src.shape)} does not fill the lane's "
                             f"{tuple(row.shape)}")
        row.copy_(src)

    for j, slot in batch_cache["stack"].items():
        for k, leaf in slot.items():
            put(k, leaf, new_cache["stack"][j][k], True)
    for leaves, new in zip(batch_cache["tail"], new_cache["tail"]):
        for k, leaf in leaves.items():
            put(k, leaf, new[k], False)
    return batch_cache
