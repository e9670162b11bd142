"""Public ops for ticket dispatch: the CUDA kernel or the plain version.

``mode="auto"`` goes through :func:`kernel.ticket_dispatch`, which launches
the kernel for CUDA tensors and runs the plain version for CPU tensors;
``mode="torch"`` runs the plain version on any device (the yardstick the
smoke run holds the kernel against).  ``grouped=True`` treats dim 0 as
independent groups, each ticketed with its own counters — the reference's
``jax.vmap`` over groups, written out as one launch of G blocks.
"""

from __future__ import annotations

import torch

from . import kernel, ref

MODES = ("auto", "torch")


def assign_slots(expert_ids: torch.Tensor, n_experts: int, capacity: int, *,
                 grouped: bool = False, mode: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tickets, slots) for MoE routing decisions; slot -1 = dropped.
    Both are int32, shaped like ``expert_ids``."""
    if mode not in MODES:
        raise ValueError(f"unknown dispatch mode {mode!r}; options: {MODES}")
    shape = expert_ids.shape
    ids = ref.as_groups(expert_ids, grouped)
    if mode == "torch":
        tickets, slots = ref.dispatch_ref(ids, n_experts, capacity,
                                          grouped=True)
    else:
        tickets, slots = kernel.ticket_dispatch(
            ids.to(torch.int32).contiguous(), n_experts, capacity)
    return tickets.reshape(shape), slots.reshape(shape)


def dispatch_combine_plan(expert_ids: torch.Tensor, gates: torch.Tensor,
                          n_experts: int, capacity: int, *,
                          grouped: bool = False, mode: str = "auto") -> dict:
    """Full dispatch plan for a gather/scatter MoE layer.

    Args:
      expert_ids: (N, K) top-k expert per token, or (G, N, K) with
        ``grouped=True``.
      gates:      routing weights of the same shape (already normalized).
    Returns dict with:
      slot:  position in the expert's buffer, -1 if dropped.
      kept:  bool.
      gates: gates zeroed for dropped pairs.
    """
    _, slot = assign_slots(expert_ids, n_experts, capacity, grouped=grouped,
                           mode=mode)
    kept = slot >= 0
    return {"slot": slot, "kept": kept,
            "gates": torch.where(kept, gates, torch.zeros_like(gates))}
