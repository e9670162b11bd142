"""Public ops for ticket dispatch and the MoE routing plan: the CUDA
kernels or the plain versions.

:func:`assign_slots` and :func:`dispatch_combine_plan` mirror the
reference's ops.  ``mode="auto"`` goes through :func:`kernel.ticket_dispatch`,
which launches the ticket kernel for CUDA tensors and runs the plain
version for CPU tensors; ``mode="torch"`` runs the plain version on any
device (the yardstick the smoke run holds the kernel against).
``grouped=True`` treats dim 0 as independent groups, each ticketed with its
own counters — the reference's ``jax.vmap`` over groups, written out as one
launch of G blocks.

:func:`route_plan` is the MoE layer's whole routing plan after the softmax
(:data:`PLAN_MODES`): ``"auto"`` the routing-plan kernel
(:func:`plan.moe_plan`) for CUDA tensors and :func:`ref.plan_ref` for CPU
tensors, ``"ticket"`` the plain plan around the standalone ticket kernel
(the unfused plan: :func:`ref.plan_ref` with its slots from
:func:`assign_slots`), ``"torch"`` :func:`ref.plan_ref` on any device.  The
three give the same plan, bit for bit.
"""

from __future__ import annotations

import torch

from . import kernel, plan, ref

MODES = ("auto", "torch")
PLAN_MODES = ("auto", "ticket", "torch")


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


def route_plan(gates_full: torch.Tensor, n_experts: int, top_k: int,
               capacity: int, gate_dtype: torch.dtype, *,
               mode: str = "auto") -> dict:
    """The routing plan of ``gates_full`` (G, N, E) float32, the router's
    softmax over each group's tokens: the dict of :func:`ref.plan_ref`."""
    if mode not in PLAN_MODES:
        raise ValueError(f"unknown dispatch mode {mode!r}; options: "
                         f"{PLAN_MODES}")
    if gates_full.shape[-1] != n_experts:
        raise ValueError(f"gates_full has {gates_full.shape[-1]} experts, "
                         f"expected {n_experts}")
    if mode == "auto":
        return plan.moe_plan(gates_full.contiguous(), top_k, capacity,
                             gate_dtype)
    slots_of = None
    if mode == "ticket":
        def slots_of(ids):
            return assign_slots(ids, n_experts, capacity, grouped=True)[1]
    return ref.plan_ref(gates_full, top_k, capacity, gate_dtype,
                        slots_of=slots_of)


def aux_loss(route: dict, weight: float) -> torch.Tensor:
    """The load-balancing aux loss (Switch/GShard style) over every token
    of a :func:`route_plan`: ``weight · E · Σ_e density_e · prob_e``, with
    density the share of tokens whose first choice is e and prob the mean
    gate of e, from the plan's per-group partials."""
    counts, sums = route["first_counts"], route["gate_sums"]
    G, E = counts.shape
    n_tokens = route["slot"].shape[0] * route["slot"].shape[1]
    if G > 1:
        counts, sums = counts.sum(0), sums.sum(0)
    else:
        counts, sums = counts[0], sums[0]
    return torch.dot(counts, sums) * (weight * E / n_tokens ** 2)
