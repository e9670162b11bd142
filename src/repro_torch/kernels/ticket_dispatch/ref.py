"""Plain PyTorch version of ticket dispatch (MoE slot assignment).

Semantics — the ticket-lock doorway (paper Listing 1, line 35): every
(token, k) routing decision "arrives" in token-major order and performs a
conceptual ``FetchAdd(ticket[expert], 1)``.  The batch of arrivals is
ticketed with an exclusive prefix count per expert — the associative-scan
equivalent of fetch-and-add: deterministic, wait-free, and FIFO by
construction (ticket order == arrival order).  A port of the reference's
``repro/kernels/ticket_dispatch/ref.py``, with a leading dimension of
independent groups written out (``grouped=True``) where the reference
``vmap``\\ s.

Top-k gives ids in [0, E).  Ids outside it follow the reference's rule,
which is JAX's ``take_along_axis``: an id in [-E, 0) is wrapped once and
takes the count of earlier arrivals to expert ``id + E`` as its ticket,
any other id takes ticket INT32_MIN (the fill value), and neither moves a
counter.  A slot is the ticket where it lies below the capacity, else -1,
so a filled ticket keeps INT32_MIN as its slot.  The CUDA kernel applies
the same rule.

:func:`plan_ref` is the MoE layer's whole routing plan after the router's
softmax, the plain version of the routing-plan kernel
(``csrc/moe_plan.cu``): the reference's ``lax.top_k``, renormalisation,
aux-loss one-hot, ``dispatch_combine_plan``, flat index and slot→token
scatter (``repro/models/layers.py:336-365``), in the same PyTorch ops the
MoE layer ran before the kernel, with one change: the renormalising sum
runs left to right over the K choices, a fixed order the kernel repeats.
"""

from __future__ import annotations

import torch

INT32_MIN = -2**31


def as_groups(expert_ids: torch.Tensor, grouped: bool) -> torch.Tensor:
    """The ids as (G, n): dim 0 as the groups, or one group of all."""
    if grouped:
        return expert_ids.reshape(expert_ids.shape[0], -1)
    return expert_ids.reshape(1, -1)


def ticket_ref(expert_ids: torch.Tensor, n_experts: int, *,
               grouped: bool = False) -> torch.Tensor:
    """Each arrival's FIFO position among the arrivals routed to the same
    expert, same shape as ``expert_ids``.  ``grouped=True`` tickets each
    slice along dim 0 on its own (its own counters)."""
    ids = as_groups(expert_ids, grouped).long()
    experts = torch.arange(n_experts, device=ids.device)
    onehot = (ids[..., None] == experts).to(torch.int32)          # (G, n, E)
    exclusive = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    # JAX's gather rule: a negative index wraps once, one still outside
    # [0, E) takes the fill value
    column = torch.where(ids < 0, ids + n_experts, ids)
    inside = (column >= 0) & (column < n_experts)
    safe = column.clamp(0, max(n_experts - 1, 0))[..., None]
    tickets = torch.where(inside, exclusive.gather(2, safe)[..., 0],
                          INT32_MIN)
    return tickets.reshape(expert_ids.shape)


def dispatch_ref(expert_ids: torch.Tensor, n_experts: int, capacity: int, *,
                 grouped: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Tickets + capacity-bounded slots (slot = -1 → dropped; a filled
    ticket, INT32_MIN, stays the slot, as in the reference).

    Like a bounded waiting room: arrivals whose ticket reaches capacity are
    turned away (MoE token dropping), FIFO-fairly — the earliest arrivals
    keep their slots, the admission order a ticket lock guarantees.
    """
    tickets = ticket_ref(expert_ids, n_experts, grouped=grouped)
    slots = torch.where(tickets < capacity, tickets, -1)
    return tickets, slots


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, ties to the lower index
    (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def renormalize(top_gates: torch.Tensor) -> torch.Tensor:
    """``top_gates / max(Σ top_gates, 1e-9)`` over the last axis, the sum
    taken left to right in the gates' dtype (a fixed order, which the
    routing-plan kernel repeats; ``Tensor.sum`` promises none)."""
    total = top_gates[..., 0]
    for k in range(1, top_gates.shape[-1]):
        total = total + top_gates[..., k]
    return top_gates / total.clamp_min(1e-9)[..., None]


def plan_ref(gates_full: torch.Tensor, top_k: int, capacity: int,
             gate_dtype: torch.dtype, *, slots_of=None) -> dict:
    """The routing plan of G groups of N tokens from their router softmax
    ``gates_full`` (G, N, E) float32.  Returns a dict of

    - ``top_ids`` (G, N, K) int32: each token's top-k experts, ties to the
      lower index;
    - ``gates`` (G, N, K) ``gate_dtype``: the renormalised top-k gates, zero
      where the pair is dropped;
    - ``slot`` (G, N, K) int32: the pair's FIFO ticket from its expert if
      below ``capacity``, else -1; ``kept`` (G, N, K) bool: slot >= 0;
    - ``safe_idx`` (G, N·K) int64: ``expert·capacity + slot``, clamped to
      ``E·capacity - 1`` (dropped pairs), the combine's gather index;
    - ``slot_tok`` (G, E·capacity) int64: the token in each buffer slot, 0
      where empty; ``valid`` (G, E·capacity) bool: whether one is;
    - ``first_counts`` (G, E) float32: tokens whose first choice is each
      expert; ``gate_sums`` (G, E) float32: ``gates_full`` summed over the
      tokens (the aux loss's per-group partials).

    ``slots_of`` maps the (G, N·K) int32 ids to their slots; the default is
    :func:`dispatch_ref`.
    """
    G, N, E = gates_full.shape
    K = top_k
    top_gates, top_ids = top_k_stable(gates_full, K)
    top_gates = renormalize(top_gates)
    experts = torch.arange(E, device=gates_full.device)
    first_counts = (top_ids[..., :1] == experts).sum(1, dtype=torch.float32)
    ids = top_ids.to(torch.int32)
    flat_ids = ids.reshape(G, N * K)
    if slots_of is None:
        slot = dispatch_ref(flat_ids, E, capacity, grouped=True)[1]
    else:
        slot = slots_of(flat_ids)
    slot = slot.reshape(G, N, K)
    kept = slot >= 0
    gates = top_gates.to(gate_dtype)
    gates = torch.where(kept, gates, torch.zeros_like(gates))
    # (token, k) pair -> flat buffer slot; dropped pairs -> overflow row
    flat_idx = torch.where(kept, top_ids * capacity + slot.long(),
                           E * capacity).reshape(G, N * K)
    pair_tok = (torch.arange(N * K, device=gates_full.device) // K
                ).expand(G, N * K)
    slot_tok = torch.full((G, E * capacity + 1), -1, dtype=torch.long,
                          device=gates_full.device)
    slot_tok.scatter_(1, flat_idx, pair_tok)
    slot_tok = slot_tok[:, :-1]
    return {"top_ids": ids, "gates": gates, "slot": slot, "kept": kept,
            "safe_idx": flat_idx.clamp_max(E * capacity - 1),
            "slot_tok": slot_tok.clamp_min(0), "valid": slot_tok >= 0,
            "first_counts": first_counts, "gate_sums": gates_full.sum(1)}
