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
