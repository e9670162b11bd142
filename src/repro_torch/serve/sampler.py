"""Token sampling for the decode loop."""

from __future__ import annotations

import torch


def sample(logits, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """logits (B, V) -> int32 tokens (B,).  Temperature 0 is greedy: the
    argmax, the first index on ties (as ``jnp.argmax``).  Otherwise a draw
    from softmax(logits / temperature), optionally cut to the ``top_k``
    largest, with ``generator`` (its numbers are not ``jax.random``'s)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, -1e30)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
