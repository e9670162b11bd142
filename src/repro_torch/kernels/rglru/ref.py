"""Plain PyTorch versions of the RG-LRU diagonal gated linear recurrence
(Griffin):

    h_t = a_t ⊙ h_{t-1} + b_t,      a_t ∈ (0, 1)

where, in RecurrentGemma, a_t = exp(-c · softplus(Λ) · σ(r_t)) and
b_t = sqrt(1 - a_t²) ⊙ (σ(i_t) ⊙ x_t); the gates are computed by the
caller, the scans are the recurrence itself.

A port of the reference's ``repro/kernels/rglru/ref.py``.  The scans take
an optional leading batch dimension of independent sequences, written out
where the reference's ``rglru_block`` ``vmap``\\ s: a, b (Bt, L, D) with
h0 (D,) shared or (Bt, D) per sequence.
"""

from __future__ import annotations

import torch


def _h0(h0, a):
    """h0 broadcast to a's batch shape: (D,) or (Bt, D)."""
    if h0 is None or a.dim() == 2 or h0.dim() == 2:
        return h0
    return h0[None].expand(a.shape[0], -1)


def rglru_scan_ref(a, b, h0=None):
    """Args: a, b (L, D) or (Bt, L, D); h0 (D,) or (Bt, D) (zeros in a's
    dtype if None).  Returns (y like a, h_final (D,) or (Bt, D)).

    A sequential loop over t **in the inputs' dtypes**, as the reference's
    ``lax.scan`` computes: at bf16 the state h is rounded to bf16 at every
    step (``rglru_block`` casts a to x's dtype and starts from a bf16
    zero state).  The CUDA kernel keeps h in float32 instead; it is held
    to this function on float32 casts of its inputs.
    """
    h = _h0(h0, a)
    if h is None:
        h = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=a.dtype,
                        device=a.device)
    ys = []
    for t in range(a.shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        ys.append(h)
    return torch.stack(ys, dim=-2), h


def rglru_scan_chunked(a, b, h0=None, chunk: int = 64):
    """Chunk-transposed two-pass form of the same recurrence, in float32
    (the reference's ``rglru_scan_chunked``): within each chunk the steps
    run from zero local state for all chunks at once, keeping the running
    decay product A_t = Π a, then the carry is threaded across the L/chunk
    boundaries and spliced in, y = h_local + A_t · h_in.  L sequential
    steps become chunk + L/chunk.  Returns y and h_final in a's dtype.
    ``chunk`` must divide L.
    """
    if a.dim() == 2:
        y, h = rglru_scan_chunked(a[None], b[None],
                                  None if h0 is None else h0[None],
                                  chunk=chunk)
        return y[0], h[0]
    f32 = torch.float32
    Bt, L, D = a.shape
    if L % chunk:
        raise ValueError(f"chunk {chunk} must divide L={L}")
    nc = L // chunk
    h_in = (torch.zeros((Bt, D), dtype=f32, device=a.device) if h0 is None
            else _h0(h0, a).to(f32))
    # time-major within a chunk, chunks batched: (chunk, Bt, nc, D)
    at = a.to(f32).reshape(Bt, nc, chunk, D).permute(2, 0, 1, 3)
    bt = b.to(f32).reshape(Bt, nc, chunk, D).permute(2, 0, 1, 3)

    h = torch.zeros((Bt, nc, D), dtype=f32, device=a.device)
    arun = torch.ones_like(h)
    h_local, a_cum = [], []
    for t in range(chunk):
        h = at[t] * h + bt[t]
        arun = arun * at[t]
        h_local.append(h)
        a_cum.append(arun)

    h_ins = []
    for c in range(nc):
        h_ins.append(h_in)
        h_in = arun[:, c] * h_in + h[:, c]
    h_ins = torch.stack(h_ins, dim=1)                       # (Bt, nc, D)

    y = torch.stack(h_local) + torch.stack(a_cum) * h_ins[None]
    y = y.permute(1, 2, 0, 3).reshape(Bt, L, D)
    return y.to(a.dtype), h_in.to(a.dtype)


def rglru_gates_ref(x, r, i, lam, c: float = 8.0):
    """The RG-LRU gates (a reference for the layer, not the kernel): (a, b)
    of the recurrence from the raw gate pre-activations r, i and the input
    x (L, D), with Λ ``lam`` (D,).  ``softplus`` is ``logaddexp(·, 0)``,
    as ``jax.nn.softplus``."""
    softplus = torch.logaddexp(lam, torch.zeros((), dtype=lam.dtype,
                                                device=lam.device))
    a = torch.exp(-c * softplus[None, :] * torch.sigmoid(r))
    gated = torch.sigmoid(i) * x
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated
    return a, b
