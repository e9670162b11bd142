"""Plain PyTorch versions of the Mamba-1 selective scan.

State update (diagonal A, per-channel state of size N):
    h_t = exp(dt_t ⊗ A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

A port of the reference's ``repro/kernels/mamba_scan/ref.py``.  Both
functions take an optional leading batch dimension of independent
sequences, written out where the reference's ``mamba_block`` ``vmap``\\ s:
x, dt (Bt, L, D) and B, C (Bt, L, N); A (D, N) or (Bt, D, N), D_skip (D,)
or (Bt, D) and h0 (D, N) or (Bt, D, N) are shared across the batch or given
per sequence.
"""

from __future__ import annotations

import torch


def _per_seq(t: torch.Tensor | None, batched: bool, rank: int):
    """A per-sequence argument (A, D_skip, h0) with a batch dimension that
    broadcasts: (1, ...) when shared, as given when per sequence."""
    if t is None or not batched or t.dim() == rank + 1:
        return t
    return t[None]


def selective_scan_ref(x, dt, A, B, C, D_skip, h0=None):
    """Args:
      x:  (L, D) or (Bt, L, D) input.
      dt: like x, positive step sizes (already softplus'd).
      A:  (D, N) negative-real diagonal state matrix (per channel).
      B:  (L, N) or (Bt, L, N) input projection.
      C:  like B, output projection.
      D_skip: (D,) skip connection.
      h0: (D, N) initial state (zeros if None).

    Returns (y like x, h_final (D, N) or (Bt, D, N)).

    A sequential loop over t that computes **in the inputs' dtypes**, as the
    reference's ``lax.scan`` does: at bf16 the state h is rounded to bf16 at
    every step (``mamba_block`` casts A to x's dtype).  The CUDA kernel
    keeps h in float32 instead; it is held to this function on float32
    casts of its inputs.
    """
    batched = x.dim() == 3
    A = _per_seq(A, batched, 2)
    D_skip = _per_seq(D_skip, batched, 1)
    h = _per_seq(h0, batched, 2)
    if h is None:
        h = torch.zeros(x.shape[:-2] + (x.shape[-1], A.shape[-1]),
                        dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[-2]):
        x_t, dt_t = x[..., t, :], dt[..., t, :]               # (..., D)
        B_t, C_t = B[..., t, :], C[..., t, :]                 # (..., N)
        dA = torch.exp(dt_t[..., None] * A)                   # (..., D, N)
        dBx = (dt_t * x_t)[..., None] * B_t[..., None, :]
        h = dA * h + dBx
        ys.append((h * C_t[..., None, :]).sum(-1) + D_skip * x_t)
    return torch.stack(ys, dim=-2), h


def selective_scan_chunked(x, dt, A, B, C, D_skip, h0=None, chunk: int = 64):
    """Chunked formulation of the same recurrence, in float32 (the
    reference's ``selective_scan_chunked``): within each chunk the steps
    run from zero local state for all chunks at once, keeping the running
    log-decay, then the carry is threaded across the L/chunk boundaries and
    spliced into the outputs.  Returns y and h_final in x's dtype.
    ``chunk`` must divide L.
    """
    batched = x.dim() == 3
    if not batched:
        y, h = selective_scan_chunked(x[None], dt[None], A, B[None],
                                      C[None], D_skip,
                                      None if h0 is None else h0[None],
                                      chunk=chunk)
        return y[0], h[0]
    f32 = torch.float32
    Bt, L, Dm = x.shape
    N = A.shape[-1]
    if L % chunk:
        raise ValueError(f"chunk {chunk} must divide L={L}")
    nc = L // chunk
    A = _per_seq(A, True, 2).to(f32)
    D_skip = _per_seq(D_skip, True, 1).to(f32)
    h0 = (torch.zeros((Bt, Dm, N), dtype=f32, device=x.device) if h0 is None
          else _per_seq(h0, True, 2).to(f32).expand(Bt, Dm, N))

    z = dt.to(f32)[..., None] * A[:, None]                     # (Bt,L,D,N)
    b = (dt.to(f32) * x.to(f32))[..., None] * B.to(f32)[:, :, None, :]
    # time-major within a chunk, chunks batched: (Lc, Bt, nc, ...)
    zt = z.reshape(Bt, nc, chunk, Dm, N).permute(2, 0, 1, 3, 4)
    bt = b.reshape(Bt, nc, chunk, Dm, N).permute(2, 0, 1, 3, 4)
    Ct = C.to(f32).reshape(Bt, nc, chunk, N).permute(2, 0, 1, 3)
    xt = x.to(f32).reshape(Bt, nc, chunk, Dm).permute(2, 0, 1, 3)
    Dsk = D_skip[:, None]                                      # (Bt,1,D)

    # pass 1: every chunk from zero local state; the carry's factor
    # E_t = exp(Σz)·C_t is the only (L, D, N)-sized result kept
    h = torch.zeros((Bt, nc, Dm, N), dtype=f32, device=x.device)
    zrun = torch.zeros_like(h)
    y_local, E = [], []
    for t in range(chunk):
        h = torch.exp(zt[t]) * h + bt[t]
        zrun = zrun + zt[t]
        C_t = Ct[t][:, :, None, :]                             # (Bt,nc,1,N)
        y_local.append((h * C_t).sum(-1) + Dsk * xt[t])
        E.append(torch.exp(zrun) * C_t)

    # pass 2: thread the carry across the chunk boundaries
    h_in, h_ins = h0, []
    for c in range(nc):
        h_ins.append(h_in)
        h_in = torch.exp(zrun[:, c]) * h_in + h[:, c]
    h_ins = torch.stack(h_ins, dim=1)                          # (Bt,nc,D,N)

    y = torch.stack(y_local) + torch.einsum(
        "tbcdn,bcdn->tbcd", torch.stack(E), h_ins)
    y = y.permute(1, 2, 0, 3).reshape(Bt, L, Dm)
    return y.to(x.dtype), h_in.to(x.dtype)
