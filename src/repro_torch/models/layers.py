"""Layer kinds of the attention, MoE, Mamba and Griffin decoders: norms,
RoPE, GQA attention (full, chunked, sliding-window, one-token decode
against a KV cache or its ring), gated MLP, MoE with ticket dispatch, the
Mamba-1 mixer and the RG-LRU mixer, each with its one-token decode.

A port of the reference's ``repro/models/layers.py`` for the layer kinds
the serve paths of granite-moe-1b-a400m, deepseek-7b, falcon-mamba-7b,
recurrentgemma-9b, gemma3-1b and gemma2-27b reach.  The functions keep its
layouts: x (B, S, D); ``wq`` (D, H, hd), ``wk``/``wv`` (D, KV, hd), ``wo``
(H, hd, D); experts' ``wi``/``wg`` (E, D, ff) and ``wo`` (E, ff, D); KV
caches (B, S, KV, hd); the Mamba state (B, d_inner, N) and conv tail
(B, kw-1, d_inner); the RG-LRU state (B, w) and conv tail (B, kw-1, w).
Computation follows x's dtype; softmax and logit reductions run in float32
and are cast back where the reference casts.  Every product is
``torch.einsum``/``matmul``, as the reference leaves them to XLA; the
kernels are the ticket dispatch inside :func:`moe`, the selective scan
inside :func:`mamba_block` and the RG-LRU scan inside :func:`rglru_block`.
The reference's sharding constraints have no counterpart on one card and
are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.mamba_scan.ops import selective_scan
from ..kernels.rglru.ops import rglru_scan
from ..kernels.ticket_dispatch.ops import aux_loss, route_plan
from ..kernels.ticket_dispatch.ref import renormalize, top_k_stable

NEG_INF = -1e30   # the reference's mask value


# ---------------------------------------------------------------------------
# Norms / positional
# ---------------------------------------------------------------------------
def rms_norm(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _rope_angles(positions, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim//2), in float32."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=positions.device) / dim
    freqs = 1.0 / (theta ** exponents)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 10000.0, sections: tuple = ()):
    """Rotary embedding; x (B, S, H, hd), positions (B, S).  M-RoPE
    (``sections``, Qwen2-VL) is not ported yet."""
    if sections:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl's vision frontend) is not ported yet: "
            "ROADMAP, model stack")
    hd = x.shape[-1]
    cos, sin = _rope_angles(positions, hd, theta)
    cos = cos[:, :, None, :]  # (B, S, 1, hd/2)
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _gqa_expand(k, n_heads):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating KV groups."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def _masked_softmax(scores, mask, dtype):
    """Masked scores (float32) -> probabilities, cast to the compute dtype
    after the float32 softmax, as the reference casts."""
    scores = scores.masked_fill(~mask, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def _attend(q, k, v, mask, cfg: ArchConfig):
    """q (B, Sq, H, hd); k/v (B, Sk, H, hd); mask broadcastable (B,1,Sq,Sk)."""
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = softcap(scores, cfg.attn_softcap)
    probs = _masked_softmax(scores, mask, q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _causal_mask(sq, sk, offset=0, device=None):
    """offset = (#cached tokens): query i attends keys <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    return (ki <= qi)[None, None]


Q_CHUNK = 1024  # query-chunk length for the memory-bounded attention path


def _attend_chunked(q, k, v, cfg: ArchConfig, *, causal: bool,
                    q_chunk: int = Q_CHUNK):
    """Full attention with queries processed in chunks, bounding the live
    score tensor to (B, H, q_chunk, S) instead of (B, H, S, S).  Exact —
    each query row sees its full key range, so no running softmax is
    needed.  The reference's ``lax.map`` over chunks is a Python loop."""
    B, S, H, hd = q.shape
    pad = (-S) % q_chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    scale = cfg.head_dim ** -0.5
    ki = torch.arange(S, device=q.device)[None, None, None, :]
    outs = []
    for start in range(0, S + pad, q_chunk):
        qi = q[:, start:start + q_chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qi, k).float()
        scores = softcap(scores * scale, cfg.attn_softcap)
        if causal:
            qpos = (start + torch.arange(q_chunk, device=q.device))[
                None, None, :, None]
            mask = ki <= qpos
        else:
            mask = torch.ones_like(scores, dtype=torch.bool)
        probs = _masked_softmax(scores, mask, q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
    return torch.cat(outs, dim=1)[:, :S]


def _project(p, x, cfg: ArchConfig, positions):
    """q, k, v of x (B, S, D) with RoPE on q and k, k and v expanded to H
    heads, and the (k, v) the cache keeps with its KV heads un-expanded."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, _gqa_expand(k, cfg.n_heads), _gqa_expand(v, cfg.n_heads), (k, v)


def attention_full(p, x, cfg: ArchConfig, positions, *, causal=True):
    """Full (global) attention over x (B, S, D); returns (out, (k, v)) with
    the cache's KV heads un-expanded.  Long sequences (S > 2·Q_CHUNK) take
    the chunked-query path so the live score tensor stays O(q_chunk · S)."""
    S = x.shape[1]
    q, k, v, kv_cache = _project(p, x, cfg, positions)
    if S > 2 * Q_CHUNK:
        out = _attend_chunked(q, k, v, cfg, causal=causal)
    else:
        mask = (_causal_mask(S, S, device=x.device) if causal
                else torch.ones((1, 1, S, S), dtype=torch.bool,
                                device=x.device))
        out = _attend(q, k, v, mask, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), kv_cache


def attention_local(p, x, cfg: ArchConfig, positions):
    """Sliding-window attention over x (B, S, D), chunked so the cost is
    O(S · 2w), never S×S; returns (out, (k, v)) with the cache's KV heads
    un-expanded.

    With S ≤ w it is plain causal attention.  Otherwise q, k, v are padded
    to a multiple of the window w and cut into chunks of w; each query
    chunk attends to itself and the previous chunk under the band
    ``qi - w < ki ≤ qi`` (chunk 0's previous keys are masked), and the
    output is cut back to S.  Scores are float32, softcapped, masked to
    -1e30 and softmaxed in float32, as in the reference.
    """
    B, S, _ = x.shape
    w = min(cfg.window, S)
    q, k, v, kv_cache = _project(p, x, cfg, positions)
    if S <= w:
        out = _attend(q, k, v, _causal_mask(S, S, device=x.device), cfg)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), kv_cache

    pad = (-S) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    Sp = S + pad
    nc = Sp // w
    H, hd = cfg.n_heads, cfg.head_dim
    qc = q.reshape(B, nc, w, H, hd)
    kc = k.reshape(B, nc, w, H, hd)
    vc = v.reshape(B, nc, w, H, hd)
    # keys of chunk i: chunks (i-1, i); chunk -1 is zeros, masked out
    k_prev = F.pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = F.pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    kk = torch.cat([k_prev, kc], dim=2)                 # (B, nc, 2w, H, hd)
    vv = torch.cat([v_prev, vc], dim=2)

    scale = hd ** -0.5
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qc, kk).float() * scale
    scores = softcap(scores, cfg.attn_softcap)
    qi = torch.arange(w, device=x.device)[:, None] + w  # within the 2w span
    ki = torch.arange(2 * w, device=x.device)[None, :]
    band = (ki <= qi) & (ki > qi - w)                   # causal, width w
    first = torch.arange(nc, device=x.device)[:, None, None] == 0
    valid = band[None] & ~(first & (ki < w)[None])      # chunk 0: no prev
    probs = _masked_softmax(scores, valid[:, None], q.dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, vv)
    out = out.reshape(B, Sp, H, hd)[:, :S]
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), kv_cache


def attention_decode(p, x, cache_k, cache_v, pos, cfg: ArchConfig, *,
                     window: int = 0):
    """One-token decode against a KV cache.

    x (B, 1, D); cache_k/v (B, S_ctx, KV, hd); ``pos`` a python int or a
    0-d tensor (every lane at one position) or a (B,) tensor (ragged lanes,
    serving): the number of tokens so far.  The new key and value are
    written **in place** into ``cache_k``/``cache_v`` and the same tensors
    are returned: (out, cache_k, cache_v).  A full-length cache takes them
    at ``pos`` (clamped into the cache, as the reference's
    ``dynamic_update_slice`` clamps).  ``window > 0`` (sliding-window
    layers) makes the cache a ring: the slot is ``pos % S_ctx``, and
    before the ring has wrapped only slots up to ``pos`` are live, after
    it every slot holds a position within the window.  GQA runs as grouped
    einsums; the cache is never expanded to H heads.
    """
    B, _, D = x.shape
    S_ctx = cache_k.shape[1]
    KV, H, hd = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    M = H // KV
    pos_b = torch.as_tensor(pos, device=x.device)
    pos_b = (pos_b.expand(B) if pos_b.dim() == 0 else pos_b).long()
    positions = pos_b[:, None]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.mrope_sections)
    lanes = torch.arange(B, device=x.device)
    slot = pos_b % S_ctx if window else pos_b.clamp(0, S_ctx - 1)
    cache_k[lanes, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[lanes, slot] = v_new[:, 0].to(cache_v.dtype)

    qg = q.reshape(B, 1, KV, M, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqgmd,bsgd->bgmqs", qg,
                          cache_k.to(x.dtype)).float() * scale
    scores = softcap(scores, cfg.attn_softcap)
    ki = torch.arange(S_ctx, device=x.device)[None, None, None, None, :]
    pm = pos_b[:, None, None, None, None]
    mask = (ki <= pm) | (pm >= S_ctx) if window else ki <= pm
    probs = _masked_softmax(scores, mask, x.dtype)
    out = torch.einsum("bgmqs,bsgd->bqgmd", probs, cache_v.to(x.dtype))
    out = out.reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def _act(name: str):
    return {"silu": F.silu, "gelu": lambda h: F.gelu(h, approximate="tanh")
            }[name]


def mlp(p, x, cfg: ArchConfig):
    """Gated MLP (SwiGLU/GeGLU)."""
    h = _act(cfg.act)(torch.einsum("bsd,df->bsf", x, p["wi"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["wg"])
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


def router_softmax(p, flat):
    """The router's float32 softmax over experts for token groups flat
    (G, N, D)."""
    logits = torch.einsum("gnd,de->gne", flat, p["router"]).float()
    return torch.softmax(logits, dim=-1)


def moe_route(p, flat, cfg: ArchConfig):
    """Router of :func:`moe` over token groups flat (G, N, D): the float32
    softmax over experts and its top-k (gates renormalised, ids)."""
    gates_full = router_softmax(p, flat)
    top_gates, top_ids = top_k_stable(gates_full, cfg.top_k)   # (G, N, K)
    return gates_full, renormalize(top_gates), top_ids


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for a group of ``n_tokens`` tokens: the reference's
    ``max(K, int(cf·N·K/E))`` rounded up to a multiple of 8."""
    E, K = cfg.n_experts, cfg.top_k
    capacity = max(K, int(cfg.capacity_factor * n_tokens * K / E))
    return (capacity + 7) // 8 * 8


def moe(p, x, cfg: ArchConfig, dispatch: str = "auto",
        groups: int | None = None):
    """Mixture-of-experts with ticket-dispatch slot assignment; returns
    (y, aux_loss).

    Dispatch is group-wise: tokens split into ``groups`` independent groups,
    each with its own per-expert capacity.  Default groups = B (one group
    per sequence) for prefill; for one-token decode (S == 1) a single group
    over all lanes, idle lanes included, as the reference does.  Arrivals
    are ticketed in token-major order, so the earliest pairs keep their
    slots.  ``dispatch`` is the routing-plan mode
    (:func:`~repro_torch.kernels.ticket_dispatch.ops.route_plan`:
    ``"auto"`` the routing-plan kernel for CUDA tensors, the plain plan for
    CPU tensors; ``"ticket"`` the plain plan around the ticket kernel;
    ``"torch"`` the plain plan): everything from the router's softmax to
    the integer maps of the gathers.  The buffers are built by a D-wide
    gather through the plan's slot→token map: kept slots are unique by
    construction, the ticket being a per-expert FIFO position.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = groups if groups is not None else (B if S > 1 else 1)
    N = (B * S) // G
    flat = x.reshape(G, N, D)
    capacity = moe_capacity(cfg, N)
    plan = route_plan(router_softmax(p, flat), E, K, capacity, x.dtype,
                      mode=dispatch)
    # load-balancing aux loss (Switch/GShard style), over all tokens
    aux = aux_loss(plan, cfg.router_aux_weight)

    buffers = torch.gather(flat, 1, plan["slot_tok"][..., None]
                           .expand(G, E * capacity, D))
    buffers = torch.where(plan["valid"][..., None], buffers,
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buffers = buffers.reshape(G, E, capacity, D)

    h = _act(cfg.act)(torch.einsum("gecd,edf->gecf", buffers, p["wi"]))
    h = h * torch.einsum("gecd,edf->gecf", buffers, p["wg"])
    out = torch.einsum("gecf,efd->gecd", h, p["wo"])            # (G,E,cap,D)

    # combine: gather each kept pair's expert output, weight by gate
    out_flat = out.reshape(G, E * capacity, D)
    gathered = torch.gather(out_flat, 1, plan["safe_idx"][..., None]
                            .expand(G, N * K, D))
    gathered = gathered.reshape(G, N, K, D) * plan["gates"][..., None]
    y = torch.where(plan["kept"][..., None], gathered,
                    torch.zeros((), dtype=gathered.dtype,
                                device=x.device)).sum(dim=2)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------
def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere (``F.softplus``
    turns into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_inputs(p, xin, cfg: ArchConfig):
    """dt (softplus'd), B and C of the selective scan from the conv'd
    input (B, S, d_inner)."""
    dtr, N = cfg.dt_rank, cfg.ssm_state
    proj = torch.einsum("bsd,dk->bsk", xin, p["x_proj"])       # (B,S,dtr+2N)
    dt_in, Bm, Cm = proj.split([dtr, N, N], dim=-1)
    dt = softplus(torch.einsum("bsk,kd->bsd", dt_in, p["dt_proj"])
                  + p["dt_bias"])
    return dt, Bm, Cm


def _ssm_A(p, dtype):
    """A = -exp(A_log) from the float32 ``A_log``, cast to x's dtype as the
    reference casts it."""
    return (-torch.exp(p["A_log"].float())).to(dtype)


def mamba_block(p, x, cfg: ArchConfig, scan: str = "auto"):
    """Mamba-1 mixer over (B, S, D); returns (y, (h_final, conv_tail)).

    The depthwise causal conv pads kw-1 zeros in front, and its tail (the
    decode state) is the last kw-1 rows of the padded input, so a prompt
    shorter than kw-1 leaves zeros in it.  ``scan`` is the selective-scan
    mode (:func:`repro_torch.kernels.mamba_scan.ops.selective_scan`:
    ``"auto"`` the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; ``"torch"`` the plain version); the batch is one launch where
    the reference maps ``vmap`` over it.
    """
    B, S, D = x.shape
    kw = cfg.ssm_conv
    xz = torch.einsum("bsd,dk->bsk", x, p["in_proj"])           # (B,S,2di)
    xin, z = xz.chunk(2, dim=-1)

    # depthwise causal conv1d, width ssm_conv: stacked shifted views
    xpad = F.pad(xin, (0, 0, kw - 1, 0))
    shifted = torch.stack([xpad[:, i:i + S] for i in range(kw)], dim=-1)
    conv = torch.einsum("bsdk,dk->bsd", shifted, p["conv_w"]) + p["conv_b"]
    xin = F.silu(conv)

    dt, Bm, Cm = _ssm_inputs(p, xin, cfg)
    y, h_final = selective_scan(xin, dt, _ssm_A(p, xin.dtype), Bm, Cm,
                                p["D_skip"], mode=scan)
    y = y * F.silu(z)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    conv_tail = xpad[:, S:] if kw == 1 else xpad[:, -(kw - 1):]
    return out, (h_final, conv_tail)


def mamba_decode(p, x, ssm_state, conv_state, cfg: ArchConfig):
    """One-token Mamba step, plain PyTorch as in the reference (no scan
    kernel).  x (B, 1, D); ssm_state (B, d_inner, N); conv_state
    (B, kw-1, d_inner).  Returns (y, new_ssm, new_conv); the states are
    new tensors (the caller writes them into its cache)."""
    xz = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    xin, z = xz.chunk(2, dim=-1)                                # (B,1,di)
    window = torch.cat([conv_state, xin], dim=1)                # (B,kw,di)
    conv = torch.einsum("bkd,dk->bd", window, p["conv_w"]) + p["conv_b"]
    xin1 = F.silu(conv)[:, None, :]                             # (B,1,di)
    dt, Bm, Cm = _ssm_inputs(p, xin1, cfg)
    dt = dt[:, 0]                                               # (B,di)
    A = _ssm_A(p, x.dtype)
    dA = torch.exp(dt[..., None] * A[None])                     # (B,di,N)
    dBx = (dt * xin1[:, 0])[..., None] * Bm[:, 0][:, None, :]
    new_ssm = dA * ssm_state + dBx
    y = (new_ssm * Cm[:, 0][:, None, :]).sum(-1) + p["D_skip"] * xin1[:, 0]
    y = (y * F.silu(z[:, 0]))[:, None, :]
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return out, new_ssm, window[:, 1:]


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------
RGLRU_C = 8.0


def _rglru_gates(p, conv, dtype):
    """a and b of the recurrence from the conv'd input (..., w), as the
    reference computes them: a = exp(-c·softplus(Λ)·σ(r)) in float32 from
    the float32 ``lam``, **rounded to x's dtype before it makes b**;
    b = sqrt(max(1 - a², 1e-12)) (float32, then rounded) · σ(i)·conv."""
    gates = torch.einsum("...w,wk->...k", conv, p["w_rg"])
    r, i = gates.chunk(2, dim=-1)
    a = torch.exp(-RGLRU_C * softplus(p["lam"].float())
                  * torch.sigmoid(r.float())).to(dtype)
    af = a.float()
    b = torch.sqrt(torch.clamp_min(1.0 - af * af, 1e-12)).to(dtype) * (
        torch.sigmoid(i) * conv)
    return a, b


def rglru_block(p, x, cfg: ArchConfig, h0=None, scan: str = "auto"):
    """Griffin recurrent mixer over (B, S, D): projection, depthwise causal
    conv, RG-LRU, gate, projection.  Returns (y, (h_final, conv_tail)).

    The gate is the tanh-approximate GELU (``jax.nn.gelu``'s default).  The
    conv pads kw-1 zeros in front and its tail (the decode state) is the
    last kw-1 rows of the padded input, so a prompt shorter than kw-1
    leaves zeros in it.  ``scan`` is the RG-LRU scan's mode
    (:func:`repro_torch.kernels.rglru.ops.rglru_scan`: ``"auto"`` the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors; ``"torch"``
    the plain version); the batch is one launch where the reference maps
    ``vmap`` over it.  With ``h0`` None the scan starts from zeros in x's
    dtype and the kernel reads no h0.
    """
    B, S, D = x.shape
    kw = cfg.conv_width
    xb = torch.einsum("bsd,dw->bsw", x, p["w_x"])               # (B,S,w)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"]),
                  approximate="tanh")
    xpad = F.pad(xb, (0, 0, kw - 1, 0))
    shifted = torch.stack([xpad[:, i:i + S] for i in range(kw)], dim=-1)
    conv = torch.einsum("bswk,wk->bsw", shifted, p["conv_w"]) + p["conv_b"]
    a, b = _rglru_gates(p, conv, x.dtype)
    y, h_final = rglru_scan(a, b, h0, mode=scan)
    y = y * gate
    out = torch.einsum("bsw,wd->bsd", y, p["w_out"])
    return out, (h_final, xpad[:, -(kw - 1):])


def rglru_decode(p, x, h, conv_state, cfg: ArchConfig):
    """One-token RG-LRU step, plain PyTorch as in the reference (no scan
    kernel).  x (B, 1, D); h (B, w); conv_state (B, kw-1, w).  Returns (y,
    new_h, new_conv); the states are new tensors (the caller writes them
    into its cache)."""
    xb = torch.einsum("bsd,dw->bsw", x, p["w_x"])               # (B,1,w)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"]),
                  approximate="tanh")
    window = torch.cat([conv_state, xb], dim=1)                 # (B,kw,w)
    conv = torch.einsum("bkw,wk->bw", window, p["conv_w"]) + p["conv_b"]
    a, b = _rglru_gates(p, conv, x.dtype)
    h_new = a * h + b
    y = (h_new * gate[:, 0])[:, None, :]
    out = torch.einsum("bsw,wd->bsd", y, p["w_out"])
    return out, h_new, window[:, 1:]
