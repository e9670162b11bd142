"""Layer kinds of the attention and MoE decoders: norms, RoPE, GQA
attention (full, chunked, one-token decode against a KV cache), gated MLP
and MoE with ticket dispatch.

A port of the reference's ``repro/models/layers.py`` for the layer kinds
the serve path of granite-moe-1b-a400m and deepseek-7b reaches.  The
functions keep its layouts: x (B, S, D); ``wq`` (D, H, hd), ``wk``/``wv``
(D, KV, hd), ``wo`` (H, hd, D); experts' ``wi``/``wg`` (E, D, ff) and
``wo`` (E, ff, D); KV caches (B, S, KV, hd).  Computation follows x's
dtype; softmax and logit reductions run in float32 and are cast back where
the reference casts.  Every product is ``torch.einsum``/``matmul``, as the
reference leaves them to XLA; the one kernel is the ticket dispatch inside
:func:`moe`.  The reference's sharding constraints have no counterpart on
one card and are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ticket_dispatch.ops import dispatch_combine_plan

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


def attention_full(p, x, cfg: ArchConfig, positions, *, causal=True):
    """Full (global) attention over x (B, S, D); returns (out, (k, v)) with
    the cache's KV heads un-expanded.  Long sequences (S > 2·Q_CHUNK) take
    the chunked-query path so the live score tensor stays O(q_chunk · S)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    kv_cache = (k, v)
    k = _gqa_expand(k, cfg.n_heads)
    v = _gqa_expand(v, cfg.n_heads)
    if S > 2 * Q_CHUNK:
        out = _attend_chunked(q, k, v, cfg, causal=causal)
    else:
        mask = (_causal_mask(S, S, device=x.device) if causal
                else torch.ones((1, 1, S, S), dtype=torch.bool,
                                device=x.device))
        out = _attend(q, k, v, mask, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), kv_cache


def attention_decode(p, x, cache_k, cache_v, pos, cfg: ArchConfig, *,
                     window: int = 0):
    """One-token decode against a KV cache.

    x (B, 1, D); cache_k/v (B, S_ctx, KV, hd); ``pos`` a python int or a
    0-d tensor (every lane at one position) or a (B,) tensor (ragged lanes,
    serving): the number of tokens so far.  The new key and value are
    written **in place** into ``cache_k``/``cache_v`` at ``pos`` (clamped
    into the cache, as the reference's ``dynamic_update_slice`` clamps), and
    the same tensors are returned: (out, cache_k, cache_v).  GQA runs as
    grouped einsums; the cache is never expanded to H heads.
    """
    if window:
        raise NotImplementedError(
            "sliding-window decode (the ring cache of 'local' layers) is not "
            "ported yet: ROADMAP, kernel 4 with attention_local")
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
    slot = pos_b.clamp(0, S_ctx - 1)
    cache_k[lanes, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[lanes, slot] = v_new[:, 0].to(cache_v.dtype)

    qg = q.reshape(B, 1, KV, M, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqgmd,bsgd->bgmqs", qg,
                          cache_k.to(x.dtype)).float() * scale
    scores = softcap(scores, cfg.attn_softcap)
    ki = torch.arange(S_ctx, device=x.device)[None, None, None, None, :]
    mask = ki <= pos_b[:, None, None, None, None]
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


def top_k_stable(x, k: int):
    """The k largest entries along the last axis, ties to the lower index
    (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_route(p, flat, cfg: ArchConfig):
    """Router of :func:`moe` over token groups flat (G, N, D): the float32
    softmax over experts and its top-k (gates renormalised, ids)."""
    logits = torch.einsum("gnd,de->gne", flat, p["router"]).float()
    gates_full = torch.softmax(logits, dim=-1)
    top_gates, top_ids = top_k_stable(gates_full, cfg.top_k)   # (G, N, K)
    top_gates = top_gates / top_gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates_full, top_gates, top_ids


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
    slots.  ``dispatch`` is the ticket-dispatch mode (``"auto"``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    ``"torch"``: the plain version).  The buffers are built by an int
    slot→token scatter and a D-wide gather: kept slots are unique by
    construction, the ticket being a per-expert FIFO position.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = groups if groups is not None else (B if S > 1 else 1)
    N = (B * S) // G
    flat = x.reshape(G, N, D)
    gates_full, top_gates, top_ids = moe_route(p, flat, cfg)

    # load-balancing aux loss (Switch/GShard style), over all tokens; the
    # one-hot by comparison (F.one_hot checks its input's range on the host,
    # a device synchronisation per layer)
    experts = torch.arange(E, device=x.device)
    density = (top_ids[..., :1] == experts).float().mean(dim=(0, 1))
    router_prob = gates_full.mean(dim=(0, 1))
    aux = cfg.router_aux_weight * E * (density * router_prob).sum()

    capacity = moe_capacity(cfg, N)
    plan = dispatch_combine_plan(top_ids, top_gates.to(x.dtype), E, capacity,
                                 grouped=True, mode=dispatch)
    slot, kept, gates = plan["slot"], plan["kept"], plan["gates"]

    # (token, k) pair -> flat buffer slot; dropped pairs -> overflow row
    flat_idx = torch.where(kept, top_ids * capacity + slot.long(),
                           E * capacity)                       # (G, N, K)
    pair_tok = (torch.arange(N * K, device=x.device) // K).expand(G, N * K)
    slot_tok = torch.full((G, E * capacity + 1), -1, dtype=torch.long,
                          device=x.device)
    slot_tok.scatter_(1, flat_idx.reshape(G, N * K), pair_tok)
    slot_tok = slot_tok[:, :-1]
    valid = slot_tok >= 0
    buffers = torch.gather(flat, 1, slot_tok.clamp_min(0)[..., None]
                           .expand(G, E * capacity, D))
    buffers = torch.where(valid[..., None], buffers,
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buffers = buffers.reshape(G, E, capacity, D)

    h = _act(cfg.act)(torch.einsum("gecd,edf->gecf", buffers, p["wi"]))
    h = h * torch.einsum("gecd,edf->gecf", buffers, p["wg"])
    out = torch.einsum("gecf,efd->gecd", h, p["wo"])            # (G,E,cap,D)

    # combine: gather each kept pair's expert output, weight by gate
    out_flat = out.reshape(G, E * capacity, D)
    safe_idx = flat_idx.clamp_max(E * capacity - 1).reshape(G, N * K, 1)
    gathered = torch.gather(out_flat, 1, safe_idx.expand(G, N * K, D))
    gathered = gathered.reshape(G, N, K, D) * gates[..., None]
    y = torch.where(kept[..., None], gathered,
                    torch.zeros((), dtype=gathered.dtype,
                                device=x.device)).sum(dim=2)
    return y.reshape(B, S, D), aux
