"""Layer kinds of the attention, MoE, Mamba and Griffin models: norms,
RoPE and Qwen2-VL's M-RoPE, GQA attention (full or bidirectional,
chunked, sliding-window, one-token decode against a KV cache or its ring),
gated MLP, MoE with ticket dispatch, the Mamba-1 mixer and the RG-LRU
mixer, each with its one-token decode.

A port of the reference's ``repro/models/layers.py``, for every config's
layer kinds.  The functions keep its
layouts: x (B, S, D); ``wq`` (D, H, hd), ``wk``/``wv`` (D, KV, hd), ``wo``
(H, hd, D); experts' ``wi``/``wg`` (E, D, ff) and ``wo`` (E, ff, D); KV
caches (B, S, KV, hd); the Mamba state (B, d_inner, N) and conv tail
(B, kw-1, d_inner); the RG-LRU state (B, w) and conv tail (B, kw-1, w).
Computation follows x's dtype; softmax and logit reductions run in float32
and are cast back where the reference casts.  Every product is
``torch.einsum``/``matmul``, as the reference leaves them to XLA; the
kernels are the ticket dispatch inside :func:`moe`, the selective scan
inside :func:`mamba_block` and the RG-LRU scan inside :func:`rglru_block`.
The reference's activation sharding constraints stand at its places
(:func:`shard_utils.constrain`): identities on one device, redistributions
of ``DTensor`` activations under the dry run's mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.causal_conv.ops import causal_conv
from ..kernels.mamba_scan.ops import selective_scan
from ..kernels.rglru.ops import rglru_scan
from ..kernels.ticket_dispatch.ops import aux_loss, route_plan
from ..kernels.ticket_dispatch.ref import renormalize, top_k_stable
from .shard_utils import (ambient_mesh, constrain, gathered,
                          mesh_axis_size, pad, relocate, shards, ways)

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
    """Rotary embedding; x (B, S, H, hd).  positions (B, S) or, for M-RoPE,
    (3, B, S) with ``sections`` giving each stream's share of the hd/2
    rotary columns (Qwen2-VL: temporal, height, width).  Each stream's
    angles are computed over the full head dim and stream s keeps columns
    ``sum(sections[:s]) : sum(sections[:s + 1])``, sliced as the reference
    slices: sections that overrun hd/2 are clipped, so a later stream may
    keep none (the reduced configs' (4, 6, 6) at hd 16)."""
    hd = x.shape[-1]
    if sections:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        cos_parts, sin_parts = [], []
        for s in range(len(sections)):
            lo, hi = sum(sections[:s]), sum(sections[:s + 1])
            c, si = _rope_angles(positions[s], hd, theta)
            cos_parts.append(c[..., lo:hi])
            sin_parts.append(si[..., lo:hi])
        cos, sin = torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)
    else:
        cos, sin = _rope_angles(positions, hd, theta)
    cos = cos[:, :, None, :]  # (B, S, 1, hd/2)
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _overwritable(t) -> bool:
    """Whether a fresh tensor ``t`` may be computed on in place: no
    autograd records it and no mesh lays it out (the dry run's byte counts
    stay those of the reference's separate buffers).  A serve's prefill
    then holds one float32 copy of its scores and logits, as the
    reference's fused softcap and softmax do, not three."""
    return ambient_mesh() is None and not (torch.is_grad_enabled()
                                           and t.requires_grad)


def _recorded(t) -> bool:
    """Whether autograd records ops on ``t`` outside any mesh."""
    return ambient_mesh() is None and torch.is_grad_enabled() and \
        t.requires_grad


class _Softcap(torch.autograd.Function):
    """cap · tanh(x / cap), keeping only its output y for the backward
    pass, whose derivative is 1 - (y / cap)²: autograd's own ops keep
    tanh's output too, a second float32 copy beside y wherever y is kept
    (the loss's logsumexp keeps the capped logits).  The forward's bits
    are those ops'."""

    @staticmethod
    def forward(ctx, x, cap):
        y = torch.div(x, cap).tanh_().mul_(cap)
        ctx.cap = cap
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        slope = torch.div(y, ctx.cap).square_().neg_().add_(1.0)
        return slope.mul_(grad), None


def softcap(x, cap: float, in_place: bool = False):
    """cap · tanh(x / cap), or x for cap 0.  ``in_place``: x is a fresh
    tensor nothing else reads, computed on in place where
    :func:`_overwritable` allows; where autograd records it outside a
    mesh, :class:`_Softcap`; the same bits every way."""
    if not cap:
        return x
    if in_place and _overwritable(x):
        return x.div_(cap).tanh_().mul_(cap)
    if _recorded(x):
        return _Softcap.apply(x, cap)
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _gqa_expand(k, n_heads, dim: int = 2):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating KV groups (``dim``: the
    KV heads' dim)."""
    kv = k.shape[dim]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=dim)


def _masked_softmax(scores, mask, dtype, split: bool = False,
                    in_place: bool = False):
    """Masked scores (float32) -> probabilities, cast to the compute dtype
    after the float32 softmax, as the reference casts.  ``in_place``: mask
    ``scores`` itself (a fresh tensor no backward needs), so that a long
    score tensor lives twice at most, as scores and probabilities.
    ``split``: the keys lie across the mesh (decode's context-sharded
    cache), so the softmax is its max, exponentials and sum, each device
    reducing its own keys and only the statistics crossing the mesh, as
    the reference's partitioner splits it (DTensor's softmax rule gathers
    the scores)."""
    scores = (scores.masked_fill_ if in_place else scores.masked_fill)(
        ~mask, NEG_INF)
    if split:
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        return (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    if in_place and _overwritable(scores):
        return torch.softmax(scores, dim=-1, out=scores).to(dtype)
    return torch.softmax(scores, dim=-1).to(dtype)


class _CappedSoftmax(torch.autograd.Function):
    """The softmax over the last dim of cap · tanh(s / cap), masked to
    -1e30 where ``mask`` is False, for float32 scores s, keeping one
    float32 tensor of the scores' size for the backward pass: the
    probabilities p, with each row's logsumexp.  The capped score y that
    tanh's derivative 1 - (y / cap)² needs is log p + lse wherever p > 0
    (where p is 0 its gradient is too).  Autograd's own ops keep tanh's
    output beside the softmax's, two float32 copies of the scores.  The
    forward's bits are those ops'."""

    @staticmethod
    def forward(ctx, scores, cap, mask):
        y = torch.div(scores, cap).tanh_().mul_(cap).masked_fill_(
            ~mask, NEG_INF)
        lse = torch.logsumexp(y, dim=-1, keepdim=True)
        p = torch.softmax(y, dim=-1, out=y)
        ctx.cap = cap
        ctx.save_for_backward(p, lse, mask)
        return p

    @staticmethod
    def backward(ctx, grad):
        p, lse, mask = ctx.saved_tensors
        g = grad * p
        g.addcmul_(p, g.sum(dim=-1, keepdim=True), value=-1.0)
        slope = torch.log(p).add_(lse).div_(ctx.cap).square_().neg_().add_(
            1.0).masked_fill_(p == 0, 0.0)
        return g.mul_(slope).masked_fill_(~mask, 0.0), None, None


def _scores(spec: str, q, k, cfg: ArchConfig):
    """Float32 attention scores ``einsum(spec, q, k)`` × head_dim^-0.5: in
    place where :func:`_overwritable` allows (the same bits)."""
    scores = torch.einsum(spec, q, k).float()
    scale = cfg.head_dim ** -0.5
    return scores.mul_(scale) if _overwritable(scores) else scores * scale


def _probs(scores, mask, cfg: ArchConfig, dtype, split: bool = False,
           in_place: bool = False):
    """Scaled float32 scores (a fresh tensor) -> probabilities in
    ``dtype``: softcapped by ``cfg.attn_softcap``, then
    :func:`_masked_softmax` (``split``, ``in_place``); where autograd
    records a softcapped pass outside a mesh, :class:`_CappedSoftmax`."""
    if cfg.attn_softcap and _recorded(scores):
        return _CappedSoftmax.apply(scores, cfg.attn_softcap, mask).to(dtype)
    return _masked_softmax(softcap(scores, cfg.attn_softcap, in_place=True),
                           mask, dtype, split, in_place)


def _attend(q, k, v, mask, cfg: ArchConfig):
    """q (B, Sq, H, hd); k/v (B, Sk, H, hd); mask broadcastable (B,1,Sq,Sk)."""
    scores = _scores("bqhd,bkhd->bhqk", q, k, cfg)
    probs = _probs(scores, mask, cfg, q.dtype)
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
    S = q.shape[1]
    extra = (-S) % q_chunk
    if extra:
        q = pad(q, (0, 0, 0, 0, 0, extra))
    ki = torch.arange(S, device=q.device)[None, None, None, :]
    outs = []
    for start in range(0, S + extra, q_chunk):
        scores = _scores("bqhd,bkhd->bhqk", q[:, start:start + q_chunk], k,
                         cfg)
        if causal:
            qpos = (start + torch.arange(q_chunk, device=q.device))[
                None, None, :, None]
            mask = ki <= qpos
        else:
            mask = torch.ones_like(scores, dtype=torch.bool)
        probs = _probs(scores, mask, cfg, q.dtype, in_place=True)
        del scores                      # no chunk's scores outlive it
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
        del probs
    return torch.cat(outs, dim=1)[:, :S]


def _residual(t):
    """A block's output (B, S, D) as the residual stream holds it: batch on
    the batch axes, the sequence on 'seq''s (none unless sequence
    parallel), D whole, or on the FSDP axis where the batch leaves it idle
    (one lane), as the reference's partitioner keeps it; a pending partial
    sum over the heads' or hidden dim's mesh axis is reduced here, where
    the reference's partitioner reduces it (an identity without a mesh)."""
    return constrain(t, "batch", "seq",
                     "embed" if _one_lane(t.shape[0]) else None)


def _one_lane(b: int) -> bool:
    """Whether ``b`` lanes leave the batch's mesh axes idle (one lane on
    16; False without a mesh)."""
    return ways("batch") > 1 and not shards("batch", b)


def _heads(t):
    """(B, S, H, hd) with its heads on their mesh axis, its batch on the
    batch axes (an identity without a mesh)."""
    return constrain(t, "batch", None, "heads", None)


def _repeat_heads(t, n_heads: int):
    """``_gqa_expand`` as an expand and a flatten, which a device takes on
    its own part of heads sharded over the mesh (a ``repeat_interleave``
    would gather them)."""
    B, S, G, hd = t.shape
    return t[:, :, :, None].expand(B, S, G, n_heads // G, hd).reshape(
        B, S, n_heads, hd)


def _project(p, x, cfg: ArchConfig, positions, cache: bool = True):
    """q, k, v of x (B, S, D) with RoPE on q and k, k and v expanded to H
    heads, and the (k, v) the cache keeps with its KV heads un-expanded
    (None when ``cache`` is False).

    Under a mesh the heads lie on their mesh axis.  Where the heads shard
    it and the KV heads do not (8 KV heads on 16), each device projects
    only the KV heads its own heads read, as the reference's partitioner
    lays k and v out: the KV weights are repeated to as many heads as the
    mesh axis has devices (or a multiple of KV), so each device computes
    its KV head once, and then expanded to its heads on the device; the
    cache's KV heads are taken back from them, their context on 'model'
    (decode's layout)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    wk, wv = p["wk"], p["wv"]
    expanded = KV != H and shards("heads", H) and not shards("kv_heads", KV)
    if expanded:
        groups = math.lcm(KV, ways("heads"))
        wk, wv = (constrain(_gqa_expand(w, groups, dim=1), "embed", "heads",
                            None) for w in (wk, wv))
    q = _heads(torch.einsum("bsd,dhk->bshk", x, p["wq"]))
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if expanded:
        k, v = _heads(k), _heads(v)
        kv_cache = tuple(constrain(t, "batch", "model", None, None)[
            :, :, ::groups // KV] for t in (k, v)) if cache else None
        return (q, _heads(_repeat_heads(k, H)), _heads(_repeat_heads(v, H)),
                kv_cache)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    kv_cache = (k, v) if cache else None
    return q, _heads(_gqa_expand(k, H)), _heads(_gqa_expand(v, H)), kv_cache


def attention_full(p, x, cfg: ArchConfig, positions, *, causal=True,
                   cache: bool = True):
    """Full (global) attention over x (B, S, D); returns (out, (k, v)) with
    the cache's KV heads un-expanded (None for (k, v) when ``cache`` is
    False).  Long sequences (S > 2·Q_CHUNK) take the chunked-query path so
    the live score tensor stays O(q_chunk · S).  Under a mesh each device
    attends with its own heads (:func:`_project`)."""
    S = x.shape[1]
    q, k, v, kv_cache = _project(p, x, cfg, positions, cache)
    if S > 2 * Q_CHUNK:
        out = _attend_chunked(q, k, v, cfg, causal=causal)
    else:
        mask = (_causal_mask(S, S, device=x.device) if causal
                else torch.ones((1, 1, S, S), dtype=torch.bool,
                                device=x.device))
        out = _attend(q, k, v, mask, cfg)
    return _residual(torch.einsum("bshk,hkd->bsd", out, p["wo"])), kv_cache


def attention_local(p, x, cfg: ArchConfig, positions, *,
                    cache: bool = True):
    """Sliding-window attention over x (B, S, D), chunked so the cost is
    O(S · 2w), never S×S; returns (out, (k, v)) with the cache's KV heads
    un-expanded (None for (k, v) when ``cache`` is False).

    With S ≤ w it is plain causal attention.  Otherwise q, k, v are padded
    to a multiple of the window w and cut into chunks of w; each query
    chunk attends to itself and the previous chunk under the band
    ``qi - w < ki ≤ qi`` (chunk 0's previous keys are masked), and the
    output is cut back to S.  Scores are float32, softcapped, masked to
    -1e30 and softmaxed in float32, as in the reference.
    """
    B, S, _ = x.shape
    w = min(cfg.window, S)
    q, k, v, kv_cache = _project(p, x, cfg, positions, cache)
    if S <= w:
        out = _attend(q, k, v, _causal_mask(S, S, device=x.device), cfg)
        return _residual(torch.einsum("bshk,hkd->bsd", out, p["wo"])), kv_cache

    extra = (-S) % w
    if extra:
        q, k, v = (pad(t, (0, 0, 0, 0, 0, extra)) for t in (q, k, v))
    Sp = S + extra
    nc = Sp // w
    H, hd = cfg.n_heads, cfg.head_dim
    qc = q.reshape(B, nc, w, H, hd)
    kc = k.reshape(B, nc, w, H, hd)
    vc = v.reshape(B, nc, w, H, hd)
    # keys of chunk i: chunks (i-1, i); chunk -1 is zeros, masked out
    k_prev = pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    kk = torch.cat([k_prev, kc], dim=2)                 # (B, nc, 2w, H, hd)
    vv = torch.cat([v_prev, vc], dim=2)

    scores = _scores("bnqhd,bnkhd->bnhqk", qc, kk, cfg)
    qi = torch.arange(w, device=x.device)[:, None] + w  # within the 2w span
    ki = torch.arange(2 * w, device=x.device)[None, :]
    band = (ki <= qi) & (ki > qi - w)                   # causal, width w
    first = torch.arange(nc, device=x.device)[:, None, None] == 0
    valid = band[None] & ~(first & (ki < w)[None])      # chunk 0: no prev
    probs = _probs(scores, valid[:, None], cfg, q.dtype, in_place=True)
    del scores
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, vv)
    out = out.reshape(B, Sp, H, hd)[:, :S]
    return _residual(torch.einsum("bshk,hkd->bsd", out, p["wo"])), kv_cache


def _decode_proj(x, w):
    """x (B, 1, D) @ w (D, n, hd) -> (B, 1, n, hd).  Under a mesh where the
    lanes shard and the n heads do not shard their mesh axis but their n·hd
    columns do (8 KV heads, or gemma3's 4 heads, on 16), each device
    computes its part of the columns, which are then gathered, as the
    reference's partitioner splits the one-token projection (DTensor would
    run it whole on every device of that axis).  With one lane the
    reference contracts over the FSDP-split D and keeps the columns whole,
    and so does this."""
    D, n, hd = w.shape
    if (ambient_mesh() is None or shards("heads", n)
            or not shards("heads", n * hd) or not shards("batch", x.shape[0])):
        return torch.einsum("bsd,dhk->bshk", x, w)
    cols = constrain(w.reshape(D, n * hd), "embed", "heads")
    out = constrain(torch.einsum("bsd,dk->bsk", x, cols), "batch", None, None)
    return out.reshape(*x.shape[:2], n, hd)


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
    if cfg.mrope_sections:      # one position in all three M-RoPE streams
        positions = positions.expand(3, B, 1)
    q = _heads(_decode_proj(x, p["wq"]))
    k_new = _decode_proj(x, p["wk"])
    v_new = _decode_proj(x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.mrope_sections)
    lanes = torch.arange(B, device=x.device)
    slot = pos_b % S_ctx if window else pos_b.clamp(0, S_ctx - 1)
    cache_k[lanes, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[lanes, slot] = v_new[:, 0].to(cache_v.dtype)
    # under a mesh: the cache's KV heads on 'model' where they divide it,
    # else its context dim, with q's heads replicated (one lane's ring
    # cache, its context on 'data', moves there point to point)
    model_size = mesh_axis_size("model")
    kv_sharded = model_size > 1 and KV % model_size == 0
    if kv_sharded:
        cache_k = constrain(cache_k, "batch", None, "model", None)
        cache_v = constrain(cache_v, "batch", None, "model", None)
    else:
        cache_k = relocate(cache_k, "batch", "model", None, None)
        cache_v = relocate(cache_v, "batch", "model", None, None)

    qg = q.reshape(B, 1, KV, M, hd)
    if not kv_sharded:
        qg = constrain(qg, "batch", None, None, None, None)
    scores = _scores("bqgmd,bsgd->bgmqs", qg, cache_k.to(x.dtype), cfg)
    ki = torch.arange(S_ctx, device=x.device)[None, None, None, None, :]
    pm = pos_b[:, None, None, None, None]
    mask = (ki <= pm) | (pm >= S_ctx) if window else ki <= pm
    probs = _probs(scores, mask, cfg, x.dtype,
                   split=model_size > 1 and not kv_sharded)
    if not kv_sharded:
        # keys on 'model'; where one lane leaves 'data' idle the heads take
        # it, as the reference's partitioner splits the value product
        # (torch 2.11's rules would run it with every head on each device)
        probs = constrain(probs, "batch", None, "data", None, "model")
    out = torch.einsum("bgmqs,bsgd->bqgmd", probs, cache_v.to(x.dtype))
    out = out.reshape(B, 1, H, hd)
    return (_residual(torch.einsum("bshk,hkd->bsd", out, p["wo"])), cache_k,
            cache_v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def _act(name: str):
    return {"silu": F.silu, "gelu": lambda h: F.gelu(h, approximate="tanh")
            }[name]


def _ffn(t):
    """(B, S, ff) with its hidden dim on its mesh axis (an identity
    without a mesh)."""
    return constrain(t, "batch", None, "ffn")


def mlp(p, x, cfg: ArchConfig):
    """Gated MLP (SwiGLU/GeGLU); under a mesh each device holds its part of
    the hidden dim."""
    h = _act(cfg.act)(_ffn(torch.einsum("bsd,df->bsf", x, p["wi"])))
    h = h * _ffn(torch.einsum("bsd,df->bsf", x, p["wg"]))
    return _residual(torch.einsum("bsf,fd->bsd", h, p["wo"]))


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


class _Dispatch(torch.autograd.Function):
    """The expert buffers ``where(valid, flat[g, slot_tok[g, s]], 0)``,
    whose backward sums each token's K kept slots through the pair→slot
    map ``safe_idx``, K terms in a fixed order, where the gather's own
    backward scatter-adds them.  On CUDA a scatter-add sums with atomics in
    whatever order the threads arrive, a bf16 rounding at each add, so two
    runs of one training step part in the last bits and the parting grows
    step by step; the reference's scatter-add on its device has a fixed
    order.  A valid slot holds exactly one kept pair's token, so the two
    backwards are the same sum."""

    @staticmethod
    def forward(ctx, flat, slot_tok, valid, safe_idx, kept):
        G, n_slots = slot_tok.shape
        D = flat.shape[-1]
        ctx.save_for_backward(safe_idx, kept)
        buffers = torch.gather(flat, 1, slot_tok[..., None]
                               .expand(G, n_slots, D))
        return torch.where(valid[..., None], buffers,
                           torch.zeros((), dtype=flat.dtype,
                                       device=flat.device))

    @staticmethod
    def backward(ctx, grad):
        safe_idx, kept = ctx.saved_tensors
        G, N, K = kept.shape
        per_pair = torch.gather(grad, 1, safe_idx[..., None]
                                .expand(G, N * K, grad.shape[-1]))
        per_pair = torch.where(kept[..., None],
                               per_pair.reshape(G, N, K, -1),
                               torch.zeros((), dtype=grad.dtype,
                                           device=grad.device))
        return per_pair.sum(dim=2), None, None, None, None


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
    construction, the ticket being a per-expert FIFO position.  Its
    backward (:class:`_Dispatch`) sums each token's slots in a fixed
    order, so a training step on the card gives the same bits run after
    run.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = groups if groups is not None else (B if S > 1 else 1)
    N = (B * S) // G
    flat = constrain(x.reshape(G, N, D), "batch", None, None)
    capacity = moe_capacity(cfg, N)
    plan = route_plan(router_softmax(p, flat), E, K, capacity, x.dtype,
                      mode=dispatch)
    # load-balancing aux loss (Switch/GShard style), over all tokens
    aux = aux_loss(plan, cfg.router_aux_weight)

    if ambient_mesh() is None:
        buffers = _Dispatch.apply(flat, plan["slot_tok"], plan["valid"],
                                  plan["safe_idx"], plan["kept"])
    else:   # the dry run records the reference's scatter-add
        buffers = torch.gather(flat, 1, plan["slot_tok"][..., None]
                               .expand(G, E * capacity, D))
        buffers = torch.where(plan["valid"][..., None], buffers,
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
    buffers = constrain(buffers, "batch", None, None)
    buffers = buffers.reshape(G, E, capacity, D)

    h = _act(cfg.act)(torch.einsum("gecd,edf->gecf", buffers, p["wi"]))
    h = h * torch.einsum("gecd,edf->gecf", buffers, p["wg"])
    h = constrain(h, "batch", None, None, "model")
    out = torch.einsum("gecf,efd->gecd", h, p["wo"])            # (G,E,cap,D)

    # combine: gather each kept pair's expert output, weight by gate
    out_flat = constrain(out.reshape(G, E * capacity, D), "batch", None,
                         None)
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


def _inner(t):
    """(B, S, d_inner) with its inner dim on its mesh axis (an identity
    without a mesh)."""
    return constrain(t, "batch", None, "inner")


def _halves(x, w, axis: str):
    """``(x @ w).chunk(2, -1)`` for x (B, S, D), w (D, 2k).  Under a mesh
    that shards w's last dim (logical ``axis``) each half is the product
    with its half of w, laid out on the mesh: chunking the sharded product
    would gather it on every device.  Each device's part of a half of w
    (its rows whole, as the FSDP gather left them: the product contracts
    them) is half of one device's part of w, sent to it point to point
    (:func:`relocate`; the backward sends the cotangents back), where
    chunking w would gather it over the axis."""
    if not shards(axis, w.shape[-1]):
        return torch.einsum("bsd,dk->bsk", x, w).chunk(2, dim=-1)
    return tuple(constrain(torch.einsum("bsd,dk->bsk", x, h), "batch", None,
                           axis)
                 for h in relocate(w, None, axis, chunks=2))


def _ssm_inputs(p, xin, cfg: ArchConfig):
    """dt (softplus'd), B and C of the selective scan from the conv'd
    input (B, S, d_inner)."""
    dtr, N = cfg.dt_rank, cfg.ssm_state
    proj = constrain(torch.einsum("bsd,dk->bsk", xin, p["x_proj"]),
                     "batch", None, None)                      # (B,S,dtr+2N)
    dt_in, Bm, Cm = proj.split([dtr, N, N], dim=-1)
    dt = softplus(_inner(torch.einsum("bsk,kd->bsd", dt_in, p["dt_proj"]))
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
    shorter than kw-1 leaves zeros in it.  ``scan`` picks both of the
    mixer's kernels, the causal conv with its bias and SiLU
    (:func:`repro_torch.kernels.causal_conv.ops.causal_conv`) and the
    selective scan (:func:`repro_torch.kernels.mamba_scan.ops
    .selective_scan`): ``"auto"`` the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors; ``"torch"`` the plain versions.  The
    batch is one launch of each where the reference maps ``vmap`` over it.
    """
    xin, z = _halves(x, p["in_proj"], "inner")                   # (B,S,di)
    # depthwise causal conv1d of width ssm_conv, its bias and SiLU
    xin, conv_tail = causal_conv(xin, p["conv_w"], p["conv_b"], mode=scan)
    xin = _inner(xin)

    dt, Bm, Cm = _ssm_inputs(p, xin, cfg)
    y, h_final = selective_scan(xin, _inner(dt), _ssm_A(p, xin.dtype),
                                *(constrain(t, "batch", None, None)
                                  for t in (Bm, Cm)),
                                p["D_skip"], mode=scan)
    y = _inner(y) * F.silu(z)
    out = _residual(torch.einsum("bsk,kd->bsd", y, p["out_proj"]))
    return out, (h_final, conv_tail)


def mamba_decode(p, x, ssm_state, conv_state, cfg: ArchConfig):
    """One-token Mamba step, plain PyTorch as in the reference (no scan
    kernel).  x (B, 1, D); ssm_state (B, d_inner, N); conv_state
    (B, kw-1, d_inner).  Returns (y, new_ssm, new_conv); the states are
    new tensors (the caller writes them into its cache)."""
    # one token: split the product, its partial sums reduced first (moving
    # a token's 2·d_inner costs less than moving the weight's halves, as
    # _halves does); under a mesh each device's part of x, or of z, is half
    # of one device's part of xz, sent to it point to point
    xz = _inner(torch.einsum("bsd,dk->bsk", x, p["in_proj"]))
    xin, z = relocate(xz, "batch", None, "inner", chunks=2)     # (B,1,di)
    window = torch.cat([conv_state, xin], dim=1)                # (B,kw,di)
    conv = torch.einsum("bkd,dk->bd", window, p["conv_w"]) + p["conv_b"]
    xin1 = _inner(F.silu(conv)[:, None, :])                     # (B,1,di)
    dt, Bm, Cm = _ssm_inputs(p, xin1, cfg)
    dt = dt[:, 0]                                               # (B,di)
    A = _ssm_A(p, x.dtype)
    dA = torch.exp(dt[..., None] * A[None])                     # (B,di,N)
    dBx = (dt * xin1[:, 0])[..., None] * Bm[:, 0][:, None, :]
    new_ssm = dA * ssm_state + dBx
    y = (new_ssm * Cm[:, 0][:, None, :]).sum(-1) + p["D_skip"] * xin1[:, 0]
    y = (y * F.silu(z[:, 0]))[:, None, :]
    out = _residual(torch.einsum("bsk,kd->bsd", y, p["out_proj"]))
    return out, new_ssm, window[:, 1:]


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------
RGLRU_C = 8.0


def _lru(t):
    """(B, S, w) with its width on its mesh axis (an identity without a
    mesh)."""
    return constrain(t, "batch", None, "lru")


def _rglru_gates(p, conv, dtype, cols: str = "lru"):
    """a and b of the recurrence from the conv'd input (lanes, ..., w), as
    the reference computes them: a = exp(-c·softplus(Λ)·σ(r)) in float32
    from the float32 ``lam``, **rounded to x's dtype before it makes b**;
    b = sqrt(max(1 - a², 1e-12)) (float32, then rounded) · σ(i)·conv.

    Under a mesh the product's partial sums over the width are reduced
    onto the mesh axes of logical ``cols``, the lanes kept where they lie:
    with ``"lru"`` a reduce-scatter of its columns onto Λ's axis, with one
    lane (its columns on the idle batch axes, ``"batch"``) an all-reduce
    over Λ's axis, as the reference's partitioner reduces it.  Each
    device's parts of r and i, laid out as Λ, then lie whole in one
    device's part of the product and are sent to it point to point
    (:func:`relocate`), where making the product whole and cutting it
    would move all of it.  The reduction is DTensor's own redistribution
    (:func:`gathered`), whose backward hands the product's cotangent on
    whole, as the gather-and-cut did: the contraction's backward then runs
    on each device as before, the same sums in the same order."""
    lead = (None,) * (conv.dim() - 2)
    gates = gathered(torch.einsum("...w,wk->...k", conv, p["w_rg"]),
                     "batch", *lead, cols)
    r, i = relocate(gates, "batch", *lead, "lru", chunks=2)
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
    xb = _lru(torch.einsum("bsd,dw->bsw", x, p["w_x"]))         # (B,S,w)
    gate = F.gelu(_lru(torch.einsum("bsd,dw->bsw", x, p["w_gate"])),
                  approximate="tanh")
    xpad = pad(xb, (0, 0, kw - 1, 0))
    shifted = torch.stack([xpad[:, i:i + S] for i in range(kw)], dim=3)
    conv = torch.einsum("bswk,wk->bsw", shifted, p["conv_w"]) + p["conv_b"]
    a, b = (_lru(t) for t in _rglru_gates(p, _lru(conv), x.dtype))
    y, h_final = rglru_scan(a, b, h0, mode=scan)
    y = _lru(y) * gate
    out = _residual(torch.einsum("bsw,wd->bsd", y, p["w_out"]))
    # the tail copied out: a view would keep the whole padded input alive
    return out, (h_final, xpad[:, -(kw - 1):].clone())


def rglru_decode(p, x, h, conv_state, cfg: ArchConfig):
    """One-token RG-LRU step, plain PyTorch as in the reference (no scan
    kernel).  x (B, 1, D); h (B, w); conv_state (B, kw-1, w).  Returns (y,
    new_h, new_conv); the states are new tensors (the caller writes them
    into its cache)."""
    xb = _lru(torch.einsum("bsd,dw->bsw", x, p["w_x"]))         # (B,1,w)
    gate = F.gelu(_lru(torch.einsum("bsd,dw->bsw", x, p["w_gate"])),
                  approximate="tanh")
    window = torch.cat([conv_state, xb], dim=1)                 # (B,kw,w)
    conv = torch.einsum("bkw,wk->bw", window, p["conv_w"]) + p["conv_b"]
    cols = "lru"
    if _one_lane(x.shape[0]):
        # the gate product's columns lie on the idle batch axes, as the
        # reference's partitioner splits it
        p = {**p, "w_rg": constrain(p["w_rg"], "lru", "batch")}
        cols = "batch"
    a, b = _rglru_gates(p, conv, x.dtype, cols)
    h_new = a * h + b
    y = (h_new * gate[:, 0])[:, None, :]
    out = _residual(torch.einsum("bsw,wd->bsd", y, p["w_out"]))
    return out, h_new, window[:, 1:]
