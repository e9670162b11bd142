"""Model builder: parameter init, forward, prefill and one-token decode with
a KV, ring or recurrent-state cache, for the attention decoders (dense and
MoE, full and sliding-window), the Mamba-1 stack and the Griffin hybrid.

A port of the reference's ``repro/models/model.py`` for layer kinds
``global``, ``local``, ``mamba`` and ``rglru``.  Parameters keep the
reference's tree so that the two packages can compute with the same
weights (:func:`params_from_numpy`):
``{"embed", "final_norm", "stack": {"slot<j>": {name: (P, ...)}},
"tail": [{name: ...}], "lm_head"?}`` with the layers of each slot of the
layer pattern stacked over the P periods.  The reference scans over
periods; here a Python loop walks them, indexing the stacked tensors.
Caches keep the same tree: (P, B, S_ctx, KV, hd) ``k``/``v`` leaves for
global attention layers, a ring of (P, B, min(S_ctx, window), KV, hd)
``k``/``v`` for sliding-window (``local``) layers, (P, B, d_inner, N)
``ssm`` and (P, B, kw-1, d_inner) ``conv`` leaves for Mamba layers, and
(P, B, w) ``h`` and (P, B, kw-1, w) ``conv`` leaves for RG-LRU layers.

The vision and audio frontends raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.mamba_scan.ops import MODES as SCAN_MODES
from . import layers as L

KINDS = ("global", "local", "mamba", "rglru")
# parameter inits kept in float32 whatever the config's dtype
_FLOAT32_INITS = ("a_log", "lam")


def _require_ported(kind: str, cfg: ArchConfig) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


def _check_ported(cfg: ArchConfig) -> None:
    for kind in dict.fromkeys(cfg.layer_pattern):
        _require_ported(kind, cfg)
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"the {cfg.frontend} frontend ({cfg.name}) is not ported yet: "
            "ROADMAP, model stack (vision and audio frontends)")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _attn_layer_shapes(cfg: ArchConfig) -> dict:
    """Name -> (shape, init) of one attention layer; init is ``"normal"``
    (× 0.02) or ``"zeros"``."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    shapes = {"ln1": ((d,), "zeros"), "ln2": ((d,), "zeros"),
              "wq": ((d, H, hd), "normal"), "wk": ((d, KV, hd), "normal"),
              "wv": ((d, KV, hd), "normal"), "wo": ((H, hd, d), "normal")}
    if cfg.n_experts:
        E = cfg.n_experts
        shapes |= {"router": ((d, E), "normal"),
                   "wi": ((E, d, ff), "normal"), "wg": ((E, d, ff), "normal"),
                   "wo_mlp": ((E, ff, d), "normal")}
    else:
        shapes |= {"wi": ((d, ff), "normal"), "wg": ((d, ff), "normal"),
                   "wo_mlp": ((ff, d), "normal")}
    return shapes


def _mamba_layer_shapes(cfg: ArchConfig) -> dict:
    """Name -> (shape, init) of one Mamba layer.  Inits beside the random
    normals are the reference's: ``A_log`` = log(1..N) in float32 whatever
    the config's dtype (``"a_log"``), ``D_skip`` ones, ``dt_bias`` -4.6
    (softplus⁻¹(0.01)), ``conv_b`` and ``ln1`` zeros."""
    d, di, N, dtr, kw = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.ssm_conv)
    return {"ln1": ((d,), "zeros"), "in_proj": ((d, 2 * di), "normal"),
            "conv_w": ((di, kw), "normal"), "conv_b": ((di,), "zeros"),
            "A_log": ((di, N), "a_log"),
            "x_proj": ((di, dtr + 2 * N), "normal"),
            "dt_proj": ((dtr, di), "normal"), "dt_bias": ((di,), "dt_bias"),
            "D_skip": ((di,), "ones"), "out_proj": ((di, d), "normal")}


def _rglru_layer_shapes(cfg: ArchConfig) -> dict:
    """Name -> (shape, init) of one RG-LRU (Griffin recurrent) layer:
    ``lam`` (Λ) is the reference's ``"lam"`` init, float32 whatever the
    config's dtype; ``conv_b``, ``ln1`` and ``ln2`` zeros."""
    d, w, kw, ff = cfg.d_model, cfg.lru_width, cfg.conv_width, cfg.d_ff
    return {"ln1": ((d,), "zeros"), "ln2": ((d,), "zeros"),
            "w_x": ((d, w), "normal"), "w_gate": ((d, w), "normal"),
            "conv_w": ((w, kw), "normal"), "conv_b": ((w,), "zeros"),
            "w_rg": ((w, 2 * w), "normal"), "lam": ((w,), "lam"),
            "w_out": ((w, d), "normal"), "wi": ((d, ff), "normal"),
            "wg": ((d, ff), "normal"), "wo_mlp": ((ff, d), "normal")}


def _layer_shapes(kind: str, cfg: ArchConfig) -> dict:
    _require_ported(kind, cfg)
    if kind == "mamba":
        return _mamba_layer_shapes(cfg)
    if kind == "rglru":
        return _rglru_layer_shapes(cfg)
    return _attn_layer_shapes(cfg)


def _param_layout(cfg: ArchConfig) -> dict:
    """The parameter tree with (shape, init) leaves; stacked leaves lead
    with P."""
    _check_ported(cfg)
    P = cfg.n_periods
    tree = {"embed": ((cfg.padded_vocab, cfg.d_model), "normal"),
            "final_norm": ((cfg.d_model,), "zeros"),
            "stack": ({f"slot{j}": {k: ((P,) + s, init) for k, (s, init)
                                    in _layer_shapes(kind, cfg).items()}
                       for j, kind in enumerate(cfg.layer_pattern)}
                      if P else {}),
            "tail": [_layer_shapes(kind, cfg) for kind in cfg.tail_kinds]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((cfg.d_model, cfg.padded_vocab), "normal")
    return tree


def _build_tree(layout: dict, fn) -> dict:
    """The tree of ``layout`` with each leaf replaced by
    ``fn(path, shape, init)``, built in the layout's order (the order
    :func:`init_params` draws in)."""
    out = {}
    for key, node in layout.items():
        if key == "stack":
            out[key] = {j: {k: fn(f"stack/{j}/{k}", *leaf)
                            for k, leaf in slot.items()}
                        for j, slot in node.items()}
        elif key == "tail":
            out[key] = [{k: fn(f"tail/{i}/{k}", *leaf)
                         for k, leaf in layer.items()}
                        for i, layer in enumerate(node)]
        else:
            out[key] = fn(key, *node)
    return out


def param_shapes(cfg: ArchConfig) -> dict:
    """The parameter tree's shapes (stacked leaves lead with P)."""
    return _build_tree(_param_layout(cfg), lambda path, shape, init: shape)


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device=None) -> dict:
    """Random parameters with the reference's shapes, scales and constant
    inits (normal × 0.02, the rest as :func:`_mamba_layer_shapes` and
    :func:`_rglru_layer_shapes` say; Λ from u ~ U(0.9, 0.999) as
    log(expm1(-log(u) / c)), so that a^(1/c) spreads over (0.9, 0.999)),
    drawn from ``generator`` on ``device`` (``cuda`` unless named; it must
    be the generator's device).  The values are not the reference's: its
    ``jax.random`` keys draw other numbers."""
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"on {device}")
    dtype = torch_dtype(cfg)

    def leaf(path, shape, init):
        if init == "normal":
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            return (w * 0.02).to(dtype)
        if init == "a_log":
            n = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(n).expand(shape).contiguous()
        if init == "lam":
            u = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=device) * (0.999 - 0.9) + 0.9
            return torch.log(torch.expm1(-torch.log(u) / L.RGLRU_C))
        value = {"zeros": 0.0, "ones": 1.0, "dt_bias": -4.6}[init]
        return torch.full(shape, value, dtype=dtype, device=device)

    return _build_tree(_param_layout(cfg), leaf)


def params_from_numpy(cfg: ArchConfig, tree, *, device=None,
                      dtype: torch.dtype | None = None) -> dict:
    """The reference's parameter tree, as numpy arrays (``stack/slot<j>``
    stacked over periods, a ``tail`` list), as the port's tensors on
    ``device`` (``cuda`` unless named) in the config's dtype (or
    ``dtype``); ``A_log`` and ``lam`` stay float32, as in the reference.
    Every shape is checked against :func:`param_shapes`."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)

    def get(path):
        node = tree
        for part in path.split("/"):
            node = node[int(part)] if isinstance(node, (list, tuple)) \
                else node[part]
        return node

    def conv(path, shape, init):
        a = np.asarray(get(path))
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device,
            dtype=torch.float32 if init in _FLOAT32_INITS else dtype)

    return _build_tree(_param_layout(cfg), conv)


def _layers(params, cfg: ArchConfig):
    """(kind, layer params, where) in depth order: period i's slots, then
    the tail; ``where`` is ("stack", slot, i) or ("tail", i)."""
    for i in range(cfg.n_periods):
        for j, kind in enumerate(cfg.layer_pattern):
            yield kind, {k: v[i] for k, v in params["stack"][f"slot{j}"]
                         .items()}, ("stack", f"slot{j}", i)
    for i, kind in enumerate(cfg.tail_kinds):
        yield kind, params["tail"][i], ("tail", i)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _mlp(p, x, cfg: ArchConfig):
    """Norm, then the gated MLP, added to the residual."""
    h = L.rms_norm(p["ln2"], x, cfg.rms_eps)
    return x + L.mlp({"wi": p["wi"], "wg": p["wg"], "wo": p["wo_mlp"]}, h,
                     cfg)


def _mixer_mlp(p, x, cfg: ArchConfig, dispatch: str):
    """An attention layer's second half: norm, then MoE or the gated
    MLP."""
    if cfg.n_experts:
        h = L.rms_norm(p["ln2"], x, cfg.rms_eps)
        moe_out, aux = L.moe({"router": p["router"], "wi": p["wi"],
                              "wg": p["wg"], "wo": p["wo_mlp"]}, h, cfg,
                             dispatch)
        return x + moe_out, aux
    return _mlp(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                        device=x.device)


def _ring(t, window: int):
    """A local layer's prefill keys or values (B, S, KV, hd) in the ring's
    layout when S exceeds the window W: the last W positions, slot j
    holding the position ≡ j (mod W), as decode writes ``pos % W``."""
    S, W = t.shape[1], window
    if S <= W:
        return t
    idx = S - W + (torch.arange(W, device=t.device) - S % W) % W
    return t.index_select(1, idx)


def apply_layer(kind: str, p, x, cfg: ArchConfig, positions,
                dispatch: str = "auto", scan: str = "auto"):
    """One layer; returns (x, aux_loss, cache_entry).  ``dispatch`` is the
    MoE routing-plan mode (:func:`layers.moe`), ``scan`` the mode of
    the recurrences' scans (the selective scan of :func:`layers.mamba_block`
    and the RG-LRU scan of :func:`layers.rglru_block`)."""
    _require_ported(kind, cfg)
    h = L.rms_norm(p["ln1"], x, cfg.rms_eps)
    no_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mamba":
        out, (ssm, conv) = L.mamba_block(p, h, cfg, scan)
        return x + out, no_aux, {"ssm": ssm, "conv": conv}
    if kind == "rglru":
        out, (hf, conv) = L.rglru_block(p, h, cfg, scan=scan)
        return _mlp(p, x + out, cfg), no_aux, {"h": hf, "conv": conv}
    if kind == "local":
        attn_out, (ck, cv) = L.attention_local(p, h, cfg, positions)
        ck, cv = _ring(ck, cfg.window), _ring(cv, cfg.window)
    else:
        attn_out, (ck, cv) = L.attention_full(p, h, cfg, positions,
                                              causal=cfg.causal)
    x, aux = _mixer_mlp(p, x + attn_out, cfg, dispatch)
    return x, aux, {"k": ck, "v": cv}


def _mask_pad_logits(logits, cfg: ArchConfig):
    """Mask the padded-vocab tail to -1e30 so softmax/argmax never pick a
    pad token.  Applied after softcap."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    logits[..., cfg.vocab:] = L.NEG_INF
    return logits


def _embed(params, tokens, cfg: ArchConfig):
    """Token embedding × sqrt(d_model) rounded to the compute dtype, as the
    reference scales (a host scalar: no copy to the device)."""
    scale = torch.tensor(np.sqrt(cfg.d_model), dtype=torch_dtype(cfg))
    return params["embed"][tokens] * scale.item()


def _logits(params, x, cfg: ArchConfig):
    x = L.rms_norm(params["final_norm"], x, cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, head).float()
    logits = L.softcap(logits, cfg.logit_softcap)
    return _mask_pad_logits(logits, cfg)


def forward(params, batch: dict, cfg: ArchConfig, *, dispatch: str = "auto",
            scan: str = "auto", collect_cache: bool = False):
    """Full forward pass over ``batch["tokens"]`` (B, S); returns
    (logits (B, S, V) float32, aux_loss, cache or None).  ``dispatch`` is
    the MoE routing-plan mode (:func:`layers.moe`), ``scan`` the mode of
    the selective scan (:func:`layers.mamba_block`) and of the RG-LRU scan
    (:func:`layers.rglru_block`)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stack_caches = {f"slot{j}": [] for j in range(cfg.period)} \
        if cfg.n_periods else {}
    tail_caches = []
    for kind, p, where in _layers(params, cfg):
        x, aux, cache = apply_layer(kind, p, x, cfg, positions, dispatch,
                                    scan)
        aux_total = aux_total + aux
        if where[0] == "stack":
            stack_caches[where[1]].append(cache)
        else:
            tail_caches.append(cache)
    logits = _logits(params, x, cfg)
    cache = None
    if collect_cache:
        cache = {"stack": {j: {k: torch.stack([c[k] for c in cs])
                               for k in cs[0]}
                           for j, cs in stack_caches.items()},
                 "tail": tail_caches}
    return logits, aux_total, cache


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def prefill(params, batch: dict, cfg: ArchConfig, *, dispatch: str = "auto",
            scan: str = "auto"):
    """Encode the prompt; returns (last-position logits, cache)."""
    logits, _, cache = forward(params, batch, cfg, dispatch=dispatch,
                               scan=scan, collect_cache=True)
    return logits[:, -1], cache


def _decode_layer(kind: str, p, x, cache, pos, cfg: ArchConfig,
                  dispatch: str = "auto"):
    """One layer of one-token decode; the layer's cache entry is updated in
    place (see :func:`layers.attention_decode`, whose ring a ``local``
    layer's window makes; the Mamba and RG-LRU states are copied into
    theirs)."""
    _require_ported(kind, cfg)
    h = L.rms_norm(p["ln1"], x, cfg.rms_eps)
    if kind == "mamba":
        out, ssm, conv = L.mamba_decode(p, h, cache["ssm"], cache["conv"],
                                        cfg)
        cache["ssm"].copy_(ssm)
        cache["conv"].copy_(conv)
        return x + out, cache
    if kind == "rglru":
        out, hf, conv = L.rglru_decode(p, h, cache["h"], cache["conv"], cfg)
        cache["h"].copy_(hf)
        cache["conv"].copy_(conv)
        return _mlp(p, x + out, cfg), cache
    out, k2, v2 = L.attention_decode(
        p, h, cache["k"], cache["v"], pos, cfg,
        window=cfg.window if kind == "local" else 0)
    x, _ = _mixer_mlp(p, x + out, cfg, dispatch)
    return x, {"k": k2, "v": v2}


def decode_step(params, cache, tokens, pos, cfg: ArchConfig, *,
                dispatch: str = "auto", scan: str = "auto"):
    """One-token decode.  tokens (B, 1); pos an int, a 0-d tensor or a (B,)
    tensor of per-lane positions (current lengths).  Returns (logits (B, V),
    cache): the cache tree is updated **in place** (the reference returns a
    new one from a donated buffer) and returned.  ``scan`` is checked but
    launches nothing: the one-token Mamba and RG-LRU steps are plain
    PyTorch, as in the reference."""
    if scan not in SCAN_MODES:
        raise ValueError(f"unknown scan mode {scan!r}; options: "
                         f"{SCAN_MODES}")
    _check_ported(cfg)
    x = _embed(params, tokens, cfg)
    for kind, p, where in _layers(params, cfg):
        if where[0] == "stack":
            c = {k: v[where[2]] for k, v in cache["stack"][where[1]].items()}
        else:
            c = cache["tail"][where[1]]
        x, _ = _decode_layer(kind, p, x, c, pos, cfg, dispatch)
    return _logits(params, x, cfg)[:, 0], cache


def init_cache(cfg: ArchConfig, batch: int, s_ctx: int, dtype=None, *,
               device=None) -> dict:
    """A zero cache for ``batch`` lanes on ``device`` (``cuda`` unless
    named): ``s_ctx`` positions of keys and values for global attention
    layers, a ring of min(``s_ctx``, window) for sliding-window layers (a
    long context costs them only the window), the state and conv tail for
    Mamba and RG-LRU layers."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)

    def kv(s):
        return (batch, s, cfg.n_kv_heads, cfg.head_dim)

    shapes = {
        "global": {"k": kv(s_ctx), "v": kv(s_ctx)},
        "local": {"k": kv(min(s_ctx, cfg.window)),
                  "v": kv(min(s_ctx, cfg.window))},
        "mamba": {"ssm": (batch, cfg.d_inner, cfg.ssm_state),
                  "conv": (batch, cfg.ssm_conv - 1, cfg.d_inner)},
        "rglru": {"h": (batch, cfg.lru_width),
                  "conv": (batch, cfg.conv_width - 1, cfg.lru_width)}}

    def zeros(kind, *lead):
        return {k: torch.zeros(lead + s, dtype=dtype, device=device)
                for k, s in shapes[kind].items()}

    return {"stack": ({f"slot{j}": zeros(kind, cfg.n_periods)
                       for j, kind in enumerate(cfg.layer_pattern)}
                      if cfg.n_periods else {}),
            "tail": [zeros(kind) for kind in cfg.tail_kinds]}
