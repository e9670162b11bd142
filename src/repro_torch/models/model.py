"""Model builder: parameter init, forward, prefill and one-token decode with
a KV or SSM cache, for the attention decoders (dense and MoE) and the
Mamba-1 stack.

A port of the reference's ``repro/models/model.py`` for layer kinds
``global`` and ``mamba``.  Parameters keep the reference's tree so that the
two packages can compute with the same weights (:func:`params_from_numpy`):
``{"embed", "final_norm", "stack": {"slot<j>": {name: (P, ...)}},
"tail": [{name: ...}], "lm_head"?}`` with the layers of each slot of the
layer pattern stacked over the P periods.  The reference scans over
periods; here a Python loop walks them, indexing the stacked tensors.
Caches keep the same tree: (P, B, S_ctx, KV, hd) ``k``/``v`` leaves for
attention layers, (P, B, d_inner, N) ``ssm`` and (P, B, kw-1, d_inner)
``conv`` leaves for Mamba layers.

Layer kinds ``rglru`` and ``local`` and the vision and audio frontends
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.mamba_scan.ops import MODES as SCAN_MODES
from . import layers as L

_NOT_PORTED = {
    "rglru": "kernel 4 (the RG-LRU scan) with the RG-LRU block, its decode "
             "and recurrentgemma-9b serving",
    "local": "kernel 4 with attention_local (sliding-window attention) and "
             "recurrentgemma-9b serving",
}


def _require_ported(kind: str, cfg: ArchConfig) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"layer kind {kind!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP, {_NOT_PORTED[kind]}")
    if kind not in ("global", "mamba"):
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


def _layer_shapes(kind: str, cfg: ArchConfig) -> dict:
    return (_mamba_layer_shapes(cfg) if kind == "mamba"
            else _attn_layer_shapes(cfg))


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
    inits (normal × 0.02, the rest as :func:`_mamba_layer_shapes` says),
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
        value = {"zeros": 0.0, "ones": 1.0, "dt_bias": -4.6}[init]
        return torch.full(shape, value, dtype=dtype, device=device)

    return _build_tree(_param_layout(cfg), leaf)


def params_from_numpy(cfg: ArchConfig, tree, *, device=None,
                      dtype: torch.dtype | None = None) -> dict:
    """The reference's parameter tree, as numpy arrays (``stack/slot<j>``
    stacked over periods, a ``tail`` list), as the port's tensors on
    ``device`` (``cuda`` unless named) in the config's dtype (or
    ``dtype``); ``A_log`` stays float32, as in the reference.  Every shape
    is checked against :func:`param_shapes`."""
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
            device=device, dtype=torch.float32 if init == "a_log" else dtype)

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
def _mixer_mlp(p, x, cfg: ArchConfig, dispatch: str):
    """The layer's second half: norm, then MoE or the gated MLP."""
    h = L.rms_norm(p["ln2"], x, cfg.rms_eps)
    if cfg.n_experts:
        moe_out, aux = L.moe({"router": p["router"], "wi": p["wi"],
                              "wg": p["wg"], "wo": p["wo_mlp"]}, h, cfg,
                             dispatch)
        return x + moe_out, aux
    out = L.mlp({"wi": p["wi"], "wg": p["wg"], "wo": p["wo_mlp"]}, h, cfg)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_layer(kind: str, p, x, cfg: ArchConfig, positions,
                dispatch: str = "auto", scan: str = "auto"):
    """One layer; returns (x, aux_loss, cache_entry).  ``dispatch`` is the
    MoE ticket-dispatch mode (:func:`layers.moe`), ``scan`` the selective
    scan's (:func:`layers.mamba_block`)."""
    _require_ported(kind, cfg)
    h = L.rms_norm(p["ln1"], x, cfg.rms_eps)
    if kind == "mamba":
        out, (ssm, conv) = L.mamba_block(p, h, cfg, scan)
        return (x + out, torch.zeros((), dtype=torch.float32,
                                     device=x.device),
                {"ssm": ssm, "conv": conv})
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
    the MoE ticket-dispatch mode (:func:`layers.moe`), ``scan`` the
    selective scan's (:func:`layers.mamba_block`)."""
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
    place (see :func:`layers.attention_decode`; the Mamba states are copied
    into theirs)."""
    _require_ported(kind, cfg)
    h = L.rms_norm(p["ln1"], x, cfg.rms_eps)
    if kind == "mamba":
        out, ssm, conv = L.mamba_decode(p, h, cache["ssm"], cache["conv"],
                                        cfg)
        cache["ssm"].copy_(ssm)
        cache["conv"].copy_(conv)
        return x + out, cache
    out, k2, v2 = L.attention_decode(p, h, cache["k"], cache["v"], pos, cfg)
    x, _ = _mixer_mlp(p, x + out, cfg, dispatch)
    return x, {"k": k2, "v": v2}


def decode_step(params, cache, tokens, pos, cfg: ArchConfig, *,
                dispatch: str = "auto", scan: str = "auto"):
    """One-token decode.  tokens (B, 1); pos an int, a 0-d tensor or a (B,)
    tensor of per-lane positions (current lengths).  Returns (logits (B, V),
    cache): the cache tree is updated **in place** (the reference returns a
    new one from a donated buffer) and returned.  ``scan`` is checked but
    launches nothing: the one-token Mamba step is plain PyTorch, as in the
    reference."""
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
    named): ``s_ctx`` positions of keys and values for attention layers,
    the SSM state and conv tail for Mamba layers."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    kv = (batch, s_ctx, cfg.n_kv_heads, cfg.head_dim)
    ssm = (batch, cfg.d_inner, cfg.ssm_state)
    conv = (batch, cfg.ssm_conv - 1, cfg.d_inner)

    def zeros(kind, *lead):
        shapes = ({"ssm": ssm, "conv": conv} if kind == "mamba"
                  else {"k": kv, "v": kv})
        return {k: torch.zeros(lead + s, dtype=dtype, device=device)
                for k, s in shapes.items()}

    return {"stack": ({f"slot{j}": zeros(kind, cfg.n_periods)
                       for j, kind in enumerate(cfg.layer_pattern)}
                      if cfg.n_periods else {}),
            "tail": [zeros(kind) for kind in cfg.tail_kinds]}
