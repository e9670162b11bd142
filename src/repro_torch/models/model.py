"""Model builder: parameter init, forward, prefill and one-token decode with
a KV, ring or recurrent-state cache, for the attention decoders (dense and
MoE, full and sliding-window), the Mamba-1 stack, the Griffin hybrid, the
bidirectional audio encoder (hubert: precomputed frames in) and the
vision-language decoder (qwen2-vl: precomputed patch embeddings and three
M-RoPE position streams in).

A port of the reference's ``repro/models/model.py`` for layer kinds
``global``, ``local``, ``mamba`` and ``rglru`` and its stub frontends
(:func:`_embed_inputs`), with its training loss (:func:`loss_fn`) and its
remat policy (``cfg.remat``: each period of the stack recomputed in the
backward pass, :func:`_remat_context`).  Parameters keep the
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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.mamba_scan.ops import MODES as SCAN_MODES
from . import layers as L
from .shard_utils import (ambient_mesh, constrain, gathered, shards,
                          take_rows)

KINDS = ("global", "local", "mamba", "rglru")
# parameter inits kept in float32 whatever the config's dtype
_FLOAT32_INITS = ("a_log", "lam")


def _require_ported(kind: str, cfg: ArchConfig) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


def _check_ported(cfg: ArchConfig) -> None:
    for kind in dict.fromkeys(cfg.layer_pattern):
        _require_ported(kind, cfg)


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


def _attn_layer_specs(cfg: ArchConfig) -> dict:
    """Logical axes of one attention layer's parameters (the reference's
    ``_attn_layer_specs``)."""
    p = {"ln1": ("embed",), "ln2": ("embed",),
         "wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.n_experts:
        return p | {"router": ("embed", "experts"),
                    "wi": ("experts", "embed", "ffn"),
                    "wg": ("experts", "embed", "ffn"),
                    "wo_mlp": ("experts", "ffn", "embed")}
    return p | {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"),
                "wo_mlp": ("ffn", "embed")}


def _mamba_layer_specs(cfg: ArchConfig) -> dict:
    return {"ln1": ("embed",), "in_proj": ("embed", "inner"),
            "conv_w": ("inner", None), "conv_b": ("inner",),
            "A_log": ("inner", None), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "D_skip": ("inner",), "out_proj": ("inner", "embed")}


def _rglru_layer_specs(cfg: ArchConfig) -> dict:
    return {"ln1": ("embed",), "ln2": ("embed",),
            "w_x": ("embed", "lru"), "w_gate": ("embed", "lru"),
            "conv_w": ("lru", None), "conv_b": ("lru",),
            "w_rg": ("lru", None), "lam": ("lru",),
            "w_out": ("lru", "embed"),
            "wi": ("embed", "ffn"), "wg": ("embed", "ffn"),
            "wo_mlp": ("ffn", "embed")}


def _layer_specs(kind: str, cfg: ArchConfig) -> dict:
    _require_ported(kind, cfg)
    if kind == "mamba":
        return _mamba_layer_specs(cfg)
    if kind == "rglru":
        return _rglru_layer_specs(cfg)
    return _attn_layer_specs(cfg)


def param_specs(cfg: ArchConfig) -> dict:
    """Logical-axis names, parallel to :func:`param_shapes` (stacked leaves
    lead with ``"layers"``), as the reference's ``param_specs``: the
    sharding rules (:mod:`repro_torch.train.sharding`) map them to mesh
    axes."""
    _check_ported(cfg)
    specs = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
             "stack": ({f"slot{j}": {k: ("layers",) + axes for k, axes
                                     in _layer_specs(kind, cfg).items()}
                        for j, kind in enumerate(cfg.layer_pattern)}
                       if cfg.n_periods else {}),
             "tail": [_layer_specs(kind, cfg) for kind in cfg.tail_kinds]}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


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


def param_dtypes(cfg: ArchConfig) -> dict:
    """The parameter tree's dtypes: the config's, float32 for ``A_log``
    and ``lam``."""
    dtype = torch_dtype(cfg)
    return _build_tree(_param_layout(cfg), lambda path, shape, init:
                       torch.float32 if init in _FLOAT32_INITS else dtype)


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
            # the leaf before its float32 draw, which is scaled in place:
            # the draw is the one temporary, and it frees a block of its
            # own whole (a leaf cut from a freed draw's block would leave
            # the rest of that block to smaller tensors only)
            out = torch.empty(shape, dtype=dtype, device=device)
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            return out.copy_(w.mul_(0.02))
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


def _periods(params, cfg: ArchConfig) -> list:
    """Each period's layer params, in depth order: a list over the P
    periods of a list over the slots of the layer pattern.  Each stacked
    leaf is unbound once into its P views, so that a backward pass stacks
    the P layers' gradients in one tensor (indexing each view apart would
    give every layer a zero-filled gradient of the whole stack)."""
    if not cfg.n_periods:
        return []
    stack = [{k: v.unbind(0) for k, v in params["stack"][f"slot{j}"].items()}
             for j in range(cfg.period)]
    return [[{k: v[i] for k, v in slot.items()} for slot in stack]
            for i in range(cfg.n_periods)]


def _layers(params, cfg: ArchConfig):
    """(kind, layer params, where) in depth order: period i's slots, then
    the tail; ``where`` is ("stack", slot, i) or ("tail", i)."""
    for i, period in enumerate(_periods(params, cfg)):
        for j, (kind, p) in enumerate(zip(cfg.layer_pattern, period)):
            yield kind, p, ("stack", f"slot{j}", i)
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
                dispatch: str = "auto", scan: str = "auto",
                cache: bool = True):
    """One layer; returns (x, aux_loss, cache_entry).  ``dispatch`` is the
    MoE routing-plan mode (:func:`layers.moe`), ``scan`` the mode of
    the recurrences' kernels (the causal conv and selective scan of
    :func:`layers.mamba_block`, the RG-LRU scan of
    :func:`layers.rglru_block`).  With ``cache``
    False an attention layer's entry is None (nothing of it is made).
    Under a mesh the layer's weights are gathered over their FSDP axis
    first (:func:`shard_utils.gathered`)."""
    _require_ported(kind, cfg)
    if ambient_mesh() is not None:
        specs = _layer_specs(kind, cfg)
        p = {k: gathered(v, *(None if a == "embed" else a for a in specs[k]))
             for k, v in p.items()}
    h = L.rms_norm(p["ln1"], x, cfg.rms_eps)
    no_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "mamba":
        out, (ssm, conv) = L.mamba_block(p, h, cfg, scan)
        return x + out, no_aux, {"ssm": ssm, "conv": conv}
    if kind == "rglru":
        out, (hf, conv) = L.rglru_block(p, h, cfg, scan=scan)
        return _mlp(p, x + out, cfg), no_aux, {"h": hf, "conv": conv}
    if kind == "local":
        attn_out, kv = L.attention_local(p, h, cfg, positions, cache=cache)
        kv = kv and tuple(_ring(t, cfg.window) for t in kv)
    else:
        attn_out, kv = L.attention_full(p, h, cfg, positions,
                                        causal=cfg.causal, cache=cache)
    x, aux = _mixer_mlp(p, x + attn_out, cfg, dispatch)
    return x, aux, kv and {"k": kv[0], "v": kv[1]}


def _mask_pad_logits(logits, cfg: ArchConfig):
    """Mask the padded-vocab tail to -1e30 so softmax/argmax never pick a
    pad token.  Applied after softcap."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    if shards("vocab", logits.shape[-1]):
        # under a mesh that shards the vocab: a select on each device's
        # part (writing the tail in place would gather the vocab)
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab
        return torch.where(pad, L.NEG_INF, logits)
    logits[..., cfg.vocab:] = L.NEG_INF
    return logits


def _embed_scale(cfg: ArchConfig) -> float:
    """sqrt(d_model) rounded to the compute dtype, as the reference scales
    the token embedding (a host scalar: no copy to the device)."""
    return torch.tensor(np.sqrt(cfg.d_model), dtype=torch_dtype(cfg)).item()


def _embed(params, tokens, cfg: ArchConfig):
    """Token embedding × :func:`_embed_scale`."""
    return params["embed"][tokens] * _embed_scale(cfg)


def _embed_inputs(params, batch: dict, cfg: ArchConfig):
    """The stack's input and its RoPE positions, as the reference's
    ``_embed_inputs``: the frontends are stubs whose embeddings arrive
    precomputed.  ``audio_frames``: ``batch["frames"]`` (B, S, D) cast to
    the compute dtype, unscaled, at positions ``arange(S)``;
    ``vision_patches``: the token embedding × sqrt(d_model), with
    ``batch["vision_embeds"]`` (cast to its dtype) where
    ``batch["vision_mask"]`` holds, at the three M-RoPE streams of
    ``batch["positions"]`` (3, B, S); otherwise the token embedding at
    positions ``arange(S)``."""
    if cfg.frontend == "audio_frames":
        x = batch["frames"].to(torch_dtype(cfg))
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device)[None].expand(B, S)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    if cfg.frontend == "vision_patches":
        x = torch.where(batch["vision_mask"][..., None],
                        batch["vision_embeds"].to(x.dtype), x)
        return x, batch["positions"]
    return x, torch.arange(S, device=x.device)[None].expand(B, S)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    outputs of the products with no batch dimension and recompute the rest.
    ``torch.einsum`` lowers a product with no batch dimension (the
    projections, ``"bsd,dhk->bshk"``) to ``mm``/``addmm`` or to a ``bmm`` of
    batch extent 1, and one with batch dimensions (attention's
    ``"bqhd,bkhd->bhqk"``, the experts' ``"gecd,edf->gecf"``) to a ``bmm``
    over them."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: ArchConfig):
    """The ``context_fn`` of :func:`torch.utils.checkpoint.checkpoint` for
    ``cfg.remat`` (the reference's ``_remat_policy``), or None for
    ``"none"``: ``"full"`` saves nothing of a period, ``"dots"`` saves what
    :func:`_dots_policy` keeps."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return noop_context_fn
    if cfg.remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    raise ValueError(f"unknown remat {cfg.remat!r}; options: none, dots, "
                     "full")


def _period(x, period, cfg: ArchConfig, positions, dispatch: str, scan: str,
            cache: bool = True):
    """One period of the stack (the layers of the layer pattern); returns
    (x, the period's aux loss, its cache entries by slot)."""
    aux_p = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for kind, p in zip(cfg.layer_pattern, period):
        x, aux, entry = apply_layer(kind, p, x, cfg, positions, dispatch,
                                    scan, cache)
        aux_p = aux_p + aux
        caches.append(entry)
    x = constrain(x, "batch", "seq", None)
    return x, aux_p, caches


def _logits(params, x, cfg: ArchConfig):
    x = L.rms_norm(params["final_norm"], x, cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, head).float()
    logits = L.softcap(logits, cfg.logit_softcap, in_place=True)
    return _mask_pad_logits(logits, cfg)


def forward(params, batch: dict, cfg: ArchConfig, *, dispatch: str = "auto",
            scan: str = "auto", collect_cache: bool = False):
    """Full forward pass over ``batch`` (``tokens`` (B, S), or the frontend's
    inputs, :func:`_embed_inputs`); returns (logits (B, S, V) float32,
    aux_loss, cache or None).  ``dispatch`` is the MoE routing-plan mode
    (:func:`layers.moe`), ``scan`` the mode of the causal conv and
    selective scan (:func:`layers.mamba_block`) and of the RG-LRU scan
    (:func:`layers.rglru_block`).

    Where autograd records the pass (grad mode on and a period's input or
    weights requiring grad), each period runs under
    :func:`torch.utils.checkpoint.checkpoint` with ``cfg.remat``'s policy
    (:func:`_remat_context`) and is recomputed in the backward pass, as
    the reference's ``jax.checkpoint`` around its period body; the tail
    layers are not.  The values are the same either way."""
    _check_ported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    x = constrain(x, "batch", "seq", None)
    context_fn = _remat_context(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stack_caches = {f"slot{j}": [] for j in range(cfg.period)} \
        if cfg.n_periods else {}
    run = functools.partial(_period, cfg=cfg, positions=positions,
                            dispatch=dispatch, scan=scan,
                            cache=collect_cache)
    for period in _periods(params, cfg):
        recorded = torch.is_grad_enabled() and (x.requires_grad or any(
            v.requires_grad for p in period for v in p.values()))
        if context_fn is not None and recorded:
            x, aux, caches = checkpoint(run, x, period, use_reentrant=False,
                                        context_fn=context_fn)
        else:
            x, aux, caches = run(x, period)
        aux_total = aux_total + aux
        for j, cache in enumerate(caches):
            stack_caches[f"slot{j}"].append(cache)
    tail_caches = []
    for i, kind in enumerate(cfg.tail_kinds):
        x, aux, cache = apply_layer(kind, params["tail"][i], x, cfg,
                                    positions, dispatch, scan, collect_cache)
        aux_total = aux_total + aux
        tail_caches.append(cache)
    logits = constrain(_logits(params, x, cfg), "batch", None, "model")
    cache = None
    if collect_cache:
        cache = {"stack": {j: {k: torch.stack([c[k] for c in cs])
                               for k in cs[0]}
                           for j, cs in stack_caches.items()},
                 "tail": tail_caches}
    return logits, aux_total, cache


# The (dispatch, scan) modes of a training forward, by ``use_pallas``: the
# plain routing plan and scans, or the plain plan around the ticket kernel,
# whose outputs are integers, so the gates stay differentiable.  No kernel
# has a backward pass, so neither mode reaches the routing-plan kernel or
# a scan kernel.
TRAIN_MODES = {False: ("torch", "torch"), True: ("ticket", "torch")}


def train_modes(cfg: ArchConfig, use_pallas: bool) -> tuple[str, str]:
    """``(dispatch, scan)`` of :func:`loss_fn`; with ``use_pallas`` a model
    with Mamba or RG-LRU layers raises, as the reference cannot train those
    through its kernels either."""
    recurrent = sorted({"mamba", "rglru"} & set(cfg.layer_kinds()))
    if use_pallas and recurrent:
        raise ValueError(
            f"use_pallas=True trains through the ticket-dispatch kernel "
            f"only: {cfg.name} has {', '.join(recurrent)} layers, whose scan "
            "kernels have no backward pass; train it with use_pallas=False")
    return TRAIN_MODES[bool(use_pallas)]


def _logsumexp(logits):
    """``logsumexp`` over the vocab; under a mesh that shards the vocab as
    the max, then the log of the sum of exponentials, as the reference's
    ``jax.nn.logsumexp`` is partitioned: each device reduces its own part
    of the vocab and only the (B, S) statistics cross the mesh (DTensor's
    rule for ``logsumexp`` gathers the whole vocab on every device)."""
    if not shards("vocab", logits.shape[-1]):
        return torch.logsumexp(logits, dim=-1)
    top = logits.amax(dim=-1, keepdim=True).detach()
    return (top + torch.exp(logits - top).sum(-1, keepdim=True).log())[..., 0]


def _label_logit(logits, labels):
    """Each position's logit at its label.  A gather, but under a mesh that
    shards the vocab a masked sum over it, as the reference's one-hot
    contraction is partitioned: each device sums its own part of the vocab
    (a gather's backward would build the whole (B, S, V) gradient on every
    device).  The same value: one term is non-zero."""
    V = logits.shape[-1]
    if not shards("vocab", V):
        return logits.gather(-1, labels[..., None])[..., 0]
    hit = torch.arange(V, device=labels.device) == labels[..., None]
    return torch.where(hit, logits, 0.0).sum(-1)


def loss_fn(params, batch: dict, cfg: ArchConfig, *,
            use_pallas: bool = False):
    """Next-token cross entropy + MoE aux.  Returns (loss, metrics).

    The reference's ``loss_fn``: the cross entropy runs over the padded
    vocab (its tail masked to -1e30 by the forward), labels below 0 are
    masked out, and the label's logit is picked by a gather where the
    reference contracts a one-hot (the same value: one term is non-zero).
    ``use_pallas`` picks the forward's modes (:func:`train_modes`)."""
    dispatch, scan = train_modes(cfg, use_pallas)
    logits, aux, _ = forward(params, batch, cfg, dispatch=dispatch, scan=scan)
    labels = batch["labels"].long()
    mask = (labels >= 0).to(torch.float32)
    labels = labels.clamp_min(0)
    lse = _logsumexp(logits)
    label_logit = _label_logit(logits, labels)
    nll = lse - label_logit
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux,
                  "tokens": mask.sum()}


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
    # _embed with each device taking its own rows of the table
    x = constrain(take_rows(params["embed"], tokens, "vocab")
                  * _embed_scale(cfg), "batch", "seq", None)
    for kind, p, where in _layers(params, cfg):
        if where[0] == "stack":
            c = {k: v[where[2]] for k, v in cache["stack"][where[1]].items()}
        else:
            c = cache["tail"][where[1]]
        x, _ = _decode_layer(kind, p, x, c, pos, cfg, dispatch)
    logits = constrain(_logits(params, x, cfg), "batch", None, "model")
    return logits[:, 0], cache


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
