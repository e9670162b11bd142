"""Activation sharding constraints, applied only when a mesh is ambient.

A port of the reference's ``repro/models/shard_utils.py`` onto
``torch.distributed.tensor``.  Models run identically on one device (every
test, every run on the card) and under the dry run's production mesh:
:func:`constrain` returns its argument itself when no mesh is set or the
tensor is not a ``DTensor``, and silently drops axes the ambient mesh
doesn't have (e.g. 'pod' on the single-pod mesh) or that don't divide the
dimension.  Under a mesh it ``redistribute``\\ s the tensor to the
placements its logical axes give (a pending partial sum is reduced there,
as XLA reduces it at a sharding constraint).
"""

from __future__ import annotations

import contextlib
import contextvars

from ..train.sharding import axis_sizes, placements

# logical activation axes -> preferred mesh axes, in priority order
_ACT_RULES = {
    "batch": ("pod", "data"),
    "model": ("model",),
    None: (),
}

# Hillclimb override: which mesh axes the activation 'batch' maps to.
# ("pod", "data", "model") turns the model axis into extra data parallelism
# (pure-DP layouts for models that fit a device).
_BATCH_AXES = contextvars.ContextVar("repro_torch_batch_axes",
                                     default=("pod", "data"))

# Megatron-style sequence parallelism: when set to ("model",), the residual
# stream is sharded along its sequence dim over the model axis at layer
# boundaries — the TP partial sums become reduce-scatters (+ an all-gather
# at next use), and the boundary activations shrink by the TP degree.
_SEQ_AXES = contextvars.ContextVar("repro_torch_seq_axes", default=())

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def act_batch_axes(axes):
    """Temporarily remap the logical 'batch' activation axis."""
    token = _BATCH_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH_AXES.reset(token)


@contextlib.contextmanager
def act_seq_axes(axes):
    """Enable sequence-parallel boundary sharding."""
    token = _SEQ_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _SEQ_AXES.reset(token)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) ambient inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh():
    """The ambient ``DeviceMesh``, or None when unset."""
    return _MESH.get()


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis in the ambient mesh (1 if absent / no mesh)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def constrain(x, *axes):
    """constrain(x, 'batch', None, 'model') — logical per-dim annotation."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    entries = []
    used: set = set()
    for dim, name in zip(x.shape, axes):
        chosen = None
        if name == "batch":
            want = _BATCH_AXES.get()
        elif name == "seq":
            want = _SEQ_AXES.get()
        else:
            want = _ACT_RULES.get(name, (name,) if name else ())
        present = tuple(a for a in want if a in sizes and a not in used)
        if present:
            total = 1
            for a in present:
                total *= sizes[a]
            if dim % total == 0:
                chosen = present if len(present) > 1 else present[0]
                used.update(present)
        entries.append(chosen)
    want_pl = placements(tuple(entries), mesh)
    if tuple(x.placements) == want_pl:
        return x
    return x.redistribute(mesh, want_pl)
