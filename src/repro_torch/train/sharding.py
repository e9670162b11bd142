"""Logical-axis sharding rules (MaxText-style) → per-dimension mesh axes,
and their DTensor form.

A port of the reference's ``repro/train/sharding.py`` onto
``torch.distributed.tensor``.  Baseline layout on mesh ("data", "model")
(+ optional leading "pod"):
  * TP over 'model' for vocab/ffn/heads/inner/lru dims,
  * FSDP (ZeRO-3) over 'data' for the d_model ('embed') dim of every weight
    — params and fp32 Adam moments are 2-D sharded,
  * batch over ('pod', 'data').
Dims that don't divide their mesh axis fall back to replication (e.g. KV=8
heads on model=16).  Rules are overridable per hillclimb variant.

A spec is a tuple in ``PartitionSpec``'s layout, one entry a tensor dim:
``None``, a mesh axis name, or a tuple of names (trailing ``None``\\ s
dropped).  :func:`placements` turns it into DTensor placements, one
``Shard(tensor_dim)`` or ``Replicate()`` a mesh dim.  A ``mesh`` is anything
with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``, or
:class:`MeshShape` where no process group is needed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

Pytree = Any

DEFAULT_RULES: dict[str, str | None] = {
    "vocab": "model",
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "inner": "model",
    "lru": "model",
    "embed": "data",     # FSDP
    "experts": None,     # baseline: experts replicated, TP inside expert ffn
    "layers": None,
    "head_dim": None,
}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group."""
    shape: tuple
    mesh_dim_names: tuple


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of ``mesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def is_axes(x) -> bool:
    """A leaf of a logical-axes or spec tree: a plain tuple of names,
    ``None``\\ s and tuples of names (the trees' containers are dicts,
    lists and NamedTuples)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_for_axes(axes: tuple, shape: tuple, mesh, rules) -> tuple:
    """Logical axes + concrete shape -> spec entries with divisibility
    fallback (replicate any dim that doesn't divide its mesh axis).

    A rule value may be a single mesh axis or a tuple of axes (e.g.
    ("pod", "data") for the batch dim); missing/used axes are dropped from
    the tuple before the divisibility check."""
    sizes = axis_sizes(mesh)
    entries = []
    used = set()
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            entries.append(None)
            continue
        ax = (mesh_axis,) if isinstance(mesh_axis, str) else tuple(mesh_axis)
        ax = tuple(a for a in ax if a in sizes and a not in used)
        size = 1
        for a in ax:
            size *= sizes[a]
        if ax and dim % size == 0:
            entries.append(ax if len(ax) > 1 else ax[0])
            used.update(ax)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(entries: tuple, mesh) -> tuple:
    """Spec entries -> DTensor placements, one a mesh dim: ``Shard(d)``
    where tensor dim d names that mesh axis, else ``Replicate()``.  A
    tensor dim over several axes shards on each of them, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, e in enumerate(entries):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def local_shape(shape: tuple, entries: tuple, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` under ``entries``
    (every sharded dim divides its axes, by :func:`spec_for_axes`)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(entries):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[d] //= sizes[a]
    return tuple(out)


def map_axes(fn, spec_tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn(axes, *leaves)`` over a tree of logical-axes leaves and trees
    of the same structure."""
    if is_axes(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple):       # a NamedTuple
        return type(spec_tree)(*(map_axes(fn, *xs)
                                 for xs in zip(spec_tree, *rest)))
    if isinstance(spec_tree, list):
        return [map_axes(fn, *xs) for xs in zip(spec_tree, *rest)]
    raise TypeError(f"not a logical-axes leaf: {spec_tree!r}")


def tree_specs(spec_tree: Pytree, shape_tree: Pytree, mesh,
               rules=None) -> Pytree:
    """Map parallel (logical-axes, tensor or shape) trees to spec entries."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return map_axes(lambda axes, t: spec_for_axes(
        axes, tuple(getattr(t, "shape", t)), mesh, rules),
        spec_tree, shape_tree)


def batch_axes(mesh, axes=None) -> tuple:
    names = tuple(mesh.mesh_dim_names)
    if axes is not None:
        return tuple(a for a in axes if a in names)
    return ("pod", "data") if "pod" in names else ("data",)


def batch_spec(mesh, ndim: int, *, shard_batch: bool = True,
               axes=None) -> tuple:
    if not shard_batch:
        return ()
    return (batch_axes(mesh, axes),) + (None,) * (ndim - 1)


def named(mesh, spec_tree: Pytree) -> Pytree:
    """A tree of spec entries -> a tree of DTensor placements, as
    ``distribute_tensor(t, mesh, placements)`` takes them."""
    return map_axes(lambda entries: placements(entries, mesh), spec_tree)
