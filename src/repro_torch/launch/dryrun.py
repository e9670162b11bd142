"""Dry run of the port at production scale: one train step, prefill or
decode of every (arch × shape × mesh) cell, executed on fake tensors laid
out as ``DTensor``\\ s over a production mesh, in one process.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --shape train_4k --mesh single

It needs no accelerator, by design: the mesh is a fake process group of
256 or 512 ranks (:mod:`repro_torch.launch.mesh`) and every local tensor
is a ``meta`` tensor (shapes, dtypes, no storage), so a 314 B-parameter
cell lays out its state on a laptop.  (Not ``FakeTensorMode``: DTensor's
strided-shard planning builds a tensor and reads it back, which a fake
tensor cannot answer.)  It is the one entry point of the port with no
``--device``.  What it gives is counted, never timed: each device's local
bytes, and the op record below, which :mod:`repro_torch.launch.roofline`
turns into the Hopper roofline terms.

Per cell it writes (to ``experiments/dryrun_torch/``):
  <cell>.json      memory (the local shards of state and batch, the donated
                   cache, the peak of live local bytes in the step), the
                   cell's shape, params, wall seconds
  <cell>.ops.json  the op record: one row per distinct aten op on the
                   *local* tensors (below the DTensor layer, so each count
                   is per device), with its calls, bytes in and out,
                   FLOPs, and for a collective its mesh axes and group size

The state is laid out by the sharding rules (:mod:`repro_torch.train.
sharding`): parameters and AdamW moments on the same placements, the batch
on the batch axes (M-RoPE ``positions`` on dim 1), the decode cache by
:func:`cache_specs`.  The step runs the port's own code, with the plain
routing plan and scans (the kernels have no ``meta`` form), under
``implicit_replication`` (tensors the forward makes join the mesh
replicated), with a hillclimb variant's rules in force for the activations
too (:func:`~repro_torch.models.shard_utils.act_rules`).  The model states
its activations' layout by logical axis where the reference's partitioner
would carry a weight's placement into them (heads, hidden and inner dims
on ``model``; :func:`~repro_torch.models.shard_utils.constrain`, whose
cotangent takes the same layout); DTensor's own rules lay out every op
between those points, replicating where they must (the gathers show in
the record), but for a few, each scoped to the run
(:func:`sharded_execution`):

* views: a flatten or split DTensor's rule cannot express on a plain
  shard (torch 2.11 raises on attention's (batch, heads) flatten; 2.13
  makes it a strided shard, whose local shape it computes at a cost of
  seconds an op) is taken on each device's part, on both versions, else
  after a gather;
* the ops whose DTensor rule raises: the label gather's masked partial sum
  is reduced at once; decode's in-place cache write is made on each
  device's part; on torch 2.11 the embedding's backward runs on
  replicated inputs;
* the routing plan, whose in-place scatters have no DTensor rule, runs
  per group in ``local_map``;
* the sequential scans (the plain Mamba and RG-LRU loops) run one time
  step and record it, forward and backward, ``L`` times over (the
  reference's analyzer counts a ``while`` body × its trips the same way),
  their inputs with time whole; the rows keep the multiplier in ``trips``;
* DTensor's shard-to-shard moves are recorded as the all-to-alls a GPU
  runs (on a CPU mesh DTensor makes each an all-gather and a cut);
* the point-to-point moves of ``shard_utils.relocate`` are recorded as
  collective-permutes with the parts the busiest device sends;
* DTensor's own shape propagation, which runs each op once on fake
  tensors of global shape, is not recorded, nor its planning on the
  host's tensors.

The record's bytes a device, FLOPs and collective bytes are held to the
reference's dry run by the tests (narrow cells with real head counts,
each remaining difference named there); its HBM bytes and launches are
eager PyTorch's, with no counterpart in a fused program.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES, ShapeCell, applicable, get_config
from ..models import model as M
from ..models.shard_utils import (act_batch_axes, act_rules, act_seq_axes,
                                  use_mesh)
from ..optim import AdamW, AdamWState
from ..train.sharding import (DEFAULT_RULES, axis_sizes, batch_axes,
                              batch_spec, local_shape, map_axes, placements,
                              spec_for_axes, tree_specs)
from ..train.train_step import TrainOptions, TrainState, build_train_step
from .mesh import make_production_mesh
from .specs import input_specs

OUT_DIR = os.path.join(os.path.dirname(__file__),
                       "../../../experiments/dryrun_torch")

# Per-arch training options, the reference's (repro/launch/dryrun.py)
ACCUM = {"mistral-large-123b": 16, "qwen2-vl-72b": 8, "grok-1-314b": 16,
         "gemma2-27b": 4, "falcon-mamba-7b": 4, "recurrentgemma-9b": 4,
         "deepseek-7b": 4, "gemma3-1b": 4, "granite-moe-1b-a400m": 2,
         "hubert-xlarge": 2}
MOMENT_DTYPE = {"grok-1-314b": "bfloat16"}
ACCUM_DTYPE = {"grok-1-314b": "bfloat16", "mistral-large-123b": "bfloat16"}

# ops that launch nothing: views, metadata, allocation without a fill, a
# collective's wait; kept in the record, free in the analysis
FREE_OPS = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand",
    "aten.permute", "aten.transpose", "aten.t", "aten.select", "aten.slice",
    "aten.unsqueeze", "aten.squeeze", "aten.as_strided", "aten.alias",
    "aten.detach", "aten.split", "aten.split_with_sizes", "aten.unbind",
    "aten.chunk", "aten.diagonal", "aten.unfold", "aten._reshape_alias",
    "aten.view_as", "aten.expand_as", "aten.movedim", "aten.narrow",
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.lift_fresh", "aten.set_",
    "aten.sym_size", "aten.sym_stride", "aten.sym_numel", "aten.is_same_size",
    "aten.sym_storage_offset", "prim.device", "prim.layout",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
})


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpRecorder(TorchDispatchMode):
    """Records every aten op on local (non-``DTensor``) tensors: calls,
    bytes in and out, FLOPs (``torch.utils.flop_counter``'s formulas for
    the ops it knows) and, for a functional collective, its group's mesh
    axes.  Ops on ``DTensor``\\ s are passed on (``NotImplemented``), so
    the record sees what each device runs, after DTensor has split the op
    into its local op and its collectives.

    Also tracks live local bytes: a storage an op returns counts from its
    creation until the last tensor on it that an op returned is freed;
    ``peak`` is the most live at once.  Storages of the step's arguments
    (:meth:`hold`) never count.
    """

    def __init__(self, groups: dict):
        super().__init__()
        self.groups = groups          # group name -> (axes, size)
        self.rows: dict = {}
        self.trips = 1
        self.paused = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}         # storage id -> [tensors on it, bytes]

    def hold(self, tensors) -> None:
        """Storages that live through the step and are not counted."""
        for t in tensors:
            self._refs[t.untyped_storage()._cdata] = [float("inf"), 0]

    @contextlib.contextmanager
    def multiplied(self, n: int):
        prev, self.trips = self.trips, self.trips * n
        try:
            yield
        finally:
            self.trips = prev

    @contextlib.contextmanager
    def pause(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            ref = self._refs.get(st._cdata)
            if ref is None:
                ref = self._refs[st._cdata] = [0, st.nbytes()]
                self.live += ref[1]
                self.peak = max(self.peak, self.live)
            ref[0] += 1
            weakref.finalize(t, self._release, st._cdata)

    def _release(self, key) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        every = (*ins, *_tensors(out))
        # the devices' tensors are all plain 'meta' tensors; DTensor's own
        # planning runs small ops on the host's tensors, and its shape
        # propagation on fake ones of global shape: no device runs either
        if self.paused or not any(t.device.type == "meta" for t in every) \
                or any(isinstance(t, FakeTensor) for t in every):
            return out
        self._track(out)
        name = str(func.overloadpacket)
        flops = 0
        from torch.utils.flop_counter import flop_registry
        if func.overloadpacket in flop_registry:
            flops = int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        axes, size = None, None
        if name.startswith("_c10d_functional."):
            gname = args[-1] if isinstance(args[-1], str) else kwargs.get(
                "group_name")
            axes, size = self.groups.get(gname, ((str(gname),), None))
        self.add(name, ins, list(_tensors(out)), flops, axes, size)
        return out

    def add(self, name: str, ins: list, outs: list, flops: int = 0,
            axes=None, size=None) -> None:
        """One call of op ``name`` on ``ins`` giving ``outs``, × trips."""
        in_b = sum(_nbytes(t) for t in ins)
        max_in = max((_nbytes(t) for t in ins), default=0)
        out_b = sum(_nbytes(t) for t in outs)
        shapes = ",".join("x".join(map(str, t.shape)) for t in ins[:2])
        key = (name, in_b, out_b, max_in, flops, axes, self.trips, shapes)
        row = self.rows.get(key)
        if row is None:
            self.rows[key] = row = {
                "op": name, "calls": 0, "trips": self.trips, "in_bytes": in_b,
                "out_bytes": out_b, "max_in_bytes": max_in, "flops": flops,
                "shapes": shapes}
            if axes is not None:
                row["axes"], row["group_size"] = list(axes), size
        row["calls"] += self.trips

    def record(self) -> list:
        return sorted(self.rows.values(),
                      key=lambda r: -(r["calls"] * (r["in_bytes"]
                                                    + r["out_bytes"])))


_RECORDER: OpRecorder | None = None


def _gathering_view(op, args, kwargs):
    """A view of a sharded tensor is taken on each device's own part where
    :func:`_local_view` finds the local shape (a flatten of two sharded
    dims, attention's (batch, heads) under einsum, which torch 2.11's rule
    raises on and 2.13's keeps as a strided shard, slowly), a local part
    no view can express reshaped; otherwise through DTensor's rule, and
    where that raises (a split whose outer part does not divide the mesh:
    the microbatches) the input is gathered over its sharded mesh dims,
    innermost first, until the view goes through (the all-gather is
    recorded)."""
    from torch.distributed.tensor import Replicate
    x, size = args[0], _view_size(args[0].shape, args[1])
    local = _local_view(x, size) if _sharded(x) else None
    if local is not None:
        shape, place = local
        try:
            out = op(x._local_tensor, shape, *args[2:], **kwargs)
        except RuntimeError:         # a local part no view can express
            out = x._local_tensor.reshape(shape)
        return _wrap(out, x.device_mesh, place, size)
    try:
        return _default(op, args, kwargs)
    except RuntimeError:
        pass
    place = list(x.placements)
    while True:
        sharded = [i for i, p in enumerate(place) if not p.is_replicate()]
        if not sharded:
            raise RuntimeError(f"{op} cannot view {tuple(x.shape)} as "
                               f"{tuple(size)}")
        place[sharded[-1]] = Replicate()
        x = x.redistribute(x.device_mesh, tuple(place))
        try:
            return _default(op, (x, *args[1:]), kwargs)
        except RuntimeError:
            continue


def _sharded(x) -> bool:
    """Whether ``x`` is split over a mesh dim of more than one device."""
    return any(not p.is_replicate() and n > 1
               for p, n in zip(x.placements, x.device_mesh.shape))


def _view_size(shape, size) -> tuple:
    """``size`` with its -1 resolved against ``shape``."""
    size = list(size)
    if -1 in size:
        known = 1
        for n in size:
            if n != -1:
                known *= n
        total = 1
        for n in shape:
            total *= n
        size[size.index(-1)] = total // known
    return tuple(size)


def _local_view(x, size: tuple):
    """(local shape, placements) of viewing ``x`` as ``size`` on each
    device's own part, or None.  The dims pair into blocks of equal extent;
    a sharded block must be one input dim split into several (each mesh
    dim's shard taken, in mesh order, by the first output dim from the
    left whose remaining part it divides, the first by the outermost) or
    several merged into one (the output dim takes every shard of the
    block).  Size-1 dims stay free."""
    from torch.distributed.tensor import Replicate, Shard
    if any(p.is_partial() or not (p.is_replicate() or hasattr(p, "dim"))
           for p in x.placements):
        return None
    sizes = axis_sizes(x.device_mesh)
    names = x.device_mesh.mesh_dim_names
    shape = tuple(x.shape)
    by_dim: dict = {}
    for name, p in zip(names, x.placements):
        if not p.is_replicate():
            by_dim.setdefault(p.dim, []).append(name)
    ins_big = [d for d, n in enumerate(shape) if n != 1]
    outs_big = [d for d, n in enumerate(size) if n != 1]
    blocks, i, o = [], 0, 0
    while i < len(ins_big) and o < len(outs_big):
        ins, outs = [ins_big[i]], [outs_big[o]]
        a, b = shape[ins_big[i]], size[outs_big[o]]
        i, o = i + 1, o + 1
        while a != b:
            if a < b and i < len(ins_big):
                a *= shape[ins_big[i]]
                ins.append(ins_big[i])
                i += 1
            elif b < a and o < len(outs_big):
                b *= size[outs_big[o]]
                outs.append(outs_big[o])
                o += 1
            else:
                return None
        blocks.append((ins, outs))
    if i != len(ins_big) or o != len(outs_big):
        return None
    local = list(size)
    owner = {}
    for ins, outs in blocks:
        sharded = [d for d in ins if d in by_dim]
        if not sharded:
            continue
        if len(outs) == 1:                         # merge (or 1 -> 1)
            for d in sharded:
                for name in by_dim[d]:
                    if local[outs[0]] % sizes[name]:
                        return None
                    local[outs[0]] //= sizes[name]
                    owner[name] = outs[0]
        elif len(ins) == 1:                        # split
            k = 0
            for j, name in enumerate(by_dim[ins[0]]):
                while k < len(outs) and local[outs[k]] % sizes[name]:
                    k += 1
                # the first shard cuts the outermost part (a contiguous
                # shard); later ones, from a merge, may cut inner parts
                if k == len(outs) or (j == 0 and k):
                    return None
                local[outs[k]] //= sizes[name]
                owner[name] = outs[k]
        else:
            return None
    place = tuple(Shard(owner[n]) if n in owner else Replicate()
                  for n in names)
    return tuple(local), place


def _wrap(local, mesh, place, shape):
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _replicated(t):
    """``t`` replicated on every mesh dim (the gathers and reductions this
    takes are recorded); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or all(p.is_replicate()
                                         for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def _replicating(op, args, kwargs):
    """``op`` through DTensor's own rule; where that rule raises, on its
    inputs replicated, the gathers recorded.  Seen on torch 2.11 only: the
    embedding's backward (an accumulating ``index_put``: 'Shard dim -1 ...
    must be normalized')."""
    try:
        return _default(op, args, kwargs)
    except (RuntimeError, AssertionError):
        pass
    from torch.utils._pytree import tree_map
    return _default(op, tree_map(_replicated, args),
                    tree_map(_replicated, kwargs))


def _local(t, mesh_dims_cut):
    """``t``'s local tensor (a plain tensor as it is) with the extra cuts
    ``[(dim, n), ...]``, each keeping one part in n (the dry run's shapes
    do not depend on which)."""
    from torch.distributed.tensor import DTensor
    out = t._local_tensor if isinstance(t, DTensor) else t
    for dim, n in mesh_dims_cut:
        out = out.narrow(dim, 0, out.shape[dim] // n)
    return out


def _sharded_index_put_(op, args, kwargs):
    """``x[idx...] = values`` in place on a sharded ``x`` (decode's KV
    cache write), whose DTensor rule raises (an in-place op whose
    placements would change; torch 2.11 replicates ``x`` instead): each
    device writes its part.  A sharded indexed dim whose index covers it
    (the cache's lanes, ``arange(B)``) cuts the index and ``values``
    alike; a sharded indexed dim it does not cover (the context position)
    is written where it lands; a sharded dim past the indices cuts
    ``values``.  ``values`` is laid out to match first (a pending partial
    sum is reduced there); any other layout raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, indices, values = args[0], list(args[1]), args[2]
    if not _sharded(x):
        return _default(op, args, kwargs)
    error = RuntimeError(f"no local write of {op} on {x.placements}")
    n_idx = len(indices)
    idx = [t for t in indices if t is not None]
    if not idx or any(isinstance(t, DTensor) and not all(
            p.is_replicate() for p in t.placements) for t in idx):
        raise error
    idx_ndim = max(t.dim() for t in idx)
    # indexing assignment strips ``values``' leading size-1 dims
    strip = idx_ndim + x.dim() - n_idx - values.dim()
    sizes = axis_sizes(x.device_mesh)
    idx_cuts, val_place = [], []
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        vp = Replicate()
        if not p.is_replicate():
            if p.is_partial() or not hasattr(p, "dim"):
                raise error
            d = p.dim
            if d < n_idx and indices[d] is not None:
                if indices[d].shape[-1] == x.shape[d] and idx_ndim == 1:
                    idx_cuts.append((0, sizes[name]))
                    if strip <= 0:
                        vp = Shard(0)
            elif d >= n_idx and d - n_idx + idx_ndim >= strip:
                vp = Shard(d - n_idx + idx_ndim - strip)
        val_place.append(vp)
    if isinstance(values, DTensor):
        local_values = values.redistribute(
            x.device_mesh, tuple(val_place))._local_tensor
    else:
        local_values = _local(values, [
            (p.dim, sizes[name]) for name, p in zip(
                x.device_mesh.mesh_dim_names, val_place)
            if not p.is_replicate()])
    local_idx = [None if t is None else _local(t, idx_cuts) for t in indices]
    op(x._local_tensor, local_idx, local_values, *args[3:], **kwargs)
    return x


def _reduced_gather(op, args, kwargs):
    """``gather`` through DTensor's own rule.  Along a sharded dim that
    rule gives a masked partial sum, which DTensor cannot reduce after a
    later view (the label logit's ``[..., 0]``: an ``IndexError`` in its
    mask): it is reduced at once, the same all-reduce."""
    from torch.distributed.tensor import Replicate
    out = _default(op, args, kwargs)
    place = tuple(Replicate() if p.is_partial() else p
                  for p in out.placements)
    return out if place == tuple(out.placements) else out.redistribute(
        out.device_mesh, place)


def _local_plan(route_plan):
    """``route_plan`` (the MoE's routing plan) on a ``DTensor``: its
    in-place scatters have no DTensor rule.  The groups (dim 0) stay where
    they are sharded, the rest of the gates is gathered (a group's plan
    needs all of its tokens and experts), and each device plans its own
    groups; every output of the plan leads with the group dim, so it keeps
    the groups' placement."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def run(gates_full, n_experts, top_k, capacity, gate_dtype, *,
            mode="auto"):
        placed = tuple(p if isinstance(p, Shard) and p.dim == 0
                       else Replicate() for p in gates_full.placements)
        fn = local_map(
            lambda g: route_plan(g, n_experts, top_k, capacity, gate_dtype,
                                 mode=mode),
            out_placements=(placed,) * len(_PLAN_KEYS),
            in_placements=(placed,), device_mesh=gates_full.device_mesh,
            redistribute_inputs=True)
        return fn(gates_full)
    return run


# the keys of ticket_dispatch.ref.plan_ref's dict, in its order
_PLAN_KEYS = ("top_ids", "gates", "slot", "kept", "safe_idx", "slot_tok",
              "valid", "first_counts", "gate_sums")


def _alltoall(fallback):
    """DTensor's shard-to-shard move over one mesh dim.  On a CPU mesh (the
    fake one) DTensor runs it as an all-gather and a cut; GPUs run one
    all-to-all, which is what is recorded."""
    def run(input, gather_dim, shard_dim, mesh, mesh_dim):
        with _RECORDER.pause():
            out = fallback(input, gather_dim, shard_dim, mesh, mesh_dim)
        _RECORDER.add("_c10d_functional.all_to_all_single", [input], [out],
                      axes=(mesh.mesh_dim_names[mesh_dim],),
                      size=mesh.size(mesh_dim))
        return out
    return run


def _permute(fallback):
    """The point-to-point move of ``shard_utils.relocate``, recorded as
    one collective-permute (``_c10d_functional.collective_permute``,
    counted as the bytes a device sends, the reference's count) with the
    parts the busiest device sends and takes: which devices send depends
    on their coordinates, and the one this process stands for may keep
    its own."""
    def run(buf, out_splits, in_splits, group, plan):
        with _RECORDER.pause():
            out = fallback(buf, out_splits, in_splits, group, plan)
            part = torch.empty(plan.piece, dtype=buf.dtype, device="meta")
        groups = _RECORDER.groups       # a mesh dim's group, or the world's
        axes = groups.get(group.group_name, (tuple(
            a for axes, _ in groups.values() for a in axes),))[0]
        _RECORDER.add("_c10d_functional.collective_permute",
                      [part] * plan.most_sent, [part] * plan.most_received,
                      axes=axes, size=plan.size)
        return out
    return run


def _default(op, args, kwargs):
    """``op`` through DTensor's own rule, past this module's handler."""
    from torch.distributed.tensor import DTensor
    handlers = DTensor._op_dispatcher._custom_op_handlers
    handler = handlers.pop(op)
    try:
        return op(*args, **kwargs)
    finally:
        handlers[op] = handler


class _FoldedScan(torch.autograd.Function):
    """A sequential scan run for one time step and recorded ``L`` times,
    forward and backward (the plain loops' steps are alike: same shapes,
    same ops).  The inputs at ``timed`` carry time at dim -2."""

    @staticmethod
    def forward(ctx, fn, timed, *inputs):
        ctx.fn, ctx.timed = fn, timed
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        L = inputs[0].shape[-2]
        with _RECORDER.multiplied(L):
            outs = fn(*_first_step(inputs, timed))
        with _RECORDER.pause():     # y: the first input's shape and layout
            y = torch.zeros_like(inputs[0], dtype=outs[0].dtype)
        return (y,) + tuple(outs[1:])

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        L = inputs[0].shape[-2]
        with torch.enable_grad(), _RECORDER.pause():
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in inputs]
            outs = ctx.fn(*_first_step(leaves, ctx.timed))
        pairs = [(o, g if i else g[..., :1, :])
                 for i, (o, g) in enumerate(zip(outs, grads))
                 if g is not None]
        wrt = [t for t in leaves if t.requires_grad]
        with _RECORDER.multiplied(L):
            got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                      [g for _, g in pairs],
                                      allow_unused=True)
            # the engine sums each input's L step contributions
            got = [None if g is None else g + g for g in got]
        it = iter(got)
        return (None, None) + tuple(next(it) if t.requires_grad else None
                                    for t in leaves)


def _first_step(inputs, timed):
    return [t[..., :1, :] if i in timed and t is not None else t
            for i, t in enumerate(inputs)]


def _time_whole(t):
    """``t`` (time at dim -2) with its time dim whole and no pending
    partial sum on every device, laid out once before the loop (else each
    step's slice would gather or reduce): a mesh dim that shards time or
    holds a partial sum replicates (an all-gather or all-reduce)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    time = t.dim() - 2
    place = tuple(Replicate() if p.is_partial()
                  or getattr(p, "dim", None) in (time, -2) else p
                  for p in t.placements)
    return t if place == tuple(t.placements) else t.redistribute(
        t.device_mesh, place)


def _folded(fn, timed: tuple, n_args: int):
    """``fn`` (a plain sequential scan) folded to one recorded step, its
    inputs first laid out with time whole (a loop over time steps on a
    time-sharded tensor would gather it at every step); a missing initial
    state becomes zeros, so the step's backward has the state path every
    later step has."""
    def run(*inputs):
        inputs = list(inputs) + [None] * (n_args - len(inputs))
        inputs = [_time_whole(t) if i in timed and t is not None else t
                  for i, t in enumerate(inputs)]
        if inputs[-1] is None:
            with _RECORDER.pause():
                inputs[-1] = fn(*_first_step(inputs, timed))[1] * 0
        return _FoldedScan.apply(fn, timed, *inputs)
    return run


@contextlib.contextmanager
def sharded_execution(mesh, recorder: OpRecorder):
    """The scope of one recorded step: ``recorder`` on, the handlers of
    the ops whose DTensor rule raises (views, the label gather, the decode
    cache's write; on torch 2.11 the embedding's backward),
    folded scans, the routing plan per group, shard moves recorded as
    all-to-alls, relocations as collective-permutes, implicit
    replication.  Every other op takes DTensor's own
    rule."""
    global _RECORDER
    from torch.distributed.tensor import DTensor, placement_types
    from torch.distributed.tensor.experimental import implicit_replication

    from ..kernels.mamba_scan import ops as scan_ops
    from ..kernels.rglru import ops as rglru_ops
    from ..models import layers, shard_utils

    aten = torch.ops.aten
    rules = {aten.view.default: _gathering_view,
             aten._unsafe_view.default: _gathering_view,
             aten.reshape.default: _gathering_view,
             aten.gather.default: _reduced_gather,
             aten.index_put_.default: _sharded_index_put_,
             aten.index_put.default: _replicating}
    patched = {(scan_ops, "selective_scan_ref"): _folded(
                   scan_ops.selective_scan_ref, (0, 1, 3, 4), 7),
               (rglru_ops, "rglru_scan_ref"): _folded(
                   rglru_ops.rglru_scan_ref, (0, 1), 3),
               (layers, "route_plan"): _local_plan(layers.route_plan),
               (placement_types, "shard_dim_alltoall"): _alltoall(
                   placement_types.shard_dim_alltoall),
               (shard_utils, "_exchange"): _permute(shard_utils._exchange)}
    handlers = DTensor._op_dispatcher._custom_op_handlers
    saved_rules = {op: handlers.get(op) for op in rules}
    saved = {key: getattr(*key) for key in patched}
    _RECORDER = recorder
    handlers.update(rules)
    for (mod, name), fn in patched.items():
        setattr(mod, name, fn)
    try:
        with implicit_replication(), recorder:
            yield
    finally:
        for op, handler in saved_rules.items():
            if handler is None:
                handlers.pop(op, None)
            else:
                handlers[op] = handler
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        _RECORDER = None


def _groups(mesh) -> dict:
    """Process-group name -> (mesh axes, size), one a mesh dim."""
    sizes = axis_sizes(mesh)
    return {mesh.get_group(name).group_name: ((name,), sizes[name])
            for name in mesh.mesh_dim_names}


def _dtensor(mesh, shape, dtype, entries):
    """A fake ``DTensor`` of global ``shape`` laid out by ``entries``."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(local_shape(tuple(shape), entries, mesh),
                        dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, placements(entries, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, out = 1, []
    for n in reversed(tuple(shape)):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def state_specs(cfg, mesh, rules: dict | None = None) -> TrainState:
    """Spec entries of the train state: parameters by the rules, AdamW's
    moments on the same, its step replicated."""
    specs = tree_specs(M.param_specs(cfg), M.param_shapes(cfg), mesh,
                       {**DEFAULT_RULES, **(rules or {})})
    return TrainState(params=specs,
                      opt=AdamWState(step=(), m=specs, v=specs))


def batch_specs(batch: dict, mesh, axes=None) -> dict:
    bx = batch_axes(mesh, axes)

    def one(name, t):
        if name == "positions":  # (3, B, S): batch is dim 1
            return (None, bx)
        return batch_spec(mesh, t.dim(), axes=axes)
    return {k: one(k, v) for k, v in batch.items()}


def cache_specs(cfg, cache, mesh) -> dict:
    """KV/SSM cache layout: batch -> (pod, data); kv_heads -> model when
    divisible, else the context length ('seq') shards over model — the
    32k/500k caches only fit with 2-D sharding.  Leading dim is the period
    stack (the reference's ``_cache_pspecs``)."""
    axis_map = {
        "k": ("layers", "batch", "seq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "seq", "kv_heads", "head_dim"),
        "ssm": ("layers", "batch", "inner", "state"),
        "h": ("layers", "batch", "lru"),
    }
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("pod", "data")
    rules["state"] = None
    model_size = axis_sizes(mesh).get("model", 1)
    if cfg.n_kv_heads and cfg.n_kv_heads % model_size == 0:
        rules["seq"] = None          # shard kv_heads over model
    else:
        rules["seq"] = "model"       # shard the context dim instead
        rules["kv_heads"] = None

    def entry(name, t):
        axes = axis_map.get(name)
        if name == "conv":
            third = "inner" if cfg.family == "ssm" else "lru"
            axes = ("layers", "batch", None, third)
        if axes is None:
            return ()
        axes = axes[:t.dim()]
        # tail (unstacked) entries lack the leading layers dim
        if t.dim() == len(axes) - 1:
            axes = axes[1:]
        return spec_for_axes(axes[-t.dim():], tuple(t.shape), mesh, rules)

    return {"stack": {j: {k: entry(k, v) for k, v in slot.items()}
                      for j, slot in cache["stack"].items()},
            "tail": [{k: entry(k, v) for k, v in layer.items()}
                     for layer in cache["tail"]]}


def _lay_out(mesh, tree, specs):
    """``tree`` of meta tensors -> fake ``DTensor``\\ s laid out by the
    parallel tree of spec entries."""
    return map_axes(lambda e, t: _dtensor(mesh, t.shape, t.dtype, e),
                    specs, tree)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t._local_tensor) for t in _tensors(tree))


def execute_cell(cfg, cell: ShapeCell, mesh, *, rules: dict | None = None,
                 accum: int = 1, optimizer: AdamW | None = None,
                 accum_dtype: str = "float32", constrain_grads: bool = False,
                 batch_ax=None, seq_ax=None) -> tuple[dict, list]:
    """One step of ``cell`` on ``mesh`` (a ``DeviceMesh``), on fake
    tensors; returns (memory, op record)."""
    recorder = OpRecorder(_groups(mesh))
    optimizer = optimizer or AdamW()
    mem = {"alias_size_in_bytes": 0}
    ctx_b = act_batch_axes(batch_ax) if batch_ax else contextlib.nullcontext()
    ctx_s = act_seq_axes(seq_ax) if seq_ax else contextlib.nullcontext()
    with use_mesh(mesh), ctx_b, ctx_s, act_rules(rules):
        sspecs = state_specs(cfg, mesh, rules)
        pshapes = M.param_shapes(cfg)
        params = map_axes(lambda e, s, d: _dtensor(mesh, s, d, e),
                          sspecs.params, pshapes, M.param_dtypes(cfg))
        spec = input_specs(cfg, cell)
        if cell.kind == "train":
            mdt = {"float32": torch.float32,
                   "bfloat16": torch.bfloat16}[optimizer.moment_dtype]
            m, v = (map_axes(lambda e, s: _dtensor(mesh, s, mdt, e),
                             specs, pshapes)
                    for specs in (sspecs.opt.m, sspecs.opt.v))
            step0 = _dtensor(mesh, (), torch.int32, sspecs.opt.step)
            state = TrainState(params, AdamWState(step0, m, v))
            batch = _lay_out(mesh, spec, batch_specs(spec, mesh, batch_ax))
            args = (state, batch)
            step = build_train_step(cfg, optimizer, TrainOptions(
                accum_steps=accum, accum_dtype=accum_dtype, rules=rules,
                constrain_grads=constrain_grads))
            run = lambda: step(state, batch)
        elif cell.kind == "prefill":
            batch = _lay_out(mesh, spec, batch_specs(spec, mesh, batch_ax))
            args = (params, batch)
            run = lambda: M.prefill(params, batch, cfg, dispatch="torch",
                                    scan="torch")
        else:
            cache = _lay_out(mesh, spec["cache"],
                             cache_specs(cfg, spec["cache"], mesh))
            shard = cell.global_batch % 16 == 0
            tokens = _dtensor(mesh, spec["tokens"].shape, torch.long,
                              batch_spec(mesh, 2, shard_batch=shard))
            args = (params, cache, tokens)
            mem["alias_size_in_bytes"] = _local_bytes(cache)
            run = lambda: M.decode_step(params, cache, tokens,
                                        cell.seq_len - 1, cfg,
                                        dispatch="torch", scan="torch")
        mem["argument_size_in_bytes"] = _local_bytes(args)
        recorder.hold(t._local_tensor for t in _tensors(args))
        with sharded_execution(mesh, recorder), torch.no_grad():
            out = run()
            del out
    mem["temp_size_in_bytes"] = recorder.peak
    mem["total_per_device"] = (mem["argument_size_in_bytes"]
                               + mem["temp_size_in_bytes"])
    return mem, recorder.record()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rules: dict | None = None, accum: int | None = None,
             save_ops: bool = True, out_dir: str = OUT_DIR, tag: str = "",
             cfg_overrides: dict | None = None,
             constrain_grads: bool = False) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPES[shape_name]
    ok, reason = applicable(cfg, cell)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag
                                                      else "")
    if not ok:
        return {"cell": cell_id, "status": "skipped", "reason": reason}

    result = {"cell": cell_id, "arch": arch, "shape": shape_name,
              "kind": cell.kind, "seq_len": cell.seq_len,
              "global_batch": cell.global_batch,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count()}
    # hillclimb overrides: '__batch__' remaps the activation/data batch axes;
    # '__seq__' turns on Megatron-style sequence-parallel layer boundaries
    batch_ax = seq_ax = None
    if rules:
        rules = dict(rules)
        batch_ax = rules.pop("__batch__", None)
        seq_ax = rules.pop("__seq__", None)
        result["rules"] = {str(k): str(v) for k, v in rules.items()}
        if batch_ax:
            result["rules"]["__batch__"] = str(batch_ax)
        if seq_ax:
            result["rules"]["__seq__"] = str(seq_ax)
    A = 1
    if cell.kind == "train":
        A = accum if accum is not None else ACCUM.get(arch, 1)
        result["accum_steps"] = A
    t0 = time.time()
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        result["mesh"] = list(axis_sizes(mesh).values())
        result["mesh_axes"] = list(mesh.mesh_dim_names)
        memory, ops = execute_cell(
            cfg, cell, mesh, rules=rules, accum=A,
            optimizer=AdamW(moment_dtype=MOMENT_DTYPE.get(arch, "float32")),
            accum_dtype=ACCUM_DTYPE.get(arch, "float32"),
            constrain_grads=constrain_grads, batch_ax=batch_ax,
            seq_ax=seq_ax)
    result["memory"] = memory
    result["wall_s"] = time.time() - t0
    result["status"] = "ok"

    os.makedirs(out_dir, exist_ok=True)
    if save_ops:
        ops_path = os.path.join(out_dir, cell_id + ".ops.json")
        with open(ops_path, "w") as f:
            json.dump(ops, f)
        result["ops_path"] = ops_path
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run (fake "
                                 "process group, fake tensors; no device)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
                try:
                    res = run_cell(arch, shape, multi_pod=mp,
                                   out_dir=args.out)
                    if res["status"] == "ok":
                        mem = res["memory"]["total_per_device"] / 2**30
                        print(f"[ok]   {label}: {mem:.2f} GiB/dev, "
                              f"wall {res['wall_s']:.1f}s", flush=True)
                    else:
                        print(f"[skip] {label}: {res['reason']}", flush=True)
                except Exception as e:  # one cell's failure: report, go on
                    failures += 1
                    print(f"[FAIL] {label}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
