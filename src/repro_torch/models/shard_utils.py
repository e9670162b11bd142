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

Beside the reference's activation axes (``batch``, ``seq``, ``model``) a
constraint may name a parameter axis (``heads``, ``kv_heads``, ``ffn``,
``inner``, ``lru``, ``vocab``, ``embed``, ``experts``), resolved through
the rules that laid the parameters out (:data:`~repro_torch.train.sharding.
DEFAULT_RULES` merged with :func:`act_rules`' overrides).  The reference
names only its few boundaries and lets XLA's sharding pass carry each
weight's placement into the activations between them; DTensor has no such
pass (each op decides from its inputs, and replicates where its rule cannot
keep a shard), so the port states those placements where they arise.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import itertools
import math

import torch

from ..train.sharding import DEFAULT_RULES, axis_sizes, placements

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

# Hillclimb override: the logical parameter rules the activations follow
# (merged over DEFAULT_RULES), e.g. {"heads": None} replicates q/k/v.
_RULES = contextvars.ContextVar("repro_torch_rules", default=None)


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
def act_rules(rules):
    """Temporarily override the parameter rules activations resolve
    through (a hillclimb variant's ``rules``, without ``__batch__`` and
    ``__seq__``)."""
    token = _RULES.set(dict(rules or {}))
    try:
        yield
    finally:
        _RULES.reset(token)


def _mesh_axes(name) -> tuple:
    """The mesh axes, in priority order, a logical axis name asks for: the
    activation axes' own, else the parameter rules in force."""
    if name == "batch":
        return _BATCH_AXES.get()
    if name == "seq":
        return _SEQ_AXES.get()
    if name in _ACT_RULES:
        return _ACT_RULES[name]
    rules = {**DEFAULT_RULES, **(_RULES.get() or {})}
    if name in rules:
        axis = rules[name]
        return () if axis is None else (
            (axis,) if isinstance(axis, str) else tuple(axis))
    return (name,)


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


def pad(x, widths: tuple):
    """``F.pad(x, widths)`` (zeros); under a mesh, on each device's own part
    of a ``DTensor`` through ``local_map``, its placements kept: the padded
    dims are whole on every device (torch 2.11's sharding rule for the
    pad raises on a two-dim mesh)."""
    import torch.nn.functional as F
    if ambient_mesh() is None:
        return F.pad(x, widths)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    from torch.distributed.tensor.experimental import local_map
    padded = {x.dim() - 1 - i // 2 for i, w in enumerate(widths) if w}
    if any(getattr(p, "dim", None) in padded for p in x.placements):
        raise ValueError(f"pad {widths} of a dim sharded as {x.placements}")
    place = tuple(x.placements)
    return local_map(lambda t: F.pad(t, widths), out_placements=(place,),
                     in_placements=(place,), device_mesh=x.device_mesh)(x)


def take_rows(table, idx, name):
    """``table[idx]`` for a table (rows, ...) whose rows are logical axis
    ``name``; under a mesh that shards them over one mesh dim, each device
    takes the indices that fall in its own rows (zeros for the others')
    and the result stays a partial sum over that dim, reduced at the next
    constraint, as the reference's partitioner runs the gather (DTensor's
    rule moves the whole table between devices).  The indices are
    gathered to every device."""
    if ambient_mesh() is None:
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor) or not shards(name, table.shape[0]):
        return table[idx]
    place = tuple(table.placements)
    cut = [m for m, p in enumerate(place) if p == Shard(0)]
    if len(cut) != 1:
        return table[idx]
    mesh = table.device_mesh
    whole = (Replicate(),) * mesh.ndim
    idx = idx.redistribute(mesh, whole) if isinstance(idx, DTensor) else \
        DTensor.from_local(idx, mesh, whole, run_check=False)
    out_place = tuple(Partial() if p == Shard(0) else
                      Shard(p.dim - 1 + idx.dim()) if isinstance(p, Shard)
                      else p for p in place)

    def local(t, i):
        j = i - mesh.get_coordinate()[cut[0]] * t.shape[0]
        hit = (j >= 0) & (j < t.shape[0])
        rows = t[j.clamp(0, t.shape[0] - 1)]
        return rows * hit[(...,) + (None,) * (t.dim() - 1)].to(t.dtype)

    from torch.distributed.tensor.experimental import local_map
    return local_map(local, out_placements=(out_place,),
                     in_placements=(place, whole), device_mesh=mesh)(
                         table, idx)


def ways(name) -> int:
    """The number of devices the mesh axes of logical axis ``name`` span
    under the ambient mesh and rules (1 without a mesh)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    total = 1
    for a in _mesh_axes(name):
        total *= sizes.get(a, 1)
    return total


def shards(name, dim: int) -> bool:
    """Whether a dim of size ``dim`` named ``name`` shards under the
    ambient mesh and rules (False without a mesh)."""
    n = ways(name)
    return n > 1 and dim % n == 0


def _placements(mesh, shape, axes) -> tuple:
    """The DTensor placements of logical ``axes`` for ``shape``: a dim
    whose axes are absent, used or do not divide it is replicated."""
    sizes = axis_sizes(mesh)
    entries = []
    used: set = set()
    for dim, name in zip(shape, axes):
        chosen = None
        want = _mesh_axes(name)
        present = tuple(a for a in want if a in sizes and a not in used)
        if present:
            total = 1
            for a in present:
                total *= sizes[a]
            if dim % total == 0:
                chosen = present if len(present) > 1 else present[0]
                used.update(present)
        entries.append(chosen)
    return placements(tuple(entries), mesh)


def gathered(w, *axes):
    """A weight laid out for its use by logical ``axes`` (its FSDP axis
    given as None: gathered), through DTensor's own redistribution, whose
    backward reduce-scatters the gradient back onto the weight's
    placements at once, as the reference's partitioner does a layer at a
    time (gathered inside an op, the weight's gradient would stay a
    partial sum at full width until the step's end).  Of an activation's
    pending partial sum its backward hands the cotangent on whole over the
    dims the forward summed, where :func:`constrain`'s keeps it laid out
    as the output.  ``w`` itself without a mesh."""
    mesh = ambient_mesh()
    if mesh is None:
        return w
    from torch.distributed.tensor import DTensor
    if not isinstance(w, DTensor):
        return w
    want = _placements(mesh, w.shape, axes)
    return w if tuple(w.placements) == want else w.redistribute(mesh, want)


def constrain(x, *axes):
    """constrain(x, 'batch', None, 'model') — logical per-dim annotation;
    a parameter axis ('heads', 'ffn', ...) takes the mesh axis its rule
    gives."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want_pl = _placements(mesh, x.shape, axes)
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, want_pl)
    if tuple(x.placements) == want_pl:
        return x
    return x.redistribute(mesh, want_pl)


class _Constrain(torch.autograd.Function):
    """A redistribution whose cotangent is laid out as its output, as the
    transpose of XLA's sharding constraint is the same constraint on the
    cotangent.  (DTensor's own ``redistribute`` takes the cotangent in
    whatever layout the backward ops give it, and its rules pick those
    by communication alone, some at full width on every device.)  A
    partial sum the forward reduced takes its cotangent replicated."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(grad.device_mesh, ctx.want)
        return grad, None


def relocate(x, *axes, chunks: int = 1):
    """:func:`constrain` of each of ``x.chunk(chunks, -1)`` to ``axes`` (a
    tuple of them when ``chunks`` > 1), whose parts, under a mesh, are
    sent point to point where the move only relocates them: every device's
    part of every chunk lies whole in one device's part of ``x``.  Each
    part then crosses a link once, as the reference's partitioner moves it
    with a collective-permute; DTensor would gather the whole of ``x`` over
    the mesh dim and cut it, (m − 1) parts a move.  Any other move is
    :func:`constrain`'s.  The parts travel in one ``all_to_all_single``
    with per-peer split sizes over the mesh dim they cross, or over the
    whole mesh when they cross several.

    Under autograd the backward is the inverse move (:class:`_Relocate`):
    each part's cotangent, laid out as the part, goes back to the device
    that sent the part and is written at the part's block of a zero
    buffer, in one more ``all_to_all_single``.  Where ``x`` is replicated
    over a mesh dim each cotangent lands on one holder: a pending partial
    sum of the cotangent stays ``Partial()`` in the gradient, reduced
    where the next redistribution asks for it; any other gradient is
    all-reduced there."""
    mesh = ambient_mesh()
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x if chunks == 1 else x.chunk(chunks, dim=-1)
    want = _placements(mesh, (*x.shape[:-1], x.shape[-1] // chunks), axes)
    plan = None
    if x.shape[-1] % chunks == 0:
        plan = _relocation(tuple(mesh.shape), tuple(x.shape),
                           tuple(x.placements), want, chunks)
    if plan is None:
        if chunks == 1:
            return constrain(x, *axes)
        return tuple(constrain(t, *axes) for t in x.chunk(chunks, dim=-1))
    if x.requires_grad and torch.is_grad_enabled():
        out = _Relocate.apply(x, plan, want, chunks)
    else:
        out = _moved(x, plan, want, chunks)
    return out[0] if chunks == 1 else tuple(out)


def _moved(x, plan, want, chunks: int) -> tuple:
    """The ``chunks`` parts of ``x`` laid out as ``want``, moved by
    ``plan`` (:class:`_Relocation`)."""
    mesh = x.device_mesh
    group = _group(mesh, plan)
    coord = tuple(mesh.get_coordinate())

    def local(t):
        parts = [None] * chunks
        got = _send([(peer, _cut(t, cut)) for peer, _, cut in
                     plan.sends[coord]],
                    [peer for peer, _ in plan.recvs[coord]], group, plan, t)
        for (_, k), part in zip(plan.recvs[coord], got):
            parts[k] = part
        return tuple(parts)

    from torch.distributed.tensor.experimental import local_map
    return tuple(local_map(local, out_placements=(want,) * chunks,
                           in_placements=(tuple(x.placements),),
                           device_mesh=mesh)(x))


class _Relocate(torch.autograd.Function):
    """:func:`relocate`'s move, whose backward is the inverse move.

    Each chunk's cotangent is first laid out as the chunk (as
    :class:`_Constrain` lays it out), except that a pending partial sum
    over a mesh dim that replicates both ``x`` and the chunk, and that no
    part crosses, is kept: every device there returns its own partial
    part.  A cotangent replicated over a mesh dim is returned by the
    devices at coordinate 0 of it alone (the others hold the same values)
    unless the dim replicates ``x`` and no part crosses it, where every
    device returns its copy to a holder in its own slice and the gradient
    stays replicated there.  Over every other mesh dim that replicates
    ``x`` each cotangent lands on exactly one of the part's holders, the
    others keep zeros there.  Where every chunk's cotangent was a kept
    partial sum the gradient is left ``Partial()``, reduced where the next
    redistribution asks for it (``layers._halves``: the FSDP gather's
    reduce-scatter, which the weight's gradient takes anyway); elsewhere
    it is all-reduced here (adding zeros to one value: the bits of the
    gather-and-cut), so a consumer meets it replicated as it met the
    gather-and-cut's."""

    @staticmethod
    def forward(ctx, x, plan, want, chunks):
        ctx.set_materialize_grads(False)
        ctx.plan, ctx.want, ctx.chunks = plan, want, chunks
        ctx.src = tuple(x.placements)
        ctx.global_shape, ctx.stride = x.shape, x.stride()
        local = x.to_local()
        ctx.local_shape, ctx.dtype = local.shape, local.dtype
        return _moved(x, plan, want, chunks)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        plan, want, src = ctx.plan, ctx.want, ctx.src
        mesh = next(g for g in grads if g is not None).device_mesh
        kept = [i for i, s in enumerate(src)
                if s.is_replicate() and i not in plan.dims]
        laid = []
        for g in grads:
            if g is not None:
                place = tuple(
                    Partial() if i in kept and w.is_replicate()
                    and p.is_partial() else w
                    for i, (p, w) in enumerate(zip(g.placements, want)))
                if tuple(g.placements) != place:
                    g = g.redistribute(mesh, place)
            laid.append(g)
        # a mesh dim that replicates x keeps the gradient replicated where
        # every chunk's cotangent is replicated there too
        whole = [i for i in kept if all(
            g is None or g.placements[i].is_replicate() for g in laid)]
        once = tuple(None if g is None else tuple(
            i for i, p in enumerate(g.placements)
            if p.is_replicate() and i not in whole) for g in laid)
        back = _returns(tuple(mesh.shape), tuple(ctx.global_shape), src,
                        want, ctx.chunks, once)
        coord = tuple(mesh.get_coordinate())
        local = [None if g is None else g.to_local() for g in laid]
        out = torch.zeros(ctx.local_shape, dtype=ctx.dtype,
                          device=next(t for t in local
                                      if t is not None).device)
        got = _send([(peer, local[k]) for peer, k in back.sends[coord]],
                    [peer for peer, _, _ in back.recvs[coord]],
                    _group(mesh, plan), back, out)
        for (_, _, cut), piece in zip(back.recvs[coord], got):
            _cut(out, cut).add_(piece)
        # kept partial sums stay partial; any other gradient over a dim
        # that replicates x is reduced below
        partial = [i for i in kept if all(
            g is None or g.placements[i].is_partial() for g in laid)]
        place = tuple(Partial() if s.is_replicate() and i not in whole
                      else s for i, s in enumerate(src))
        grad = DTensor.from_local(out, mesh, place, run_check=False,
                                  shape=ctx.global_shape, stride=ctx.stride)
        reduced = tuple(Replicate() if p.is_partial() and i not in partial
                        else p for i, p in enumerate(place))
        if reduced != place:
            grad = grad.redistribute(mesh, reduced)
        return grad, None, None, None


def _send(parts: list, peers: list, group, plan, like) -> list:
    """Each (group rank, part) of ``parts`` sent to that rank and the
    parts from ``peers`` (group ranks, in the order they come) returned,
    each of ``plan.piece``'s shape: one exchange over ``group``, or none
    where it is None (every part is where it is wanted)."""
    if group is None:
        return [t for _, t in parts]
    n = math.prod(plan.piece)
    in_splits, out_splits = [0] * plan.size, [0] * plan.size
    for peer, _ in parts:
        in_splits[peer] += n
    for peer in peers:
        out_splits[peer] += n
    buf = torch.cat([t.reshape(-1) for _, t in parts]
                    or [like.new_empty((0,))])
    got = _exchange(buf, out_splits, in_splits, group, plan)
    return [t.view(plan.piece) for t in got.split(n)] if peers else []


def _group(mesh, plan):
    """The process group ``plan``'s parts cross: a mesh dim's, the
    world's, or None where every device keeps its own."""
    if len(plan.dims) == 1:
        return mesh.get_group(plan.dims[0])
    return _world_group(mesh) if plan.dims else None


def _cut(t, cut: tuple):
    """``t``'s block at ``cut`` ((start, length) a dim)."""
    for d, (a, n) in enumerate(cut):
        if n != t.shape[d]:
            t = t.narrow(d, a, n)
    return t


def _world_group(mesh):
    """The default process group, where ``mesh`` lays the world's ranks
    out in their order (a move across several mesh dims runs over it)."""
    import torch.distributed as dist
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise RuntimeError("a move across mesh dims needs a mesh of the "
                           "world's ranks in order")
    return dist.group.WORLD


def _exchange(buf, out_splits: list, in_splits: list, group, plan):
    """``buf`` cut by ``in_splits`` to the group's ranks, the parts from
    them joined by ``out_splits``: one ``all_to_all_single``.  ``plan``
    (:class:`_Relocation`) is for the dry run, which records the move
    (``launch.dryrun.sharded_execution``)."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single(
        buf, out_splits, in_splits, group))


@dataclasses.dataclass(frozen=True)
class _Relocation:
    """The moves of :func:`relocate`, by device coordinate: ``sends``
    (the receiver's rank in the group, chunk, block of the sender's part)
    and ``recvs`` (the sender's rank in the group, chunk), each in the
    order the buffers lay them out; of their inverse (:func:`_returns`),
    ``sends`` (the rank a cotangent goes back to, chunk) and ``recvs``
    (the rank it comes from, chunk, block it is written at).  ``dims``
    are the mesh dims the parts cross (none: every device keeps its
    own), ``size`` their group's ranks, ``piece`` a part's local shape;
    ``most_sent`` and ``most_received`` count the parts the busiest
    device sends to others and takes from them."""
    dims: tuple
    size: int
    piece: tuple
    sends: dict
    recvs: dict
    most_sent: int
    most_received: int


def _block(shape, place, sizes, coord):
    """The block ((start, length) a dim) device ``coord`` holds of a
    tensor of ``shape`` laid out as ``place``, or None where a placement
    is not a plain shard or replica or a shard does not divide."""
    from torch.distributed.tensor import Replicate, Shard
    lo, n = [0] * len(shape), list(shape)
    for i, p in enumerate(place):
        if type(p) is Replicate:
            continue
        if type(p) is not Shard:
            return None
        d = p.dim % len(shape)
        if n[d] % sizes[i]:
            return None
        n[d] //= sizes[i]
        lo[d] += coord[i] * n[d]
    return tuple(zip(lo, n))


def _inside(block, outer) -> bool:
    return all(ho <= a and a + n <= ho + hn
               for (a, n), (ho, hn) in zip(block, outer))


@functools.lru_cache(maxsize=256)
def _relocation(sizes, shape, src, want, chunks):
    """The moves of :func:`relocate` on a mesh of ``sizes`` (its ranks in
    row-major order), or None where some device's part of a chunk is not
    held whole by one device.

    A device whose own part holds its part of a chunk keeps it; the others
    take theirs from a holder, and the holders of a part differ only on
    the mesh dims that replicate ``x``.  The moves cross one mesh dim, or
    all of them (a group spans either): of the choices, the one whose
    busiest device sends the fewest parts, then the one crossing fewer
    dims.  Within a choice the receivers of a part go round its holders in
    turn, the holders in reach (agreeing with the receiver on the dims not
    crossed) taken in order: falcon-mamba's (x, z) halves move along
    ``model`` within each row of the mesh, two halves a device; one
    lane's ring cache moving its context from ``data`` to ``model`` sends
    one part a device over the whole mesh, where along one dim a single
    holder would send to every row."""
    coords = list(itertools.product(*(range(m) for m in sizes)))
    part = (*shape[:-1], shape[-1] // chunks)
    held = {c: _block(shape, src, sizes, c) for c in coords}
    wanted = {c: _block(part, want, sizes, c) for c in coords}
    if None in held.values() or None in wanted.values():
        return None
    holders: dict = {}                   # a block -> its holders, in order
    for c in coords:
        holders.setdefault(held[c], []).append(c)
    needs = []                           # (receiver, chunk, block, holders)
    for c in coords:
        for k in range(chunks):
            b = (*wanted[c][:-1],
                 (wanted[c][-1][0] + k * part[-1], wanted[c][-1][1]))
            if _inside(b, held[c]):
                needs.append((c, k, b, [c]))
                continue
            owner = next((h for h in holders if _inside(b, h)), None)
            if owner is None:
                return None
            needs.append((c, k, b, holders[owner]))

    def assign(cross):
        turn = collections.Counter()
        moves = []                       # (receiver, chunk, sender, block)
        for c, k, b, hs in needs:
            reach = [h for h in hs if all(h[i] == c[i] for i in range(
                len(sizes)) if i not in cross)]
            if not reach:
                return None
            s = reach[turn[tuple(reach)] % len(reach)]
            turn[tuple(reach)] += 1
            moves.append((c, k, s, tuple((a - ho, m) for (a, m), (ho, _)
                                         in zip(b, held[s]))))
        return moves

    best = None
    for cross in [(i,) for i in range(len(sizes))] + [
            tuple(range(len(sizes)))]:
        moves = assign(cross)
        if moves is None:
            continue
        load = max(collections.Counter(s for c, _, s, _ in moves
                                       if s != c).values(), default=0)
        if best is None or load < best[0]:
            best = (load, moves)
    moves = best[1]
    dims = tuple(sorted({i for c, _, s, _ in moves
                         for i in range(len(sizes)) if c[i] != s[i]}))
    if len(dims) > 1:                    # the world's group spans them
        dims = tuple(range(len(sizes)))
    flat = {c: r for r, c in enumerate(coords)}

    def rank(c):
        return c[dims[0]] if len(dims) == 1 else flat[c]
    sends = {c: [] for c in coords}
    recvs = {c: [] for c in coords}
    for c, k, s, cut in moves:
        sends[s].append((rank(c), k, cut))
        recvs[c].append((rank(s), k))
    away = [(c, s) for c, _, s, _ in moves if c != s]
    return _Relocation(
        dims=dims, size=math.prod(sizes[i] for i in dims),
        piece=tuple(m for _, m in wanted[coords[0]]),
        sends={c: sorted(v, key=lambda e: e[:2]) for c, v in sends.items()},
        recvs={c: sorted(v) for c, v in recvs.items()},
        most_sent=best[0],
        most_received=max(collections.Counter(c for c, _ in away).values(),
                          default=0))


@functools.lru_cache(maxsize=256)
def _returns(sizes, shape, src, want, chunks, once):
    """The inverse of :func:`_relocation`'s moves (the same arguments), as
    a :class:`_Relocation` whose ``sends`` are the forward's ``recvs`` and
    whose ``recvs`` (with the block each part is written at) are its
    ``sends``: each receiver returns a chunk's cotangent to the part's
    sender.  ``once`` gives, chunk by chunk, the mesh dims over which only
    the devices at coordinate 0 return it (the cotangent is replicated
    there), or None for a chunk without one."""
    plan = _relocation(sizes, shape, src, want, chunks)
    coords = list(itertools.product(*(range(m) for m in sizes)))

    def peer(c, r):                      # the device of group rank r
        if len(plan.dims) != 1:
            return coords[r]
        return c[:plan.dims[0]] + (r,) + c[plan.dims[0] + 1:]

    def returns(c, k):
        return once[k] is not None and all(c[i] == 0 for i in once[k])
    sends = {c: [(r, k) for r, k in plan.recvs[c] if returns(c, k)]
             for c in coords}
    recvs = {c: [(r, k, cut) for r, k, cut in plan.sends[c]
                 if returns(peer(c, r), k)] for c in coords}
    return dataclasses.replace(
        plan, sends=sends, recvs=recvs,
        most_sent=max((sum(peer(c, r) != c for r, _ in v)
                       for c, v in sends.items()), default=0),
        most_received=max((sum(peer(c, r) != c for r, _, _ in v)
                           for c, v in recvs.items()), default=0))
