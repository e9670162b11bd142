"""Values and gradients of ``shard_utils.relocate`` on a real mesh: four
CPU processes joined by ``gloo`` on localhost, a 2×2 (data, model) mesh,
tensors and cotangents made from a seed.  The dry run moves only ``meta``
tensors, so these cases hold that the point-to-point move and its inverse
give, bit for bit and in the same placements once reduced, what
``constrain``'s gather-and-cut gives, at the layouts of its sites:

* falcon-mamba's one-token in-projection ``xz`` (lanes, 1, 2·d_inner),
  its last dim on ``model``, cut into its (x, z) halves, each on
  ``model`` (``layers.mamba_decode``): one lane (the lanes replicated)
  and two (the lanes on ``data``); the parts move along ``model``;
* one lane's ring cache (1, context, 1, head_dim), its context on
  ``data``, moved to ``model`` (``layers.attention_decode``): the
  transpose of the mesh, over the whole mesh's group;
* falcon-mamba's in-projection weight (D, 2·d_inner) cut into its halves
  (``layers._halves``): as the FSDP gather leaves it (``embed`` whole,
  ``inner`` on ``model``; each half's rows whole) and in its own layout
  (``embed`` on ``data``, ``inner`` on ``model``; each half so too);
* recurrentgemma's gate product (lanes, ..., 2·lru) cut into r and i,
  each laid out as Λ (``layers._rglru_gates``): lanes on ``data`` and the
  product's columns reduce-scattered onto ``model``; and one lane, the
  columns on the idle ``data`` axis and reduced over ``model``, moved over
  the whole mesh.

Every case runs under autograd too, with a cotangent laid out as each
part and with one pending as a partial sum over the mesh (half of it on
two ranks): the input's gradient equals the gather-and-cut's and the
plain ``cat`` of the cotangents, bit for bit; a mesh dim where it is
``Replicate()`` holds the same values on every rank.  Each move, forward
and backward, is one exchange a rank, so a silent fall back to
``constrain`` fails.

The two layer functions that move parts under autograd,
``layers._halves`` and ``layers._rglru_gates`` (and its one-lane decode
form), run at reduced widths: outputs and gradients equal the
single-process plain form within ``rtol=atol=1e-6`` (float32, as
``test_torch_launch_mesh_values.py``), and the gather-and-cut (the same
function with ``relocate`` made ``constrain`` of the chunks) bit for bit.
"""

import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

# (name, global shape, placements as (data, model) specs, axes, chunks)
CASES = (
    ("xz_one_lane", (1, 1, 16), ((None,), ("model", 2)),
     ("batch", None, "inner"), 2),
    ("xz_two_lanes", (2, 1, 16), (("data", 0), ("model", 2)),
     ("batch", None, "inner"), 2),
    ("ring_cache", (1, 8, 1, 4), (("data", 1), (None,)),
     ("batch", "model", None, None), 1),
    ("in_proj_gathered", (8, 16), ((None,), ("model", 1)),
     (None, "inner"), 2),
    ("in_proj", (8, 16), (("data", 0), ("model", 1)),
     ("embed", "inner"), 2),
    ("gates_lanes", (2, 3, 16), (("data", 0), ("model", 2)),
     ("batch", None, "lru"), 2),
    ("gates_one_lane", (1, 16), (("data", 1), (None,)),
     ("batch", "lru"), 2),
)
COTANGENTS = ("laid", "partial")

# layer cases: B, S, D, inner (falcon); B, S, lru width (recurrentgemma)
HALVES = (2, 3, 8, 8)
GATES = (2, 3, 8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data(shape):
    return torch.from_numpy(np.random.default_rng(len(shape) + shape[0])
                            .standard_normal(shape)).float()


def _cotangents(name, shape, chunks):
    rng = np.random.default_rng(sum(map(ord, name)))
    part = (*shape[:-1], shape[-1] // chunks)
    return [torch.from_numpy(rng.standard_normal(part)).float()
            for _ in range(chunks)]


def _layer_inputs():
    """The layer cases' plain tensors, from one seed."""
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).float()
    B, S, D, di = HALVES
    b, s, w = GATES
    return {"x": t(B, S, D), "in_proj": t(D, 2 * di),
            "halves_cot": [t(B, S, di), t(B, S, di)],
            "conv": t(b, s, w), "w_rg": t(w, 2 * w) / w ** 0.5,
            "lam": t(w), "gates_cot": [t(b, s, w), t(b, s, w)],
            "conv1": t(1, w), "gates1_cot": [t(1, w), t(1, w)]}


def _plain_layers(inp):
    """The layer functions without a mesh: outputs and gradients."""
    from repro_torch.models import layers
    leaves = {k: inp[k].clone().requires_grad_(True)
              for k in ("x", "in_proj", "conv", "w_rg", "lam", "conv1")}
    halves = layers._halves(leaves["x"], leaves["in_proj"], "inner")
    gates = layers._rglru_gates({"w_rg": leaves["w_rg"],
                                 "lam": leaves["lam"]}, leaves["conv"],
                                torch.float32)
    gates1 = layers._rglru_gates({"w_rg": leaves["w_rg"],
                                  "lam": leaves["lam"]}, leaves["conv1"],
                                 torch.float32)
    torch.autograd.backward([*halves, *gates, *gates1],
                            [*inp["halves_cot"], *inp["gates_cot"],
                             *inp["gates1_cot"]])
    return {"halves": [t.detach() for t in halves],
            "gates": [t.detach() for t in gates],
            "gates1": [t.detach() for t in gates1],
            **{f"grad_{k}": v.grad for k, v in leaves.items()}}


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.models import layers, shard_utils
    from repro_torch.models.shard_utils import (constrain, gathered,
                                                relocate, use_mesh)

    exchanges = []
    exchange = shard_utils._exchange

    def counted(buf, *args):             # the move, not constrain's
        exchanges.append(buf.numel())
        return exchange(buf, *args)
    shard_utils._exchange = counted

    def cut(x, *axes, chunks=1):         # constrain's gather-and-cut
        if chunks == 1:
            return constrain(x, *axes)
        return tuple(constrain(t, *axes) for t in x.chunk(chunks, dim=-1))

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        coord = tuple(mesh.get_coordinate())

        def cotangent(t, like, kind):
            if kind == "laid":
                return distribute_tensor(t, mesh, like.placements)
            # a pending partial sum over both mesh dims: half on two ranks
            half = t / 2 if coord in ((0, 0), (1, 1)) else t * 0
            return DTensor.from_local(half, mesh, (Partial(), Partial()),
                                      run_check=False)

        got = {}
        with use_mesh(mesh):
            for name, shape, place, axes, chunks in CASES:
                src = tuple(Shard(p[1]) if p[0] else Replicate()
                            for p in place)
                x = distribute_tensor(_data(shape), mesh, src)
                exchanges.clear()
                moved = as_tuple(relocate(x, *axes, chunks=chunks))
                sent = list(exchanges)
                plain = as_tuple(cut(x, *axes, chunks=chunks))
                got[name] = {
                    "moved": [t.full_tensor() for t in moved],
                    "cut": [t.full_tensor() for t in plain],
                    "same_local": all(torch.equal(a.to_local(), b.to_local())
                                      for a, b in zip(moved, plain)),
                    "sent": sent,
                    "taken": sum(t.to_local().numel() for t in moved),
                    "place": [str(t.placements) for t in moved],
                    "cut_place": [str(t.placements) for t in plain]}
                for kind in COTANGENTS:
                    cots = _cotangents(name, shape, chunks)
                    grads = []
                    exchanges.clear()
                    for move in (relocate, cut):
                        leaf = distribute_tensor(_data(shape), mesh, src)
                        leaf.requires_grad_(True)
                        outs = as_tuple(move(leaf, *axes, chunks=chunks))
                        torch.autograd.backward(outs, [
                            cotangent(c, o, kind)
                            for c, o in zip(cots, outs)])
                        grads.append(leaf.grad)
                        if move is relocate:
                            moves = list(exchanges)
                    g, g_cut = grads
                    got[name][kind] = {
                        "exchanges": len(moves),
                        "place": [str(p) for p in g.placements],
                        "raw": g.to_local(),
                        "local": g.redistribute(mesh, src).to_local(),
                        "cut_local": g_cut.redistribute(mesh, src)
                        .to_local(),
                        "full": g.full_tensor(),
                        "cut_full": g_cut.full_tensor()}

            # the layer functions, relocating and gathering-and-cutting
            inp = _layer_inputs()
            layer_got = {}
            for label, move in (("moved", relocate), ("cut", cut)):
                layers.relocate = move
                x = distribute_tensor(inp["x"], mesh, (Shard(0),
                                                       Replicate()))
                w = distribute_tensor(inp["in_proj"], mesh,
                                      (Shard(0), Shard(1)))
                conv = distribute_tensor(inp["conv"], mesh,
                                         (Shard(0), Shard(2)))
                w_rg = distribute_tensor(inp["w_rg"], mesh,
                                         (Replicate(), Shard(0)))
                lam = distribute_tensor(inp["lam"], mesh,
                                        (Replicate(), Shard(0)))
                conv1 = distribute_tensor(inp["conv1"], mesh,
                                          (Replicate(), Shard(1)))
                leaves = {"x": x, "in_proj": w, "conv": conv, "w_rg": w_rg,
                          "lam": lam, "conv1": conv1}
                for t in leaves.values():
                    t.requires_grad_(True)
                exchanges.clear()
                halves = layers._halves(x, gathered(w, None, "inner"),
                                        "inner")
                gates = layers._rglru_gates({"w_rg": w_rg, "lam": lam},
                                            conv, torch.float32)
                # one lane: the product's columns on the idle data axis
                gates1 = layers._rglru_gates(
                    {"w_rg": constrain(w_rg, "lru", "batch"), "lam": lam},
                    conv1, torch.float32, "batch")
                outs = [*halves, *gates, *gates1]
                cots = [*inp["halves_cot"], *inp["gates_cot"],
                        *inp["gates1_cot"]]
                torch.autograd.backward(outs, [
                    distribute_tensor(c, mesh, o.placements)
                    for c, o in zip(cots, outs)])
                layer_got[label] = {
                    "exchanges": len(exchanges),
                    "halves": [t.full_tensor() for t in halves],
                    "gates": [t.full_tensor() for t in gates],
                    "gates1": [t.full_tensor() for t in gates1],
                    **{f"grad_{k}": v.grad.full_tensor()
                       for k, v in leaves.items()}}
            layers.relocate = relocate
            got["layers"] = layer_got
        got["coord"] = coord
        torch.save(got, os.path.join(out_dir, f"got{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = tmp_path_factory.mktemp("relocate")
    mp.spawn(_worker, args=(4, _free_port(), str(out)), nprocs=4,
             join=True)
    return [torch.load(out / f"got{rank}.pt") for rank in range(4)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_relocation_equals_gather_and_cut(got, case):
    name, shape, _, _, chunks = case
    plain = _data(shape).chunk(chunks, dim=-1)
    for g in got:                        # every rank, its part bit for bit
        assert len(g[name]["moved"]) == chunks
        for moved, cut, want in zip(g[name]["moved"], g[name]["cut"], plain):
            assert torch.equal(moved, cut) and torch.equal(moved, want)
        assert g[name]["same_local"]
        assert g[name]["place"] == g[name]["cut_place"]
    # one exchange a move on every rank, each part sent once (a rank's
    # own included): the ranks send what they take
    sent = [g[name]["sent"] for g in got]
    assert all(len(s) == 1 for s in sent), sent
    assert sum(s[0] for s in sent) == sum(g[name]["taken"] for g in got)


@pytest.mark.parametrize("kind", COTANGENTS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_relocation_gradient_equals_gather_and_cut(got, case, kind):
    name, shape, _, _, chunks = case
    want = torch.cat(_cotangents(name, shape, chunks), dim=-1)
    for g in got:
        r = g[name][kind]
        assert r["exchanges"] == 2       # the move and its inverse
        assert torch.equal(r["local"], r["cut_local"])
        assert torch.equal(r["full"], r["cut_full"])
        assert torch.equal(r["full"], want)
    # a Replicate() gradient holds the same values on every rank of the
    # mesh dim (ranks differing there alone)
    place = got[0][name][kind]["place"]
    assert all(g[name][kind]["place"] == place for g in got)
    for dim, p in enumerate(place):
        if p == "Replicate()":
            for a in got:
                for b in got:
                    if all(a["coord"][i] == b["coord"][i]
                           for i in range(2) if i != dim):
                        assert torch.equal(a[name][kind]["raw"],
                                           b[name][kind]["raw"])


LAYER_KEYS = ("halves", "gates", "gates1", "grad_x", "grad_in_proj",
              "grad_conv", "grad_w_rg", "grad_lam", "grad_conv1")


@pytest.mark.parametrize("key", LAYER_KEYS)
def test_layer_moves_equal_plain_and_gather_and_cut(got, key):
    plain = _plain_layers(_layer_inputs())[key]
    for g in got:
        moved, cut = g["layers"]["moved"][key], g["layers"]["cut"][key]
        for m, c, p in zip(*(v if isinstance(v, list) else [v]
                             for v in (moved, cut, plain))):
            assert torch.equal(m, c)
            torch.testing.assert_close(m, p, rtol=1e-6, atol=1e-6)


def test_layer_moves_go_point_to_point(got):
    # _halves: its two halves' move and inverse; _rglru_gates, lanes and
    # one lane: the same
    for g in got:
        assert g["layers"]["moved"]["exchanges"] == 6
        assert g["layers"]["cut"]["exchanges"] == 0
