"""Values of ``shard_utils.relocate`` on a real mesh: four CPU processes
joined by ``gloo`` on localhost, a 2×2 (data, model) mesh, tensors made
from a seed.  The dry run moves only ``meta`` tensors, so these cases
hold that the point-to-point move gives, bit for bit and in the same
placements, what ``constrain``'s gather-and-cut gives, at the layouts of
its two sites:

* falcon-mamba's one-token in-projection ``xz`` (lanes, 1, 2·d_inner),
  its last dim on ``model``, cut into its (x, z) halves, each on
  ``model`` (``layers.mamba_decode``): one lane (the lanes replicated)
  and two (the lanes on ``data``); the parts move along ``model``;
* one lane's ring cache (1, context, 1, head_dim), its context on
  ``data``, moved to ``model`` (``layers.attention_decode``): the
  transpose of the mesh, over the whole mesh's group.

Under autograd the move raises (it has no backward).
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
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data(shape):
    return torch.from_numpy(np.random.default_rng(len(shape) + shape[0])
                            .standard_normal(shape)).float()


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import shard_utils
    from repro_torch.models.shard_utils import constrain, relocate, use_mesh

    exchanges = []
    exchange = shard_utils._exchange

    def counted(buf, *args):             # the move, not constrain's
        exchanges.append(buf.numel())
        return exchange(buf, *args)
    shard_utils._exchange = counted

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        got = {}
        with use_mesh(mesh):
            for name, shape, place, axes, chunks in CASES:
                x = distribute_tensor(_data(shape), mesh, tuple(
                    Shard(p[1]) if p[0] else Replicate() for p in place))
                exchanges.clear()
                moved = relocate(x, *axes, chunks=chunks)
                sent = list(exchanges)
                cut = (constrain(x, *axes) if chunks == 1 else
                       tuple(constrain(t, *axes)
                             for t in x.chunk(chunks, dim=-1)))
                moved = moved if chunks > 1 else (moved,)
                cut = cut if chunks > 1 else (cut,)
                got[name] = {
                    "moved": [t.full_tensor() for t in moved],
                    "cut": [t.full_tensor() for t in cut],
                    "same_local": all(torch.equal(a.to_local(), b.to_local())
                                      for a, b in zip(moved, cut)),
                    "sent": sent,
                    "taken": sum(t.to_local().numel() for t in moved),
                    "place": [str(t.placements) for t in moved],
                    "cut_place": [str(t.placements) for t in cut]}
                x.requires_grad_(True)
                try:
                    relocate(x, *axes, chunks=chunks)
                    got[name]["grad"] = "ran"
                except RuntimeError as e:
                    got[name]["grad"] = str(e)
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_relocation_refuses_autograd(got, case):
    assert all("no backward" in g[case[0]]["grad"] for g in got)
