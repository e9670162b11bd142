"""Values of the decode path's mesh-only helpers on a real mesh: four CPU
processes joined by ``gloo`` on localhost, a 2×2 (data, model) mesh, real
tensors made from a seed.  The dry run executes these helpers only on
``meta`` tensors, so these cases hold that each computes what its plain
form computes:

* ``shard_utils.take_rows`` (decode's embedding: each device takes the
  tokens in its own rows of the vocab-sharded table, a partial sum over
  ``model``) equals ``table[tokens]``;
* ``layers._decode_proj`` with KV heads that do not shard ``model`` but
  whose columns do (its columns split over ``model``, then gathered)
  equals the plain einsum.
"""

import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import _decode_proj
    from repro_torch.models.shard_utils import constrain, take_rows, use_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        rng = np.random.default_rng(0)
        table = torch.from_numpy(rng.standard_normal((8, 4))).float()
        tokens = torch.from_numpy(rng.integers(0, 8, (2, 1)))
        x = torch.from_numpy(rng.standard_normal((2, 1, 4))).float()
        wk = torch.from_numpy(rng.standard_normal((4, 1, 4))).float()
        with use_mesh(mesh):
            # the table as the rules lay it out: vocab on model, embed on
            # data; the lanes on data
            t = distribute_tensor(table, mesh, (Shard(1), Shard(0)))
            tok = distribute_tensor(tokens, mesh, (Shard(0), Replicate()))
            rows = constrain(take_rows(t, tok, "vocab"), "batch", "seq",
                             None)
            xd = distribute_tensor(x, mesh, (Shard(0), Replicate()))
            wd = distribute_tensor(wk, mesh, (Shard(0), Replicate()))
            k = _decode_proj(xd, wd)
            got = {"rows": rows.full_tensor(), "k": k.full_tensor(),
                   "rows_place": str(rows.placements)}
        if rank == 0:
            torch.save(got, os.path.join(out_dir, "got.pt"))
    finally:
        dist.destroy_process_group()


def test_take_rows_and_decode_proj_equal_their_plain_forms(tmp_path):
    mp.spawn(_worker, args=(4, _free_port(), str(tmp_path)), nprocs=4,
             join=True)
    got = torch.load(tmp_path / "got.pt")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((8, 4))).float()
    tokens = torch.from_numpy(rng.integers(0, 8, (2, 1)))
    x = torch.from_numpy(rng.standard_normal((2, 1, 4))).float()
    wk = torch.from_numpy(rng.standard_normal((4, 1, 4))).float()
    assert torch.equal(got["rows"], table[tokens])
    assert got["rows_place"] == "(Shard(dim=0), Replicate())"
    torch.testing.assert_close(got["k"], torch.einsum("bsd,dhk->bshk", x,
                                                      wk),
                               rtol=1e-6, atol=1e-6)
