"""How the dry run counts ``shard_utils.relocate`` and what layout it pins.

* The recorder (``launch.dryrun.OpRecorder`` under ``sharded_execution``)
  records a relocation on ``meta`` tensors of a fake 4×4 mesh as one
  ``_c10d_functional.collective_permute`` row with the parts the busiest
  device sends and takes, over the mesh dim the parts cross (falcon-mamba's
  (x, z) halves: ``model``) or over the whole mesh (one lane's ring cache,
  its context moving from ``data`` to ``model``), and no all-gather;
  ``roofline.link_bytes`` counts the row as the bytes sent, the
  reference analyzer's count of a collective-permute.  Under autograd
  the backward's inverse move is one more collective-permute with the
  same bytes, and still no all-gather (the ring cache, replicated over
  ``model``, which its parts cross, adds its gradient's all-reduce there).
* falcon-mamba-7b prefill_32k (full width, 2 layers): the in-projection's
  halves move point to point (``layers._halves``): no all-gather of a
  device's part of the weight (``4096x1024``) over ``model``, and two
  half-parts (``4096x512``) a device a layer.
* recurrentgemma-9b long_500k (full width, 3 layers): attention's value
  product runs with the heads split over the idle ``data`` axis and the
  keys on ``model`` (``bmm 1x1x128,1x128x256`` a device), the layout the
  reference's partitioner takes and the one torch 2.13's rules took
  unasked; torch 2.11's ran every head on each device (``1x16x128``,
  1.067× the reference's FLOPs) until the model constrained the
  probabilities.  Tolerance: exact.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.shard_utils import relocate, use_mesh  # noqa: E402

# (name, global shape, spec entries, axes, chunks, parts the busiest
# device sends and takes, axes crossed, group size)
CASES = (
    ("xz_halves", (1, 1, 64), (None, None, "model"),
     ("batch", None, "inner"), 2, (2, 2), ["model"], 4),
    ("ring_cache", (1, 32, 1, 8), (None, "data", None, None),
     ("batch", "model", None, None), 1, (1, 1), ["data", "model"], 16),
)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_recorder_counts_a_relocation(case):
    name, shape, entries, axes, chunks, (sent, taken), crossed, size = case
    with make_local_mesh(4, 4) as mesh, use_mesh(mesh):
        recorder = dryrun.OpRecorder(dryrun._groups(mesh))
        x = dryrun._dtensor(mesh, shape, torch.float32, entries)
        with dryrun.sharded_execution(mesh, recorder), torch.no_grad():
            out = relocate(x, *axes, chunks=chunks)
        out = out if chunks > 1 else (out,)
    part = tuple(out[0].to_local().shape)
    assert len(out) == chunks and all(
        tuple(t.shape) == (*shape[:-1], shape[-1] // chunks) for t in out)
    rows = [r for r in recorder.record() if r["op"].startswith("_c10d")]
    assert [r["op"] for r in rows] == ["_c10d_functional.collective_permute"]
    r = rows[0]
    nbytes = 4 * torch.Size(part).numel()
    assert r["calls"] == 1 and r["axes"] == crossed
    assert r["group_size"] == size
    assert r["in_bytes"] == sent * nbytes
    assert r["out_bytes"] == taken * nbytes
    assert r["shapes"].split(",")[0] == "x".join(map(str, part))
    assert roofline.link_bytes(r) == r["in_bytes"]
    tot = roofline.analyze_ops([r], {"data": 4, "model": 4})
    assert tot["coll_bytes"] == sent * nbytes
    assert tot["coll_breakdown"] == {
        "collective_permute|" + ",".join(crossed): sent * nbytes}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_recorder_counts_a_relocation_and_its_inverse(case):
    name, shape, entries, axes, chunks, (sent, taken), crossed, size = case
    with make_local_mesh(4, 4) as mesh, use_mesh(mesh):
        recorder = dryrun.OpRecorder(dryrun._groups(mesh))
        x = dryrun._dtensor(mesh, shape, torch.float32, entries)
        x.requires_grad_(True)
        with dryrun.sharded_execution(mesh, recorder):
            out = relocate(x, *axes, chunks=chunks)
            out = out if chunks > 1 else (out,)
            torch.autograd.backward(out, [torch.ones_like(t) for t in out])
        assert tuple(x.grad.shape) == shape
        assert x.grad.to_local().shape == x.to_local().shape
    part = tuple(out[0].to_local().shape)
    local = "x".join(map(str, x.to_local().shape))
    rows = [r for r in recorder.record() if r["op"].startswith("_c10d")
            and r["op"] != "_c10d_functional._wrap_tensor_autograd"]
    # x replicated over a mesh dim the parts cross (the ring cache on
    # model): each cotangent came back to one holder, and the gradient is
    # all-reduced there; no all-gather either way
    reduced = [r for r in rows if r["op"] == "_c10d_functional.all_reduce"]
    assert [(r["shapes"], r["axes"], r["calls"]) for r in reduced] == (
        [(local, ["model"], 1)] if name == "ring_cache" else [])
    rows = [r for r in rows if r not in reduced]
    assert {r["op"] for r in rows} == {"_c10d_functional.collective_permute"}
    nbytes = 4 * torch.Size(part).numel()
    # forward and backward: the inverse sends what the forward took
    assert sum(r["calls"] for r in rows) == 2
    assert all(r["axes"] == crossed and r["group_size"] == size
               and r["shapes"].split(",")[0] == "x".join(map(str, part))
               for r in rows)
    assert sorted((r["in_bytes"], r["out_bytes"]) for r in rows
                  for _ in range(r["calls"])) == sorted(
        [(sent * nbytes, taken * nbytes), (taken * nbytes, sent * nbytes)])


def test_falcon_prefill_moves_the_in_projection_halves(tmp_path):
    res = dryrun.run_cell("falcon-mamba-7b", "prefill_32k", multi_pod=False,
                          cfg_overrides={"n_layers": 2}, out_dir=tmp_path)
    with open(res["ops_path"]) as f:
        rows = json.load(f)
    gathers = [r for r in rows
               if r["op"] == "_c10d_functional.all_gather_into_tensor"
               and r["shapes"].split(",")[0] == "4096x1024"
               and r["axes"] == ["model"]]
    assert not gathers
    permutes = [r for r in rows
                if r["op"] == "_c10d_functional.collective_permute"]
    assert [(r["shapes"].split(",")[0], r["axes"], r["calls"])
            for r in permutes] == [("4096x512", ["model"], 2)]
    # at most two half-parts a device a layer, bf16
    assert permutes[0]["in_bytes"] <= 2 * 4096 * 512 * 2


def test_link_bytes_of_a_permute_is_what_a_device_sends():
    r = {"op": "_c10d_functional.collective_permute", "calls": 3,
         "trips": 1, "in_bytes": 4096, "out_bytes": 4096,
         "max_in_bytes": 2048, "flops": 0, "shapes": "", "axes": ["model"],
         "group_size": 16}
    assert roofline.link_bytes(r) == 4096
    tot = roofline.analyze_ops([r], {"data": 16, "model": 16})
    assert tot["coll_bytes"] == 3 * 4096
    assert tot["coll_seconds"] == 3 * 4096 / roofline.NETWORK_BW


def test_a_move_that_is_no_relocation_stays_constrains():
    """A shard-to-shard move within one mesh dim needs every device's
    parts (no part lies whole on one device): DTensor's all-to-all."""
    with make_local_mesh(4, 4) as mesh, use_mesh(mesh):
        recorder = dryrun.OpRecorder(dryrun._groups(mesh))
        x = dryrun._dtensor(mesh, (8, 8), torch.float32, (None, "model"))
        with dryrun.sharded_execution(mesh, recorder), torch.no_grad():
            relocate(x, "model", None)
    ops = [r["op"] for r in recorder.record() if r["op"].startswith("_c10d")]
    assert ops == ["_c10d_functional.all_to_all_single"]


def test_recurrentgemma_long_context_value_product_layout(tmp_path,
                                                           monkeypatch):
    seen = []
    einsum = torch.einsum

    def spy(spec, *ops):
        if spec == "bgmqs,bsgd->bqgmd":
            seen.append([str(tuple(t.placements)) for t in ops])
        return einsum(spec, *ops)
    monkeypatch.setattr(torch, "einsum", spy)
    res = dryrun.run_cell("recurrentgemma-9b", "long_500k", multi_pod=False,
                          cfg_overrides={"n_layers": 3}, out_dir=tmp_path)
    monkeypatch.undo()
    with open(res["ops_path"]) as f:
        rows = json.load(f)
    bmm = {r["shapes"]: r for r in rows if r["op"] == "aten.bmm"}
    # one local layer in three: heads 16/16 on data, keys 2,048/16 on model
    assert bmm["1x1x128,1x128x256"]["calls"] == 1
    assert "1x16x128,1x128x256" not in bmm
    assert seen == [["(Shard(dim=2), Shard(dim=4))",
                     "(Replicate(), Shard(dim=1))"]]
    flops = roofline.roofline_cell(res["ops_path"].replace(
        ".ops.json", ".json"))["op_flops"]
    assert flops == 14_684_160          # the reference dry run's count
