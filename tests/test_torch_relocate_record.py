"""How the dry run counts ``shard_utils.relocate`` and what layout it pins.

* The recorder (``launch.dryrun.OpRecorder`` under ``sharded_execution``)
  records a relocation on ``meta`` tensors of a fake 4×4 mesh as one
  ``_c10d_functional.collective_permute`` row with the parts the busiest
  device sends and takes, over the mesh dim the parts cross (falcon-mamba's
  (x, z) halves: ``model``) or over the whole mesh (one lane's ring cache,
  its context moving from ``data`` to ``model``), and no all-gather;
  ``roofline.link_bytes`` counts the row as the bytes sent, the
  reference analyzer's count of a collective-permute.
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
