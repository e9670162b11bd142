"""The port's shape cells, logical-axis trees, sharding rules and
activation constraints against the reference's.

``repro_torch.configs.shapes`` and ``models.model.param_specs`` must equal
the reference's for every arch at full width; ``train.sharding``'s
``spec_for_axes`` must give the reference's ``PartitionSpec`` entries
(divisibility fallback, used axes, tuple rules); ``constrain`` and
``_constrain_like_params`` must return their inputs themselves without a
mesh and lay ``DTensor``\\ s out by the rules under a small fake mesh; the
hillclimb must leave ``os.environ`` as it found it.  Tolerance: exact.
"""

import os

import pytest

pytest.importorskip("torch")

import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable as ref_applicable
from repro.models.model import param_specs as ref_param_specs
from repro.train import sharding as ref_sharding
from repro_torch.configs import ARCHS, SHAPES, applicable, cells_for
from repro_torch.launch import hillclimb
from repro_torch.launch.mesh import links_crossed, make_local_mesh
from repro_torch.models.model import param_specs
from repro_torch.models.shard_utils import (act_batch_axes, act_rules,
                                            act_seq_axes, constrain,
                                            mesh_axis_size, shards, use_mesh)
from repro_torch.train import sharding
from repro_torch.train.train_step import _constrain_like_params


def test_shape_cells_and_applicability_equal_the_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, cell in SHAPES.items():
        ref = REF_SHAPES[name]
        assert (cell.name, cell.kind, cell.seq_len, cell.global_batch) == (
            ref.name, ref.kind, ref.seq_len, ref.global_batch)
    for arch, cfg in ARCHS.items():
        for name, cell in SHAPES.items():
            assert applicable(cfg, cell) == ref_applicable(
                REF_ARCHS[arch], REF_SHAPES[name]), (arch, name)
        assert [(c.name, ok, why) for c, ok, why in cells_for(cfg)] == [
            (c.name, *ref_applicable(REF_ARCHS[arch], c))
            for c in REF_SHAPES.values()]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch):
    assert param_specs(ARCHS[arch]) == ref_param_specs(REF_ARCHS[arch])


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
CASES = [
    (("embed", "ffn"), (2048, 1024), {}),
    (("vocab", "embed"), (49155, 1024), {}),           # vocab: no divide
    (("layers", "embed", "kv_heads", "head_dim"), (24, 1024, 8, 64), {}),
    (("batch", None), (256, 4096), {"batch": ("pod", "data")}),
    (("batch", "embed"), (256, 4096), {"batch": ("data", "model"),
                                       "embed": "data"}),  # data used
    (("batch", "seq", "kv_heads"), (128, 32768, 8),
     {"batch": ("pod", "data"), "seq": "model", "kv_heads": None}),
    (("experts", "embed", "ffn"), (32, 1024, 512), {"experts": "model"}),
    ((None, "inner"), (256, 8192), {}),
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_spec_for_axes_equals_the_reference(mesh_name, case):
    shape, names = MESHES[mesh_name]
    axes, dims, extra = CASES[case]
    rules = {**sharding.DEFAULT_RULES, **extra}
    ref = ref_sharding.spec_for_axes(axes, dims, AbstractMesh(shape, names),
                                     {**ref_sharding.DEFAULT_RULES, **extra})
    got = sharding.spec_for_axes(axes, dims,
                                 sharding.MeshShape(shape, names), rules)
    assert got == tuple(ref)


def test_placements_shard_each_mesh_dim_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.placements((), mesh) == (Replicate(),) * 3
    assert sharding.local_shape((256, 4096, 1024),
                                (("pod", "data"), None, "model"), mesh) == (
        8, 4096, 64)
    assert sharding.batch_spec(mesh, 3) == (("pod", "data"), None, None)
    assert sharding.batch_spec(mesh, 2, shard_batch=False) == ()
    assert sharding.named(mesh, {"w": ("data", None), "b": [(), ("pod",)]}) \
        == {"w": (Replicate(), Shard(0), Replicate()),
            "b": [(Replicate(),) * 3, (Shard(0), Replicate(), Replicate())]}


def test_links_crossed_by_a_group():
    shape = {"data": 16, "model": 16}
    assert links_crossed(shape, ("model",)) == "network"   # 16 > 8 a host
    assert links_crossed(shape, ("data",)) == "network"
    assert links_crossed({"data": 2, "model": 4}, ("model",)) == "nvlink"
    assert links_crossed({"data": 2, "model": 4}, ("data",)) == "nvlink"
    assert links_crossed({"data": 4, "model": 4}, ("data",)) == "network"


def test_constrain_without_a_mesh_returns_its_argument():
    x = torch.randn(4, 8)
    assert constrain(x, "batch", "model") is x
    assert mesh_axis_size("model") == 1
    grads = {"embed": torch.randn(6, 4)}
    assert _constrain_like_params(grads, ARCHS["gemma3-1b"], None) is grads


@pytest.fixture
def mesh():
    with make_local_mesh(data=4, model=2) as m:
        yield m


def _replicated(mesh, shape):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(torch.zeros(shape, device="meta"), mesh,
                              (Replicate(), Replicate()), run_check=False)


def test_constrain_lays_dtensors_out_by_logical_axes(mesh):
    from torch.distributed.tensor import Replicate, Shard
    x = _replicated(mesh, (8, 6, 4))
    plain = torch.zeros(8, 6, 4)
    with use_mesh(mesh):
        assert mesh_axis_size("model") == 2
        assert constrain(plain, "batch", None, "model") is plain
        y = constrain(x, "batch", None, "model")
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y._local_tensor.shape) == (2, 6, 2)
        assert constrain(y, "batch", None, "model") is y
        # 'seq' is sharded only under sequence parallelism
        assert constrain(x, "batch", "seq", None).placements == (
            Shard(0), Replicate())
        with act_seq_axes(("model",)):
            assert constrain(x, "batch", "seq", None).placements == (
                Shard(0), Shard(1))
        # the batch over both axes; a dim that does not divide: replicated
        with act_batch_axes(("data", "model")):
            assert constrain(x, "batch", None, None).placements == (
                Shard(0), Shard(0))
        assert constrain(_replicated(mesh, (6, 3)), "batch",
                         "model").placements == (Replicate(), Replicate())


def test_a_variant_rule_changes_an_activation_placement(mesh):
    """Parameter axes resolve through the rules, a hillclimb variant's
    overrides included: ``heads: None`` replicates q/k/v, and the dry run
    hands a variant's rules to the model (attention's products run on
    every head of a device's rows)."""
    from torch.distributed.tensor import Replicate, Shard
    q = _replicated(mesh, (8, 6, 4, 16))              # (B, S, H, hd)
    with use_mesh(mesh):
        assert shards("heads", 4) and not shards("heads", 3)
        assert constrain(q, "batch", None, "heads", None).placements == (
            Shard(0), Shard(2))
        with act_rules({"heads": None}):
            assert not shards("heads", 4)
            assert constrain(q, "batch", None, "heads", None).placements \
                == (Shard(0), Replicate())
        with act_rules({"ffn": "data"}), act_batch_axes(("model",)):
            assert constrain(_replicated(mesh, (8, 6, 32)), "batch", None,
                             "ffn").placements == (Shard(2), Shard(0))

    import dataclasses

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].reduced(),
                              n_heads=16, n_kv_heads=8)
    cell = ShapeCell("t", "prefill", 64, 8)

    def attention_batches(rules):
        _, rows = dryrun.execute_cell(cfg, cell, mesh, rules=rules)
        return {int(r["shapes"].split("x")[0]) for r in rows
                if r["op"] == "aten.bmm" and f"x{cfg.head_dim}," in
                r["shapes"] and not r["shapes"].startswith("1x")}
    # 2 rows a device (8 over data = 4) × 8 heads (16 over model = 2), or
    # all 16 heads under the variant
    assert attention_batches(None) == {2 * 8}
    assert attention_batches({"heads": None}) == {2 * 16}


def test_constrain_lays_the_cotangent_out_as_its_output(mesh):
    """As XLA's sharding constraint, whose transpose constrains the
    cotangent alike: the gradient that flows back through a constraint
    takes the constrained layout, whatever layout the ops after it gave."""
    from torch.distributed.tensor import Replicate, Shard
    x = _replicated(mesh, (8, 6, 4)).requires_grad_(True)
    with use_mesh(mesh):
        y = constrain(x, "batch", None, "model")
        assert y.placements == (Shard(0), Shard(2))
        # the sum's backward hands a replicated cotangent back
        grad, = torch.autograd.grad(y.sum(), x)
    assert grad.placements == (Shard(0), Shard(2))
    assert tuple(grad._local_tensor.shape) == (2, 6, 2)
    with use_mesh(mesh):      # without autograd: a plain redistribution
        assert constrain(x.detach(), None, None, "model").placements == (
            Replicate(), Shard(2))


def test_pad_runs_on_each_devices_part(mesh):
    """``shard_utils.pad`` pads each device's part, its placements kept;
    a padded dim that is sharded raises."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Shard

    from repro_torch.models.shard_utils import pad
    plain = torch.zeros(8, 6, 4)
    assert pad(plain, (0, 0, 3, 0)).shape == F.pad(plain, (0, 0, 3, 0)).shape
    with use_mesh(mesh):
        x = constrain(_replicated(mesh, (8, 6, 4)), "batch", None, "model")
        y = pad(x, (0, 0, 3, 0))
        assert tuple(y.shape) == (8, 9, 4)
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y._local_tensor.shape) == (2, 9, 2)
        with pytest.raises(ValueError):
            pad(x, (1, 0))


def test_constrain_like_params_gives_each_grad_its_params_placements(mesh):
    from repro_torch.launch.dryrun import state_specs
    from repro_torch.models.model import param_shapes
    cfg = ARCHS["granite-moe-1b-a400m"].reduced()
    specs = state_specs(cfg, mesh).params
    grads = sharding.map_axes(lambda e, s: _replicated(mesh, s), specs,
                              param_shapes(cfg))
    with use_mesh(mesh):
        out = _constrain_like_params(grads, cfg, None)
    pairs = []
    sharding.map_axes(lambda e, g: pairs.append(
        (tuple(g.placements), sharding.placements(e, mesh))), specs, out)
    assert all(got == want for got, want in pairs)
    assert any(any(not p.is_replicate() for p in want) for _, want in pairs)


@pytest.mark.parametrize("before", [None, "7"])
def test_hillclimb_variant_restores_the_environment(monkeypatch, before):
    seen = {}

    def fake_run_cell(arch, shape, **kw):
        seen["during"] = os.environ.get("REPRO_SCAN_CHUNK")
        return {"status": "ok", "cell": "c"}

    monkeypatch.setattr(hillclimb, "run_cell", fake_run_cell)
    monkeypatch.setattr(hillclimb, "roofline_cell", lambda path: {})
    if before is None:
        monkeypatch.delenv("REPRO_SCAN_CHUNK", raising=False)
    else:
        monkeypatch.setenv("REPRO_SCAN_CHUNK", before)
    snapshot = dict(os.environ)
    hillclimb.run_variant("falcon_chunk", out_dir="unused")
    assert seen["during"] == "64"
    assert dict(os.environ) == snapshot
