"""The port's sharding layout against the reference's, leaf by leaf.

For every arch at full width on both production meshes (16×16 and
2×16×16), each leaf's per-device shape under the port's placements
(``DTensor``'s own local-shape rule on the fake-process-group mesh) must
equal the reference's ``NamedSharding(AbstractMesh(...), spec).shard_shape``
— parameters, AdamW moments, every shape cell's batch, and the decode
caches and tokens.  Tolerance: exact.  The reference side runs in a
subprocess, since its dry-run module sets ``XLA_FLAGS`` at import.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.model import param_shapes
from repro_torch.train.sharding import (batch_spec, is_axes, map_axes,
                                       placements)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs import ARCHS, SHAPES, applicable
    from repro.launch import dryrun as D
    from repro.launch.specs import input_specs
    from repro.optim import AdamW
    from repro.train.sharding import batch_spec

    def shapes(mesh, spec_tree, sds_tree):
        specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        return [[list(s.shape), list(NamedSharding(mesh, p).shard_shape(
                    s.shape))]
                for p, s in zip(specs, jax.tree.leaves(sds_tree))]

    out = {}
    for mname, (shape, axes) in {
            "single": ((16, 16), ("data", "model")),
            "multi": ((2, 16, 16), ("pod", "data", "model"))}.items():
        mesh = AbstractMesh(shape, axes)
        for arch, cfg in sorted(ARCHS.items()):
            st = D._abstract_state(cfg, AdamW(
                moment_dtype=D.MOMENT_DTYPE.get(arch, "float32")))
            ps = D._state_pspecs(cfg, st, mesh)
            row = {"params": shapes(mesh, ps.params, st.params),
                   "moments": shapes(mesh, ps.opt.m, st.opt.m)}
            for cell in SHAPES.values():
                if not applicable(cfg, cell)[0]:
                    continue
                spec = input_specs(cfg, cell)
                if cell.kind == "decode":
                    row[cell.name] = shapes(
                        mesh, D._cache_pspecs(cfg, spec["cache"], mesh),
                        spec["cache"]) + shapes(mesh, batch_spec(
                            mesh, 2, shard_batch=cell.global_batch % 16
                            == 0), spec["tokens"])
                else:
                    row[cell.name] = shapes(
                        mesh, D._batch_pspecs(spec, mesh), spec)
            out[f"{mname}/{arch}"] = row
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _pairs(specs, tensors):
    """(spec entries, global shape) leaf by leaf in ``jax.tree``'s order
    (a dict's keys sorted)."""
    if is_axes(specs):
        yield specs, tuple(tensors.shape)
    elif isinstance(specs, dict):
        for k in sorted(specs):
            yield from _pairs(specs[k], tensors[k])
    else:
        for s, t in zip(specs, tensors):
            yield from _pairs(s, t)


def _local(mesh, specs, tensors) -> list:
    """[[global shape, per-device shape], ...] in ``jax.tree`` leaf
    order, the per-device shape by DTensor's own rule."""
    return [[list(shape), list(compute_local_shape_and_global_offset(
        shape, mesh, placements(e, mesh))[0])]
        for e, shape in _pairs(specs, tensors)]


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_every_leaf_shards_as_the_reference(reference, multi_pod):
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        for arch, cfg in sorted(ARCHS.items()):
            ref = reference[f"{'multi' if multi_pod else 'single'}/{arch}"]
            st = dryrun.state_specs(cfg, mesh)
            metas = map_axes(lambda e, s: _Shape(s), st.params,
                             param_shapes(cfg))
            got = {"params": _local(mesh, st.params, metas),
                   "moments": _local(mesh, st.opt.m, metas)}
            for cell in SHAPES.values():
                if not applicable(cfg, cell)[0]:
                    continue
                spec = input_specs(cfg, cell)
                if cell.kind == "decode":
                    got[cell.name] = _local(
                        mesh, dryrun.cache_specs(cfg, spec["cache"], mesh),
                        spec["cache"]) + _local(mesh, batch_spec(
                            mesh, 2, shard_batch=cell.global_batch % 16
                            == 0), spec["tokens"])
                else:
                    got[cell.name] = _local(
                        mesh, dryrun.batch_specs(spec, mesh), spec)
            assert got.keys() == ref.keys(), arch
            for key, rows in got.items():
                assert rows == ref[key], (arch, key)
