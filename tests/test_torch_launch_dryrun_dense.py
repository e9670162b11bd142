"""The port's dry run against the reference's on deepseek-7b: the check
of ``test_torch_launch_dryrun.py`` (argument bytes equal, exact), in a
file of its own so that each file stays well inside its time.  Also
decode's KV-cache write, whose DTensor rule raises (an in-place op whose
placements would change): the dry run makes it on each device's part of
the cache, and no collective moves the cache."""

import pytest

pytest.importorskip("torch")

from test_torch_launch_dryrun import check_argument_bytes

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh


def test_argument_bytes_equal_the_reference_dry_run(tmp_path):
    check_argument_bytes("deepseek-7b", tmp_path)


def test_decode_cache_write_is_made_on_each_devices_part():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    with make_production_mesh() as mesh:
        mem, rows = dryrun.execute_cell(cfg, SHAPES["decode_32k"], mesh)
    # one layer's k (or v) on one device: lanes over data, context over
    # model (2 KV heads do not divide 16)
    layer = 128 // 16 * 32768 // 16 * cfg.n_kv_heads * cfg.head_dim * 4
    assert mem["alias_size_in_bytes"] == 2 * cfg.n_layers * layer
    writes = [r for r in rows if r["op"] == "aten.index_put_"]
    assert sum(r["calls"] for r in writes) == 2 * cfg.n_layers
    assert all(r["out_bytes"] == layer for r in writes)
    moved = [r["in_bytes"] for r in rows if r["op"] in (
        "_c10d_functional.all_gather_into_tensor",
        "_c10d_functional.all_reduce",
        "_c10d_functional.reduce_scatter_tensor",
        "_c10d_functional.all_to_all_single")]
    assert moved and max(moved) < layer
