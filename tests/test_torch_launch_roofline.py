"""The port's Hopper roofline analyzer on hand-written op records — the
counterpart of ``tests/test_roofline_parser.py``'s HLO snippets: each
collective's ring convention and link, the gather and scatter byte rules,
free views, the latency term (a launch a non-free op, one more a
collective), and the recorder's trip multiplication (a sequential scan
folded to one recorded step, ``L`` trips).  Tolerance: exact.
"""

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_local_mesh

MESH = {"data": 16, "model": 16}


def row(op, calls=1, in_bytes=0, out_bytes=0, max_in=None, flops=0,
        axes=None, n=None):
    r = {"op": op, "calls": calls, "trips": 1, "in_bytes": in_bytes,
         "out_bytes": out_bytes,
         "max_in_bytes": in_bytes if max_in is None else max_in,
         "flops": flops, "shapes": ""}
    if axes is not None:
        r["axes"], r["group_size"] = list(axes), n
    return r


@pytest.mark.parametrize("op, in_b, out_b, link", [
    ("all_reduce", 1600, 1600, 2 * 1600 * 15 / 16),
    ("all_gather_into_tensor", 100, 1600, 1500),
    ("reduce_scatter_tensor", 1600, 100, 1500),
    ("all_to_all_single", 1600, 1600, 1600 * 15 / 16),
    ("broadcast", 1600, 1600, 1600),
])
def test_collective_ring_conventions(op, in_b, out_b, link):
    r = row("_c10d_functional." + op, calls=3, in_bytes=in_b,
            out_bytes=out_b, axes=("model",), n=16)
    tot = roofline.analyze_ops([r], MESH)
    assert tot["coll_bytes"] == 3 * link
    # a 16-wide group spans two hosts of 8: the network's rate
    assert tot["coll_seconds"] == 3 * link / roofline.NETWORK_BW
    assert tot["bytes"] == 3 * (in_b + out_b)
    assert tot["launches"] == 3 and tot["seq_steps"] == 6
    # inside one host: NVLink
    small = roofline.analyze_ops([r], {"data": 2, "model": 4})
    assert small["coll_seconds"] == 3 * link / roofline.NVLINK_BW


def test_views_are_free_and_products_count_flops():
    rows = [row("aten.view", calls=10, in_bytes=4096, out_bytes=4096),
            row("_c10d_functional.wait_tensor", calls=2, in_bytes=64,
                out_bytes=64),
            row("aten.mm", calls=2, in_bytes=300, out_bytes=100, flops=7e6),
            row("aten.add", calls=5, in_bytes=200, out_bytes=100, flops=0),
            row("aten.dot", calls=1, in_bytes=8, out_bytes=4, flops=8)]
    tot = roofline.analyze_ops(rows, MESH)
    assert tot["flops"] == 2 * 7e6            # dot is not a product here
    assert tot["bytes"] == 2 * 400 + 5 * 300 + 12
    assert tot["launches"] == tot["seq_steps"] == 2 + 5 + 1
    assert tot["coll_bytes"] == 0


def test_gather_reads_what_it_picks_and_scatter_writes_what_it_puts():
    g = row("aten.gather", in_bytes=1000 + 40, out_bytes=40, max_in=1000)
    s = row("aten.index_put_", in_bytes=1000 + 8 + 40, out_bytes=1000,
            max_in=1000)
    assert roofline.analyze_ops([g], MESH)["bytes"] == 40 + 2 * 40
    assert roofline.analyze_ops([s], MESH)["bytes"] == 2 * 48


def test_latency_term_and_dominant_term():
    cell = {"cell": "c", "arch": "a", "shape": "train_4k", "mesh": [16, 16],
            "mesh_axes": ["data", "model"], "params": 100,
            "active_params": 10, "memory": {"total_per_device": 2**30,
                                            "alias_size_in_bytes": 0}}
    rows = [row("aten.add", calls=1000, in_bytes=2, out_bytes=1),
            row("_c10d_functional.all_reduce", calls=10, in_bytes=16,
                out_bytes=16, axes=("data",), n=16)]
    r = roofline.roofline(cell, rows)
    assert r["latency_s"] == (1000 + 2 * 10) * roofline.LAUNCH_S
    assert r["dominant"] == "latency"
    assert r["step_time_bound_s"] == r["latency_s"]
    # 6·N_active·tokens over the chips, tokens from SHAPES
    assert r["model_flops"] == 6.0 * 10 * 256 * 4096 / 256
    assert r["memory_gib"] == 1.0


def test_recorder_multiplies_trips_and_skips_host_tensors():
    rec = dryrun.OpRecorder({})
    x = torch.empty(8, 4, device="meta")
    with rec:
        with rec.multiplied(3):
            torch.exp(x)
            with rec.multiplied(2):
                torch.neg(x)
        torch.arange(4)             # a host tensor: no device runs it
    rows = {r["op"]: r for r in rec.record()}
    assert rows["aten.exp"]["calls"] == 3 and rows["aten.exp"]["trips"] == 3
    assert rows["aten.neg"]["calls"] == 6
    assert "aten.arange" not in rows
    assert rows["aten.exp"]["in_bytes"] == rows["aten.exp"]["out_bytes"] \
        == 8 * 4 * 4


def test_a_sequential_scan_is_recorded_as_its_steps():
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    L = 12
    with make_local_mesh(1, 1) as mesh:
        def t(*shape):
            return dryrun._dtensor(mesh, shape, torch.float32, ())
        rec = dryrun.OpRecorder({})
        with dryrun.sharded_execution(mesh, rec):
            y, h = scan_ops.selective_scan(t(2, L, 8), t(2, L, 8), t(8, 4),
                                           t(2, L, 4), t(2, L, 4), t(8),
                                           mode="torch")
        assert tuple(y.shape) == (2, L, 8) and tuple(h.shape) == (2, 8, 4)
        # the plain loop: one exp a step
        exp = [r for r in rec.record() if r["op"] == "aten.exp"]
        assert sum(r["calls"] for r in exp) == L
        assert all(r["trips"] == L for r in exp)
    assert scan_ops.selective_scan_ref.__name__ == "selective_scan_ref"
