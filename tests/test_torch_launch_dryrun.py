"""The port's dry run against the reference's: a reduced train cell on the
16×16 production mesh, the bytes each device holds and the FLOPs it runs.

``repro_torch.launch.dryrun.run_cell`` lays the state and batch out as
``DTensor``\\ s over a fake process group and executes the port's train
step on ``meta`` tensors.  Both dry runs take ``train_4k`` with every
config field the reduced config changes passed as ``cfg_overrides``; the
reference runs in a subprocess, since its dry-run module sets
``XLA_FLAGS`` at import.

* ``argument_size_in_bytes`` (the local shards of parameters, AdamW
  moments, step and batch) equals the reference's, exactly: 554,100 bytes
  for granite-moe-1b-a400m (deepseek-7b in
  ``test_torch_launch_dryrun_dense.py``).
* The per-device matrix-product FLOPs of granite's mesh run against the
  reference analyzer's ``hlo_flops`` (4.229e11), class by class.  The
  attention products (``bqhd,bkhd->bhqk``, ``bhqk,bkhd->bqhd`` and their
  backward) and the expert products (``gecd,edf->gecf``,
  ``gecf,efd->gecd``) are equal, exactly: 97.6% and 0.7% of the count.
  The rest differs, each difference named:

  - the one-hot label contraction (``bsv,bsv->bs``,
    ``repro/models/model.py:368-369``) is the reference's alone: the port
    takes the label logit without a product (a gather; under a mesh that
    shards the vocab, a masked sum);
  - the dense products (the q/k/v/o projections, the router and the tied
    lm head, forward and backward): the port's 1.07e10 against the
    reference's 7.59e9.  Granite's reduced 4 heads do not divide
    ``model`` = 16, so both keep them whole on every device and run the
    projections and their weight gradients at full width; the reference's
    partitioner splits their input-gradient products over the otherwise
    idle ``model`` axis (a sixteenth each, then an all-reduce: its
    q/k/v backward counts 2.28e9 against a forward of 2.15e9), where the
    port runs them whole.  (Before the model laid its weights and
    activations out by logical axis, DTensor cut the forward products
    over ``model`` and ran the weight gradients whole: 4.63e9.)  With
    heads that divide the mesh axis the dense products agree within 2%
    (``test_torch_launch_fidelity.py``).

  The totals, the one-hot term taken out, agree within 1%.

The bytes a device and the collective bytes of mesh runs are held to the
reference in ``test_torch_launch_fidelity.py``, on narrow cells with real
head counts.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = {"granite-moe-1b-a400m": 554_100}


def _overrides(arch: str) -> dict:
    full, red = get_config(arch), get_config(arch).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
            if f.name != "name" and getattr(red, f.name) != getattr(
                full, f.name)}


def _reference(arch: str, tmp) -> dict:
    """The reference dry run's memory and its analyzer's FLOPs."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, "src")
        from repro.launch.dryrun import run_cell
        from repro.launch.roofline import roofline_cell
        r = run_cell({arch!r}, "train_4k", multi_pod=False,
                     out_dir={str(tmp)!r}, cfg_overrides={_overrides(arch)!r})
        a = roofline_cell({str(tmp)!r} + "/" + r["cell"] + ".json")
        print(json.dumps({{"memory": r["memory"], "hlo_flops": a["hlo_flops"],
                          "flop_breakdown": a["flop_breakdown"]}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def run_both(arch, tmp_path) -> tuple[dict, dict]:
    """(the port's cell and its op record, the reference's numbers)."""
    res = dryrun.run_cell(arch, "train_4k", multi_pod=False,
                          cfg_overrides=_overrides(arch),
                          out_dir=str(tmp_path / "port"))
    assert res["status"] == "ok" and res["mesh"] == [16, 16]
    with open(res["ops_path"]) as f:
        res["rows"] = json.load(f)
    return res, _reference(arch, tmp_path / "ref")


def check_argument_bytes(arch, tmp_path, both=None):
    res, ref = both or run_both(arch, tmp_path)
    got = res["memory"]["argument_size_in_bytes"]
    assert got == ref["memory"]["argument_size_in_bytes"]
    if arch in EXPECTED:
        assert got == EXPECTED[arch]
    assert res["memory"]["total_per_device"] == got + res["memory"][
        "temp_size_in_bytes"]
    assert res["memory"]["temp_size_in_bytes"] > 0
    # the artifacts read back into the roofline
    r = roofline.roofline_cell(res["ops_path"].replace(".ops.json",
                                                       ".json"))
    assert r["dominant"] in ("compute", "memory", "collective", "latency")
    assert r["op_flops"] > 0 and r["coll_bytes"] > 0
    assert r["step_time_bound_s"] == max(
        r[k] for k in ("compute_s", "memory_s", "collective_s", "latency_s"))


@pytest.fixture(scope="module")
def granite(tmp_path_factory):
    return run_both("granite-moe-1b-a400m", tmp_path_factory.mktemp("g"))


def test_argument_bytes_equal_the_reference_dry_run(granite, tmp_path):
    check_argument_bytes("granite-moe-1b-a400m", tmp_path, granite)


ATTENTION = ("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")
EXPERTS = ("gecd,edf->gecf", "gecf,efd->gecd")
ONE_HOT = "bsv,bsv->bs"
PORT_DENSE = 10_670_309_376    # the dense products' named difference


def _port_classes(rows, cfg) -> dict:
    """The port's product FLOPs by class, from each batched product's
    operand shapes: attention's have the sequence as a dim, the experts'
    lead with the expert dim, the rest are dense."""
    out = {"attention": 0, "experts": 0, "dense": 0}
    for r in rows:
        if not r["flops"]:
            continue
        assert r["op"] == "aten.bmm", r
        dims = [[int(n) for n in s.split("x")] for s in r["shapes"].split(",")]
        if any(4096 in d for d in dims):
            key = "attention"
        elif dims[0][0] == cfg.n_experts:
            key = "experts"
        else:
            key = "dense"
        out[key] += r["calls"] * r["flops"]
    return out


def test_mesh_flops_equal_the_reference_dry_run_but_named_terms(granite):
    res, ref = granite
    cfg = get_config("granite-moe-1b-a400m").reduced()
    bd = ref["flop_breakdown"]
    assert sum(bd.values()) == ref["hlo_flops"]      # nothing cut off

    def ref_sum(names):
        return sum(v for k, v in bd.items() if any(n in k for n in names))

    port = _port_classes(res["rows"], cfg)
    assert port["attention"] == ref_sum(ATTENTION)
    assert port["experts"] == ref_sum(EXPERTS)
    onehot = ref_sum((ONE_HOT,))
    assert onehot == 2 * 256 * 4096 // 16 * cfg.padded_vocab // 16 * 2
    ref_dense = ref["hlo_flops"] - ref_sum(ATTENTION) - ref_sum(EXPERTS) \
        - onehot
    assert (port["dense"], ref_dense) == (PORT_DENSE, 7_587_495_936)
    total = sum(port.values())
    assert abs(total - (ref["hlo_flops"] - onehot)) <= 0.01 * (
        ref["hlo_flops"] - onehot), (total, ref["hlo_flops"], onehot)
