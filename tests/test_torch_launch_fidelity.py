"""The port's mesh runs held to the reference's dry run on narrow cells
with real head counts: per device on 16×16, the bytes each device holds,
the matrix-product FLOPs class by class, and the collective link bytes.

Each cell keeps its full config's ``n_heads`` and ``n_kv_heads`` (16 and
8 for granite: the heads divide ``model`` = 16, the KV heads do not) at
the reduced widths (``reduced()``, ``head_dim`` 16), so that the
reference's partitioner shards what a full-width run shards.  Both dry
runs take the cell's shape with the same ``cfg_overrides``; the reference
runs in one subprocess, since its dry-run module sets ``XLA_FLAGS`` at
import, and its FLOPs and collectives come from its own analyzer
(``repro.launch.roofline.analyze_hlo_text``, every term, not the top 12).

Bands: attention and expert products equal, exactly; the dense products
and the total (the reference's one-hot label contraction taken out, the
port takes the label logit without a product) within 10%; bytes a device
and collective bytes within 2× either way.  Where a cell differs beyond a
band the difference is named here, a tensor and a reason, and taken out
before the band is applied:

* train with chunked attention (S > 2·Q_CHUNK): the reference's temp
  holds, beside the one float32 score tensor a chunk and layer that
  eager autograd keeps (the softmax's output), a second one for every
  chunk and layer, and the ``lax.map`` stacks of the layer being written
  (two a chunk): (L + 2) · chunks · rows · heads · q_chunk · S · 4 bytes
  (its buffer assignment: two f32[L, chunks, rows, heads, 1024, S] and two
  f32[chunks, rows, heads, 1024, S] buffers).

Heads that do not divide ``model`` (gemma3's 4 on 16) stay whole on
every device on both sides, and their products agree exactly here; the
reduced granite cell of ``test_torch_launch_dryrun.py`` names what still
differs there in the backward.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from test_torch_launch_dryrun import REPO, _overrides

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline

HEAD_DIM = 16
ATTENTION = ("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd", "bnqhd,bnkhd->bnhqk",
             "bnhqk,bnkhd->bnqhd", "bqgmd,bsgd->bgmqs", "bgmqs,bsgd->bqgmd",
             # the chunked attention's products inside lax.map carry no
             # op name (no other product does in these cells)
             "(unattributed)")
EXPERTS = ("gecd,edf->gecf", "gecf,efd->gecd")
ONE_HOT = "bsv,bsv->bs"


def narrow(arch: str) -> dict:
    """The reduced config's changes with the full config's head counts."""
    full = get_config(arch)
    ov = _overrides(arch)
    if full.n_heads:
        ov.update(n_heads=full.n_heads, n_kv_heads=full.n_kv_heads,
                  head_dim=HEAD_DIM)
    return ov


def reference(cells: dict, tmp) -> dict:
    """{key: the reference dry run's memory, FLOP classes and collective
    bytes} for cells {key: (arch, shape, overrides, multi_pod)}."""
    code = textwrap.dedent(f"""
        import json, math, sys
        sys.path.insert(0, "src")
        from repro.launch.dryrun import run_cell
        from repro.launch.roofline import analyze_hlo_text
        out = {{}}
        for key, (arch, shape, ov, mp) in {cells!r}.items():
            r = run_cell(arch, shape, multi_pod=mp, out_dir={str(tmp)!r},
                         cfg_overrides=ov)
            with open(r["hlo_path"]) as f:
                t = analyze_hlo_text(f.read(), math.prod(r["mesh"]))
            out[key] = {{"memory": r["memory"], "flops": t["flops"],
                         "flop_breakdown": t["flop_breakdown"],
                         "coll_bytes": t["coll_bytes"]}}
        print(json.dumps(out))
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def ref_classes(breakdown: dict) -> dict:
    out = {"attention": 0.0, "experts": 0.0, "one_hot": 0.0, "dense": 0.0}
    for name, flops in breakdown.items():
        if any(n in name for n in ATTENTION):
            out["attention"] += flops
        elif any(n in name for n in EXPERTS):
            out["experts"] += flops
        elif ONE_HOT in name:
            out["one_hot"] += flops
        else:
            out["dense"] += flops
    return out


def port_classes(rows: list, cfg) -> dict:
    """The port's product FLOPs by class, from each batched product's
    operand shapes: a dense product has batch 1 (einsum's ``bmm`` of a
    weight), attention's carry the head dim, the experts' lead with the
    expert dim; the rest (the depthwise convolutions) are dense."""
    out = {"attention": 0, "experts": 0, "dense": 0}
    for r in rows:
        if not r["flops"]:
            continue
        assert r["op"] == "aten.bmm", r
        dims = [[int(n) for n in s.split("x")] for s in r["shapes"].split(",")]
        if dims[0][0] == 1:
            key = "dense"
        elif any(cfg.head_dim in d[1:] for d in dims):
            key = "attention"
        elif cfg.n_experts and dims[0][0] == cfg.n_experts:
            key = "experts"
        else:
            key = "dense"
        out[key] += r["calls"] * r["flops"]
    return out


def port(arch, shape, ov, multi_pod, tmp) -> dict:
    res = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                          cfg_overrides=ov, out_dir=str(tmp))
    assert res["status"] == "ok"
    r = roofline.roofline_cell(res["ops_path"].replace(".ops.json",
                                                       ".json"))
    with open(res["ops_path"]) as f:
        rows = json.load(f)
    return {"memory": res["memory"], "flops": r["op_flops"],
            "coll_bytes": r["coll_bytes"], "rows": rows}


def within(got, want, band) -> bool:
    return want / band <= got <= want * band


def check(got: dict, ref: dict, cfg, *, named_bytes=0, classes=True):
    """The bands of the module docstring, the named term taken out
    (``classes`` False: the total FLOPs alone, where a product's batch dim
    does not tell its class)."""
    pc, rc = port_classes(got["rows"], cfg), ref_classes(
        ref["flop_breakdown"])
    assert sum(rc.values()) == ref["flops"]          # nothing cut off
    if classes:
        assert pc["attention"] == rc["attention"], (pc, rc)
        assert pc["experts"] == rc["experts"], (pc, rc)
        assert abs(pc["dense"] - rc["dense"]) <= 0.1 * rc["dense"], (pc,
                                                                     rc)
    total, want = sum(pc.values()), ref["flops"] - rc["one_hot"]
    assert abs(total - want) <= 0.1 * want, (total, want)
    assert within(got["memory"]["total_per_device"] + named_bytes,
                  ref["memory"]["total_per_device"], 2), (
        got["memory"], ref["memory"], named_bytes)
    assert within(got["coll_bytes"], ref["coll_bytes"], 2), (
        got["coll_bytes"], ref["coll_bytes"])


def attention_residuals(cfg, cell_rows: int, seq: int, heads: int) -> int:
    """The reference's chunked-attention residuals beyond the port's (the
    module docstring): (L + 2) · chunks · rows · heads · 1024 · S · 4."""
    chunks = seq // 1024
    return (cfg.n_layers + 2) * chunks * cell_rows * heads * 1024 * seq * 4


CELLS = {
    "granite_train": ("granite-moe-1b-a400m", "train_4k"),
    "gemma3_prefill": ("gemma3-1b", "prefill_32k"),
    "falcon_train": ("falcon-mamba-7b", "train_4k"),
    "rgemma_prefill": ("recurrentgemma-9b", "prefill_32k"),
    "granite_decode": ("granite-moe-1b-a400m", "decode_32k"),
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fidelity")
    cells = {k: (arch, shape, narrow(arch), False)
             for k, (arch, shape) in CELLS.items()}
    ref = reference(cells, tmp / "ref")
    return {k: (port(arch, shape, ov, mp, tmp / "port" / k), ref[k])
            for k, (arch, shape, ov, mp) in cells.items()}


def _cfg(key):
    arch = CELLS[key][0]
    return dataclasses.replace(get_config(arch), **narrow(arch))


def test_granite_train_lays_heads_out_as_the_reference(both):
    """16 heads on 16, 8 KV heads expanded: one head a device (DTensor's
    own rules, with no head constraints, ran all 16 on every device,
    14.6× the attention FLOPs)."""
    cfg = _cfg("granite_train")
    got, ref = both["granite_train"]
    rows = 256 // 16 // 2                       # accumulation 2
    check(got, ref, cfg, named_bytes=attention_residuals(cfg, rows, 4096, 1))


@pytest.mark.parametrize("key", ["gemma3_prefill", "falcon_train",
                                 "rgemma_prefill", "granite_decode"])
def test_local_recurrent_and_decode_cells_within_the_bands(both, key):
    check(*both[key], _cfg(key))
