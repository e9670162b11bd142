"""The port's decode and long-context mesh runs held to the reference's dry
run on 16×16, as ``test_torch_launch_fidelity.py`` holds its cells: per
device, the bytes each device holds, the matrix-product FLOPs and the
collective link bytes.  Every cell is float32 (the reference's CPU backend
then keeps no float32 twin of a buffer).

* ``granite_decode``: granite decode_32k, reduced but at its own attention
  widths (d_model 1024, 16 heads, 8 KV heads, head_dim 64).  The 8 KV
  heads do not divide ``model`` = 16, and the reference's partitioner
  splits the k and v projections' 8·64 columns over ``model``; run whole
  on every device of ``model`` (DTensor's rule) they cost
  (15/16)·2·lanes·d_model·2·KV·hd·layers more FLOPs (:func:`kv_columns`),
  5.5× the dense products here.
* ``gemma3_decode``: gemma3-1b decode_32k at its own d_model 1152 and
  head_dim 256: its 4 heads on 16 split q's columns too.
* ``rgemma_decode``: recurrentgemma-9b decode_32k at full width, 3 layers
  (RG-LRU, RG-LRU, local).
* long_500k (one lane: the batch leaves ``data`` idle) at full width, the
  depth cut: falcon-mamba-7b (2 layers), recurrentgemma-9b (3: RG-LRU,
  RG-LRU, local), gemma3-1b (2: its stack's tail of local layers) and
  gemma2-27b (2).

Bands: product FLOPs equal in total, exactly (at these widths a
product's shapes do not tell its class: granite's head_dim is its
d_model/16, one lane leaves no batch dim), bytes and collective bytes
within 2× either way (``check``).  Named, each taken out before its
band:

* bytes, every cell: the reference's temp copies of its KV cache — the
  buffers of its temp allocation shaped as a device's part of a layer's k
  or v cache, or of the stack of them (the same dims in any order: the
  updated cache written apart from the donated one, and the operands of
  its score and value products laid out anew).  The port writes its cache
  in place and reads it where it lies (:func:`cache_copies`).
* bytes and collectives, ``rgemma_decode``: the reference gathers each
  weight's FSDP dim for the one-token products (its all-gathers at them,
  :func:`weight_gathers`, and their results in its temp,
  :func:`weight_parts`), where DTensor gathers the lanes' activations
  instead (counted in the port's bytes); at full widths the weights
  outweigh the rest.  Added to the port's side, as the table
  (``tests/launch_fidelity_table.py``) adds them.
* none on the collectives of the one-lane cells: where a device's part
  is held by another device the port moves it point to point
  (``shard_utils.relocate``), as XLA moves it with collective-permutes
  (gemma3 long_500k: the tail layers' ring caches, laid out with their
  context on ``data`` by the cache rules, the reference's own, moving
  to ``model`` for attention, k and v of each; falcon-mamba long_500k:
  the in-projection's (x, z) halves, each device's part held by another
  device).  No all-gather of a moved part is left, and the port's
  permute bytes are within 2× of the reference's at the same sites
  (:func:`relocated`, :func:`permuted`).
"""

import dataclasses
import json
import math
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from test_torch_launch_dryrun import REPO
from test_torch_launch_fidelity import ATTENTION, check, narrow, port

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import cache_specs
from repro_torch.launch.roofline import link_bytes
from repro_torch.launch.specs import input_specs
from repro_torch.models import model as M
from repro_torch.train.sharding import (MeshShape, local_shape, map_axes,
                                        tree_specs)

F32 = {"dtype": "float32"}
MESH = MeshShape((16, 16), ("data", "model"))
CELLS = {
    "granite_decode": ("granite-moe-1b-a400m", "decode_32k", {
        **narrow("granite-moe-1b-a400m"), "d_model": 1024, "head_dim": 64}),
    "gemma3_decode": ("gemma3-1b", "decode_32k", {
        **narrow("gemma3-1b"), "d_model": 1152, "head_dim": 256}),
    "rgemma_decode": ("recurrentgemma-9b", "decode_32k", {**F32,
                                                          "n_layers": 3}),
    "falcon_long": ("falcon-mamba-7b", "long_500k", {**F32, "n_layers": 2}),
    "rgemma_long": ("recurrentgemma-9b", "long_500k", {**F32,
                                                       "n_layers": 3}),
    "gemma3_long": ("gemma3-1b", "long_500k", {**F32, "n_layers": 2}),
    "gemma2_long": ("gemma2-27b", "long_500k", {**F32, "n_layers": 2}),
}


def reference(cells: dict, tmp) -> dict:
    """{key: the reference dry run's memory, FLOPs, collective bytes by
    name, the buffers of its temp allocation (shape, bytes) and its
    collective-permutes (operand bytes, the devices that send to another)}."""
    code = textwrap.dedent(f"""
        import glob, json, math, os, re, shutil, sys
        sys.path.insert(0, "src")
        from repro.launch.dryrun import run_cell
        from repro.launch.roofline import analyze_hlo_text
        dump = os.path.join({str(tmp)!r}, "xla")
        os.environ["XLA_FLAGS"] += " --xla_dump_to=" + dump

        def temp_buffers():
            name = "jit_(prefill_fn|serve_fn)"
            text = "".join(open(f).read() for f in glob.glob(
                dump + "/*buffer-assignment.txt") if re.search(name, f))
            temp = re.search(r"^allocation \\d+: size \\d+, "
                             r"preallocated-temp:.*?(?=^allocation |\\Z)",
                             text, re.M | re.S)
            shutil.rmtree(dump, ignore_errors=True)
            pat = r"\\(size=(\\d+),offset=(\\d+)\\): (\\S+)"
            bufs = {{(int(o), int(s)): t for s, o, t in re.findall(
                pat, temp.group(0))}} if temp else {{}}
            return [[t, s] for (_, s), t in bufs.items()]

        def permutes(text):
            pat = (r"= (\\w+)\\[([\\d,]*)\\]\\S* collective-permute(?:-start)?"
                   r"\\(.*?source_target_pairs=\\{{(.*?)\\}}\\}}")
            size = {{"f32": 4, "bf16": 2, "s32": 4, "f16": 2}}
            return [[size[t] * math.prod(int(d) for d in dims.split(",") if d),
                     [int(a) for a, b in re.findall(r"(\\d+),(\\d+)", pairs)
                      if a != b]]
                    for t, dims, pairs in re.findall(pat, text)]

        out = {{}}
        for key, (arch, shape, ov) in {cells!r}.items():
            r = run_cell(arch, shape, multi_pod=False,
                         out_dir={str(tmp)!r}, cfg_overrides=ov)
            with open(r["hlo_path"]) as f:
                text = f.read()
            t = analyze_hlo_text(text, math.prod(r["mesh"]))
            out[key] = {{"memory": r["memory"], "flops": t["flops"],
                         "flop_breakdown": t["flop_breakdown"],
                         "coll_bytes": t["coll_bytes"],
                         "coll_breakdown": t["coll_breakdown"],
                         "temp_buffers": temp_buffers(),
                         "permutes": permutes(text)}}
        print(json.dumps(out))
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fidelity_decode")
    ref = reference(CELLS, tmp / "ref")
    return {k: (port(arch, shape, ov, False, tmp / "port" / k), ref[k])
            for k, (arch, shape, ov) in CELLS.items()}


def _cfg(key):
    arch, _, ov = CELLS[key]
    return dataclasses.replace(get_config(arch), **ov)


def _dims(shape) -> tuple:
    """A shape's dims other than 1, sorted."""
    return tuple(sorted(int(d) for d in shape if d and int(d) != 1))


def cache_parts(cfg, shape: str, mesh=MESH) -> set:
    """The dims (:func:`_dims`) of a device's part of each k and v cache
    leaf of the cell and of one layer of a stacked leaf."""
    cache = input_specs(cfg, SHAPES[shape])["cache"]
    specs = cache_specs(cfg, cache, mesh)
    parts = set()
    for tree, spec, stacked in (
            [(cache["stack"][j], specs["stack"][j], True)
             for j in cache["stack"]]
            + [(c, s, False) for c, s in zip(cache["tail"],
                                             specs["tail"])]):
        for name in ("k", "v"):
            if name in tree:
                local = local_shape(tuple(tree[name].shape), spec[name],
                                    mesh)
                parts.add(_dims(local))
                if stacked:
                    parts.add(_dims(local[1:]))
    return parts


def cache_copies(ref: dict, parts: set) -> int:
    """Bytes of the reference's temp buffers shaped as a cache part."""
    return sum(size for t, size in ref["temp_buffers"] if "[" in t
               and _dims(t.split("[", 1)[1].split("]", 1)[0].split(","))
               in parts)


def weight_parts(cfg, mesh=MESH) -> set:
    """The dims (:func:`_dims`) of a device's part of each weight with its
    FSDP dim (``embed``) whole, and of one layer of a stacked weight."""
    shapes = M.param_shapes(cfg)
    specs = tree_specs(M.param_specs(cfg), shapes, mesh, {"embed": None})
    parts = set()
    map_axes(lambda e, shape: parts.update(
        {_dims(local_shape(tuple(shape), e, mesh)),
         _dims(local_shape(tuple(shape), e, mesh)[1:])}), specs, shapes)
    return parts


def weight_gathers(ref: dict) -> float:
    """The reference's all-gathers at its products with a weight (every
    product but attention's): its FSDP gathers of the weights."""
    return sum(v for k, v in ref["coll_breakdown"].items()
               if k.startswith("all-gather|") and "/dot_general" in k
               and not any(a in k for a in ATTENTION))


def kv_columns(cfg, lanes: int) -> int:
    """FLOPs a device spends on the KV projections of a decode step when
    they run whole on every device of ``model``, beyond the reference's
    split of their columns: (15/16)·2·lanes·d_model·2·KV·hd·layers."""
    return (15 * 2 * lanes * cfg.d_model * 2 * cfg.n_kv_heads
            * cfg.head_dim * cfg.n_layers) // 16


def gathered_parts(got: dict, part: str) -> list:
    """The port's all-gathers of parts shaped ``part`` (its op record)."""
    return [r for r in got["rows"]
            if r["op"] == "_c10d_functional.all_gather_into_tensor"
            and r["shapes"] == part]


def relocated(got: dict) -> float:
    """Link bytes of the port's point-to-point moves (its op record)."""
    return sum(r["calls"] * r["trips"] * link_bytes(r) for r in got["rows"]
               if r["op"] == "_c10d_functional.collective_permute")


def permuted(ref: dict, at: str) -> float:
    """The reference's collective-permute bytes at op names containing
    ``at`` (its analyzer's count: each permute's operand, on every
    device)."""
    return sum(v for k, v in ref["coll_breakdown"].items()
               if k.startswith("collective-permute|") and at in k)


def busiest_share(ref: dict) -> float:
    """The share of the reference's permute operands that its busiest
    device sends to another (its analyzer counts every permute's operand
    on every device, where one takes part in some): over every
    collective-permute of the module, by their source-target pairs."""
    sent: dict = {}
    for size, sources in ref["permutes"]:
        for d in sources:
            sent[d] = sent.get(d, 0) + size
    return max(sent.values()) / sum(size for size, _ in ref["permutes"])


@pytest.mark.parametrize("key", ["granite_decode", "gemma3_decode",
                                 "rgemma_decode"])
def test_decode_within_the_bands(both, key):
    cfg, (got, ref) = _cfg(key), both[key]
    copies = cache_copies(ref, cache_parts(cfg, "decode_32k"))
    assert copies >= ref["memory"]["alias_size_in_bytes"]   # one at least
    weights = gathers = 0
    if key == "granite_decode":
        # the term the split saves is larger than the band it would break
        lanes = SHAPES["decode_32k"].global_batch // 16
        assert kv_columns(cfg, lanes) > 0.1 * got["flops"]
    if key == "rgemma_decode":
        # full widths: the reference's gathered weights outweigh the rest;
        # the tied table's gather, 15 of 16 parts of (V/16, D) float32
        table = 15 * cfg.padded_vocab // 16 * cfg.d_model // 16 * 4
        assert ref["coll_breakdown"]["all-gather|bsd,dv->bsv/dot_general"] \
            == table
        weights = cache_copies(ref, weight_parts(cfg))
        gathers = weight_gathers(ref)
        assert weights >= 16 * table // 15 and gathers >= table
    assert got["flops"] == ref["flops"], (got["flops"], ref["flops"])
    got = {**got, "coll_bytes": got["coll_bytes"] + gathers}
    check(got, ref, cfg, named_bytes=copies + weights, classes=False)


@pytest.mark.parametrize("key", ["falcon_long", "rgemma_long",
                                 "gemma3_long", "gemma2_long"])
def test_long_context_one_lane_within_the_bands(both, key):
    cfg, (got, ref) = _cfg(key), both[key]
    assert got["flops"] == ref["flops"], (got["flops"], ref["flops"])
    if key in ("gemma3_long", "falcon_long"):
        if key == "gemma3_long":
            # k and v of each tail layer's ring cache: (1, window/16, 1, hd)
            part = (1, cfg.window // 16, 1, cfg.head_dim)
            moves = 2 * len(cfg.tail_kinds)
            theirs = permuted(ref, "")
        else:
            # each layer's (x, z) product, 2·d_inner/16 a device
            part = (1, 1, 2 * cfg.d_inner // 16)
            moves = cfg.n_layers
            theirs = permuted(ref, "split")
        assert not gathered_parts(got, "x".join(map(str, part)))
        # the busiest device sends one part a move, once; the reference's
        # busiest sends 1 (gemma3: each transpose) or 1.5 (falcon: 4
        # permutes, one of a whole part) a move, its analyzer counts 2
        # and 2.5 (gemma3: the caches moved back after the write too)
        ours = relocated(got)
        assert ours == moves * 4 * math.prod(part), ours
        busiest = theirs * busiest_share(ref)
        assert 0 < ours <= theirs and 0.5 <= ours / busiest <= 2, (
            ours, busiest, theirs)
    copies = cache_copies(ref, cache_parts(cfg, "long_500k"))
    check(got, ref, cfg, named_bytes=copies, classes=False)
