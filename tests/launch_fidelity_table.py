"""The port's dry run beside the reference's, every applicable config ×
shape at full width on one mesh: per device, the bytes each device holds,
the matrix-product FLOPs and the collective link bytes, with their ratios.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/launch_fidelity_table.py --out local/fidelity.jsonl

``--layers n`` cuts every config's depth on both sides (chip_smoke's
``CUT_REFERENCE`` holds the reference's numbers of its cut cells so).

A tool beside the tests, not one of them (its cells take minutes): it
runs the port's ``repro_torch.launch.dryrun`` in this process and the
reference's ``repro.launch.dryrun`` in a subprocess an arch (the
reference's dry run sets ``XLA_FLAGS`` at import), with the helpers of
``test_torch_launch_fidelity.py``.  Counts on a CPU, never a time.

Each row gives the point-to-point moves' link bytes on both sides
(``permute``: the port's collective-permutes, the reference analyzer's).
Beside the reference's collective bytes it gives ``coll_bf16``: the same
program with each float32 tensor counted at 2 bytes in a bf16 config (of
its counts only the collective bytes are taken so).  The reference's CPU
backend runs bf16 products in float32 and reduces their partial sums in
float32 (its analyzer counts those bytes as they are); the port reduces
them in the model's dtype.  Each row also lists the largest buffers of
the reference's temp allocation (XLA's buffer assignment, dumped to a
temporary directory): shape and bytes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_launch_fidelity import REPO, port, port_classes  # noqa: E402
from test_torch_launch_fidelity_decode import relocated  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, applicable  # noqa: E402

ONE_HOT = "bsv,bsv->bs"


def reference(arch: str, shapes: list, multi_pod: bool, tmp: str,
              overrides: dict | None = None) -> dict:
    """{shape: the reference dry run's memory, FLOPs (one-hot apart) and
    collective bytes, as they are and with float32 collectives of a bf16
    config counted at bf16}, one subprocess for the arch (its config with
    ``overrides``)."""
    code = textwrap.dedent(f"""
        import glob, json, math, os, re, shutil, sys
        sys.path.insert(0, "src")
        from repro.configs import get_config
        from repro.launch import roofline
        from repro.launch.dryrun import run_cell
        dump = os.path.join({tmp!r}, "xla")
        os.environ["XLA_FLAGS"] += " --xla_dump_to=" + dump
        bf16 = get_config({arch!r}).dtype == "bfloat16"

        def temp_buffers():
            # the largest buffers of the step's temp allocation, by shape
            files = [f for f in glob.glob(dump + "/*buffer-assignment.txt")
                     if re.search("jit_(train_step|prefill_fn|serve_fn)", f)]
            text = open(files[0]).read() if files else ""
            allocs = re.findall(r"^allocation (\\d+): size (\\d+)(.*)$",
                                text, re.M)
            temp = [a for a in allocs if "preallocated-temp" in a[2]]
            bufs = {{}}
            if temp:
                m = re.search(r"^allocation %s:.*?(?=^allocation |\\Z)"
                              % temp[0][0], text, re.M | re.S)
                pat = r"\\(size=(\\d+),offset=(\\d+)\\): (\\S+)"
                for size, off, shape in re.findall(pat, m.group(0)):
                    bufs[int(off), int(size)] = shape
            shutil.rmtree(dump, ignore_errors=True)
            return sorted(([s, sz] for (_, sz), s in bufs.items()
                           if sz >= 2**20), key=lambda b: -b[1])

        out = {{}}
        for shape in {shapes!r}:
            r = run_cell({arch!r}, shape, multi_pod={multi_pod!r},
                         out_dir={tmp!r}, cfg_overrides={overrides!r})
            with open(r["hlo_path"]) as f:
                text = f.read()
            os.remove(r["hlo_path"])
            n = math.prod(r["mesh"])
            t = roofline.analyze_hlo_text(text, n)
            coll_bf16 = t["coll_bytes"]
            if bf16:       # every float32 tensor at 2 bytes: collectives
                roofline.DTYPE_BYTES["f32"] = 2
                coll_bf16 = roofline.analyze_hlo_text(text, n)["coll_bytes"]
                roofline.DTYPE_BYTES["f32"] = 4
            one_hot = sum(v for k, v in t["flop_breakdown"].items()
                          if {ONE_HOT!r} in k)
            coll_top = sorted(t["coll_breakdown"].items(),
                              key=lambda kv: -kv[1])
            out[shape] = {{"memory": r["memory"], "flops": t["flops"],
                           "one_hot": one_hot,
                           "coll_bytes": t["coll_bytes"],
                           "coll_bf16": coll_bf16, "coll_top": coll_top,
                           "temp_buffers": temp_buffers()}}
        print(json.dumps(out))
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=7200)
    if run.returncode:
        raise RuntimeError(run.stderr[-4000:])
    return json.loads(run.stdout.strip().splitlines()[-1])


def _dims(shape: str) -> str:
    return shape.split("[", 1)[1].split("]", 1)[0]


def part_dims(cfg, shape: str, multi_pod: bool) -> tuple:
    """(cache dims, weight dims) of the cell, as the decode fidelity test
    shapes them: each KV cache leaf's part and one layer of it (a decode
    cell's; a train or prefill cell has no cache, so none); each
    weight's local part, with and without its FSDP dim gathered, and one
    layer of each."""
    from repro_torch.launch.dryrun import state_specs
    from repro_torch.models.model import param_shapes
    from repro_torch.train.sharding import MeshShape, local_shape, map_axes
    from test_torch_launch_fidelity_decode import (_dims, cache_parts,
                                                   weight_parts)
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else MeshShape((16, 16), ("data", "model"))
    local: set = set()
    map_axes(lambda e, s: local.update(
        {_dims(local_shape(tuple(s), e, mesh)),
         _dims(local_shape(tuple(s), e, mesh)[1:])}),
        state_specs(cfg, mesh).params, param_shapes(cfg))
    cache = cache_parts(cfg, shape, mesh) if SHAPES[shape].kind == \
        "decode" else set()
    return cache, local | weight_parts(cfg, mesh)


def named(kind: str, ref: dict, port_bytes: int, port_coll: float,
          periods: int, cache_dims: set = frozenset(),
          weight_dims: set = frozenset()) -> dict:
    """The named differences of a cell's bytes a device, and the ratio with
    them taken out: ``f32_copies``, the float32 twins the reference's CPU
    backend makes of bf16 buffers stacked over the periods (same dims,
    among its largest temp buffers: the remat stack of period inputs in
    train); ``held_output``, a prefill's returned cache, which the port's
    peak holds and the reference counts apart (``output_size_in_bytes``);
    decode's ``cache_copies``, the reference's temp buffers shaped as a
    device's part of a KV cache leaf or of one layer of it (``cache_dims``,
    :func:`test_torch_launch_fidelity_decode.cache_parts`: its updated
    cache written apart, the operands of its attention products laid out
    anew, and on the CPU their float32 twins; the port writes and reads
    the cache in place), and ``weights_held``, those shaped as a weight's
    local part or its part with the FSDP dim gathered (``weight_dims``:
    the gathered weights of its one-token products, and float32 copies).
    Collective bytes: ``weights_gathered``, decode's all-gathers at the
    reference's products with a weight (its partitioner gathers the FSDP
    weights for the one-token step, DTensor's rules move the tokens'
    activations instead, :func:`test_torch_launch_fidelity_decode.
    weight_gathers`)."""
    from test_torch_launch_fidelity_decode import weight_gathers
    bufs = [(b, n) for b, n in ref["temp_buffers"]
            if _dims(b).split(",")[0] == str(periods)]
    bf16 = {_dims(b) for b, _ in bufs if b.startswith("bf16[")}

    def held(dims):
        return sum(n for b, n in ref["temp_buffers"]
                   if tuple(sorted(int(d) for d in _dims(b).split(",")
                                   if d and int(d) != 1)) in dims)

    decode = kind == "decode"
    out = {"f32_copies": 0 if decode else sum(
               n for b, n in bufs if b.startswith("f32[")
               and _dims(b) in bf16),
           "held_output": ref["output"] if kind == "prefill" else 0,
           "cache_copies": held(cache_dims) if decode else 0,
           "weights_held": held(weight_dims - cache_dims) if decode else 0}
    out["bytes_ratio"] = (port_bytes - out["held_output"]) / (
        ref["bytes"] - out["f32_copies"] - out["cache_copies"]
        - out["weights_held"])
    out["weights_gathered"] = weight_gathers(
        {"coll_breakdown": dict(ref["coll_top"])}) if decode else 0
    if ref["coll_bytes"]:
        out["coll_ratio"] = (port_coll + out["weights_gathered"]) / ref[
            "coll_bytes"]
    return out


def rows(archs, shapes, multi_pod: bool, overrides: dict | None = None):
    """One row a cell: the port's and the reference's numbers and ratios
    (bytes, FLOPs against the reference's less its one-hot term,
    collective bytes), each config with ``overrides``."""
    for arch in archs:
        cfg = dataclasses.replace(ARCHS[arch], **(overrides or {}))
        todo = [s for s in shapes if applicable(cfg, SHAPES[s])[0]]
        if not todo:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            ref = reference(arch, todo, multi_pod, tmp, overrides)
            for shape in todo:
                got = port(arch, shape, overrides, multi_pod,
                           os.path.join(tmp, "port"))
                r = ref[shape]
                p_bytes = got["memory"]["total_per_device"]
                r_bytes = r["memory"]["total_per_device"]
                r_flops = r["flops"] - r["one_hot"]
                refd = {"bytes": r_bytes, "flops": r_flops,
                        "one_hot": r["one_hot"],
                        "coll_bytes": r["coll_bytes"],
                        "coll_bf16": r["coll_bf16"],
                        "temp": r["memory"]["temp_size_in_bytes"],
                        "output": r["memory"]["output_size_in_bytes"],
                        "alias": r["memory"]["alias_size_in_bytes"],
                        "arguments": r["memory"]["argument_size_in_bytes"],
                        "temp_buffers": r["temp_buffers"],
                        "coll_top": r["coll_top"],
                        "permute": sum(v for k, v in r["coll_top"]
                                       if k.startswith("collective-permute|"))}
                yield {
                    "arch": arch, "shape": shape,
                    "port": {"bytes": p_bytes, "flops": got["flops"],
                             "coll_bytes": got["coll_bytes"],
                             "permute": relocated(got),
                             "classes": port_classes(got["rows"], cfg)},
                    "ref": refd,
                    "named": named(SHAPES[shape].kind, refd, p_bytes,
                                   got["coll_bytes"], cfg.n_periods,
                                   *part_dims(cfg, shape, multi_pod)),
                    "ratio": {
                        "bytes": p_bytes / r_bytes,
                        "flops": got["flops"] / r_flops if r_flops else None,
                        "coll": got["coll_bytes"] / r["coll_bytes"]
                        if r["coll_bytes"] else None,
                        "coll_bf16": got["coll_bytes"] / r["coll_bf16"]
                        if r["coll_bf16"] else None}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, help="cut each config's depth "
                    "to this many layers (both sides)")
    ap.add_argument("--out", required=True, help="JSON lines, one a cell")
    ap.add_argument("--rows", help="re-derive the named terms of the rows "
                    "of this JSON-lines file (no dry run), written to --out")
    args = ap.parse_args(argv)
    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    overrides = {"n_layers": args.layers} if args.layers else {}
    if args.rows:
        with open(args.rows) as f:
            done = [json.loads(line) for line in f]
        for row in done:
            cfg = dataclasses.replace(ARCHS[row["arch"]], **overrides)
            row["named"] = named(
                SHAPES[row["shape"]].kind, row["ref"], row["port"]["bytes"],
                row["port"]["coll_bytes"], cfg.n_periods,
                *part_dims(cfg, row["shape"], args.multi_pod))
        todo = iter(done)
    else:
        todo = rows(archs, shapes, args.multi_pod, overrides)
    with open(args.out, "a") as f:
        for row in todo:
            f.write(json.dumps(row) + "\n")
            f.flush()
            r = row["ratio"]
            print(f"{row['arch']:22s} {row['shape']:12s} "
                  f"GB {row['port']['bytes'] / 1e9:9.3f}/"
                  f"{row['ref']['bytes'] / 1e9:9.3f} ({r['bytes']:.2f})  "
                  f"FLOPs {row['port']['flops']:.4g}/{row['ref']['flops']:.4g}"
                  f" ({r['flops'] or 0:.3f})  coll "
                  f"{row['port']['coll_bytes']:.4g}/"
                  f"{row['ref']['coll_bytes']:.4g} ({r['coll'] or 0:.2f}; "
                  f"bf16 {r['coll_bf16'] or 0:.2f}; permute "
                  f"{row['port']['permute']:.4g}/{row['ref']['permute']:.4g})"
                  f"  named: bytes "
                  f"{row['named']['bytes_ratio']:.2f} coll "
                  f"{row['named'].get('coll_ratio') or 0:.2f}", flush=True)


if __name__ == "__main__":
    main()
