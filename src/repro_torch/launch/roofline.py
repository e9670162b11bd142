"""Hopper roofline of a dry-run cell, from its op record.

The reference parses compiled HLO; the port has none.  Its dry run
(:mod:`repro_torch.launch.dryrun`) executes the step and records every
aten op on each device's local tensors (``<cell>.ops.json``).  This module
turns that record into the roofline terms of one H100 of the mesh:

    compute    = matrix-product FLOPs / PEAK_FLOPS
    memory     = HBM bytes            / HBM_BW
    collective = Σ link bytes / the slowest link the group crosses
    latency    = dependent steps × LAUNCH_S

Conventions (per device, the reference's):
  FLOPs           matrix products and convolutions only (mm, bmm, addmm,
                  baddbmm, convolution, SDPA), by torch.utils.flop_counter's
                  formulas — the class the reference counts (dot,
                  convolution)
  HBM bytes       each op's inputs plus outputs: the port runs eagerly, so
                  nothing is fused away; views, metadata and allocation are
                  free (FREE_OPS); a gather reads what it picks (indices +
                  2·output), an in-place scatter writes what it puts
                  (2·(inputs − its target))
  link bytes      all-reduce 2·|in|·(n-1)/n, all-gather |out| - |in|,
                  reduce-scatter |in| - |out|, all-to-all |in|·(n-1)/n,
                  collective-permute |in| (the parts a device sends),
                  anything else |in|
  dependent steps every launch (each non-free op, × its trips), plus one
                  more per collective

Constants are one H100 SXM's at 700 W (NVIDIA's data sheet): bf16 dense
peak, HBM3 bandwidth, NVLink (18 links of 25 GB/s each way) inside a host
of 8 GPUs, and one 400 Gb/s network port a GPU between hosts (DGX H100);
a collective's term uses the slowest link its group crosses
(:func:`repro_torch.launch.mesh.links_crossed`).  The launch floor is the
card's measured one (``PERF.md``, the device time of a one-element add).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from ..configs import SHAPES
from .dryrun import FREE_OPS, OUT_DIR
from .mesh import links_crossed

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s each way, inside a host of 8
NETWORK_BW = 50e9            # bytes/s a GPU between hosts (400 Gb/s)
LAUNCH_S = 1.15e-6           # measured launch floor a kernel
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}

FLOP_OPS = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.convolution",
    "aten.convolution_backward", "aten._scaled_dot_product_efficient_attention",
    "aten._scaled_dot_product_flash_attention",
    "aten._scaled_dot_product_cudnn_attention",
    "aten._scaled_dot_product_efficient_attention_backward",
    "aten._scaled_dot_product_flash_attention_backward",
    "aten._scaled_dot_product_cudnn_attention_backward"})
GATHER_OPS = frozenset({"aten.gather", "aten.index", "aten.index_select",
                        "aten.embedding", "aten.take_along_dim"})
SCATTER_INPLACE_OPS = frozenset({
    "aten.index_put_", "aten._index_put_impl_", "aten.scatter_",
    "aten.scatter_add_", "aten.index_copy_", "aten.index_add_",
    "aten.masked_scatter_"})
COLLECTIVE_PREFIX = "_c10d_functional."


def link_bytes(row: dict) -> float:
    """Link bytes of one call of a collective row (ring conventions)."""
    kind = row["op"][len(COLLECTIVE_PREFIX):]
    n = row.get("group_size") or 1
    i, o = row["in_bytes"], row["out_bytes"]
    if kind.startswith("all_reduce"):
        return 2 * i * (n - 1) / n
    if kind.startswith("all_gather"):
        return max(o - i, 0)
    if kind.startswith("reduce_scatter"):
        return max(i - o, 0)
    if kind.startswith("all_to_all"):
        return i * (n - 1) / n
    return i        # collective_permute: the parts a device sends


def hbm_bytes(row: dict) -> float:
    """HBM bytes of one call of a non-collective, non-free row."""
    op, i, o, big = (row["op"], row["in_bytes"], row["out_bytes"],
                     row["max_in_bytes"])
    if op in GATHER_OPS:
        return max(i - big, 0) + 2 * o
    if op in SCATTER_INPLACE_OPS:
        return 2 * max(i - big, 0)
    return i + o


def analyze_ops(rows: list, mesh_shape: dict) -> dict:
    """Totals of an op record: matrix-product FLOPs, HBM bytes, link bytes
    and link seconds, dependent steps and launches, with breakdowns."""
    flops = mem = coll = coll_s = 0.0
    steps = launches = 0
    flop_bd: dict = {}
    mem_bd: dict = {}
    coll_bd: dict = {}

    def acc(bd, key, v):
        if v:
            bd[key] = bd.get(key, 0.0) + v

    for r in rows:
        op, calls = r["op"], r["calls"]
        if op in FREE_OPS:
            continue
        launches += calls
        steps += calls
        if op.startswith(COLLECTIVE_PREFIX):
            link = calls * link_bytes(r)
            axes = tuple(r.get("axes") or ())
            coll += link
            coll_s += link / LINK_BW[links_crossed(mesh_shape, axes)]
            steps += calls
            kind = op[len(COLLECTIVE_PREFIX):]
            acc(coll_bd, f"{kind}|{','.join(axes)}", link)
            b = calls * (r["in_bytes"] + r["out_bytes"])
            mem += b
            acc(mem_bd, op, b)
            continue
        if op in FLOP_OPS:
            f = calls * r["flops"]
            flops += f
            acc(flop_bd, f"{op}({r.get('shapes', '')})", f)
        b = calls * hbm_bytes(r)
        mem += b
        acc(mem_bd, op, b)

    def top(bd):
        return dict(sorted(bd.items(), key=lambda kv: -kv[1])[:12])

    return {"flops": flops, "bytes": mem, "coll_bytes": coll,
            "coll_seconds": coll_s, "seq_steps": steps,
            "launches": launches, "flop_breakdown": top(flop_bd),
            "mem_breakdown": top(mem_bd), "coll_breakdown": top(coll_bd)}


def model_flops(cell: dict, chips: int) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference), per
    device; tokens from the cell's shape (``SHAPES``, or the batch and
    sequence the cell records when it is not a named one)."""
    shape = SHAPES.get(cell["shape"])
    kind = shape.kind if shape else cell["kind"]
    batch = shape.global_batch if shape else cell["global_batch"]
    seq = shape.seq_len if shape else cell["seq_len"]
    n_active = cell.get("active_params", cell["params"])
    if kind == "train":
        return 6.0 * n_active * batch * seq / chips
    if kind == "prefill":
        return 2.0 * n_active * batch * seq / chips
    return 2.0 * n_active * batch / chips      # decode: one token a lane


def roofline(cell: dict, rows: list) -> dict:
    """The roofline terms of a dry-run cell (its json) and its op record."""
    mesh_shape = dict(zip(cell["mesh_axes"], cell["mesh"]))
    chips = math.prod(cell["mesh"])
    tot = analyze_ops(rows, mesh_shape)
    terms = {"compute_s": tot["flops"] / PEAK_FLOPS,
             "memory_s": tot["bytes"] / HBM_BW,
             "collective_s": tot["coll_seconds"],
             "latency_s": tot["seq_steps"] * LAUNCH_S}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cell, chips)
    kind = SHAPES[cell["shape"]].kind if cell["shape"] in SHAPES \
        else cell["kind"]
    mem_eff = None
    if kind == "decode":
        # ideal decode traffic: the active params once, the cache once
        ideal = 2.0 * cell.get("active_params", cell["params"]) / chips \
            + cell["memory"]["alias_size_in_bytes"]
        mem_eff = round(ideal / tot["bytes"], 4) if tot["bytes"] else None
    return {
        "cell": cell["cell"], "arch": cell["arch"], "shape": cell["shape"],
        "mesh": cell["mesh"], "op_flops": tot["flops"],
        "op_bytes": tot["bytes"], "coll_bytes": tot["coll_bytes"],
        "sequential_steps": tot["seq_steps"], "launches": tot["launches"],
        "coll_breakdown": tot["coll_breakdown"],
        "flop_breakdown": tot["flop_breakdown"],
        "mem_breakdown": tot["mem_breakdown"],
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_time_bound_s": bound,
        "model_flops": mf,
        "useful_flop_fraction": mf / tot["flops"] if tot["flops"] else 0.0,
        "roofline_fraction": (mf / PEAK_FLOPS) / bound if bound else 0.0,
        "memory_efficiency": mem_eff,
        "memory_gib": cell["memory"]["total_per_device"] / 2**30,
        "wall_s": cell.get("wall_s"),
    }


def roofline_cell(json_path: str) -> dict:
    """Read a dry-run cell (json + op record) and compute the roofline
    terms; every quantity in the record is already per device."""
    with open(json_path) as f:
        cell = json.load(f)
    if cell.get("status") != "ok":
        return {**cell, "roofline": None}
    ops_path = cell.get("ops_path") or json_path.replace(".json", ".ops.json")
    with open(ops_path) as f:
        rows = json.load(f)
    return roofline(cell, rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Hopper roofline from dry-run "
                                 "artifacts")
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--mesh", default="pod16x16",
                    help="pod16x16 | pod2x16x16 | all")
    ap.add_argument("--out", default=None, help="write JSON rows here")
    args = ap.parse_args(argv)

    rows = []
    for fname in sorted(os.listdir(args.dir)):
        if not fname.endswith(".json") or fname.endswith(".ops.json"):
            continue
        if args.mesh != "all" and f"__{args.mesh}" not in fname:
            continue
        if fname.count("__") > 2:      # tagged hillclimb variants: skip
            continue
        try:
            r = roofline_cell(os.path.join(args.dir, fname))
        except (OSError, ValueError, KeyError) as e:
            print(f"[FAIL] {fname}: {e}", file=sys.stderr)
            continue
        if r.get("roofline", True) is None:
            continue
        rows.append(r)
        print(f"{r['cell']:60s} {r['memory_gib']:8.2f} GiB  "
              f"comp {r['compute_s']*1e3:9.2f}ms  "
              f"mem {r['memory_s']*1e3:9.2f}ms  "
              f"coll {r['collective_s']*1e3:9.2f}ms  "
              f"lat {r['latency_s']*1e3:8.2f}ms  "
              f"dom={r['dominant']:10s} "
              f"useful={r['useful_flop_fraction']:6.3f} "
              f"roofline={r['roofline_fraction']:8.5f}  "
              f"wall {r['wall_s'] or 0:6.1f}s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {len(rows)} rows to {args.out}")


if __name__ == "__main__":
    main()
