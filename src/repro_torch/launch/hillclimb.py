"""Perf hillclimb — run a named sharding/algorithm variant of one
dry-run cell, re-run it, re-analyze, and print the four Hopper roofline
terms next to the baseline (the reference's ``repro/launch/hillclimb.py``,
with the same variants).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell granite_dp

A variant's ``env`` is set for its run only and restored after it (the
reference's ``run_variant`` leaves it set, so ``REPRO_SCAN_CHUNK`` leaks into
every later variant of the process).
"""

from __future__ import annotations

import argparse
import contextlib
import os

from .dryrun import OUT_DIR, run_cell
from .roofline import roofline_cell

_DP = {"__batch__": ("data", "model"), "vocab": None, "ffn": None,
       "heads": None, "kv_heads": None, "experts": None}

# name -> (arch, shape, kwargs for run_cell)
VARIANTS = {
    # granite: kill TP collectives entirely — the model fits a device, so
    # the 'model' mesh axis becomes extra data parallelism (ZeRO over
    # 'data').
    "granite_dp": ("granite-moe-1b-a400m", "train_4k", {"rules": _DP}),
    # granite: DP with accum=1 (batch 16/dev) — trades activation memory
    # for fewer FSDP re-gathers.
    "granite_dp_a1": ("granite-moe-1b-a400m", "train_4k", {
        "rules": _DP, "accum": 1}),
    # mistral: Megatron sequence parallelism at layer boundaries.
    "mistral_sp": ("mistral-large-123b", "train_4k", {
        "rules": {"__seq__": ("model",)}}),
    "mistral_sp_a8": ("mistral-large-123b", "train_4k", {
        "rules": {"__seq__": ("model",)}, "accum": 8}),
    "mistral_a8": ("mistral-large-123b", "train_4k", {"accum": 8}),
    # mistral: grads born sharded -> reduce-scatter instead of all-reduce
    "mistral_gradrs": ("mistral-large-123b", "train_4k", {
        "constrain_grads": True}),
    # falcon: chunked selective scan (env-gated in kernels/mamba_scan/ops)
    "falcon_chunk": ("falcon-mamba-7b", "train_4k", {
        "env": {"REPRO_SCAN_CHUNK": "64"}}),
    "falcon_chunk128": ("falcon-mamba-7b", "train_4k", {
        "env": {"REPRO_SCAN_CHUNK": "128"}}),
    "falcon_chunk_sp": ("falcon-mamba-7b", "train_4k", {
        "env": {"REPRO_SCAN_CHUNK": "64"},
        "rules": {"__seq__": ("model",)}}),
    # granite iter3: DP + no remat (activations at 1 row/device are cheaper
    # than the recompute's extra param re-gathers + refwd traffic)
    "granite_dp_nr": ("granite-moe-1b-a400m", "train_4k", {
        "rules": _DP, "accum": 1, "cfg_overrides": {"remat": "none"}}),
    # granite iter4: + tighter expert capacity
    "granite_dp_nr_c1": ("granite-moe-1b-a400m", "train_4k", {
        "rules": _DP, "accum": 1,
        "cfg_overrides": {"remat": "none", "capacity_factor": 1.0}}),
    # granite iter4: DP (remat full) + tighter expert capacity
    "granite_dp_c1": ("granite-moe-1b-a400m", "train_4k", {
        "rules": _DP, "accum": 1, "cfg_overrides": {"capacity_factor": 1.0}}),
    "grok_dp_experts": ("grok-1-314b", "train_4k", {
        "rules": {"experts": "model"}}),
    # recurrentgemma: chunked RG-LRU scan (same as falcon iter-2)
    "rgemma_chunk": ("recurrentgemma-9b", "train_4k", {
        "env": {"REPRO_SCAN_CHUNK": "64"}}),
    # grok: halve FSDP re-gathers (accum 16->8) + tighter expert capacity
    "grok_tuned": ("grok-1-314b", "train_4k", {
        "accum": 8, "cfg_overrides": {"capacity_factor": 1.0}}),
}


@contextlib.contextmanager
def environment(env: dict):
    """``os.environ`` with ``env`` set inside the block, and as it was
    after it (a variable the block set is removed, one it changed
    restored)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_variant(name: str, multi_pod: bool = False,
                out_dir: str = OUT_DIR) -> dict:
    arch, shape, kw = VARIANTS[name]
    kw = dict(kw)
    with environment(kw.pop("env", {})):
        res = run_cell(arch, shape, multi_pod=multi_pod, tag=name,
                       out_dir=out_dir, **kw)
    if res.get("status") != "ok":
        raise SystemExit(f"variant {name} failed: {res}")
    return roofline_cell(os.path.join(out_dir, res["cell"] + ".json"))


def compare(name: str, multi_pod: bool = False,
            out_dir: str = OUT_DIR) -> None:
    arch, shape, _ = VARIANTS[name]
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    base_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(base_path):
        run_cell(arch, shape, multi_pod=multi_pod, out_dir=out_dir)
    base = roofline_cell(base_path)
    var = run_variant(name, multi_pod=multi_pod, out_dir=out_dir)

    def fmt(r):
        return (f"comp {r['compute_s']:8.3f}s  mem {r['memory_s']:8.3f}s  "
                f"coll {r['collective_s']:8.3f}s  "
                f"lat {r['latency_s']:7.3f}s  dom={r['dominant']:10s} "
                f"bound {r['step_time_bound_s']:8.3f}s  "
                f"roofline {r['roofline_fraction']:.4f}  "
                f"mem/dev {r['memory_gib']:.1f} GiB")

    print(f"baseline : {fmt(base)}")
    print(f"{name:9s}: {fmt(var)}")
    d = base["step_time_bound_s"] / max(var["step_time_bound_s"], 1e-12)
    print(f"step-time bound speedup: {d:.2f}x")
    print("variant coll breakdown:")
    for k, v in list(var["coll_breakdown"].items())[:6]:
        print(f"   {v/1e9:10.1f} GB  {k}")
    print("variant mem breakdown:")
    for k, v in list(var["mem_breakdown"].items())[:6]:
        print(f"   {v/1e9:10.1f} GB  {k}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    help=f"one of {sorted(VARIANTS)}")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    compare(args.cell, multi_pod=args.multi_pod, out_dir=args.out)


if __name__ == "__main__":
    main()
