"""Device time of the lockVM and selective-scan kernels of two source trees,
on one card, in turns: a parent tree's and this one's.

    python src/repro_torch/bench/kernel_pair.py --parent PARENT [--out FILE]

PARENT is an unpacked checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C local/parent``; ``local/`` is
gitignored).  The script runs four child processes in the order parent,
change, change, parent; each imports ``repro_torch`` from its own tree's
``src/`` (this file is run by path, so it works against a tree that lacks
it), builds that tree's kernels into a build directory of its own, and
times on the same inputs:

* the lockVM kernel (``engine_cuda.run_cells``) on the full fig3 sweep of
  ``chip_smoke.py`` (13 locks at 1-64 threads, ``twa-timo`` at 1-32, seeds
  1-3, horizon 1.5M cycles): device ms from CUDA events, the median of 3,
  and microseconds per event on the longest cell's chain;
* the selective-scan kernel at falcon-mamba-7b's prefill, L 256 x D 8,192 x
  N 16 in bf16: device ms of one launch under ``torch.profiler``, the
  median of 50.

Each child prints one JSON line with its numbers, the card's name, power
limit and SM clock (``nvidia-smi``, sampled while the lockVM kernel runs),
the ptxas report of the build and its outputs' fingerprints; the parent
script checks that both trees' lockVM outputs are identical and that each
scan is within 5e-2 of the plain loop on float32 casts, then prints a
summary line (and writes all lines to FILE).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

SMI_QUERY = "name,power.limit,clocks.sm,clocks.max.sm"
FIG3_THREADS = (1, 2, 4, 8, 16, 32, 64)
TIMO_THREADS = (1, 2, 4, 8, 16, 32)
SCAN_SHAPE = (256, 8192, 16)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def child(tree: Path) -> dict:
    """Time both kernels of ``tree`` (imported from ``tree/src``)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _build, sim
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.sim import engine, engine_cuda

    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve())
    if not torch.cuda.is_available():
        raise SystemExit("kernel_pair: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.load_libraries(["lockvm", "mamba_scan"])

    # ---- lockVM: the full fig3 sweep
    kw = dict(seeds=(1, 2, 3), cs_work=4, ncs_max=200, horizon=1_500_000,
              max_events=2_000_000, collect_latency=True)
    others = tuple(lk for lk in sim.SIM_LOCKS if lk != "twa-timo")
    specs = [sim.SweepSpec(locks=others, threads=FIG3_THREADS, **kw),
             sim.SweepSpec(locks="twa-timo", threads=TIMO_THREADS, **kw)]
    progs, ekw, _ = sim.sweep_engine_args(specs)
    ekw.pop("live_mem_words")
    n_locks = ekw.pop("n_locks")
    args = engine.sweep_inputs(progs, **ekw, device=dev)
    engine_cuda.run_cells(*args, n_locks=n_locks)        # warm-up
    torch.cuda.synchronize()
    times, card = [], None
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = engine_cuda.run_cells(*args, n_locks=n_locks)
        end.record()
        if i == 0:
            card = smi()            # sampled while the kernel runs
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    lvm_ms = float(np.median(times))
    events = out["events"].long()
    digest = hashlib.sha256()
    for key in engine.OUT_KEYS:
        digest.update(out[key].cpu().numpy().tobytes())

    # ---- selective scan at the full-width prefill, bf16
    L, D, N = SCAN_SHAPE
    rng = np.random.default_rng(21)
    f32 = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(size=(L, D)), rng.uniform(0.01, 0.2, size=(L, D)),
        -rng.uniform(0.5, 2.0, size=(D, N)), rng.normal(size=(L, N)),
        rng.normal(size=(L, N)), rng.normal(size=(D,)))]
    xs = [a.to(torch.bfloat16) for a in f32]
    ry, rh = scan_ref.selective_scan_ref(*(a.float() for a in xs))

    def fn():
        return scan_kernel.selective_scan(*xs)

    y, h = fn()
    torch.cuda.synchronize()
    err = max(float((y.float() - ry).abs().max()),
              float((h.float() - rh).abs().max()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    dts = [e.device_time for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "mamba_scan_kernel" in e.name]
    assert len(dts) == 50, len(dts)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "stack" in ln]
             for name, log in _build.build_logs.items()}
    return {"tree": str(tree), "card": card, "card_after": smi(),
            "ptxas": ptxas,
            "lockvm": {"ms": lvm_ms, "ms_all": times, "cells": len(events),
                       "max_events": int(events.max()),
                       "sum_events": int(events.sum()),
                       "us_per_event": lvm_ms * 1e3 / int(events.max()),
                       "outputs_sha256": digest.hexdigest()},
            "scan": {"shape": list(SCAN_SHAPE), "dtype": "bf16",
                     "device_ms": float(np.median(dts)) / 1e3,
                     "max_abs_err": err}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent tree")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help="write every line here too")
    a = ap.parse_args(argv)
    if a.child is not None:
        print(json.dumps(child(a.child)), flush=True)
        return 0
    if a.parent is None:
        ap.error("--parent is required")
    change = Path(__file__).resolve().parents[3]
    trees = [("parent", a.parent), ("change", change), ("change", change),
             ("parent", a.parent)]
    lines = []
    for label, tree in trees:
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
            Path(tree).resolve() / "build" / "kernel_pair"))
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(Path(tree).resolve())], env=env,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"kernel_pair: the {label} child failed")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["label"] = label
        lines.append(row)
        print(json.dumps(row), flush=True)
    digests = {r["lockvm"]["outputs_sha256"] for r in lines}
    assert len(digests) == 1, "lockVM outputs differ between the trees"
    for r in lines:
        assert r["scan"]["max_abs_err"] <= 5e-2, (r["label"], r["scan"])

    def side(label, pick):
        return [pick(r) for r in lines if r["label"] == label]

    summary = {"summary": "kernel_pair", "order": [r["label"] for r in lines],
               "cards": [r["card"] for r in lines]}
    for label in ("parent", "change"):
        summary[label] = {
            "lockvm_ms": side(label, lambda r: r["lockvm"]["ms"]),
            "lockvm_us_per_event": side(
                label, lambda r: r["lockvm"]["us_per_event"]),
            "scan_device_ms": side(label,
                                   lambda r: r["scan"]["device_ms"])}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
