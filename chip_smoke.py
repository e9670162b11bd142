"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the lockVM sweep behind the paper's fig3 —
on the card, through the entry points a user calls, and checks it:

1. card and build: the card's name and power limit; ``csrc/lockvm.cu``
   built with ``nvcc`` for ``sm_90a`` from the checkout.
2. kernel vs plain: the CUDA kernel (``mode="cuda"``) against the plain
   PyTorch engine on the card, bit-identical on all eight output stats, on
   the 14 ``tests/corpus`` entries, a fault sweep (preemptions, spurious
   wakes and aborts) and the fig3 cells at a reduced horizon.
3. main path: ``repro_torch.sim.run_sweeps`` with ``mode="auto"`` over the
   full fig3 spec (13 locks at 1-64 threads, ``twa-timo`` at 1-32, seeds
   1-3, horizon 1.5M cycles), which must resolve to the kernel.
4. the paper's fig3 claims on the kernel (ticket collapses, TWA stays flat
   and meets MCS, handover scaling).

Each phase prints one JSON line.  Before the last line come the kernel
table (a JSON object with key ``kernels``) and the ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": ...}``.  Any failure
exits non-zero.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bandwidth, and the
# 32-bit rate outside the tensor cores, used for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

FIG3_THREADS = (1, 2, 4, 8, 16, 32, 64)
TIMO_THREADS = (1, 2, 4, 8, 16, 32)  # gen_twa_timo_acquire: T <= 32
CHECK_HORIZON = 10_000
CLAIMS_HORIZON = 800_000


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fig3_specs(sim, horizon: int, max_events: int = 2_000_000) -> list:
    """The fig3 sweep: every lock at 1-64 threads, twa-timo at 1-32."""
    kw = dict(seeds=(1, 2, 3), cs_work=4, ncs_max=200, horizon=horizon,
              max_events=max_events, collect_latency=True)
    others = tuple(lk for lk in sim.SIM_LOCKS if lk != "twa-timo")
    return [sim.SweepSpec(locks=others, threads=FIG3_THREADS, **kw),
            sim.SweepSpec(locks="twa-timo", threads=TIMO_THREADS, **kw)]


def cuda_ms(fn, repeats: int = 1) -> tuple[float, object]:
    """Median device time of ``fn()`` in ms (CUDA events), and its result."""
    times, out = [], None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def nbytes(tensors) -> int:
    total = 0
    for x in tensors:
        if x is None:
            continue
        if isinstance(x, (tuple, list)):
            total += nbytes(x)
        else:
            total += x.numel() * x.element_size()
    return total


def compare(name: str, args, n_locks: int, engine, engine_cuda) -> dict:
    """Kernel vs plain engine on one set of input tensors on the card."""
    t0 = time.perf_counter()
    kernel_ms, k_out = cuda_ms(lambda: engine_cuda.run_cells(
        *args, n_locks=n_locks))
    plain_ms, p_out = cuda_ms(lambda: engine.run_cells(*args,
                                                       n_locks=n_locks))
    err = 0
    for key in engine.OUT_KEYS:
        diff = (k_out[key].long() - p_out[key].long()).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    if err:
        bad = [k for k in engine.OUT_KEYS if not torch.equal(k_out[k],
                                                             p_out[k])]
        raise AssertionError(f"{name}: kernel != plain engine on {bad}")
    return {"set": name, "cells": int(args[0].shape[0]),
            "max_events": int(p_out["events"].max()),
            "sum_events": int(p_out["events"].long().sum()),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "plain_ms_per_step": plain_ms / max(int(p_out["events"].max()),
                                                1),
            "max_abs_err": err, "seconds": time.perf_counter() - t0,
            "bytes": nbytes(args) + nbytes(k_out.values()), "out": k_out}


def bound_ms(nbytes_moved: int, sum_events: int) -> tuple[float, str]:
    """Least time for the work: bytes over HBM bandwidth, or one 32-bit
    operation per executed event over the scalar peak — the larger."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum_events / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_claims(by: dict) -> None:
    """The fig3 inequalities of tests/test_sim_paper_claims.py."""
    for T in (1, 2, 4):
        tk, tw, mc = (by[lk, T]["throughput"] for lk in ("ticket", "twa",
                                                          "mcs"))
        assert tk >= tw * 0.98, (T, tk, tw)
        assert tw >= tk * 0.90, (T, tk, tw)
        if T == 1:
            assert tk > mc, (T, tk, mc)
        else:
            assert tk >= mc * 0.97, (T, tk, mc)
    tk16, tk64 = (by["ticket", T]["throughput"] for T in (16, 64))
    tw16, tw64 = (by["twa", T]["throughput"] for T in (16, 64))
    mc16, mc64 = (by["mcs", T]["throughput"] for T in (16, 64))
    assert tk64 < 0.5 * tk16
    assert tw64 > 0.85 * tw16
    assert mc64 > 0.85 * mc16
    assert tw64 > 2.5 * tk64
    assert tw64 >= mc64
    assert mc64 > tk64
    h_tk8, h_tk64 = (by["ticket", T]["avg_handover"] for T in (8, 64))
    h_tw8, h_tw64 = (by["twa", T]["avg_handover"] for T in (8, 64))
    h_mc64 = by["mcs", 64]["avg_handover"]
    assert h_tk64 > 2.5 * h_tk8
    assert h_tw64 < 1.3 * h_tw8
    assert h_tw64 < h_tk64 / 2
    assert h_tw64 < h_mc64 * 1.6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import _build
    from repro_torch import sim
    from repro_torch.sim import engine, engine_cuda
    from repro_torch.sim.corpus import load_scenario, scenario_sweep_args

    root = Path(__file__).resolve().parent
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def spec_inputs(specs):
        """The kernel's input tensors on the card for one engine call."""
        progs, kw, _ = sim.sweep_engine_args(specs)
        kw.pop("live_mem_words")
        n_locks = kw.pop("n_locks")
        return engine.sweep_inputs(progs, **kw, device=dev), n_locks

    # ---- 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.load_library("lockvm")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_logs.get("lockvm", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    n_fig3_threads = max(FIG3_THREADS)
    mem64 = sim.Layout(n_threads=n_fig3_threads, n_locks=1).mem_words
    words = engine_cuda.state_words_from_kernel(n_fig3_threads, mem64, 1)
    assert 4 * words == engine_cuda.cell_state_bytes(n_fig3_threads, mem64), \
        (words, engine_cuda.cell_state_bytes(n_fig3_threads, mem64))
    emit({"phase": "build", "card": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": build_s, "ptxas": ptxas,
          "cell_state_bytes_T64": 4 * words})

    # ---- 2. kernel vs plain engine on the card
    t0 = time.perf_counter()
    corpus = [load_scenario(p) for p in sorted((root / "tests" / "corpus")
                                               .glob("*.npz"))]
    assert len(corpus) == 14, len(corpus)
    progs, kw = scenario_sweep_args(corpus)
    checks = [compare("corpus", engine.sweep_inputs(
        progs, **{k: v for k, v in kw.items() if k != "n_locks"},
        device=dev), kw["n_locks"], engine, engine_cuda)]
    # faults on every lane of a warp and past it (T = 40: two bitset words,
    # two threads per lane); twa-timo's generator stops at 32 threads
    fault_kw = dict(seeds=(1, 2), horizon=4_000, preempt_faults=3,
                    spurious_faults=2, abort_faults=1, preempt_cost=512,
                    fault_evt_span=3_000)
    fault_specs = [sim.SweepSpec(locks=("ticket", "twa", "mcs", "twa-sem"),
                                 threads=(4, 16, 40), **fault_kw),
                   sim.SweepSpec(locks="twa-timo", threads=(4, 16),
                                 **fault_kw)]
    sets = [("faults", fault_specs),
            ("fig3_reduced", fig3_specs(sim, CHECK_HORIZON))]
    for name, specs in sets:
        args, n_locks = spec_inputs(specs)
        if name == "faults":
            assert args[-1] is not None and bool((args[-1][0] != 0).any())
        checks.append(compare(name, args, n_locks, engine, engine_cuda))
    emit({"phase": "kernel_vs_plain", "tolerance": "bit-identical",
          "seconds": time.perf_counter() - t0,
          "sets": [{k: v for k, v in c.items() if k != "out"}
                   for c in checks]})
    reduced = checks[-1]
    # kernel time on the reduced fig3 inputs (warm): the median of 3
    kernel_ms, _ = cuda_ms(lambda: engine_cuda.run_cells(
        *args, n_locks=n_locks), repeats=3)

    # ---- 3. the main path at full size, through the user's entry point
    specs = fig3_specs(sim, 1_500_000)
    t0 = time.perf_counter()
    engine_cuda.launches = 0
    results = sim.run_sweeps(specs, device=dev)
    launches = engine_cuda.launches
    wall = time.perf_counter() - t0
    rows = [r for rs in results for r in rs]
    assert len(rows) == 13 * len(FIG3_THREADS) * 3 + len(TIMO_THREADS) * 3
    assert all(r["mode"] == "cuda" for r in rows), rows[0]["mode"]
    assert launches > 0, launches
    for r in rows:
        assert r["acquisitions"].shape == (r["n_threads"],)
        assert 0 < int(r["events"]) <= 2_000_000, r["events"]
        assert (r["acquisitions"] >= 0).all() and r["acquisitions"].sum() > 0
        assert math.isfinite(r["throughput"]) and r["throughput"] > 0
        for col in ("lat_p50", "lat_p99", "lat_p999"):
            assert math.isfinite(r[col]), (r["lock"], r["n_threads"], col)
        assert r["lat_p50"] <= r["lat_p99"] <= r["lat_p999"]
    events = np.asarray([int(r["events"]) for r in rows])
    by = {(r["lock"], r["n_threads"], r["seed"]): r for r in rows}
    # the kernel alone on the main path's inputs (device time)
    main_args, n_locks = spec_inputs(specs)
    main_ms, main_out = cuda_ms(lambda: engine_cuda.run_cells(
        *main_args, n_locks=n_locks), repeats=3)
    assert np.array_equal(main_out["events"].cpu().numpy(), events)
    main_bound, main_bound_by = bound_ms(
        nbytes(main_args) + nbytes(main_out.values()), int(events.sum()))
    emit({"phase": "main_path", "entry": "repro_torch.sim.run_sweeps",
          "mode": rows[0]["mode"], "launches": launches, "cells": len(rows),
          "wall_seconds": wall, "kernel_ms": main_ms,
          "sum_events": int(events.sum()), "max_events": int(events.max()),
          "events_per_s": float(events.sum()) / wall,
          "throughput_T64": {lk: float(np.median(
              [by[lk, 64, s]["throughput"] for s in (1, 2, 3)]))
              for lk in ("ticket", "twa", "mcs")},
          "bound_ms": main_bound, "bound_by": main_bound_by})

    # ---- 4. the paper's fig3 claims on the kernel
    t0 = time.perf_counter()
    engine_cuda.launches = 0
    claims = sim.run_sweep(sim.SweepSpec(
        locks=("ticket", "twa", "mcs"), threads=(1, 2, 4, 8, 16, 64),
        seeds=1, horizon=CLAIMS_HORIZON), device=dev)
    assert engine_cuda.launches > 0 and claims[0]["mode"] == "cuda"
    check_claims({(r["lock"], r["n_threads"]): r for r in claims})
    emit({"phase": "paper_claims", "seconds": time.perf_counter() - t0,
          "launches": engine_cuda.launches, "checked": [
              "low_contention_ticket_best_twa_close",
              "high_contention_ticket_collapses_twa_wins",
              "handover_scaling"]})

    bound, bound_by = bound_ms(reduced["bytes"], reduced["sum_events"])
    print(json.dumps({"kernels": [{
        "name": "lockvm_run", "route": "cuda",
        "source": "src/repro_torch/csrc/lockvm.cu",
        "replaces": "src/repro/sim/engine_pallas.py:154",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": kernel_ms, "plain_ms": reduced["plain_ms"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "timed_on": f"fig3 cells at horizon {CHECK_HORIZON}",
        "max_events": reduced["max_events"],
        "main_path_ms": main_ms, "main_path_bound_ms": main_bound,
        "main_path_max_events": int(events.max())}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
