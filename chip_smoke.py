"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card — the lockVM sweep behind the
paper's fig3, and serving granite-moe-1b-a400m at full width through the
ticket-FIFO ``ServeEngine`` — through the entry points a user calls, and
checks them:

1. card and build: the card's name and power limit; ``csrc/lockvm.cu`` and
   ``csrc/ticket_dispatch.cu`` built with ``nvcc`` for ``sm_90a`` from the
   checkout, both at once.
2. kernel vs plain: the lockVM kernel (``mode="cuda"``) against the plain
   PyTorch engine on the card, bit-identical on all eight output stats, on
   the 14 ``tests/corpus`` entries, a fault sweep (preemptions, spurious
   wakes and aborts) and the fig3 cells at a reduced horizon.
3. main path: ``repro_torch.sim.run_sweeps`` with ``mode="auto"`` over the
   full fig3 spec (13 locks at 1-64 threads, ``twa-timo`` at 1-32, seeds
   1-3, horizon 1.5M cycles), which must resolve to the kernel.
4. the paper's fig3 claims on the kernel (ticket collapses, TWA stays flat
   and meets MCS, handover scaling).
5. ticket kernel vs plain: the ticket-dispatch kernel against its plain
   version on the card, tickets and slots equal, on granite-moe's prefill
   and decode groups, 16 groups in one launch, a million arrivals in one
   group, 1 to 3,418 experts, a skewed draw that drops pairs and ids
   outside [0, E).
6. serve: ``repro_torch.serve.ServeEngine`` on granite-moe-1b-a400m at
   full width in bf16 (random weights from a seeded generator): 16 requests
   of 16-256 prompt tokens and 32 new tokens each, 8 lanes, greedy, the
   default TWA gate.  Every MoE layer goes through the ticket kernel; a
   second run with ``dispatch="torch"`` must give the same tokens, bit for
   bit.  A reduced float32 model on the card agrees with the same model on
   the CPU.

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
# 32-bit rate outside the tensor cores, used for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# The serve phase: granite-moe-1b-a400m at full width, its traffic.
SERVE_ARCH = "granite-moe-1b-a400m"
SERVE_REQUESTS = 16
SERVE_PROMPT = (16, 256)       # prompt lengths drawn in [16, 256]
SERVE_NEW = 32
SERVE_LANES = 8
SERVE_CTX = 512

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


def bound_ms(nbytes_moved: int, n_ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over HBM bandwidth, or one 32-bit
    operation per unit of work (an executed event, an arrival's counter
    step) over the scalar peak — the larger."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_ms(fn, launches: int = 200, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device time per call of ``fn`` over
    ``launches`` back-to-back calls (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def ticket_cases(dev, moe_capacity, cfg, max_experts: int) -> list:
    """(name, ids (G, n) int32 on the card, E, capacity) of the ticket
    check: granite-moe's prefill groups (N·K = 8·Lp arrivals, E = 32) and
    its decode group at 8 lanes, 16 groups in one launch, one group of
    2**20 arrivals, E from 1 to the shared-memory limit, a skewed draw (all
    to one expert) and ids outside [0, E)."""
    rng = np.random.default_rng(12)
    E, K = cfg.n_experts, cfg.top_k

    def ids(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(
            np.int32)).to(dev)

    cases = [(f"prefill_Lp{lp}", ids((1, K * lp), 0, E), E,
              moe_capacity(cfg, lp)) for lp in (16, 128, 256, 512)]
    cases += [("decode_8_lanes", ids((1, K * SERVE_LANES), 0, E), E,
               moe_capacity(cfg, SERVE_LANES)),
              ("16_groups", ids((16, K * 128), 0, E), E,
               moe_capacity(cfg, 128)),
              ("one_group_2^20", ids((1, 1 << 20), 0, E), E,
               moe_capacity(cfg, (1 << 20) // K))]
    cases += [(f"E{e}", ids((3, 777), 0, e), e, 64)
              for e in (1, 5, 8, 100, 128, max_experts)]
    cases += [("skewed_drop", torch.full((2, 5000), 7, dtype=torch.int32,
                                         device=dev), E, 160),
              ("ids_outside", ids((2, 999), -3, E + 3), E, 20)]
    return cases


def ticket_phase(dev, kernel, ref, moe_capacity, cfg) -> dict:
    """The ticket kernel against its plain version on the card (exact), and
    its time and bound at the serve path's shapes."""
    t0 = time.perf_counter()
    sets = []
    for name, ids, n_experts, capacity in ticket_cases(
            dev, moe_capacity, cfg, kernel.MAX_EXPERTS):
        t, s = kernel.ticket_dispatch(ids, n_experts, capacity)
        torch.cuda.synchronize()
        p_t, p_s = ref.dispatch_ref(ids, n_experts, capacity, grouped=True)
        err = max(int((t.long() - p_t.long()).abs().max()),
                  int((s.long() - p_s.long()).abs().max()))
        if err:
            raise AssertionError(f"ticket kernel != plain on {name}: "
                                 f"max |err| {err}")
        sets.append({"set": name, "shape": list(ids.shape), "E": n_experts,
                     "capacity": capacity,
                     "dropped": int((s < 0).sum()) - int((t < 0).sum()),
                     "max_abs_err": err})
    timed = {}
    for name, lp in (("decode", None), ("prefill_Lp256", 256)):
        n = cfg.top_k * (SERVE_LANES if lp is None else lp)
        cap = moe_capacity(cfg, SERVE_LANES if lp is None else lp)
        ids = torch.from_numpy(np.random.default_rng(lp or 0).integers(
            0, cfg.n_experts, size=(1, n)).astype(np.int32)).to(dev)
        ms = launch_ms(lambda: kernel.ticket_dispatch(ids, cfg.n_experts,
                                                      cap))
        plain = launch_ms(lambda: ref.dispatch_ref(ids, cfg.n_experts, cap,
                                                   grouped=True))
        # id read once, ticket and slot written once; one counter step each
        bound, bound_by = bound_ms(12 * n, n)
        timed[name] = {"arrivals": n, "E": cfg.n_experts, "capacity": cap,
                       "ms": ms, "plain_ms": plain, "bound_ms": bound,
                       "bound_by": bound_by}
    return {"phase": "ticket_kernel_vs_plain", "tolerance": "exact",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def serve_phase(dev, cfg, params, ServeEngine, kernel) -> dict:
    """Serve SERVE_REQUESTS requests at full width, first through the
    ticket kernel (``dispatch="auto"``), then with ``dispatch="torch"``;
    the tokens must be equal."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))).tolist()
        for _ in range(SERVE_REQUESTS)]

    def run(dispatch, prompts, max_new):
        eng = ServeEngine(cfg, params, lanes=SERVE_LANES, max_ctx=SERVE_CTX,
                          device=dev, dispatch=dispatch)
        prefill_s = []
        admit = eng._admit

        def timed_admit(lane, req):
            t = time.perf_counter()
            admit(lane, req)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)

        eng._admit = timed_admit
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        torch.cuda.synchronize()
        kernel.launches = 0
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, reqs, wall, prefill_s, kernel.launches

    t0 = time.perf_counter()
    for dispatch in ("auto", "torch"):  # warm-up: allocator, GEMM plans
        run(dispatch, prompts, 2)
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, wall, prefill_s, launches = run("auto", prompts, SERVE_NEW)
    peak = torch.cuda.max_memory_allocated()
    tokens = [r.tokens_out for r in reqs]
    assert [r.ticket for r in reqs] == list(range(SERVE_REQUESTS))
    for r in reqs:
        assert r.done.is_set() and len(r.tokens_out) == SERVE_NEW, r.rid
        assert all(0 <= t < cfg.vocab for t in r.tokens_out), r.rid
    adm = [r.admitted_at_step for r in reqs]
    assert adm == sorted(adm), adm                   # admitted in ticket order
    assert eng.prefill_count == SERVE_REQUESTS
    want = cfg.n_layers * (eng.prefill_count + eng.step_count)
    assert launches == want, (launches, want)
    stats = eng.stats()
    p_eng, p_reqs, p_wall, p_prefill_s, p_launches = run("torch", prompts,
                                                         SERVE_NEW)
    assert p_launches == 0, p_launches
    p_tokens = [r.tokens_out for r in p_reqs]
    if p_tokens != tokens:
        bad = [i for i, (a, b) in enumerate(zip(tokens, p_tokens)) if a != b]
        raise AssertionError(f"tokens with the ticket kernel differ from "
                             f"dispatch='torch' on requests {bad}")
    assert p_eng.step_count == eng.step_count
    n_tok = sum(len(t) for t in tokens)
    decode_s = wall - sum(prefill_s)
    p_decode_s = p_wall - sum(p_prefill_s)
    return {"phase": "serve", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "experts": cfg.n_experts,
            "top_k": cfg.top_k, "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": SERVE_CTX, "gate": stats["lock"],
            "prefills": eng.prefill_count, "decode_steps": eng.step_count,
            "ticket_launches": launches, "tokens_bit_identical": True,
            "wall_s": wall, "tokens_per_s": n_tok / wall,
            "prefill_ms_per_request": 1e3 * sum(prefill_s) / len(prefill_s),
            "prefill_ms": [1e3 * t for t in prefill_s],
            "decode_ms_per_step": 1e3 * decode_s / eng.step_count,
            "plain_dispatch": {
                "wall_s": p_wall,
                "prefill_ms_per_request":
                    1e3 * sum(p_prefill_s) / len(p_prefill_s),
                "decode_ms_per_step": 1e3 * p_decode_s / p_eng.step_count},
            "peak_memory_bytes": peak,
            "admission": {k: v for k, v in stats.items() if k != "lock"},
            "seconds": time.perf_counter() - t0}


def _leaves(params):
    yield params["embed"]
    yield params["final_norm"]
    for slot in params["stack"].values():
        yield from slot.values()
    for layer in params["tail"]:
        yield from layer.values()
    if "lm_head" in params:
        yield params["lm_head"]


def small_model_phase(dev, cfg, model, kernel) -> dict:
    """A reduced float32 model on the card (ticket kernel) against the same
    weights on the CPU (plain dispatch): prefill logits and one decode
    step.  Tolerance rtol = atol = 1e-4: float32 sums run in another order
    on the card (TF32 is off)."""
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    on_card = {"embed": params["embed"].to(dev),
               "final_norm": params["final_norm"].to(dev),
               "stack": {j: {k: v.to(dev) for k, v in slot.items()}
                         for j, slot in params["stack"].items()},
               "tail": [{k: v.to(dev) for k, v in layer.items()}
                        for layer in params["tail"]]}
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 40)))
    step = torch.tensor([[5], [9]])
    pos = torch.tensor([40, 17])

    def grow(cache):
        """The prefill cache with room for 40 more positions."""
        def more(v, dim):
            return torch.cat([v, torch.zeros_like(v)], dim=dim)
        return {"stack": {j: {k: more(v, 2) for k, v in slot.items()}
                          for j, slot in cache["stack"].items()},
                "tail": [{k: more(v, 1) for k, v in layer.items()}
                         for layer in cache["tail"]]}

    def prefill_and_step(p, device):
        logits, _, cache = model.forward(p, {"tokens": tokens.to(device)},
                                         cfg, collect_cache=True)
        d_logits, _ = model.decode_step(p, grow(cache), step.to(device),
                                        pos.to(device), cfg)
        return logits.cpu(), d_logits.cpu()

    kernel.launches = 0
    card = prefill_and_step(on_card, dev)
    launches = kernel.launches
    assert launches == 2 * cfg.n_layers, launches
    host = prefill_and_step(params, torch.device("cpu"))
    errs = []
    for a, b in zip(card, host):
        assert torch.isfinite(a[..., :cfg.vocab]).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        errs.append(float((a - b).abs()[..., :cfg.vocab].max()))
    return {"arch": cfg.name + " reduced", "dtype": cfg.dtype,
            "tolerance": "rtol=atol=1e-4 vs the CPU", "max_abs_err": errs,
            "ticket_launches": launches}


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
    from repro_torch.configs import get_config
    from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
    from repro_torch.kernels.ticket_dispatch import ref as ticket_ref
    from repro_torch.models import model
    from repro_torch.models.layers import moe_capacity
    from repro_torch.serve import ServeEngine
    from repro_torch.sim import engine, engine_cuda
    from repro_torch.sim.corpus import load_scenario, scenario_sweep_args

    root = Path(__file__).resolve().parent
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (the small-model check); the serve
    # path is bf16 and takes no TF32 either way
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    _build.load_libraries(["lockvm", "ticket_dispatch"])
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_logs.get(name, "")
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in ("lockvm", "ticket_dispatch")}
    assert ticket_kernel.smem_bytes_from_kernel(32) == \
        ticket_kernel.smem_bytes(32)
    n_fig3_threads = max(FIG3_THREADS)
    mem64 = sim.Layout(n_threads=n_fig3_threads, n_locks=1).mem_words
    words = engine_cuda.state_words_from_kernel(n_fig3_threads, mem64, 1)
    assert 4 * words == engine_cuda.cell_state_bytes(n_fig3_threads, mem64), \
        (words, engine_cuda.cell_state_bytes(n_fig3_threads, mem64))
    emit({"phase": "build", "card": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": build_s, "ptxas": ptxas,
          "ticket_smem_bytes_E32": ticket_kernel.smem_bytes(32),
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

    # ---- 5. the ticket kernel against its plain version
    cfg = get_config(SERVE_ARCH)
    ticket = ticket_phase(dev, ticket_kernel, ticket_ref, moe_capacity, cfg)
    emit(ticket)

    # ---- 6. serve granite-moe-1b-a400m at full width
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    probe = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, size=(1, 64))).to(dev)
    logits, _, _ = model.forward(params, {"tokens": probe}, cfg)
    assert logits.shape == (1, 64, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert bool((logits[..., cfg.vocab:] == -1e30).all())
    served = serve_phase(dev, cfg, params, ServeEngine, ticket_kernel)
    serve_launches = served["ticket_launches"]
    served["init_params_s"] = init_s
    served["small_model"] = small_model_phase(dev, cfg.reduced(), model,
                                              ticket_kernel)
    emit(served)
    del params

    bound, bound_by = bound_ms(reduced["bytes"], reduced["sum_events"])
    dec = ticket["timed"]["decode"]
    pre = ticket["timed"]["prefill_Lp256"]
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
        "main_path_max_events": int(events.max())}, {
        "name": "ticket_dispatch_run", "route": "cuda",
        "source": "src/repro_torch/csrc/ticket_dispatch.cu",
        "replaces": "src/repro/kernels/ticket_dispatch/kernel.py:72",
        "launches": serve_launches,
        "max_abs_err": max(c["max_abs_err"] for c in ticket["sets"]),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "timed_on": f"decode group: {dec['arrivals']} arrivals, "
                    f"E={dec['E']}",
        "prefill_Lp256_ms": pre["ms"], "prefill_Lp256_plain_ms":
            pre["plain_ms"], "prefill_Lp256_bound_ms": pre["bound_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
