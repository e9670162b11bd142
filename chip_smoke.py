"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four paths on the card — the lockVM sweep behind the
paper's fig3, serving granite-moe-1b-a400m at full width through the
ticket-FIFO ``ServeEngine`` (its MoE routing plan through the routing-plan
kernel, and through the ticket kernel), and serving falcon-mamba-7b and
recurrentgemma-9b at full width through the same engine — through the
entry points a user calls, and checks them:

1. card and build: the card's name and power limit; ``csrc/lockvm.cu``,
   ``csrc/ticket_dispatch.cu``, ``csrc/mamba_scan.cu``,
   ``csrc/rglru_scan.cu`` and ``csrc/moe_plan.cu`` built with ``nvcc`` for
   ``sm_90a`` from the checkout, all at once.
2. kernel vs plain: the lockVM kernel (``mode="cuda"``) against the plain
   PyTorch engine on the card, bit-identical on all eight output stats, on
   the 14 ``tests/corpus`` entries, a fault sweep (preemptions, spurious
   wakes and aborts), cells of 130 threads (past the 128 whose rows the
   kernel keeps in registers) and the fig3 cells at a reduced horizon.
3. main path: ``repro_torch.sim.run_sweeps`` with ``mode="auto"`` over the
   full fig3 spec (13 locks at 1-64 threads, ``twa-timo`` at 1-32, seeds
   1-3, horizon 1.5M cycles), which must resolve to the kernel; then the
   kernel alone on the same inputs (CUDA events), its microseconds per
   event on the longest cell's chain and the SM clock while it runs.
4. the paper's fig3 claims on the kernel (ticket collapses, TWA stays flat
   and meets MCS, handover scaling).
5. ticket kernel vs plain: the ticket-dispatch kernel against its plain
   version on the card, tickets and slots equal, on granite-moe's prefill
   and decode groups, 16 groups in one launch, a million arrivals in one
   group, 1 to 3,418 experts, a skewed draw that drops pairs, ids
   outside [0, E) and ids drawn in [-2E, 2E) (wrapped once, or filled with
   INT32_MIN, as the reference's ``dispatch_ref``); the kernel alone under
   ``torch.profiler`` at the decode and a 256-token prefill group, beside
   the device time of a one-element ``torch.add`` (the launch floor).
   Then the MoE routing-plan kernel against its plain version
   (``plan_ref``) on the card, every output equal but the aux loss's gate
   sums (rtol 1e-6: summed in another order), on seeded softmax gates at
   granite-moe's prefill groups (Lp 16, 128, 256, 512) and decode group,
   16 groups in one launch, gates tied to the bit, all mass on one expert
   (drops) and grok-1's E 8 / K 2; its time alone and back to back at the
   decode and a 256-token prefill group, beside the launch floor.
6. serve: ``repro_torch.serve.ServeEngine`` on granite-moe-1b-a400m at
   full width in bf16 (random weights from a seeded generator): 16 requests
   of 16-256 prompt tokens and 32 new tokens each, 8 lanes, greedy, the
   default TWA gate.  Every MoE layer's routing plan is one launch of the
   routing-plan kernel (``dispatch="auto"``); a run with
   ``dispatch="ticket"`` (the plain plan around the ticket kernel, one
   launch a layer) and one with ``dispatch="torch"`` (the plain plan) must
   give the same tokens, bit for bit.  A reduced float32 model on the card
   agrees with the same model on the CPU.
7. scan kernel vs plain: the selective-scan kernel against the plain loop
   on float32 casts of its inputs, within 1e-5 (float32 inputs) and 5e-2
   (bf16), at falcon-mamba-7b's full-width prefill shape and small, ragged,
   batched, h0-threaded and mixed-dtype cases; its time at the full-width
   prefill (back-to-back calls, and the kernel alone under
   ``torch.profiler``) beside the plain loop's.
8. serve_mamba: the same traffic on falcon-mamba-7b at full width (64
   layers, d 4,096, bf16, random weights from a seeded generator): every
   prefill goes through the scan kernel once per layer, decode through
   none.  A second run with ``scan="torch"`` (the plain loop, whose state
   is bf16 where the kernel's is float32) must give the same first token
   wherever its top-2 margin exceeds twice the largest first-token logit
   difference.  A reduced float32 model on the card agrees with the same
   model on the CPU.
9. RG-LRU kernel vs plain: the RG-LRU scan kernel against the plain loop
   on float32 casts of its inputs, equal on float32 inputs and within 5e-2
   on bf16, and within one ulp of the output's dtype of that loop rounded
   to it, at recurrentgemma-9b's full-width prefill shapes (L 256 and
   2,600, D 4,096) and small, ragged, batched, h0-threaded and mixed-dtype
   cases; at the full-width shapes the bf16-state loop must fail the ulp
   limit, so that it tells a float32 state from a bf16 one; its time at
   both prefill shapes (back-to-back calls, and the kernel alone under
   ``torch.profiler`` beside the launch floor) beside the plain loop's;
   its block shape and ring.
10. serve_griffin: recurrentgemma-9b at full width (38 layers, d 4,096,
   window 2,048, bf16, random weights from a seeded generator) on the
   shared traffic plus two long requests (2,030 prompt tokens, whose
   decode crosses the ring's wrap, and 2,600, whose prefill takes the
   banded chunked attention and the ring reorder), ``max_ctx`` 4,096:
   every prefill goes through the RG-LRU kernel once per RG-LRU layer,
   decode through none; the first-token margin rule against
   ``scan="torch"`` as in phase 8.  A reduced float32 model on the card,
   on a prompt longer than its window, agrees with the same model on the
   CPU.

Each phase prints one JSON line.  Before the last line come the kernel
table (a JSON object with key ``kernels``) and the ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": ...}``.  Any failure
exits non-zero.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import gc
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

# The serve phases: granite-moe-1b-a400m, falcon-mamba-7b and
# recurrentgemma-9b at full width, on one traffic (recurrentgemma's with two
# long requests added, GRIFFIN_LONG prompt tokens, and a longer context).
SERVE_ARCH = "granite-moe-1b-a400m"
GROK_ARCH = "grok-1-314b"        # the routing plan's E 8 / K 2 check only
MAMBA_ARCH = "falcon-mamba-7b"
GRIFFIN_ARCH = "recurrentgemma-9b"
GRIFFIN_LONG = (2030, 2600)
GRIFFIN_CTX = 4096
# the RG-LRU kernel's timed shapes: a 256-token and the 2,600-token prefill
GRIFFIN_PREFILL_L = (256, 2600)
SERVE_REQUESTS = 16
SERVE_PROMPT = (16, 256)       # prompt lengths drawn in [16, 256]
SERVE_NEW = 32
SERVE_LANES = 8
SERVE_CTX = 512

FIG3_THREADS = (1, 2, 4, 8, 16, 32, 64)
TIMO_THREADS = (1, 2, 4, 8, 16, 32)  # gen_twa_timo_acquire: T <= 32
CHECK_HORIZON = 10_000
CLAIMS_HORIZON = 800_000


def query_smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    """Least time for the work: bytes over HBM bandwidth, or its 32-bit
    operations (one per executed event or arrival's counter step; seven per
    scan element) over the scalar peak — the larger."""
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
    to one expert), ids outside [0, E) and ids in [-2E, 2E), whose wrapped
    and filled ids take the reference's tickets."""
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
              ("ids_outside", ids((2, 999), -3, E + 3), E, 20),
              ("ids_wrap_fill", ids((2, 999), -2 * E, 2 * E), E, 20)]
    return cases


def ticket_phase(dev, kernel, ref, moe_capacity, cfg) -> dict:
    """The ticket kernel against its plain version on the card (exact), and
    its time (back to back, and alone beside the launch floor) and bound at
    the serve path's shapes."""
    from repro_torch.bench.kernel_pair import profiled_ms

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
        device_ms, floor_ms = profiled_ms(
            lambda: kernel.ticket_dispatch(ids, cfg.n_experts, cap),
            "ticket_dispatch_kernel")
        plain = launch_ms(lambda: ref.dispatch_ref(ids, cfg.n_experts, cap,
                                                   grouped=True))
        # id read once, ticket and slot written once; one counter step each
        bound, bound_by = bound_ms(12 * n, n)
        timed[name] = {"arrivals": n, "E": cfg.n_experts, "capacity": cap,
                       "ms": ms, "device_ms": device_ms,
                       "launch_floor_ms": floor_ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": bound_by}
    return {"phase": "ticket_kernel_vs_plain", "tolerance": "exact",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def plan_cases(dev, moe_capacity, cfg, grok) -> list:
    """(name, gates_full (G, N, E) float32 on the card, K, capacity, gate
    dtype) of the routing-plan check: seeded softmax gates at granite-moe's
    prefill groups and decode group at 8 lanes, 16 groups in one launch,
    gates tied to the bit, all mass on one expert (drops), and grok-1's
    E 8 / K 2 at its decode and prefill groups."""
    rng = np.random.default_rng(13)
    E, K = cfg.n_experts, cfg.top_k

    def soft(logits):
        return torch.softmax(torch.from_numpy(np.asarray(
            logits, np.float32)).to(dev), -1)

    bf16 = torch.bfloat16
    cases = [(f"prefill_Lp{lp}", soft(rng.normal(size=(1, lp, E))), K,
              moe_capacity(cfg, lp), bf16) for lp in (16, 128, 256, 512)]
    cases += [("decode_8_lanes", soft(rng.normal(size=(1, SERVE_LANES, E))),
               K, moe_capacity(cfg, SERVE_LANES), bf16),
              ("16_groups", soft(rng.normal(size=(16, 128, E))), K,
               moe_capacity(cfg, 128), bf16),
              ("16_groups_float32", soft(rng.normal(size=(16, 128, E))), K,
               moe_capacity(cfg, 128), torch.float32),
              ("ties", torch.from_numpy((rng.integers(0, 4, size=(
                  2, 256, E)) / 64).astype(np.float32)).to(dev), K,
               moe_capacity(cfg, 256), bf16),
              ("one_expert_drops", soft(np.where(np.arange(E) == 5, 20.0,
                                                 0.0) * np.ones((2, 256, E))),
               K, moe_capacity(cfg, 256), bf16)]
    cases += [(f"grok_E{grok.n_experts}_K{grok.top_k}_{name}",
               soft(rng.normal(size=(g, n, grok.n_experts))), grok.top_k,
               moe_capacity(grok, n), bf16)
              for name, g, n in (("decode", 1, SERVE_LANES),
                                 ("prefill", 4, 256))]
    return cases


def plan_phase(dev, plan, ref, moe_capacity, cfg, grok) -> dict:
    """The routing-plan kernel against its plain version on the card (every
    output equal, the gate sums within 1e-6 relative), and its time (back to
    back, and alone beside the launch floor) and bound at the serve path's
    decode and 256-token prefill groups."""
    from repro_torch.bench.kernel_pair import profiled_ms

    t0 = time.perf_counter()
    sets = []
    for name, gates_full, K, cap, dtype in plan_cases(dev, moe_capacity, cfg,
                                                     grok):
        got = plan.moe_plan(gates_full, K, cap, dtype)
        torch.cuda.synchronize()
        want = ref.plan_ref(gates_full, K, cap, dtype)
        unequal = [k for k in want if k != "gate_sums"
                   and not torch.equal(got[k], want[k])]
        if unequal:
            raise AssertionError(f"routing-plan kernel != plain on {name}: "
                                 f"{unequal}")
        rel = float(((got["gate_sums"] - want["gate_sums"]).abs()
                     / want["gate_sums"].abs().clamp_min(1e-30)).max())
        assert rel <= 1e-6, (name, rel)
        sets.append({"set": name, "shape": list(gates_full.shape), "K": K,
                     "capacity": cap, "gates": str(dtype).split(".")[-1],
                     "dropped": int((~got["kept"]).sum()),
                     "max_abs_err": 0, "gate_sums_max_rel_err": rel})
    timed = {}
    for name, lp in (("decode", None), ("prefill_Lp256", 256)):
        n = SERVE_LANES if lp is None else lp
        cap = moe_capacity(cfg, n)
        gates_full = torch.softmax(torch.from_numpy(np.random.default_rng(
            lp or 0).normal(size=(1, n, cfg.n_experts)).astype(
                np.float32)).to(dev), -1)

        def fn():
            return plan.moe_plan(gates_full, cfg.top_k, cap, torch.bfloat16)

        ms = launch_ms(fn)
        device_ms, floor_ms = profiled_ms(fn, "moe_plan_kernel")
        plain = launch_ms(lambda: ref.plan_ref(gates_full, cfg.top_k, cap,
                                               torch.bfloat16),
                          launches=20)
        # gates_full read once, every output written once; the top-k's
        # compares (E per gate) and one counter step a pair
        bound, bound_by = bound_ms(nbytes([gates_full]) + nbytes(fn().values()),
                                   gates_full.numel() * cfg.n_experts
                                   + n * cfg.top_k)
        timed[name] = {"tokens": n, "E": cfg.n_experts, "K": cfg.top_k,
                       "capacity": cap, "ms": ms, "device_ms": device_ms,
                       "launch_floor_ms": floor_ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": bound_by}
    return {"phase": "moe_plan_kernel_vs_plain",
            "tolerance": "exact; gate_sums rtol 1e-6",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


def serve_prompts(cfg, long: tuple = ()) -> list:
    """The serve traffic's prompts: SERVE_REQUESTS seeded draws of
    SERVE_PROMPT lengths, then one prompt of each length in ``long`` from
    the same draw."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(
        SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))).tolist()
        for _ in range(SERVE_REQUESTS)]
    return prompts + [rng.integers(1, cfg.vocab, size=n).tolist()
                      for n in long]


def timed_serve(ServeEngine, cfg, params, dev, prompts, max_new, kernel,
                max_ctx: int = SERVE_CTX, **modes) -> dict:
    """One engine run over ``prompts`` with the kernel modes ``modes``:
    the engine, its requests, the wall time, each prefill's seconds and
    kernel launches, the launches of the whole run and each request's
    first-token logits (float32, on the host)."""
    eng = ServeEngine(cfg, params, lanes=SERVE_LANES, max_ctx=max_ctx,
                      device=dev, **modes)
    prefill_s, prefill_launches, first = [], [], []
    admit, sample = eng._admit, eng._sample

    def timed_admit(lane, req):
        t, n = time.perf_counter(), kernel.launches
        admit(lane, req)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        prefill_launches.append(kernel.launches - n)

    def recorded_sample(logits):
        if logits.shape[0] == 1:                   # a prefill's first token
            first.append(logits[0].float().cpu())
        return sample(logits)

    eng._admit, eng._sample = timed_admit, recorded_sample
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the wrappers hold the engine's bound methods: a reference cycle that
    # would keep the engine, and the weights it holds, alive past the phase
    del eng._admit, eng._sample
    return {"eng": eng, "reqs": reqs, "wall": wall,
            "prefill_s": prefill_s, "prefill_launches": prefill_launches,
            "launches": kernel.launches, "first_logits": first}


def check_served(run: dict, cfg, n_requests: int) -> None:
    """FIFO admission, every request done with SERVE_NEW in-range tokens,
    a finite first-token logit row each."""
    eng, reqs = run["eng"], run["reqs"]
    assert [r.ticket for r in reqs] == list(range(n_requests))
    for r in reqs:
        assert r.done.is_set() and len(r.tokens_out) == SERVE_NEW, r.rid
        assert all(0 <= t < cfg.vocab for t in r.tokens_out), r.rid
    adm = [r.admitted_at_step for r in reqs]
    assert adm == sorted(adm), adm                   # admitted in ticket order
    assert eng.prefill_count == n_requests
    assert len(run["first_logits"]) == n_requests
    for row in run["first_logits"]:
        assert bool(torch.isfinite(row[:cfg.vocab]).all())


def serve_times(run: dict) -> dict:
    """Tokens/s, prefill ms per request and decode ms per step of a run."""
    n_tok = sum(len(r.tokens_out) for r in run["reqs"])
    prefill = sum(run["prefill_s"])
    return {"wall_s": run["wall"], "tokens_per_s": n_tok / run["wall"],
            "prefill_ms_per_request": 1e3 * prefill / len(run["prefill_s"]),
            "decode_ms_per_step":
                1e3 * (run["wall"] - prefill) / run["eng"].step_count}


def serve_phase(dev, cfg, params, ServeEngine, plan, ticket) -> dict:
    """Serve SERVE_REQUESTS requests at full width, first through the
    routing-plan kernel (``dispatch="auto"``), then through the ticket
    kernel (``dispatch="ticket"``) and with ``dispatch="torch"``; the tokens
    must be equal."""
    prompts = serve_prompts(cfg)
    counters = {"auto": plan, "ticket": ticket, "torch": plan}

    def run(dispatch, max_new):
        return timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                           counters[dispatch], dispatch=dispatch)

    t0 = time.perf_counter()
    for dispatch in counters:           # warm-up: allocator, GEMM plans
        run(dispatch, 2)
    torch.cuda.reset_peak_memory_stats()
    auto = run("auto", SERVE_NEW)
    peak = torch.cuda.max_memory_allocated()
    eng, launches = auto["eng"], auto["launches"]
    check_served(auto, cfg, SERVE_REQUESTS)
    want = cfg.n_layers * (eng.prefill_count + eng.step_count)
    assert launches == want, (launches, want)
    stats = eng.stats()
    unfused = run("ticket", SERVE_NEW)
    assert unfused["launches"] == want, (unfused["launches"], want)
    plain = run("torch", SERVE_NEW)
    assert plain["launches"] == 0, plain["launches"]
    tokens = [r.tokens_out for r in auto["reqs"]]
    for name, other in (("ticket", unfused), ("torch", plain)):
        o_tokens = [r.tokens_out for r in other["reqs"]]
        if o_tokens != tokens:
            bad = [i for i, (a, b) in enumerate(zip(tokens, o_tokens))
                   if a != b]
            raise AssertionError(f"tokens with the routing-plan kernel "
                                 f"differ from dispatch={name!r} on "
                                 f"requests {bad}")
        assert other["eng"].step_count == eng.step_count
    times = serve_times(auto)
    return {"phase": "serve", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "experts": cfg.n_experts,
            "top_k": cfg.top_k, "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": SERVE_CTX, "gate": stats["lock"],
            "prefills": eng.prefill_count, "decode_steps": eng.step_count,
            "plan_launches": launches,
            "ticket_launches": unfused["launches"],
            "tokens_bit_identical": True,
            **times, "prefill_ms": [1e3 * t for t in auto["prefill_s"]],
            **{f"{name}_dispatch": {k: serve_times(run_)[k] for k in (
                "wall_s", "prefill_ms_per_request", "decode_ms_per_step")}
               for name, run_ in (("ticket", unfused), ("plain", plain))},
            "peak_memory_bytes": peak,
            "admission": {k: v for k, v in stats.items() if k != "lock"},
            "seconds": time.perf_counter() - t0}


def margin_rule(auto: dict, plain: dict, cfg) -> dict:
    """First tokens of a kernel run (float32 state) against a plain run
    (bf16 state): they must agree wherever the plain run's top-2 margin
    exceeds twice the largest first-token logit difference, since tokens
    may part only where logits nearly tie.  Returns the differences and
    the counts of decided, equal first tokens and equal streams."""
    diffs = [float((a - b)[:cfg.vocab].abs().max())
             for a, b in zip(auto["first_logits"], plain["first_logits"])]
    delta = max(diffs)
    decided, agree = 0, 0
    for a_req, p_req, row in zip(auto["reqs"], plain["reqs"],
                                 plain["first_logits"]):
        top2 = torch.topk(row[:cfg.vocab], 2).values
        if float(top2[0] - top2[1]) > 2 * delta:
            decided += 1
            assert a_req.tokens_out[0] == p_req.tokens_out[0], a_req.rid
        agree += a_req.tokens_out[0] == p_req.tokens_out[0]
    streams = sum(a.tokens_out == b.tokens_out
                  for a, b in zip(auto["reqs"], plain["reqs"]))
    return {"first_logit_max_abs_diff": delta,
            "first_logit_max_abs_diff_per_request": diffs,
            "first_tokens_decided_by_margin": decided,
            "first_tokens_equal": int(agree),
            "token_streams_equal": int(streams)}


def serve_mamba_phase(dev, cfg, params, ServeEngine, kernel) -> dict:
    """Serve the same traffic on falcon-mamba-7b at full width through the
    scan kernel (``scan="auto"``): each prefill launches it once per layer,
    decode never.  Then the same prompts with ``scan="torch"``, the plain
    loop in bf16, held to :func:`margin_rule`."""
    prompts = serve_prompts(cfg)

    def run(scan, max_new):
        return timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                           kernel, scan=scan)

    t0 = time.perf_counter()
    run("auto", 2)                      # warm-up: allocator, GEMM plans
    torch.cuda.reset_peak_memory_stats()
    auto = run("auto", SERVE_NEW)
    peak = torch.cuda.max_memory_allocated()
    eng = auto["eng"]
    check_served(auto, cfg, SERVE_REQUESTS)
    assert auto["prefill_launches"] == [cfg.n_layers] * SERVE_REQUESTS, \
        auto["prefill_launches"]
    # every launch came from a prefill: decode launched none
    assert auto["launches"] == sum(auto["prefill_launches"]) \
        == cfg.n_layers * SERVE_REQUESTS, auto["launches"]
    stats = eng.stats()
    t_plain = time.perf_counter()
    plain = run("torch", SERVE_NEW)
    plain_s = time.perf_counter() - t_plain
    assert plain["launches"] == 0, plain["launches"]
    check_served(plain, cfg, SERVE_REQUESTS)
    margins = margin_rule(auto, plain, cfg)
    times, p_times = serve_times(auto), serve_times(plain)
    return {"phase": "serve_mamba", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "d_inner": cfg.d_inner,
            "ssm_state": cfg.ssm_state, "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": SERVE_CTX, "gate": stats["lock"],
            "prefills": eng.prefill_count, "decode_steps": eng.step_count,
            "scan_launches": auto["launches"], "decode_scan_launches": 0,
            **times, "prefill_ms": [1e3 * t for t in auto["prefill_s"]],
            "peak_memory_bytes": peak,
            "plain_scan": {"requests": SERVE_REQUESTS, "seconds": plain_s,
                           **{k: p_times[k] for k in (
                               "wall_s", "prefill_ms_per_request",
                               "decode_ms_per_step")}},
            **margins,
            "admission": {k: v for k, v in stats.items() if k != "lock"},
            "seconds": time.perf_counter() - t0}


def serve_griffin_phase(dev, cfg, params, ServeEngine, kernel) -> dict:
    """Serve the shared traffic plus the two long requests on
    recurrentgemma-9b at full width through the RG-LRU kernel
    (``scan="auto"``): each prefill launches it once per RG-LRU layer,
    decode never.  Then the same prompts with ``scan="torch"``, the plain
    loop in bf16, held to :func:`margin_rule`."""
    prompts = serve_prompts(cfg, GRIFFIN_LONG)
    n_req = len(prompts)
    n_rglru = cfg.layer_kinds().count("rglru")

    def run(scan, max_new):
        return timed_serve(ServeEngine, cfg, params, dev, prompts, max_new,
                           kernel, max_ctx=GRIFFIN_CTX, scan=scan)

    t0 = time.perf_counter()
    run("auto", 2)                      # warm-up: allocator, GEMM plans
    torch.cuda.reset_peak_memory_stats()
    auto = run("auto", SERVE_NEW)
    peak = torch.cuda.max_memory_allocated()
    eng = auto["eng"]
    check_served(auto, cfg, n_req)
    assert auto["prefill_launches"] == [n_rglru] * n_req, \
        auto["prefill_launches"]
    # every launch came from a prefill: decode launched none
    assert auto["launches"] == sum(auto["prefill_launches"]) \
        == n_rglru * n_req, auto["launches"]
    stats = eng.stats()
    t_plain = time.perf_counter()
    plain = run("torch", SERVE_NEW)
    plain_s = time.perf_counter() - t_plain
    assert plain["launches"] == 0, plain["launches"]
    check_served(plain, cfg, n_req)
    margins = margin_rule(auto, plain, cfg)
    times, p_times = serve_times(auto), serve_times(plain)
    n_short = SERVE_REQUESTS
    prefill_ms = [1e3 * t for t in auto["prefill_s"]]
    return {"phase": "serve_griffin", "entry": "repro_torch.serve.ServeEngine",
            "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
            "rglru_layers": n_rglru, "d_model": cfg.d_model,
            "lru_width": cfg.lru_width, "window": cfg.window,
            "vocab": cfg.vocab,
            "params": sum(v.numel() for v in _leaves(params)),
            "param_count_formula": cfg.param_count(),
            "requests": n_req, "new_tokens": SERVE_NEW,
            "prompt_lengths": [len(p) for p in prompts],
            "lanes": SERVE_LANES, "max_ctx": GRIFFIN_CTX,
            "gate": stats["lock"], "prefills": eng.prefill_count,
            "decode_steps": eng.step_count,
            "rglru_launches": auto["launches"], "decode_rglru_launches": 0,
            **times, "prefill_ms": prefill_ms,
            "prefill_ms_per_short_request": float(np.mean(
                prefill_ms[:n_short])),
            "prefill_ms_long": prefill_ms[n_short:],
            "peak_memory_bytes": peak,
            "plain_scan": {"requests": n_req, "seconds": plain_s,
                           **{k: p_times[k] for k in (
                               "wall_s", "prefill_ms_per_request",
                               "decode_ms_per_step")},
                           "prefill_ms_long": [1e3 * t for t in
                                               plain["prefill_s"][n_short:]]},
            **margins,
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


def _to(tree, dev):
    """A parameter or cache tree with every tensor moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def small_model_phase(dev, cfg, model, kernel, launches_per_pass) -> dict:
    """A reduced float32 model on the card (its kernel) against the same
    weights on the CPU (plain versions): prefill logits and two decode
    steps, the kernel launched ``launches_per_pass[i]`` times in pass i.
    Tolerance rtol = atol = 1e-4: float32 sums run in another order on the
    card (TF32 is off)."""
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    on_card = _to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 40)))
    steps = [(torch.tensor([[5], [9]]), torch.tensor([40, 17])),
             (torch.tensor([[7], [11]]), torch.tensor([41, 18]))]

    def grow(cache):
        """The prefill cache with room for 40 more positions in the keys
        and values of global attention layers; a sliding-window layer's
        ring (the prompt is longer than the window) and state leaves stay
        as they are."""
        def more(kind, k, v, dim):
            if kind != "global" or k not in ("k", "v"):
                return v
            return torch.cat([v, torch.zeros_like(v)], dim=dim)
        return {"stack": {j: {k: more(cfg.layer_pattern[int(j[4:])], k, v, 2)
                              for k, v in slot.items()}
                          for j, slot in cache["stack"].items()},
                "tail": [{k: more(kind, k, v, 1) for k, v in layer.items()}
                         for kind, layer in zip(cfg.tail_kinds,
                                                cache["tail"])]}

    def prefill_and_steps(p, device):
        counts = []
        n = kernel.launches
        logits, _, cache = model.forward(p, {"tokens": tokens.to(device)},
                                         cfg, collect_cache=True)
        outs = [logits.cpu()]
        counts.append(kernel.launches - n)
        cache = grow(cache)
        for tok, pos in steps:
            n = kernel.launches
            d_logits, cache = model.decode_step(p, cache, tok.to(device),
                                                pos.to(device), cfg)
            outs.append(d_logits.cpu())
            counts.append(kernel.launches - n)
        return outs, counts

    card, launches = prefill_and_steps(on_card, dev)
    assert launches == list(launches_per_pass), launches
    host, host_launches = prefill_and_steps(params, torch.device("cpu"))
    assert host_launches == [0, 0, 0], host_launches
    errs = []
    for a, b in zip(card, host):
        assert torch.isfinite(a[..., :cfg.vocab]).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        errs.append(float((a - b).abs()[..., :cfg.vocab].max()))
    return {"arch": cfg.name + " reduced", "dtype": cfg.dtype,
            "tolerance": "rtol=atol=1e-4 vs the CPU",
            "passes": ["prefill", "decode", "decode"], "max_abs_err": errs,
            "launches": launches}


def scan_cases(dev) -> list:
    """(name, float32 inputs on the card, dtype) of the scan check:
    falcon-mamba-7b's full-width prefill (L 256, D 8,192, N 16) in bf16 and
    float32, the reference tests' shapes, L 1 and 33, D 20, N 4 and 8, a
    batch of 2 with h0 shared and per sequence, and mixed dtypes (float32
    A and D_skip, bf16 rest)."""
    rng = np.random.default_rng(21)

    def draw(L, D, N, lead=(), per_seq=False, h0=False):
        own = lead if per_seq else ()
        arrays = [rng.normal(size=lead + (L, D)),
                  rng.uniform(0.01, 0.2, size=lead + (L, D)),
                  -rng.uniform(0.5, 2.0, size=own + (D, N)),
                  rng.normal(size=lead + (L, N)),
                  rng.normal(size=lead + (L, N)), rng.normal(size=own + (D,)),
                  rng.normal(size=own + (D, N)) if h0 else None]
        return [None if a is None else torch.from_numpy(
            a.astype(np.float32)).to(dev) for a in arrays]

    cases = [("prefill_L256_D8192_N16_bf16", draw(256, 8192, 16), "bf16"),
             ("prefill_L256_D8192_N16_f32", draw(256, 8192, 16), "f32")]
    cases += [(f"L{L}_D{D}_N{N}_{dt}", draw(L, D, N), dt)
              for L, D, N, dt in ((16, 8, 4, "f32"), (100, 96, 16, "f32"),
                                  (256, 128, 16, "f32"), (33, 20, 8, "f32"),
                                  (64, 64, 16, "bf16"), (1, 40, 16, "f32"),
                                  (1, 8192, 16, "bf16"), (33, 40, 16, "bf16"),
                                  (70, 20, 4, "f32"), (70, 20, 8, "f32"))]
    cases += [("batch2_h0_shared", draw(40, 24, 8, (2,), h0=True), "f32"),
              ("batch2_h0_per_seq", draw(40, 24, 8, (2,), True, True),
               "bf16"),
              ("mixed_dtypes", draw(50, 30, 16), "mixed")]
    return cases


def as_dtype(args, dtype: str) -> list:
    """The inputs all in ``dtype`` ("f32", "bf16"), or bf16 with float32 A
    and D_skip ("mixed")."""
    return [None if a is None else
            a.to(torch.bfloat16) if dtype == "bf16" or (
                dtype == "mixed" and i not in (2, 5)) else a
            for i, a in enumerate(args)]


def scan_phase(dev, kernel, ref) -> dict:
    """The scan kernel against the plain loop on float32 casts of its
    inputs (rtol = atol = 1e-5 for float32 inputs, 5e-2 otherwise), the
    h0 threading, and its time and bound at the full-width prefill."""
    from repro_torch.bench.kernel_pair import profiled_ms

    t0 = time.perf_counter()
    sets = []
    cases = scan_cases(dev)
    for name, f32_args, dtype in cases:
        args = as_dtype(f32_args, dtype)
        y, h = kernel.selective_scan(*args)
        torch.cuda.synchronize()
        assert y.dtype == h.dtype == args[0].dtype, name
        ry, rh = ref.selective_scan_ref(*(None if a is None else a.float()
                                          for a in args))
        tol = 1e-5 if dtype == "f32" else 5e-2
        for got, want in ((y, ry), (h, rh)):
            assert bool(torch.isfinite(got).all()), name
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                       msg=name)
        sets.append({"set": name, "shape": list(args[0].shape),
                     "N": args[2].shape[-1], "dtype": dtype,
                     "tolerance": tol,
                     "max_abs_err": max(float((y.float() - ry).abs().max()),
                                        float((h.float() - rh).abs().max()))})
    # h0 threads through: two halves equal one scan (float32, L 100)
    x, dt, A, B, C, Dsk, _ = cases[3][1]
    y_full, h_full = ref.selective_scan_ref(x, dt, A, B, C, Dsk)
    y_a, h_a = kernel.selective_scan(x[:37], dt[:37], A, B[:37], C[:37],
                                     Dsk)
    y_b, h_b = kernel.selective_scan(x[37:], dt[37:], A, B[37:], C[37:],
                                     Dsk, h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)
    sets.append({"set": "two_halves_L100", "tolerance": 1e-5,
                 "max_abs_err": max(
                     float((torch.cat([y_a, y_b]) - y_full).abs().max()),
                     float((h_b - h_full).abs().max()))})
    # time and bound at the full-width prefill, bf16 as the serve runs it
    args = as_dtype(cases[0][1], "bf16")[:6]
    ms = launch_ms(lambda: kernel.selective_scan(*args))
    device_ms, floor_ms = profiled_ms(lambda: kernel.selective_scan(*args),
                                      "mamba_scan_kernel")
    plain_ms = launch_ms(lambda: ref.selective_scan_ref(*args), launches=3,
                         repeats=3)
    L, D = args[0].shape
    N = args[2].shape[-1]
    out = kernel.selective_scan(*args)
    bound, bound_by = bound_ms(nbytes(args) + nbytes(out),
                               7 * L * D * N + 2 * L * D)
    return {"phase": "scan_kernel_vs_plain",
            "tolerance": "rtol=atol=1e-5 (float32 inputs), 5e-2 (bf16)",
            "seconds": time.perf_counter() - t0, "sets": sets,
            "lanes_per_channel": kernel.LANES,
            "timed": {"shape": [L, D, N], "dtype": "bf16", "ms": ms,
                      "device_ms": device_ms, "launch_floor_ms": floor_ms,
                      "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}}


def rglru_cases(dev) -> list:
    """(name, float32 (a, b, h0) on the card, dtype) of the RG-LRU check:
    recurrentgemma-9b's full-width prefills (L 256 and 2,600, D 4,096) in
    bf16 and float32, the reference tests' shapes, L 1, 31 and 65, D 20,
    70 and 129 (ragged), a batch of 3 with h0 per sequence and of 2 with
    h0 shared, and mixed dtypes (float32 a, bf16 b and h0)."""
    rng = np.random.default_rng(22)

    def draw(L, D, lead=(), h0=None):
        arrays = [rng.uniform(0.3, 0.999, size=lead + (L, D)),
                  rng.normal(size=lead + (L, D)),
                  None if h0 is None else rng.normal(size=h0)]
        return [None if a is None else torch.from_numpy(
            a.astype(np.float32)).to(dev) for a in arrays]

    cases = [(f"prefill_L{L}_D4096_bf16", draw(L, 4096), "bf16")
             for L in GRIFFIN_PREFILL_L]
    cases += [("prefill_L256_D4096_f32", draw(256, 4096), "f32")]
    cases += [(f"L{L}_D{D}_{dt}", draw(L, D), dt)
              for L, D, dt in ((16, 8, "f32"), (100, 96, "f32"),
                               (256, 256, "f32"), (33, 20, "f32"),
                               (128, 64, "bf16"), (1, 20, "f32"),
                               (31, 70, "bf16"), (65, 129, "f32"))]
    cases += [("batch3_h0_per_seq", draw(40, 24, (3,), (3, 24)), "f32"),
              ("batch2_h0_shared", draw(40, 24, (2,), (24,)), "bf16"),
              ("mixed_dtypes", draw(50, 30, (), (30,)), "mixed")]
    return cases


def rglru_phase(dev, kernel, ref) -> dict:
    """The RG-LRU kernel against the plain loop on float32 casts of its
    inputs (equal for float32 inputs, rtol = atol = 5e-2 otherwise), and
    within one ulp of the output's dtype of that loop rounded to it: a
    float32 state rounds only at the output.  At both full-width bf16
    prefills the bf16-state loop must fall outside that ulp limit, so the
    limit tells the two states apart.  Also the h0 threading, and the
    kernel's time and bound at both full-width prefills."""
    from repro_torch.bench.kernel_pair import outside_one_ulp, profiled_ms

    t0 = time.perf_counter()
    sets = []
    cases = rglru_cases(dev)
    for name, f32_args, dtype in cases:
        args = [None if a is None else a.to(torch.bfloat16)
                if dtype == "bf16" or (dtype == "mixed" and i > 0) else a
                for i, a in enumerate(f32_args)]
        y, h = kernel.rglru_scan(*args)
        torch.cuda.synchronize()
        assert y.dtype == h.dtype == args[0].dtype, name
        ry, rh = ref.rglru_scan_ref(*(None if a is None else a.float()
                                      for a in args))
        tol = 1e-5 if dtype == "f32" else 5e-2
        for got, want in ((y, ry), (h, rh)):
            assert bool(torch.isfinite(got).all()), name
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                       msg=name)
            assert outside_one_ulp(got, want) == 0.0, name
            # the product and the sum rounded apart, as the loop does
            assert dtype != "f32" or torch.equal(got, want), name
        sets.append({"set": name, "shape": list(args[0].shape),
                     "dtype": dtype, "tolerance": tol,
                     "max_abs_err": max(float((y.float() - ry).abs().max()),
                                        float((h.float() - rh).abs().max())),
                     "max_abs_err_rounded": max(
                         float((y.float() - ry.to(y.dtype).float()).abs()
                               .max()),
                         float((h.float() - rh.to(h.dtype).float()).abs()
                               .max()))})
    # h0 threads through: two halves equal one scan (float32, L 100)
    a, b, _ = cases[len(GRIFFIN_PREFILL_L) + 2][1]
    y_full, h_full = ref.rglru_scan_ref(a, b)
    y_a, h_a = kernel.rglru_scan(a[:37], b[:37])
    y_b, h_b = kernel.rglru_scan(a[37:], b[37:], h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)
    sets.append({"set": "two_halves_L100", "tolerance": 1e-5,
                 "max_abs_err": max(
                     float((torch.cat([y_a, y_b]) - y_full).abs().max()),
                     float((h_b - h_full).abs().max()))})
    # time and bound at both full-width prefills, bf16 as the serve runs it
    timed = {}
    for (name, f32_args, _), L in zip(cases, GRIFFIN_PREFILL_L):
        a, b = (t.to(torch.bfloat16) for t in f32_args[:2])
        ms = launch_ms(lambda: kernel.rglru_scan(a, b))
        device_ms, floor_ms = profiled_ms(lambda: kernel.rglru_scan(a, b),
                                          "rglru_scan_kernel")
        plain_ms = launch_ms(lambda: ref.rglru_scan_ref(a, b), launches=1,
                             repeats=3)
        out = kernel.rglru_scan(a, b)
        ry, _ = ref.rglru_scan_ref(a.float(), b.float())
        bf16_state = outside_one_ulp(ref.rglru_scan_ref(a, b)[0], ry)
        assert outside_one_ulp(out[0], ry) == 0.0 < bf16_state, name
        # a and b read once, y and h_final written once (no h0 is read);
        # one multiply and one add per element
        bound, bound_by = bound_ms(nbytes((a, b)) + nbytes(out),
                                   2 * a.numel())
        timed[f"L{L}"] = {"shape": list(a.shape), "dtype": "bf16", "ms": ms,
                          "device_ms": device_ms,
                          "launch_floor_ms": floor_ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "bf16_state_loop_outside_one_ulp": bf16_state}
    return {"phase": "rglru_kernel_vs_plain",
            "tolerance": "equal (float32 inputs), rtol=atol=5e-2 (bf16); "
                         "one ulp of the output's dtype from the float32 "
                         "loop rounded to it",
            "block": {"channels": kernel.CHANNELS, "threads": kernel.THREADS,
                      "warps": ["chain", "copy", "store"]},
            "ring": {"stages": kernel.STAGES, "steps_per_stage": kernel.STEPS,
                     "smem_bytes_bf16": kernel.smem_bytes(True, True)},
            "seconds": time.perf_counter() - t0, "sets": sets,
            "timed": timed}


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
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
    from repro_torch.kernels.ticket_dispatch import plan as plan_kernel
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
    smi = query_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libraries = ["lockvm", "ticket_dispatch", "mamba_scan", "rglru_scan",
                 "moe_plan"]
    _build.load_libraries(libraries)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_logs.get(name, "")
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in libraries}
    assert ticket_kernel.smem_bytes_from_kernel(32) == \
        ticket_kernel.smem_bytes(32)
    for args in ((32, 8, 8), (32, 512, 8), (32, 5000, 8), (8, 256, 2),
                 (32, 1, 32)):
        assert plan_kernel.smem_bytes_from_kernel(*args) == \
            plan_kernel.smem_bytes(*args), args
    for mask in range(8):
        assert rglru_kernel.smem_bytes_from_kernel(mask) == \
            rglru_kernel.smem_bytes(bool(mask & 1), bool(mask & 2)), mask
    n_fig3_threads = max(FIG3_THREADS)
    mem64 = sim.Layout(n_threads=n_fig3_threads, n_locks=1).mem_words
    words = engine_cuda.state_words_from_kernel(n_fig3_threads, mem64, 1)
    assert 4 * words == engine_cuda.cell_state_bytes(n_fig3_threads, mem64), \
        (words, engine_cuda.cell_state_bytes(n_fig3_threads, mem64))
    emit({"phase": "build", "card": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": build_s, "ptxas": ptxas,
          "ticket_smem_bytes_E32": ticket_kernel.smem_bytes(32),
          "plan_smem_bytes_E32_K8_Lp512": plan_kernel.smem_bytes(32, 512, 8),
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
    # 130 threads: past the 128 the kernel keeps in registers (rows in
    # shared memory)
    wide_specs = [sim.SweepSpec(locks=("ticket", "twa"), threads=(130,),
                                seeds=1, horizon=600, collect_latency=True)]
    sets = [("faults", fault_specs), ("rows_in_memory_T130", wide_specs),
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
    # the kernel alone on the main path's inputs (device time), and the SM
    # clock sampled while it runs
    main_args, n_locks = spec_inputs(specs)
    main_ms, main_out = cuda_ms(lambda: engine_cuda.run_cells(
        *main_args, n_locks=n_locks), repeats=3)
    assert np.array_equal(main_out["events"].cpu().numpy(), events)
    engine_cuda.run_cells(*main_args, n_locks=n_locks)
    sm_clock = query_smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    us_per_event = main_ms * 1e3 / int(events.max())
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
          "us_per_event_longest_cell": us_per_event,
          "sm_clock_during_kernel": sm_clock,
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
    plan = plan_phase(dev, plan_kernel, ticket_ref, moe_capacity, cfg,
                      get_config(GROK_ARCH))
    emit(plan)

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
    served = serve_phase(dev, cfg, params, ServeEngine, plan_kernel,
                         ticket_kernel)
    served["init_params_s"] = init_s
    small = cfg.reduced()
    served["small_model"] = small_model_phase(
        dev, small, model, plan_kernel, [small.n_layers] * 3)
    emit(served)
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. the scan kernel against its plain version
    scan = scan_phase(dev, scan_kernel, scan_ref)
    emit(scan)

    # ---- 8. serve falcon-mamba-7b at full width
    t0 = time.perf_counter()
    mcfg = get_config(MAMBA_ARCH)
    params = model.init_params(mcfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mamba = serve_mamba_phase(dev, mcfg, params, ServeEngine, scan_kernel)
    mamba["init_params_s"] = init_s
    small = mcfg.reduced()
    mamba["small_model"] = small_model_phase(dev, small, model, scan_kernel,
                                             [small.n_layers, 0, 0])
    emit(mamba)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. the RG-LRU kernel against its plain version
    rglru = rglru_phase(dev, rglru_kernel, rglru_ref)
    emit(rglru)

    # ---- 10. serve recurrentgemma-9b at full width
    t0 = time.perf_counter()
    gcfg = get_config(GRIFFIN_ARCH)
    params = model.init_params(gcfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    griffin = serve_griffin_phase(dev, gcfg, params, ServeEngine,
                                  rglru_kernel)
    griffin["init_params_s"] = init_s
    small = gcfg.reduced()
    griffin["small_model"] = small_model_phase(
        dev, small, model, rglru_kernel,
        [small.layer_kinds().count("rglru"), 0, 0])
    emit(griffin)
    del params

    bound, bound_by = bound_ms(reduced["bytes"], reduced["sum_events"])
    dec = ticket["timed"]["decode"]
    pre = ticket["timed"]["prefill_Lp256"]
    pdec = plan["timed"]["decode"]
    ppre = plan["timed"]["prefill_Lp256"]
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
        "main_path_max_events": int(events.max()),
        "main_path_us_per_event": us_per_event,
        "sm_clock_during_kernel": sm_clock}, {
        "name": "ticket_dispatch_run", "route": "cuda",
        "source": "src/repro_torch/csrc/ticket_dispatch.cu",
        "replaces": "src/repro/kernels/ticket_dispatch/kernel.py:72",
        "launches": served["ticket_launches"],
        "launches_on": "serve, dispatch='ticket'",
        "max_abs_err": max(c["max_abs_err"] for c in ticket["sets"]),
        "ms": dec["ms"], "device_ms": dec["device_ms"],
        "launch_floor_ms": dec["launch_floor_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "timed_on": f"decode group: {dec['arrivals']} arrivals, "
                    f"E={dec['E']}",
        "prefill_Lp256_ms": pre["ms"],
        "prefill_Lp256_device_ms": pre["device_ms"],
        "prefill_Lp256_plain_ms": pre["plain_ms"],
        "prefill_Lp256_bound_ms": pre["bound_ms"]}, {
        "name": "moe_plan_run", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_plan.cu",
        "replaces": "src/repro/kernels/ticket_dispatch/kernel.py:72",
        "launches": served["plan_launches"],
        "launches_on": "serve, dispatch='auto'",
        "max_abs_err": max(c["max_abs_err"] for c in plan["sets"]),
        "gate_sums_max_rel_err": max(c["gate_sums_max_rel_err"]
                                     for c in plan["sets"]),
        "ms": pdec["ms"], "device_ms": pdec["device_ms"],
        "launch_floor_ms": pdec["launch_floor_ms"],
        "plain_ms": pdec["plain_ms"], "bound_ms": pdec["bound_ms"],
        "bound_by": pdec["bound_by"], "library_ms": None,
        "timed_on": f"decode group: {pdec['tokens']} tokens, "
                    f"E={pdec['E']}, K={pdec['K']}",
        "prefill_Lp256_ms": ppre["ms"],
        "prefill_Lp256_device_ms": ppre["device_ms"],
        "prefill_Lp256_plain_ms": ppre["plain_ms"],
        "prefill_Lp256_bound_ms": ppre["bound_ms"]}, {
        "name": "mamba_scan_run", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:94",
        "launches": mamba["scan_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in scan["sets"]),
        "max_abs_err_float32": max(c["max_abs_err"] for c in scan["sets"]
                                   if c["tolerance"] == 1e-5),
        "ms": scan["timed"]["ms"], "device_ms": scan["timed"]["device_ms"],
        "launch_floor_ms": scan["timed"]["launch_floor_ms"],
        "plain_ms": scan["timed"]["plain_ms"],
        "bound_ms": scan["timed"]["bound_ms"],
        "bound_by": scan["timed"]["bound_by"], "library_ms": None,
        "timed_on": "falcon-mamba-7b prefill: L 256, D 8192, N 16, bf16"}, {
        "name": "rglru_scan_run", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:94",
        "launches": griffin["rglru_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in rglru["sets"]),
        "max_abs_err_float32": max(c["max_abs_err"] for c in rglru["sets"]
                                   if c["tolerance"] == 1e-5),
        "ms": rglru["timed"]["L256"]["ms"],
        "device_ms": rglru["timed"]["L256"]["device_ms"],
        "launch_floor_ms": rglru["timed"]["L256"]["launch_floor_ms"],
        "plain_ms": rglru["timed"]["L256"]["plain_ms"],
        "bound_ms": rglru["timed"]["L256"]["bound_ms"],
        "bound_by": rglru["timed"]["L256"]["bound_by"], "library_ms": None,
        "timed_on": "recurrentgemma-9b prefill: L 256, D 4096, bf16",
        "L2600_ms": rglru["timed"]["L2600"]["ms"],
        "L2600_device_ms": rglru["timed"]["L2600"]["device_ms"],
        "L2600_plain_ms": rglru["timed"]["L2600"]["plain_ms"],
        "L2600_bound_ms": rglru["timed"]["L2600"]["bound_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
