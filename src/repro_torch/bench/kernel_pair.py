"""Device time of the port's kernels, and of the MoE layer and the granite
serve around them, for two source trees, on one card, in turns: a parent
tree's and this one's.

    python src/repro_torch/bench/kernel_pair.py --parent PARENT [--out FILE]
        [--parts lockvm,scan,rglru,ticket,moe,serve,conv]

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
  median of at least 50, beside the launch floor of the same session (a
  one-element ``torch.add``);
* the RG-LRU scan kernel at recurrentgemma-9b's prefills, D 4,096 in bf16
  at L 256 and 2,600: device ms of one launch under ``torch.profiler``, the
  median of at least 50, beside the launch floor;
* the ticket kernel at granite-moe-1b-a400m's decode group (64 arrivals)
  and a 256-token prefill group (2,048 arrivals), E 32, and the routing-plan
  kernel, where the tree has it, at the decode group (8 tokens) and a
  256-token prefill group: device ms under ``torch.profiler`` beside the
  launch floor;
* one granite-moe-1b-a400m MoE layer (``layers.moe``, d 1,024, E 32, K 8,
  d_ff 512, bf16, seeded weights) at the decode step (8 lanes) and a
  256-token prefill, as each tree runs it by default: the wall ms per call
  with a synchronise, and its launches per call, split into the routing
  plan's and the rest (:func:`moe_launches`);
* one falcon-mamba-7b layer's causal conv with its bias and SiLU, x the
  in-projection's strided half at S 256, 2,048 and 10,857 x d_inner 8,192
  in bf16: the plain path (the parent's stack of shifted copies, einsum,
  bias and SiLU) in device ms from CUDA events, and the conv kernel, where
  the tree has it, under ``torch.profiler`` beside the launch floor, its
  bytes bound (x read once, y written once, at 3.35 TB/s) and its distance
  from the plain path (``conv_bound``, and the share of elements that
  differ); ``F.conv1d(groups=d_inner)``'s time
  beside them as the library's figure (information only: the port never
  calls it);
* granite-moe-1b-a400m served at full width on ``chip_smoke.py``'s
  traffic (16 requests of 16-256 prompt tokens, 32 new tokens each, 8
  lanes, ``max_ctx`` 512, seeded weights): decode ms a step, prefill ms a
  request and tokens/s.

``--parts`` picks some of these (all by default).

``chip_smoke.py`` times its kernels with this file's ``profiled_ms`` and
holds the RG-LRU kernel to its ``outside_one_ulp`` rule, and the conv
kernel to the plain path by ``conv_bound`` and ``ulps_apart``.

Each child prints one JSON line with its numbers, the card's name, power
limit and SM clock (``nvidia-smi``, sampled while the lockVM kernel runs),
the ptxas report of the build and its outputs' fingerprints; the parent
script checks that both trees' lockVM outputs are identical, that each
scan is within 5e-2 of the plain loop on float32 casts, and that each
RG-LRU output is within one ulp of bf16 of the float32 loop rounded to
bf16 (and equal to it on float32 inputs), and that each conv output is
within ``conv_bound`` of the plain path's and equal to it on all but at
most 1e-5 of the elements, its tail equal, then prints a summary line (and
writes all lines to FILE).  Needs one CUDA device.

    python src/repro_torch/bench/kernel_pair.py --child $PWD

times this tree alone (one child).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

SMI_QUERY = "name,power.limit,clocks.sm,clocks.max.sm"
FIG3_THREADS = (1, 2, 4, 8, 16, 32, 64)
TIMO_THREADS = (1, 2, 4, 8, 16, 32)
SCAN_SHAPE = (256, 8192, 16)
RGLRU_D = 4096
RGLRU_L = (256, 2600)
# granite-moe-1b-a400m's MoE calls (B, S): the decode step at 8 lanes and a
# 256-token prefill
MOE_SHAPES = {"decode": (8, 1), "prefill_Lp256": (1, 256)}
# the ticket kernel's timed groups: granite-moe's decode at 8 lanes and a
# 256-token prefill, 8 arrivals a token
TICKET_ARRIVALS = {"decode": 64, "prefill_Lp256": 2048}
SERVE_ARCH = "granite-moe-1b-a400m"
# falcon-mamba-7b's conv: prompt lengths (256, the code-batch cell's mean
# and longest), d_inner and width
CONV_S = (256, 2048, 10857)
CONV_D, CONV_KW = 8192, 4
HBM_BYTES_PER_MS = 3.35e9        # the H100's 3.35 TB/s
PARTS = ("lockvm", "scan", "rglru", "ticket", "moe", "serve", "conv")
# the runtime calls that launch a kernel, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC",
                "cuLaunchKernel")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def profiled_ms(fn, kernel_name: str, launches: int = 50,
                spare: int = 10) -> tuple[float, float]:
    """Median device time in ms of the kernels named ``kernel_name`` over
    ``launches`` calls of ``fn`` under ``torch.profiler``: the kernel alone,
    where back-to-back calls of a short kernel time the host's wrapper.
    The session makes ``spare`` calls more, since a second profiler session
    in one process has reported all but a few of its launches; at least
    ``launches`` must be reported, and a session that reports fewer (one
    has reported none) is run again, up to three times.  Returned with it:
    the launch floor, the
    median device time of a one-element ``torch.add`` called after each
    ``fn`` in the same session (a yardstick: the port never calls it)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    one = torch.ones(1, device="cuda")
    out = torch.empty_like(one)
    fn()
    torch.add(one, one, out=out)
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches + spare):
                fn()
                torch.add(one, one, out=out)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        times = [e.device_time for e in kernels if kernel_name in e.name]
        floor = [e.device_time for e in kernels
                 if kernel_name not in e.name and "add" in e.name.lower()]
        if all(launches <= len(got) <= launches + spare
               for got in (times, floor)):
            return (float(np.median(times)) / 1e3,
                    float(np.median(floor)) / 1e3)
        counts.append((len(times), len(floor)))
    raise AssertionError(f"{kernel_name}: the profiler reported (kernel, "
                         f"floor) launches {counts} of {launches + spare}")


def moe_inputs(cfg, dev) -> tuple[dict, dict]:
    """One MoE layer's weights at ``cfg``'s full width and its inputs at
    :data:`MOE_SHAPES`, in the model's dtype, from a seeded numpy draw (the
    same in every tree)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(17)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    dtype = getattr(torch, cfg.dtype)

    def draw(*shape, scale=0.02):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev, dtype)

    p = {"router": draw(d, E), "wi": draw(E, d, ff), "wg": draw(E, d, ff),
         "wo": draw(E, ff, d)}
    return p, {name: draw(B, S, d, scale=1.0)
               for name, (B, S) in MOE_SHAPES.items()}


def moe_launches(fn) -> dict:
    """The kernel launches of one call of ``fn`` (a ``layers.moe`` call)
    under ``torch.profiler``, split into the routing plan's and the rest:
    the plan's are those the host makes between the end of the router's
    softmax and the start of the first ``aten::gather`` after it (the D-wide
    gather of the tokens into the expert buffers).  Also the host µs
    between the two (under the profiler, which adds its own cost to every
    op) and the count of plan launches by the outermost op that made
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    launches = [e for e in cpu if e.name in LAUNCH_CALLS]
    soft_end = max(e.time_range.end for e in cpu if "softmax" in e.name)
    gather_start = min(e.time_range.start for e in cpu
                       if e.name == "aten::gather"
                       and e.time_range.start >= soft_end)
    plan = [e for e in launches
            if soft_end <= e.time_range.start < gather_start]
    by_op: dict = {}
    for e in plan:
        op = e
        while op.cpu_parent is not None:
            op = op.cpu_parent
        by_op[op.name] = by_op.get(op.name, 0) + 1
    return {"launches": len(launches), "plan_launches": len(plan),
            "other_launches": len(launches) - len(plan),
            "plan_host_us_profiled": gather_start - soft_end,
            "plan_launches_by_op": by_op}


def wall_ms(fn, calls: int = 50) -> float:
    """Median host ms of ``fn()`` followed by a synchronise."""
    import time

    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def outside_one_ulp(got, want) -> float:
    """Share of ``got``'s elements more than one ulp of its dtype (rtol =
    the dtype's eps, atol 1e-6) from the float32 ``want`` rounded to that
    dtype."""
    import torch

    r = want.to(got.dtype).float()
    limit = 1e-6 + torch.finfo(got.dtype).eps * r.abs()
    return float(((got.float() - r).abs() > limit).float().mean())


def ulps_apart(a, b):
    """Elementwise distance of a and b (both float32 or both bf16) in steps
    of their dtype: 0 for equal values, +0 and -0 alike."""
    import torch

    bits, itype = {torch.bfloat16: (16, torch.int16),
                   torch.float32: (32, torch.int32)}[a.dtype]

    def ordered(t):
        i = t.view(itype).long()
        return torch.where(i < 0, -(i & ((1 << (bits - 1)) - 1)), i)

    return (ordered(a) - ordered(b)).abs()


def conv_bound(x, w, b, want):
    """The tolerance of the conv kernel against its plain version,
    elementwise, for x in float32 or bf16 (unit roundoff u_d: 2^-24 or
    2^-8).  The two differ in the order of the conv's float32 sum (and, on
    the CPU, in whether each product is rounded first), which moves it by
    at most 2 kw u (sum_k |w_k x_k|), u = 2^-24; its rounding to the dtype
    and that of the bias added may then go either way, at most 4 u_d
    (sum_k |w_k x_k| + |b|) in all; the SiLU's slope is at most 1.1; and
    the two SiLUs' exponentials may differ in their last bits, which 4 ulps
    of the output cover.  One ulp of the output says nothing where the sum
    cancels the bias."""
    import torch
    import torch.nn.functional as F

    S, kw = x.shape[1], w.shape[1]
    u = 2.0 ** -24
    u_d = 2.0 ** -8 if x.dtype == torch.bfloat16 else u
    xpad = F.pad(x.double(), (0, 0, kw - 1, 0))
    terms = sum((xpad[:, k:k + S] * w[:, k].double()).abs()
                for k in range(kw)) + b.double().abs()
    y = want.abs()
    ulp = (torch.nextafter(y, torch.full_like(y, float("inf"))) - y).double()
    return 1.1 * (2 * kw * u + 4 * u_d) * terms + 4 * ulp


def events_ms(fn, calls: int = 20, repeats: int = 3) -> float:
    """Device ms a call of ``fn``: CUDA events around ``calls`` calls back
    to back, the median of ``repeats``, after a warm-up call."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def plain_conv(x, w, b):
    """The Mamba mixer's conv as the parent's ``mamba_block`` computes it:
    the pad, kw shifted copies stacked, the einsum, the bias, the SiLU, and
    the tail copied out."""
    import torch
    import torch.nn.functional as F

    S, kw = x.shape[1], w.shape[1]
    xpad = F.pad(x, (0, 0, kw - 1, 0))
    shifted = torch.stack([xpad[:, i:i + S] for i in range(kw)], dim=3)
    conv = torch.einsum("bsdk,dk->bsd", shifted, w) + b
    return F.silu(conv), xpad[:, -(kw - 1):].clone()


def conv_times(dev) -> dict:
    """One falcon-mamba-7b layer's conv at :data:`CONV_S`, bf16: the plain
    path, the kernel where the tree has it, the bytes bound and the
    library's figure."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    have = importlib.util.find_spec(
        "repro_torch.kernels.causal_conv") is not None
    if have:
        from repro_torch.kernels.causal_conv import kernel as conv_kernel
    out = {}
    for S in CONV_S:
        rng = np.random.default_rng(S)

        def draw(*shape, scale=1.0):
            return torch.from_numpy((rng.normal(size=shape) * scale).astype(
                np.float32)).to(dev, torch.bfloat16)

        # x is the in-projection's first half, read in place as the model
        # reads it
        x = draw(1, S, 2 * CONV_D).chunk(2, -1)[0]
        w, b = draw(CONV_D, CONV_KW, scale=0.5), draw(CONV_D, scale=0.1)
        xt = x.transpose(1, 2).contiguous()
        w3 = w[:, None, :].contiguous()
        nbytes = 2 * (2 * S * CONV_D + (CONV_KW - 1) * CONV_D
                      + CONV_KW * CONV_D + CONV_D)
        row = {"shape": [1, S, CONV_D], "kw": CONV_KW, "dtype": "bf16",
               "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_MS,
               "plain_ms": events_ms(lambda: plain_conv(x, w, b)),
               "library_ms": events_ms(lambda: F.conv1d(
                   xt, w3, b, padding=CONV_KW - 1, groups=CONV_D))}
        if have:
            def fn():
                return conv_kernel.causal_conv(x, w, b)

            y, tail = fn()
            ry, rtail = plain_conv(x, w, b)
            torch.cuda.synchronize()
            ulps = ulps_apart(y, ry)
            err = (y.double() - ry.double()).abs()
            device_ms, floor_ms = profiled_ms(fn, "causal_conv_kernel")
            row.update({"kernel_ms": device_ms, "launch_floor_ms": floor_ms,
                        "bound_share": row["bound_ms"] / device_ms,
                        "run": conv_kernel.run_length(
                            1, S, CONV_D,
                            torch.cuda.get_device_properties(
                                dev).multi_processor_count),
                        "max_ulps": int(ulps.max()),
                        "differing_share": float((ulps > 0).float().mean()),
                        "within_bound": bool((err <= conv_bound(
                            x, w, b, ry)).all()),
                        "tail_equal": bool(torch.equal(tail, rtail))})
        out[f"S{S}"] = row
    return out


def ticket_times(dev) -> dict:
    """The ticket kernel alone at granite-moe's decode and 256-token prefill
    groups, beside the launch floor; its outputs equal ``dispatch_ref``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ticket_dispatch import kernel, ref
    from repro_torch.models.layers import moe_capacity

    cfg = get_config(SERVE_ARCH)
    out = {}
    E = cfg.n_experts
    for name, n in TICKET_ARRIVALS.items():
        ids = torch.from_numpy(np.random.default_rng(n).integers(
            0, E, size=(1, n)).astype(np.int32)).to(dev)
        cap = moe_capacity(cfg, n // cfg.top_k)
        t, s = kernel.ticket_dispatch(ids, E, cap)
        want = ref.dispatch_ref(ids, E, cap, grouped=True)
        assert torch.equal(t, want[0]) and torch.equal(s, want[1]), name
        device_ms, floor_ms = profiled_ms(
            lambda: kernel.ticket_dispatch(ids, E, cap),
            "ticket_dispatch_kernel")
        out[name] = {"arrivals": n, "E": E, "capacity": cap,
                     "device_ms": device_ms, "launch_floor_ms": floor_ms}
    if importlib.util.find_spec("repro_torch.kernels.ticket_dispatch.plan"):
        out.update(plan_times(dev, cfg, moe_capacity))
    return out


def plan_times(dev, cfg, moe_capacity) -> dict:
    """The routing-plan kernel alone (where the tree has it) at granite-moe's
    decode group and a 256-token prefill group, beside the launch floor;
    its outputs equal ``plan_ref`` but the gate sums."""
    import numpy as np
    import torch

    from repro_torch.kernels.ticket_dispatch import plan, ref

    out = {}
    for name, (B, S) in MOE_SHAPES.items():
        n = B * S
        gates_full = torch.softmax(torch.from_numpy(np.random.default_rng(
            n).normal(size=(1, n, cfg.n_experts)).astype(np.float32)).to(
                dev), -1)
        cap = moe_capacity(cfg, n)

        def fn():
            return plan.moe_plan(gates_full, cfg.top_k, cap, torch.bfloat16)

        got = fn()
        want = ref.plan_ref(gates_full, cfg.top_k, cap, torch.bfloat16)
        assert all(torch.equal(got[k], want[k]) for k in want
                   if k != "gate_sums"), name
        device_ms, floor_ms = profiled_ms(fn, "moe_plan_kernel")
        out[f"plan_{name}"] = {"tokens": n, "E": cfg.n_experts,
                               "K": cfg.top_k, "capacity": cap,
                               "device_ms": device_ms,
                               "launch_floor_ms": floor_ms}
    return out


def moe_times(dev) -> dict:
    """One granite-moe MoE layer as this tree runs it by default: wall ms
    per call and launches per call at the decode step and a 256-token
    prefill, and a fingerprint of its outputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config(SERVE_ARCH)
    p, xs = moe_inputs(cfg, dev)
    out = {}
    for name, x in xs.items():
        def call():
            return layers.moe(p, x, cfg)
        y, aux = call()
        out[name] = {"shape": list(MOE_SHAPES[name]), "wall_ms": wall_ms(call),
                     **moe_launches(call),
                     "y_sha256": hashlib.sha256(y.float().cpu().numpy()
                                                .tobytes()).hexdigest(),
                     "aux": float(aux)}
        del y
    torch.cuda.synchronize()
    return out


def serve_times(dev) -> dict:
    """granite-moe served at full width on chip_smoke.py's traffic, after a
    warm-up run of 2 new tokens: decode ms a step, prefill ms a request,
    tokens/s, and a fingerprint of the tokens."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config(SERVE_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(
        16, 257))).tolist() for _ in range(16)]

    def run(max_new):
        eng = ServeEngine(cfg, params, lanes=8, max_ctx=512, device=dev)
        prefill_s, admit = [], eng._admit

        def timed_admit(lane, req):
            t = time.perf_counter()
            admit(lane, req)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)

        eng._admit = timed_admit
        reqs = [eng.submit(q, max_new_tokens=max_new) for q in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del eng._admit
        return eng, reqs, wall, prefill_s

    run(2)
    eng, reqs, wall, prefill_s = run(32)
    tokens = [r.tokens_out for r in reqs]
    return {"requests": len(prompts), "new_tokens": 32, "lanes": 8,
            "decode_steps": eng.step_count, "wall_s": wall,
            "prefill_ms_per_request": 1e3 * sum(prefill_s) / len(prefill_s),
            "decode_ms_per_step": 1e3 * (wall - sum(prefill_s))
                                  / eng.step_count,
            "tokens_per_s": sum(map(len, tokens)) / wall,
            "tokens_sha256": hashlib.sha256(json.dumps(tokens).encode())
                             .hexdigest()}


def child(tree: Path, parts) -> dict:
    """Time ``parts`` of ``tree`` (imported from ``tree/src``)."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch import _build

    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve())
    if not torch.cuda.is_available():
        raise SystemExit("kernel_pair: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.load_libraries(list(_build.KERNELS))
    row = {"tree": str(tree), "card": smi()}
    if "lockvm" in parts:
        row.update(_lockvm(dev))
    if "scan" in parts:
        row["scan"] = _scan(dev)
    if "rglru" in parts:
        row["rglru"] = _rglru(dev)
    if "ticket" in parts:
        row["ticket"] = ticket_times(dev)
    if "moe" in parts:
        row["moe"] = moe_times(dev)
    if "serve" in parts:
        row["serve"] = serve_times(dev)
    if "conv" in parts:
        row["conv"] = conv_times(dev)
    row["card_after"] = smi()
    row["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "stack" in ln]
                    for name, log in _build.build_logs.items()}
    return row


def _lockvm(dev) -> dict:
    """The lockVM kernel on the full fig3 sweep, and the card while it
    runs."""
    import numpy as np
    import torch

    from repro_torch import sim
    from repro_torch.sim import engine, engine_cuda

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
    return {"card": card,
            "lockvm": {"ms": lvm_ms, "ms_all": times, "cells": len(events),
                       "max_events": int(events.max()),
                       "sum_events": int(events.sum()),
                       "us_per_event": lvm_ms * 1e3 / int(events.max()),
                       "outputs_sha256": digest.hexdigest()}}


def _scan(dev) -> dict:
    """The selective scan at falcon-mamba-7b's full-width prefill, bf16."""
    import numpy as np
    import torch

    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ref as scan_ref

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
    scan_ms, scan_floor_ms = profiled_ms(fn, "mamba_scan_kernel")
    return {"shape": list(SCAN_SHAPE), "dtype": "bf16",
            "device_ms": scan_ms, "launch_floor_ms": scan_floor_ms,
            "max_abs_err": err}


def _rglru(dev) -> dict:
    """The RG-LRU scan at recurrentgemma-9b's prefills, bf16."""
    import numpy as np
    import torch

    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ref as rglru_ref

    rglru = {}
    for L in RGLRU_L:
        rng = np.random.default_rng(22)
        a32, b32 = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
            rng.uniform(0.3, 0.999, size=(L, RGLRU_D)),
            rng.normal(size=(L, RGLRU_D))))
        a, b = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
        ry, rh = rglru_ref.rglru_scan_ref(a.float(), b.float())
        y, h = rglru_kernel.rglru_scan(a, b)
        y32, h32 = rglru_kernel.rglru_scan(a32, b32)
        r32 = rglru_ref.rglru_scan_ref(a32, b32)
        torch.cuda.synchronize()
        device_ms, floor_ms = profiled_ms(
            lambda: rglru_kernel.rglru_scan(a, b), "rglru_scan_kernel")
        rglru[f"L{L}"] = {
            "shape": [L, RGLRU_D], "dtype": "bf16", "device_ms": device_ms,
            "launch_floor_ms": floor_ms,
            "outside_one_ulp": max(outside_one_ulp(y, ry),
                                   outside_one_ulp(h, rh)),
            "max_abs_err": max(float((y.float() - ry).abs().max()),
                               float((h.float() - rh).abs().max())),
            "float32_equal": bool(torch.equal(y32, r32[0])
                                  and torch.equal(h32, r32[1]))}
    return rglru


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent tree")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {','.join(PARTS)}")
    ap.add_argument("--out", type=Path, help="write every line here too")
    a = ap.parse_args(argv)
    parts = a.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}; options: {PARTS}")
    if a.child is not None:
        print(json.dumps(child(a.child, parts)), flush=True)
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
                               str(Path(tree).resolve()), "--parts",
                               a.parts], env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"kernel_pair: the {label} child failed")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["label"] = label
        lines.append(row)
        print(json.dumps(row), flush=True)
    if "lockvm" in parts:
        digests = {r["lockvm"]["outputs_sha256"] for r in lines}
        assert len(digests) == 1, "lockVM outputs differ between the trees"
    for r in lines:
        if "scan" in parts:
            assert r["scan"]["max_abs_err"] <= 5e-2, (r["label"], r["scan"])
        for rg in r.get("rglru", {}).values():
            assert rg["outside_one_ulp"] == 0.0 and rg["float32_equal"], (
                r["label"], rg)
        for cv in r.get("conv", {}).values():
            assert cv.get("within_bound", True) and cv.get(
                "differing_share", 0) <= 1e-5 and cv.get(
                "tail_equal", True), (r["label"], cv)
    for label in ("parent", "change"):
        # a tree gives the same MoE outputs and tokens in both its children
        prints = {json.dumps([r.get("moe", {}).get(n, {}).get("y_sha256")
                              for n in MOE_SHAPES]
                             + [r.get("serve", {}).get("tokens_sha256")])
                  for r in lines if r["label"] == label}
        assert len(prints) == 1, (label, prints)

    def side(label, pick):
        return [pick(r) for r in lines if r["label"] == label]

    summary = {"summary": "kernel_pair", "order": [r["label"] for r in lines],
               "parts": parts, "cards": [r["card"] for r in lines]}
    for label in ("parent", "change"):
        row = summary[label] = {}
        if "lockvm" in parts:
            row["lockvm_ms"] = side(label, lambda r: r["lockvm"]["ms"])
            row["lockvm_us_per_event"] = side(
                label, lambda r: r["lockvm"]["us_per_event"])
        if "scan" in parts:
            row["scan_device_ms"] = side(label,
                                         lambda r: r["scan"]["device_ms"])
        for L in RGLRU_L if "rglru" in parts else ():
            row[f"rglru_L{L}_device_ms"] = side(
                label, lambda r: r["rglru"][f"L{L}"]["device_ms"])
        for name in ("decode", "prefill_Lp256", "plan_decode",
                     "plan_prefill_Lp256") if "ticket" in parts else ():
            for k in ("device_ms", "launch_floor_ms"):
                row[f"ticket_{name}_{k}"] = side(
                    label, lambda r: r["ticket"].get(name, {}).get(k))
        for name in MOE_SHAPES if "moe" in parts else ():
            for k in ("wall_ms", "launches", "plan_launches"):
                row[f"moe_{name}_{k}"] = side(label,
                                              lambda r: r["moe"][name][k])
        if "serve" in parts:
            for k in ("decode_ms_per_step", "prefill_ms_per_request",
                      "tokens_per_s"):
                row[f"serve_{k}"] = side(label, lambda r: r["serve"][k])
        for S in CONV_S if "conv" in parts else ():
            for k in ("plain_ms", "kernel_ms", "library_ms", "bound_ms"):
                row[f"conv_S{S}_{k}"] = side(
                    label, lambda r: r["conv"][f"S{S}"].get(k))
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
