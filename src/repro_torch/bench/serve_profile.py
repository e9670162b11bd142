"""Where the serve path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.bench.serve_profile [--arch NAME] [--out DIR]

``--arch`` names the model served (``granite-moe-1b-a400m`` unless given;
``falcon-mamba-7b`` the Mamba path, ``recurrentgemma-9b`` the Griffin
path).  Up to two measurements, each printed
as one JSON line:

* ``ticket_call``: the host's cost of one call of the ticket-dispatch
  wrapper at the decode group's shape (64 arrivals, 32 experts) against
  the raw library call on preallocated outputs, ``torch.empty_like`` and
  one small PyTorch op, each timed over many calls without synchronising
  (the enqueue cost), and the kernel's device time from ``torch.profiler``;
  only for a model with experts.
* ``moe_plan``: one MoE layer of the model at full width (seeded bf16
  weights, ``layers.moe`` with ``dispatch="auto"``) at the decode step (8
  lanes) and a 256-token prefill: its kernel launches per call under
  ``torch.profiler``, split into the routing plan's (from the router's
  softmax to the D-wide gather) and the rest, the host µs of the plan
  section under the profiler, the plan's launches by op, and the wall ms
  per call with a synchronise; only for a model with experts.
* ``serve``: the model at full width (random bf16 weights from a seed)
  serving 8 requests of 64-256 prompt tokens and 8 new tokens on 8 lanes,
  with ``torch.profiler`` over the run after a warm-up: wall time of
  prefill and decode, the device's busy time (the sum of its kernels'
  times) and idle share, the host's kernel launches per model pass, the
  port's own kernels' device times, and the ops that take the most host
  and device time.

With ``--out`` the profiler tables go to files in DIR.  Every row names
the card and its power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import spans
from ..configs import get_config
from ..device import resolve_device
from ..kernels.ticket_dispatch import assign_slots
from ..kernels.ticket_dispatch import kernel as ticket_kernel
from ..models.model import init_params
from ..models import layers
from ..serve import ServeEngine
from .kernel_pair import (LAUNCH_CALLS, MOE_SHAPES, moe_inputs, moe_launches,
                          smi, wall_ms)


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls, before the
    device is waited on (the enqueue cost)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


# the port's kernels, by the name of their __global__ function
PORT_KERNELS = ("ticket_dispatch_kernel", "mamba_scan_kernel",
                "rglru_scan_kernel", "causal_conv_kernel")


def _device_events(prof):
    """The device's own events (kernels, copies)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_us(prof, name_part: str) -> tuple[float, int]:
    """Mean device time (µs) and count of the kernels whose name holds
    ``name_part``."""
    times = [e.device_time for e in _device_events(prof)
             if name_part in e.name]
    return (sum(times) / len(times) if times else float("nan")), len(times)


def ticket_call(dev, out_dir: Path | None) -> dict:
    ids = torch.randint(0, 32, (1, 64), dtype=torch.int32, device=dev)
    tickets, slots = torch.empty_like(ids), torch.empty_like(ids)
    lib = ticket_kernel._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    x = torch.zeros(64, device=dev)

    def raw():
        lib.ticket_dispatch_run(ids.data_ptr(), tickets.data_ptr(),
                                slots.data_ptr(), 64, 1, 32, 8, stream)

    row = {"phase": "ticket_call", "shape": [1, 64], "E": 32,
           "wrapper_host_us": host_us(
               lambda: ticket_kernel.ticket_dispatch(ids, 32, 8)),
           "raw_call_host_us": host_us(raw),
           "empty_like_host_us": host_us(lambda: torch.empty_like(ids)),
           "torch_add_host_us": host_us(lambda: x.add(1.0)),
           "assign_slots_auto_host_us": host_us(
               lambda: assign_slots(ids, 32, 8, grouped=True)),
           "assign_slots_torch_host_us": host_us(
               lambda: assign_slots(ids, 32, 8, grouped=True, mode="torch"))}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            ticket_kernel.ticket_dispatch(ids, 32, 8)
        torch.cuda.synchronize()
    row["kernel_device_us"], row["kernel_count"] = _device_us(
        prof, "ticket_dispatch_kernel")
    stats = cProfile.Profile()
    stats.enable()
    for _ in range(500):
        ticket_kernel.ticket_dispatch(ids, 32, 8)
    stats.disable()
    torch.cuda.synchronize()
    buf = io.StringIO()
    pstats.Stats(stats, stream=buf).sort_stats("tottime").print_stats(12)
    if out_dir is not None:
        (out_dir / "ticket_call_cprofile.txt").write_text(buf.getvalue())
        (out_dir / "ticket_call_profile.txt").write_text(
            prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=20))
    return row


def moe_plan(dev, arch: str) -> dict:
    cfg = get_config(arch)
    p, xs = moe_inputs(cfg, dev)
    row = {"phase": "moe_plan", "arch": cfg.name, "dtype": cfg.dtype,
           "d_model": cfg.d_model, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "d_ff": cfg.d_ff}
    for name, x in xs.items():
        def call():
            return layers.moe(p, x, cfg, dispatch="auto")
        row[name] = {"shape": list(MOE_SHAPES[name]), **moe_launches(call),
                     "wall_ms_per_call": wall_ms(call)}
    return row


def phase_seconds(recorded) -> tuple[float, float]:
    """Prefill and decode seconds from the engine's spans: every
    ``serve.admit``, and every ``serve.step`` less the admissions inside
    it."""
    steps = {s.id for s in recorded if s.name == "serve.step"}
    prefill_s = sum(s.end - s.start for s in recorded
                    if s.name == "serve.admit")
    decode_s = sum(s.end - s.start for s in recorded
                   if s.name == "serve.step") - sum(
        s.end - s.start for s in recorded
        if s.name == "serve.admit" and s.parent in steps)
    return prefill_s, decode_s


def serve(dev, out_dir: Path | None, arch: str) -> dict:
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(64, 257)))
               .tolist() for _ in range(8)]

    def run(max_new: int):
        eng = ServeEngine(cfg, params, lanes=8, max_ctx=512, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        eng.run()
        torch.cuda.synchronize()
        return eng

    run(2)                                            # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spans.enable()
        t0 = time.perf_counter()
        eng = run(8)
        wall = time.perf_counter() - t0
        spans.disable()
    prefill_s, decode_s = phase_seconds(spans.collect())
    by_kernel: dict = {}
    for e in _device_events(prof):
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time
    busy_us = sum(by_kernel.values())
    port_kernels = {}
    for name in PORT_KERNELS:
        us, n = _device_us(prof, name)
        if n:
            port_kernels[name] = {"device_us_mean": us, "count": n}
    launch_calls = sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)
    passes = eng.prefill_count + eng.step_count
    avg = prof.key_averages()
    top_dev = sorted(by_kernel.items(), key=lambda kv: kv[1],
                     reverse=True)[:8]
    top_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    if out_dir is not None:
        (out_dir / f"serve_profile_{cfg.name}.txt").write_text(
            avg.table(sort_by="self_cpu_time_total", row_limit=40)
            + "\n\n" + avg.table(sort_by="self_cuda_time_total",
                                 row_limit=25))
    return {"phase": "serve", "arch": cfg.name, "requests": len(prompts),
            "new_tokens": 8, "lanes": 8, "prefills": eng.prefill_count,
            "decode_steps": eng.step_count, "wall_s": wall,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_ms_per_step": 1e3 * decode_s / eng.step_count,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "passes": passes, "launch_calls": launch_calls,
            "launches_per_pass": launch_calls / passes,
            "port_kernels": port_kernels,
            "top_device_kernels_ms": {name[:80]: us / 1e3
                                      for name, us in top_dev},
            "top_host_ops_ms": {e.key: e.self_cpu_time_total / 1e3
                                for e in top_cpu}}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    rows = []
    if get_config(args.arch).n_experts:
        rows.append(ticket_call(dev, args.out))
        rows.append(moe_plan(dev, args.arch))
    rows.append(serve(dev, args.out, args.arch))
    card = smi()
    for row in rows:
        print(json.dumps({**row, "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
