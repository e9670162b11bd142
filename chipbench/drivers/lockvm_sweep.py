"""The sweep loop: a lockVM suite run back to back through the program's
``run_sweeps``, each pass with fresh seeds drawn from ``--seed``.

A traffic file of this driver lists ``calls``: each call is one
``run_sweeps`` over its specs (one kernel launch), and one pass of the
suite makes every call in order.  A spec gives the sweep's axes (``locks``,
``threads``, ``cs_work``, ``ncs_max``, ``n_locks``, ``private_arrays``,
``collect_latency``) and ``seeds``, the number of seeds each pass draws.
The configuration fixes the machine: costs, waiting-array size, horizon
(the traffic may set its own) and the event budget of a cell.

Set-up builds the kernel (first run only) and runs one pass; the window
then runs whole passes until ``--seconds`` have gone, and ends with the
last pass.  One cell of each call of each pass is set aside, drawn from the
seed; after the window the plain reference replays a sample of them, drawn
from the seed, until ``check_events`` events have been replayed, and every
output column of each must equal the program's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from chipbench import bench
from chipbench import trace as tr
from chipbench.reference import lockvm as ref

KERNEL = "lockvm_kernel"


def _seeds(rng, n: int) -> tuple:
    return tuple(int(s) for s in rng.integers(1, 2**31 - 1, size=n))


def plan(config: dict, traffic: dict) -> list:
    """The suite's calls: for each, a list of spec dicts (every axis given,
    horizon, event budget and costs filled in from the configuration)."""
    base = {"cs_work": 4, "ncs_max": 200, "n_locks": 1,
            "private_arrays": False, "collect_latency": False,
            "horizon": traffic.get("horizon", config["horizon"]),
            "max_events": config["max_events"],
            "wa_size": config["wa_size"], "costs": config["costs"]}
    calls = []
    for call in traffic["calls"]:
        specs = []
        for spec in call:
            s = {**base, **spec}
            unknown = set(s["locks"]) - set(config["locks"])
            if unknown:
                raise ValueError(f"locks {sorted(unknown)} are not in the "
                                 f"configuration's {config['locks']}")
            if max(s["threads"]) > config["max_threads"]:
                raise ValueError("more threads than the configuration's "
                                 f"{config['max_threads']}")
            specs.append(s)
        calls.append(specs)
    return calls


def sweep_spec(sim, spec: dict, seeds: tuple):
    """The program's ``SweepSpec`` for one spec dict and its seeds."""
    return sim.SweepSpec(
        locks=tuple(spec["locks"]), threads=tuple(spec["threads"]),
        seeds=seeds, cs_work=spec["cs_work"], ncs_max=spec["ncs_max"],
        n_locks=spec["n_locks"],
        private_arrays=(tuple(spec["private_arrays"])
                        if isinstance(spec["private_arrays"], list)
                        else spec["private_arrays"]),
        wa_size=spec["wa_size"], costs=sim.Costs(**spec["costs"]),
        horizon=spec["horizon"], max_events=spec["max_events"],
        collect_latency=spec["collect_latency"])


def reference_cell(spec: dict, row: dict) -> dict:
    """The coordinates the reference replays a row's cell from: the spec
    the benchmark wrote and the row's own axis values."""
    return {"lock": row["lock"], "n_threads": int(row["n_threads"]),
            "seed": int(row["seed"]), "cs_work": int(row["cs_work"]),
            "private_arrays": bool(row["private_arrays"]),
            "n_locks": spec["n_locks"], "wa_size": spec["wa_size"],
            "ncs_max": spec["ncs_max"],
            "collect_latency": spec["collect_latency"],
            "horizon": spec["horizon"], "max_events": spec["max_events"],
            "costs": dict(spec["costs"])}


def kept(row: dict) -> dict:
    """A copy of a row's compared columns (the rows hold views of the
    whole sweep's arrays)."""
    return {k: np.array(row[k]) for k in ref.COLUMNS if k in row}


class Suite:
    """One pass after another of the suite's calls."""

    def __init__(self, sim, calls, rng, pick, device) -> None:
        self.sim, self.calls, self.rng, self.pick = sim, calls, rng, pick
        self.device = device
        self.spans = tr.Spans()
        self.passes = []        # per pass: (start, end, events, longest)
        self.set_aside = []     # (cell coordinates, kept row)

    def run_pass(self, keep: bool):
        t0 = time.perf_counter()
        events, longest, cells = 0, [], 0
        for specs in self.calls:
            seeds = [_seeds(self.rng, s["seeds"]) for s in specs]
            sweeps = [sweep_spec(self.sim, s, sd)
                      for s, sd in zip(specs, seeds)]
            c0 = time.perf_counter()
            out = self.sim.run_sweeps(sweeps, device=self.device)
            self.spans.add("run_sweeps", c0, time.perf_counter())
            rows = [(s, r) for s, rs in zip(specs, out) for r in rs]
            ev = [int(r["events"]) for _, r in rows]
            events += sum(ev)
            longest.append(max(ev))
            cells += len(rows)
            if keep:
                s, r = rows[int(self.pick.integers(len(rows)))]
                self.set_aside.append((reference_cell(s, r), kept(r)))
        t1 = time.perf_counter()
        self.passes.append((t0, t1, events, longest, cells))
        return t1


def check(set_aside, rng, budget: int) -> dict:
    """Replay set-aside cells in an order drawn from ``rng`` until
    ``budget`` events have been replayed; the cells that differ."""
    order = rng.permutation(len(set_aside))
    replayed, events, bad = 0, 0, []
    for i in order:
        cell, row = set_aside[int(i)]
        want = ref.replay(cell)
        if ref.mismatches(row, want):
            bad.append((cell["lock"], cell["n_threads"], cell["seed"],
                        ref.mismatches(row, want)))
        replayed += 1
        events += int(want["events"])
        if events >= budget:
            break
    return {"replayed": replayed, "events": events, "bad": bad}


def control_check(set_aside, replayed: int, order_seed) -> list:
    """The cells, of the same ``replayed`` first in the check's order, on
    which the control (the reference with ``free_invalidation``) differs
    from the reference."""
    order = np.random.default_rng(order_seed).permutation(len(set_aside))
    bad = []
    for i in order[:replayed]:
        cell, _ = set_aside[int(i)]
        want = ref.replay(cell)
        if ref.mismatches(ref.replay(cell, ("free_invalidation",)), want):
            bad.append(cell)
    return bad


def run(cell: bench.Cell, control: bool = False) -> bench.Outcome:
    """One run of the cell.  With ``control`` (the control's test, never a
    benchmark run) the check judges the control in the program's place:
    the reference with a free invalidation (a broken coherence cost),
    which must differ from the reference on some replayed cell; the
    program's own readings go to the notes."""
    import torch
    from repro_torch import sim

    device = torch.device(cell.device)
    calls = plan(cell.config, cell.traffic)
    seed_seq = np.random.SeedSequence(cell.seed)
    rng_seed, pick_seed, order_seed = seed_seq.spawn(3)
    rng, pick = np.random.default_rng(rng_seed), np.random.default_rng(
        pick_seed)
    suite = Suite(sim, calls, rng, pick, device)
    suite.run_pass(keep=False)           # builds the kernel, warms up
    suite.passes.clear()
    suite.spans.items.clear()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    with (tr.DeviceTrace(device) if cell.trace
          else contextlib.nullcontext()) as trace:
        w0 = time.perf_counter()
        setup_s = w0 - cell.t_start
        while True:
            w1 = suite.run_pass(keep=True)
            if w1 - w0 >= cell.seconds:
                break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    events = sum(p[2] for p in suite.passes)
    facts = {"window_s": w1 - w0, "events": events,
             "passes": len(suite.passes),
             "sweep_wall_s": sum(e - s for s, e in
                                 suite.spans.within("run_sweeps", w0, w1)),
             "longest_events": sum(sum(p[3]) for p in suite.passes)}
    outcome = bench.Outcome(facts=facts, checks=[],
                            attempted=sum(p[4] for p in suite.passes),
                            failed=0, setup_s=setup_s,
                            memory_peak_bytes=peak)
    if trace is not None:
        ops = trace.ops
        facts["kernel_s"] = tr.kernel_seconds(ops, w0, w1, KERNEL)
        facts["busy_s"] = tr.busy_seconds(ops, w0, w1)
        facts["trace_window_s"] = w1 - w0
        outcome.busy_s = facts["busy_s"]
        outcome.window_s = w1 - w0
        outcome.breakdown = tr.breakdown(ops, suite.spans, w0, w1)

    c0 = time.perf_counter()
    result = check(suite.set_aside, np.random.default_rng(order_seed),
                   cell.traffic.get("check_events", 2_000_000))
    outcome.checks = [bench.Check("cells_differing", len(result["bad"]), 0)]
    outcome.notes = {"cells_replayed": result["replayed"],
                     "events_replayed": result["events"],
                     "differing": result["bad"][:5],
                     "check_s": time.perf_counter() - c0}
    if control:
        outcome.notes["program"] = {"cells_differing": len(result["bad"])}
        outcome.checks = [bench.Check("cells_differing", len(control_check(
            suite.set_aside, result["replayed"], order_seed)), 0)]
    return outcome
