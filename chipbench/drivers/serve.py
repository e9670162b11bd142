"""The serve loops: requests through the program's ``ServeEngine`` in an
open loop (arrivals on a schedule, whatever the engine does) or a closed
loop (clients that each send their next request when the reply comes).

A traffic file of this driver gives ``loop`` (``open`` or ``closed``),
``rate_per_s`` (open) or ``clients`` (closed), ``prompt_tokens`` and
``new_tokens`` (each a log-normal: ``median`` and ``sigma``, cut to
[``min``, ``max``]), ``block`` and ``strata``, ``lanes``, ``lock``,
``scan``, ``lead_s`` and ``check_served_tokens``.  Every seed gets the same
sizes and gaps in each block, in an order the seed draws (:class:`Requests`);
a block starts when the window opens, and one block is the requests a
window holds at the cell's rate.  The seed also draws the prompts' tokens
and the weights.  Answers are greedy and run to their length.

Set-up makes the weights (the configuration's reference module draws them
on the device from the seed), builds the engine, warms up a prefill of the
longest and of the shortest prompt and their decode, and then runs the
loop for ``lead_s`` seconds, so that the queue is at its steady state when
the window opens.  The window runs ``--seconds``; it ends with the step
under way.  A request is timed from when it was due (closed loop: sent).

After the window, the engine is dropped and a sample of the finished
requests, drawn from the seed with the longest in it, is run through the
reference: its ``served_gap`` is the widest gap by which a served token's
logit lies below the reference's best; and the order of admission must be
the order of submission.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import time
from statistics import NormalDist

import numpy as np

from chipbench import bench, work
from chipbench import trace as tr

SCAN_KERNEL = "mamba_scan_kernel"


def _quantiles(k: int) -> np.ndarray:
    return (np.arange(k) + 0.5) / k


def lognormal_sizes(dist: dict, k: int) -> np.ndarray:
    """The ``k`` stratified quantiles (j + 1/2) / k of a log-normal with
    ``median`` and ``sigma``, cut to [``min``, ``max``], as whole numbers."""
    z = NormalDist()
    mu, sigma = math.log(dist["median"]), dist["sigma"]
    lo, hi = (z.cdf((math.log(dist[b]) - mu) / sigma)
              for b in ("min", "max"))
    return np.array([round(math.exp(mu + sigma * z.inv_cdf(lo + q * (hi - lo))))
                     for q in _quantiles(k)], dtype=np.int64)


def stratified_order(values: np.ndarray, strata: int, rng) -> np.ndarray:
    """One block of ``values`` (``strata`` × m of them) in an order drawn
    from ``rng``: the sorted values cut into ``strata`` groups of m
    neighbours, and each run of ``strata`` in the block takes one value of
    every group, so no run holds two of the largest."""
    groups = np.sort(values).reshape(strata, -1)
    picked = np.stack([rng.permutation(g) for g in groups], axis=1)
    return np.concatenate([rng.permutation(run) for run in picked])


class Requests:
    """The traffic's requests in order: prompt, new tokens, gap before.

    A block of ``block`` requests takes the quantiles (j + 1/2) / block of
    the prompt, answer and gap distributions, each in an order of its own
    drawn from the seed (:func:`stratified_order`): every seed sends the
    same sizes and gaps, block by block, in another order.  The seed also
    draws the prompts' tokens."""

    def __init__(self, traffic: dict, seed: int, vocab: int) -> None:
        self.t = traffic
        order, tokens = np.random.SeedSequence(seed).spawn(2)
        self.order = np.random.default_rng(order)
        self.rng = np.random.default_rng(tokens)
        self.vocab = vocab
        k = traffic["block"]
        self.prompts = lognormal_sizes(traffic["prompt_tokens"], k)
        self.news = lognormal_sizes(traffic["new_tokens"], k)
        rate = traffic.get("rate_per_s")
        self.gaps = -np.log1p(-_quantiles(k)) / rate if rate else np.zeros(k)
        self.block: list = []

    def _refill(self) -> None:
        k = self.t["strata"]
        self.block = list(zip(*(stratified_order(v, k, self.order) for v in
                                (self.prompts, self.news, self.gaps))))[::-1]

    def restart(self) -> None:
        """The next request opens a new block."""
        self.block = []

    def next(self):
        if not self.block:
            self._refill()
        length, new, gap = self.block.pop()
        tokens = self.rng.integers(0, self.vocab, size=int(length))
        return tokens.tolist(), int(new), float(gap)


def engine_class(ServeEngine):
    """The program's engine, with the benchmark's spans around each
    admission (whose prefill ends synchronised: its first token is read
    back) and the order of admission kept."""

    class Timed(ServeEngine):
        def __init__(self, *args, spans: tr.Spans, **kw) -> None:
            super().__init__(*args, **kw)
            self.spans = spans
            self.admissions: list = []      # (ticket, start, end, tokens)

        def _admit(self, lane, req):
            t0 = time.perf_counter()
            super()._admit(lane, req)
            t1 = time.perf_counter()
            req.first_at = t1
            self.spans.add("prefill", t0, t1)
            self.admissions.append((req.ticket, t0, t1, len(req.prompt)))

    return Timed


class Loop:
    """One engine driven by the traffic; keeps every request's times."""

    def __init__(self, engine, requests: Requests, traffic: dict) -> None:
        self.eng = engine
        self.req = requests
        self.t = traffic
        self.spans = engine.spans
        self.records: list = []     # dicts: req, due, sent, stamps
        self.in_flight: list = []
        self.steps: list = []       # (start, end, admissions, decoded)
        self.next_due = None
        self.pending = None

    def submit(self, due: float) -> None:
        prompt, new, _ = self.pending
        r = self.eng.submit(prompt, max_new_tokens=new)
        rec = {"req": r, "due": due, "sent": time.perf_counter(),
               "stamps": []}
        self.records.append(rec)
        self.in_flight.append(rec)
        self.pending = None

    def _draw(self, after: float) -> None:
        self.pending = self.req.next()
        self.next_due = after + self.pending[2]

    def step(self) -> None:
        n_adm = len(self.eng.admissions)
        t0 = time.perf_counter()
        decoded = self.eng.step()
        t1 = time.perf_counter()
        self.spans.add("step", t0, t1)
        self.steps.append((t0, t1, len(self.eng.admissions) - n_adm,
                           decoded))
        still = []
        for rec in self.in_flight:
            r, stamps = rec["req"], rec["stamps"]
            while len(stamps) < len(r.tokens_out):
                stamps.append(r.first_at if not stamps else t1)
            if not r.done.is_set():
                still.append(rec)
        done = len(self.in_flight) - len(still)
        self.in_flight = still
        if self.t["loop"] == "closed":
            for _ in range(done):
                self._draw(t1)
                self.submit(t1)

    def open_window(self, w0: float) -> None:
        """A new block of requests from ``w0``: the open loop's next
        request, drawn but not yet sent, is drawn again from it."""
        self.req.restart()
        if self.t["loop"] == "open":
            self._draw(w0)

    def start(self, t0: float) -> None:
        if self.t["loop"] == "closed":
            for _ in range(self.t["clients"]):
                self._draw(t0)
                self.submit(t0)
        else:
            self._draw(t0)

    def run_until(self, t_end: float) -> float:
        """Drive the engine until ``t_end``; returns when the last step
        ended (at or after ``t_end``)."""
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return now
            while self.pending is not None and self.next_due <= now \
                    and self.t["loop"] == "open":
                due = self.next_due
                self.submit(due)
                self._draw(due)
            if self.in_flight:
                self.step()
            else:
                wake = min(self.next_due, t_end)
                time.sleep(max(0.0, wake - time.perf_counter()))
                self.spans.add("wait", now, time.perf_counter())


def warm_up(engine, traffic: dict, vocab: int) -> None:
    """A prefill of the longest and the shortest prompt the traffic draws,
    each with two decode steps."""
    sizes = lognormal_sizes(traffic["prompt_tokens"], traffic["block"])
    for length in (int(sizes.max()), int(sizes.min())):
        engine.submit([1 + i % (vocab - 1) for i in range(length)],
                      max_new_tokens=3)
        engine.run()


def window_facts(loop: Loop, arch: dict, w0: float, w1: float) -> dict:
    """What the readers take, from the window [w0, w1]."""
    ttft, itl, generated = [], [], 0
    for rec in loop.records:
        stamps = rec["stamps"]
        if w0 <= rec["due"] < w1:
            first = stamps[0] if stamps else w1
            ttft.append((min(first, w1) - rec["due"]) * 1e3)
        for a, b in zip([None] + stamps[:-1], stamps):
            if w0 <= b <= w1:
                generated += 1
                if a is not None:
                    itl.append((b - a) * 1e3)
    admissions = [(s, e, n) for _, s, e, n in loop.eng.admissions
                  if w0 <= e <= w1]
    prompt_tokens = sum(n for _, _, n in admissions)
    decode_tokens = generated - len(admissions)
    flops = (sum(work.prefill_flops(arch, n) for _, _, n in admissions)
             + work.decode_flops(arch, max(0, decode_tokens)))
    return {"window_s": w1 - w0, "ttft_ms": ttft, "itl_ms": itl,
            "prompt_tokens": prompt_tokens, "generated_tokens": generated,
            "decode_only_step_ms": [(e - s) * 1e3
                                    for s, e, n, d in loop.steps
                                    if w0 <= s and e <= w1 and n == 0
                                    and d > 0],
            "prefill_ms": [(e - s) * 1e3 for s, e, _ in admissions],
            "prefill_tokens": [n for _, _, n in admissions],
            "model_flops": flops}


def scan_facts(ops, loop: Loop, arch: dict, w0: float, w1: float) -> dict:
    """The scan kernel's time inside the window's admissions, and its
    least time for their prompt lengths (one launch a layer)."""
    s = work.mamba_sizes(arch)
    adm = [(a, b, n) for _, a, b, n in loop.eng.admissions
           if w0 <= a and b <= w1]
    kernels = sorted((a, b) for n, a, b in ops if SCAN_KERNEL in n)
    starts = [a for a, _ in kernels]
    spent, bound, launches = 0.0, 0.0, 0
    for a, b, n in adm:
        i, j = np.searchsorted(starts, a), np.searchsorted(starts, b)
        spent += sum(e - s0 for s0, e in kernels[i:j])
        launches += int(j - i)
        bound += s["layers"] * work.scan_bound_s(n, s["di"], s["N"])
    return {"scan_kernel_s": spent, "scan_bound_s": bound,
            "scan_launches": launches, "scan_admissions": len(adm)}


def sample(loop: Loop, rng, tokens: int) -> list:
    """Finished requests, the longest first and then in an order drawn
    from ``rng``, until ``tokens`` served tokens are held."""
    done = [rec["req"] for rec in loop.records if rec["req"].done.is_set()]
    if not done:
        return []
    size = [len(r.prompt) + len(r.tokens_out) for r in done]
    first = int(np.argmax(size))
    order = [first] + [int(i) for i in rng.permutation(len(done))
                       if i != first]
    out, held = [], 0
    for i in order:
        out.append(done[i])
        held += len(done[i].tokens_out)
        if held >= tokens:
            break
    return out


def admission_order_errors(loop: Loop) -> int:
    """Admissions that do not follow the order of submission."""
    sent = [rec["req"].ticket for rec in loop.records]
    admitted = [t for t, *_ in loop.eng.admissions]
    return sum(a != s for a, s in zip(admitted, sent))


def build(cell: bench.Cell, weights=None):
    """Weights (unless given), engine and loop of a cell, its traffic not
    yet started, and the seed of its check's sample."""
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve import ServeEngine

    arch, t = cell.config["arch"], cell.traffic
    cfg = ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in arch.items()})
    ref = importlib.import_module(
        f"chipbench.reference.{cell.config['reference']}")
    seeds = np.random.SeedSequence(cell.seed).generate_state(3)
    device = torch.device(cell.device)
    if weights is None:
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[arch["dtype"]]
        weights = ref.make_weights(arch, int(seeds[0]), device, dtype,
                                   cell.config["init_std"])
    max_ctx = (int(lognormal_sizes(t["prompt_tokens"], t["block"]).max())
               + int(lognormal_sizes(t["new_tokens"], t["block"]).max()) + 1)
    engine = engine_class(ServeEngine)(
        cfg, weights, lanes=t["lanes"], max_ctx=max_ctx, lock=t["lock"],
        scan=t["scan"], device=device, spans=tr.Spans())
    loop = Loop(engine, Requests(t, int(seeds[1]), arch["vocab"]), t)
    return weights, engine, loop, ref, int(seeds[2])


def run(cell: bench.Cell, control: bool = False) -> bench.Outcome:
    """One run of the cell.  With ``control`` (the control's test, never a
    benchmark run) the check judges the control in the program's place:
    the tokens the reference's float8 forward puts first at the served
    positions, whose widest gap must fail the limit; the program's own
    readings go to the notes."""
    import torch

    weights, engine, loop, ref, check_seed = build(cell)
    arch, t = cell.config["arch"], cell.traffic
    device = engine.device
    with torch.inference_mode():
        warm_up(engine, t, arch["vocab"])
    engine.admissions.clear()
    engine.spans.items.clear()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with (tr.DeviceTrace(device) if cell.trace
          else contextlib.nullcontext()) as trace, torch.inference_mode():
        t0 = time.perf_counter()
        loop.start(t0)
        loop.run_until(t0 + t["lead_s"])
        w0 = time.perf_counter()
        loop.open_window(w0)
        w1 = loop.run_until(w0 + cell.seconds)
    setup_s = w0 - cell.t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    facts = window_facts(loop, arch, w0, w1)
    attempted = sum(1 for rec in loop.records if w0 <= rec["due"] < w1)
    outcome = bench.Outcome(facts=facts, checks=[], attempted=attempted,
                            failed=0, setup_s=setup_s,
                            memory_peak_bytes=peak)
    if trace is not None:
        facts.update(scan_facts(trace.ops, loop, arch, w0, w1))
        facts["busy_s"] = tr.busy_seconds(trace.ops, w0, w1)
        facts["trace_window_s"] = w1 - w0
        outcome.busy_s, outcome.window_s = facts["busy_s"], w1 - w0
        outcome.breakdown = tr.breakdown(trace.ops, engine.spans, w0, w1)

    picked = sample(loop, np.random.default_rng(check_seed),
                    t["check_served_tokens"])
    order_errors = admission_order_errors(loop)
    held = [(list(r.prompt), list(r.tokens_out)) for r in picked]
    del engine, loop, picked
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    gaps = [ref.served_gaps(weights, arch, p, s, control) for p, s in held]
    limit = cell.config["limits"]["served_gap"]
    program = [bench.Check("served_gap", _widest(g for g, _ in gaps), limit),
               bench.Check("admission_order_errors", order_errors, 0)]
    outcome.checks = program
    outcome.notes = {"requests_checked": len(held),
                     "tokens_checked": sum(len(s) for _, s in held),
                     "check_s": time.perf_counter() - c0}
    if control:
        outcome.checks = [bench.Check("served_gap", _widest(
            c for _, c in gaps), limit)]
        outcome.notes["program"] = {c.name: c.value for c in program}
    return outcome


def _widest(gaps) -> float:
    return max((float(g.max()) for g in gaps), default=float("inf"))
