"""ServeEngine — continuous batching with ticket-FIFO admission.

Decode lanes are the contended resource.  Requests draw a ticket on submit
(wait-free doorway); the engine admits strictly in ticket order as lanes
free up, advancing the grant counter through a :class:`LockGate` whose
two-tier waiting is the paper's TWA algorithm at request granularity.

The model side is PyTorch: per-request prefill (prompts right-padded to a
multiple of ``pad_to``; recurrent archs at their exact length), one
lane-packed KV/SSM cache updated in place, and a batched one-token decode
step with per-lane positions that decodes every lane, finished ones
included, as the reference does (their MoE routing takes expert capacity in
the decode group; their Mamba and RG-LRU states advance until admission
overwrites the lane's row).  Inside every MoE layer each routing decision
draws a FIFO ticket from its expert: the layer's whole routing plan (top-k,
tickets, slots, the slot→token map) is one launch of the CUDA routing-plan
kernel (``dispatch="auto"`` on a GPU), the plain plan around the CUDA
ticket kernel (``dispatch="ticket"``), or the plain plan
(``dispatch="torch"``, or on the CPU).  ``scan`` selects both recurrences
alike: every Mamba layer's prefill runs the selective scan, and every
RG-LRU layer's prefill the RG-LRU scan, through its CUDA kernel
(``scan="auto"`` on a GPU) or its plain version (``scan="torch"``, or on
the CPU); decode launches neither.  A port of the reference's
``repro/serve/engine.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.mamba_scan.ops import MODES as SCAN_MODES
from ..kernels.ticket_dispatch.ops import PLAN_MODES
from ..device import resolve_device
from ..models.model import decode_step, forward, init_cache
from .admission import LockGate, gate_kind_for_lock, make_gate
from .kv_cache import insert_prefill
from .sampler import sample
from .trace import LockTraceRecorder


@dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    eos_id: int = -1
    ticket: int = -1
    tokens_out: list = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    admitted_at_step: int = -1
    finished_at_step: int = -1

    @property
    def text_ids(self) -> list:
        return list(self.prompt) + list(self.tokens_out)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: dict, *, lanes: int = 4,
                 max_ctx: int = 256, pad_to: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 two_tier: bool = True, threshold: int = 1,
                 lock: str | LockGate | None = None,
                 record_trace: bool = False,
                 store: str | None = None,
                 workload: dict | None = None,
                 device=None, dispatch: str = "auto",
                 scan: str = "auto") -> None:
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if dispatch not in PLAN_MODES:
            raise ValueError(f"unknown dispatch mode {dispatch!r}; "
                             f"options: {PLAN_MODES}")
        if scan not in SCAN_MODES:
            raise ValueError(f"unknown scan mode {scan!r}; options: "
                             f"{SCAN_MODES}")
        self.cfg = cfg
        self.params = params
        self.lanes = lanes
        self.max_ctx = max_ctx
        # Recurrent-state archs can't take right-padded prompts (pads pollute
        # the SSM/LRU state); they prefill at exact length.
        recurrent = any(k in ("mamba", "rglru") for k in cfg.layer_pattern)
        self.pad_to = 1 if recurrent else pad_to
        self.temperature = temperature
        self.dispatch = dispatch
        self.scan = scan
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

        self.gate, self.lock_choice = self._make_gate(
            lock, lanes=lanes, two_tier=two_tier, threshold=threshold,
            store=store, workload=workload)
        self.recorder = (LockTraceRecorder(lanes, gate=self.gate.kind)
                         if record_trace else None)
        self._pending: dict[int, Request] = {}   # ticket -> request
        self._mutex = threading.Lock()

        self.cache = init_cache(cfg, lanes, max_ctx, device=self.device)
        self.lane_req: list[Request | None] = [None] * lanes
        self.lane_pos = np.zeros(lanes, np.int32)        # next write position
        self.lane_last = np.zeros(lanes, np.int32)       # last sampled token
        self.step_count = 0
        self.prefill_count = 0

    # -- lock selection ----------------------------------------------------------
    @staticmethod
    def _make_gate(lock, *, lanes, two_tier, threshold, store, workload):
        """Resolve the ``lock=`` parameter into a gate + a provenance record.

        ``None`` keeps the historical behaviour (``two_tier`` picks twa vs
        single-tier ticket); a string names a registered gate or any
        ``SIM_LOCKS`` algorithm; a :class:`LockGate` instance is used as-is.
        ``"auto"`` (the results-store advisor) raises until ``sim/results/``
        is ported.
        """
        if isinstance(lock, LockGate):
            return lock, {"source": "instance", "gate": lock.kind}
        if lock is None:
            kind = "twa" if two_tier else "ticket"
            return (make_gate(kind, lanes, threshold=threshold),
                    {"source": "default", "gate": kind})
        if lock == "auto":
            raise NotImplementedError(
                "lock='auto' asks the results-store advisor, which is not "
                "ported yet (ROADMAP: sim/results/ with the "
                "REPRO_RESULTS_STORE hook); name a gate or a SIM_LOCKS lock")
        return (make_gate(lock, lanes, threshold=threshold),
                {"source": "explicit", "gate": gate_kind_for_lock(lock)
                 if lock not in ("ticket", "twa", "fissile-twa", "twa-rw")
                 else lock})

    # -- client side -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: int = -1) -> Request:
        req = Request(rid=-1, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id)
        req.ticket = self.gate.draw()
        req.rid = req.ticket
        if self.recorder is not None:
            self.recorder.on_draw(req.ticket)
        with self._mutex:
            self._pending[req.ticket] = req
        return req

    def wait(self, req: Request, timeout_s: float = 60.0) -> Request:
        """Client-side blocking wait: two-tier wait for admission (the TWA
        part), then block on completion."""
        self.gate.wait(req.ticket, timeout_s=timeout_s)
        req.done.wait(timeout_s)
        return req

    # -- engine side -------------------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        toks = sample(logits, self._generator, temperature=self.temperature)
        return toks.cpu().numpy()

    def _admit(self, lane: int, req: Request) -> None:
        L = len(req.prompt)
        if L + req.max_new_tokens > self.max_ctx:
            raise ValueError(f"request {req.rid} exceeds the context: "
                             f"{L} + {req.max_new_tokens} > {self.max_ctx}")
        Lp = -(-L // self.pad_to) * self.pad_to
        tokens = np.zeros((1, Lp), np.int64)
        tokens[0, :L] = req.prompt
        logits, _, new_cache = forward(
            self.params, {"tokens": torch.from_numpy(tokens).to(self.device)},
            self.cfg, dispatch=self.dispatch, scan=self.scan,
            collect_cache=True)
        insert_prefill(self.cache, new_cache, lane)
        first = int(self._sample(logits[0, L - 1][None])[0])
        self.prefill_count += 1
        self.lane_req[lane] = req
        self.lane_pos[lane] = L
        self.lane_last[lane] = first
        req.admitted_at_step = self.step_count
        if self.recorder is not None:
            self.recorder.on_grant(req.ticket)
        req.tokens_out.append(first)
        self._finish_if_done(lane)

    def _finish_if_done(self, lane: int) -> None:
        req = self.lane_req[lane]
        if req is None:
            return
        tok = req.tokens_out[-1] if req.tokens_out else -2
        hit_eos = req.eos_id >= 0 and tok == req.eos_id
        full = len(req.tokens_out) >= req.max_new_tokens
        out_of_ctx = self.lane_pos[lane] + 1 >= self.max_ctx
        if hit_eos or full or out_of_ctx:
            req.finished_at_step = self.step_count
            self.lane_req[lane] = None
            if self.recorder is not None:
                self.recorder.on_release(req.ticket)
            req.done.set()
            self.gate.advance()          # handover: next ticket admitted FIFO

    def _next_ticket_waiting(self):
        with self._mutex:
            waiting = [t for t, r in self._pending.items()
                       if r.admitted_at_step < 0]
        return min(waiting) if waiting else None

    def _fill_free_lanes(self) -> None:
        for lane in range(self.lanes):
            if self.lane_req[lane] is not None:
                continue
            t = self._next_ticket_waiting()
            if t is None or not self.gate.admitted(t):
                break
            with self._mutex:
                req = self._pending.pop(t)
            req.admitted_at_step = self.step_count  # mark before prefill
            self._admit(lane, req)

    def _active(self) -> list:
        return [l for l in range(self.lanes) if self.lane_req[l] is not None]

    def step(self) -> int:
        """Admit + one decode step across all lanes; returns #active lanes."""
        self._fill_free_lanes()
        active = self._active()
        if not active:
            return 0
        tokens = torch.from_numpy(self.lane_last[:, None].astype(np.int64))
        pos = torch.from_numpy(self.lane_pos.astype(np.int64))
        logits, self.cache = decode_step(
            self.params, self.cache, tokens.to(self.device),
            pos.to(self.device), self.cfg, dispatch=self.dispatch,
            scan=self.scan)
        next_tok = self._sample(logits)
        self.step_count += 1
        for lane in active:
            self.lane_pos[lane] += 1
            self.lane_last[lane] = next_tok[lane]
            self.lane_req[lane].tokens_out.append(int(next_tok[lane]))
            self._finish_if_done(lane)
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until all submitted requests complete."""
        for _ in range(max_steps):
            self._fill_free_lanes()
            if not self._active():
                with self._mutex:
                    if not self._pending:
                        return
                continue
            self.step()
        raise RuntimeError("run() exceeded max_steps")

    # -- stats -------------------------------------------------------------------
    def queue_depth(self) -> int:
        """Admission-metadata read, routed through the gate's read path (the
        read-mostly traffic ``twa-rw`` keeps off the hot counters)."""
        if self.recorder is not None:
            self.recorder.on_read()
        return self.gate.read_metadata(self.gate.queue_depth)

    def stats(self) -> dict:
        if self.recorder is not None:
            self.recorder.on_read()
        polls = self.gate.read_metadata(self.gate.poll_stats)
        return {"steps": self.step_count, "lock": self.lock_choice, **polls}

    def finish_trace(self):
        """Finalize and return the recorded :class:`LockTrace`."""
        if self.recorder is None:
            raise ValueError("engine was not constructed with record_trace=True")
        return self.recorder.to_trace()
