"""Serving layer: continuous batching with ticket-FIFO admission.

The admission path is the paper's algorithm applied at the request level:
arriving requests draw a ticket (FetchAdd doorway), the engine's `grant`
counter advances as decode lanes free up, and waiting clients use TWA
two-tier waiting — the immediate successors poll the grant counter,
everyone else parks on hashed slots of the shared waiting array and is
promoted FIFO.

The lock is pluggable (`LockGate` / `make_gate`): ticket (global spinning),
twa (two-tier), fissile-twa (fast grant-spin window then TWA) and twa-rw
(registered metadata reads).  `record_trace=True` captures a `LockTrace`
that `repro_torch.sim.traces` compiles into a sweepable lockVM workload.
"""

from .admission import (GATES, FissileTWAGate, LockGate, RWTWAGate,
                        TicketGate, TWAGate, gate_kind_for_lock, make_gate)
from .engine import Request, ServeEngine
from .kv_cache import insert_prefill
from .sampler import sample
from .trace import TRACE_VERSION, LockTrace, LockTraceRecorder, load_trace

__all__ = [
    "GATES", "FissileTWAGate", "LockGate", "LockTrace", "LockTraceRecorder",
    "RWTWAGate", "Request", "ServeEngine", "TRACE_VERSION", "TWAGate",
    "TicketGate", "gate_kind_for_lock", "insert_prefill", "load_trace",
    "make_gate", "sample",
]
