"""The lockVM's plain reference: one sweep cell replayed by a sequential
NumPy interpreter, from the benchmark's own copy of the lock generators.

Nothing here imports the program.  :func:`replay` builds the cell's program,
initial state and memory from the cell's coordinates (as the benchmark drew
them), runs :func:`oracle.run_oracle` over it, and returns the columns that
the program's ``run_sweeps`` reports for a cell, sliced to the cell's own
threads and memory words.
"""

from __future__ import annotations

import numpy as np

from .costs import Costs
from .oracle import run_oracle
from .programs import INIT_MEM_GEN, Layout, build_mutexbench, init_state

# The output columns compared, by the names of a ``run_sweeps`` result row.
COLUMNS = ("acquisitions", "waited_acquisitions", "handover_sum",
           "handover_count", "events", "sleeping", "mem", "lat_hist")


def build_cell(cell: dict):
    """``(layout, program, init_pc, init_regs, init_mem)`` of one synthetic
    MutexBench cell: ``cell`` holds ``lock``, ``n_threads``, ``n_locks``,
    ``wa_size``, ``private_arrays``, ``cs_work``, ``ncs_max`` and
    ``collect_latency``."""
    layout = Layout(n_threads=cell["n_threads"], n_locks=cell["n_locks"],
                    wa_size=cell["wa_size"],
                    private_arrays=cell["private_arrays"])
    prog = build_mutexbench(cell["lock"], layout, cs_work=cell["cs_work"],
                            ncs_max=cell["ncs_max"],
                            collect_latency=cell["collect_latency"])
    pc, regs = init_state(layout)
    gen_mem = INIT_MEM_GEN.get(cell["lock"])
    init_mem = (gen_mem(layout) if gen_mem
                else np.zeros(layout.mem_words, np.int32))
    return layout, prog, pc, regs, init_mem


def replay(cell: dict, mutate: tuple = ()) -> dict:
    """The reference's output columns of one cell (``lat_hist`` where the
    cell collects latency) (``cell`` as for
    :func:`build_cell`, plus ``seed``, ``horizon``, ``max_events`` and
    ``costs``, a dict of :class:`Costs` fields).  ``mutate`` names
    :data:`oracle.ORACLE_MUTATIONS` to break (the control)."""
    layout, prog, pc, regs, init_mem = build_cell(cell)
    out = run_oracle(prog, n_threads=layout.n_threads,
                     mem_words=layout.mem_words, n_locks=layout.n_locks,
                     init_pc=pc, init_regs=regs, wa_base=layout.wa_base,
                     wa_size=layout.wa_size, horizon=cell["horizon"],
                     max_events=cell["max_events"], seed=cell["seed"],
                     costs=Costs(**cell["costs"]), init_mem=init_mem,
                     mutate=tuple(mutate))
    out["mem"] = out.pop("grant_value")
    return {k: np.asarray(out[k]) for k in COLUMNS
            if k != "lat_hist" or cell["collect_latency"]}


def mismatches(program_row: dict, reference: dict) -> list:
    """The columns on which a cell's program row and the reference differ
    (every element compared exactly; a column missing from the row
    differs)."""
    return [k for k, want in reference.items()
            if k not in program_row
            or not np.array_equal(np.asarray(program_row[k]), want)]
