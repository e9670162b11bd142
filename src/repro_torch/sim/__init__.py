"""lockVM — the discrete-event simulator for the paper's lock algorithms,
in PyTorch, with its event loop as a hand-written CUDA kernel."""

from .costs import Costs, DEFAULT_COSTS
from .engine import (EVENT_ORDER_CONTRACT, OUT_KEYS, STAT_KEYS, choose_mode,
                     debug_states, run_sim)
from .programs import (ACQUIRE_GEN, INIT_MEM_GEN, LT_THRESHOLD, Layout,
                       PROG_LEN, RELEASE_GEN, RW_WRITER_W, SIM_LOCKS,
                       build_invalidation_diameter, build_mutexbench,
                       build_occupancy_probe, build_rw_probe, init_state,
                       pad_mem, pad_program, pad_threads,
                       read_collision_counters)
from .traces import (TraceLayout, TraceWorkload, build_trace_bench,
                     quantize_trace, trace_init_mem, trace_layout_for,
                     trace_sweep_spec, trace_workload_coords,
                     workload_from_meta)
from .workloads import (SweepCell, SweepSpec, fig1_invalidation_diameter,
                        fig2_interlock_interference, hist_percentile,
                        latency_percentiles, median_throughput,
                        mutexbench_curve, pack_engine_cells, run_contention,
                        run_sweep, run_sweeps, sweep_curves,
                        sweep_engine_args)

__all__ = [
    "TraceLayout", "TraceWorkload", "build_trace_bench", "quantize_trace",
    "trace_init_mem", "trace_layout_for", "trace_sweep_spec",
    "trace_workload_coords", "workload_from_meta",
    "Costs", "DEFAULT_COSTS", "run_sim", "debug_states", "choose_mode",
    "EVENT_ORDER_CONTRACT", "OUT_KEYS", "STAT_KEYS", "Layout", "SIM_LOCKS",
    "PROG_LEN", "LT_THRESHOLD", "build_mutexbench",
    "build_invalidation_diameter", "build_occupancy_probe", "build_rw_probe",
    "RW_WRITER_W", "read_collision_counters", "init_state",
    "pad_program", "pad_threads", "pad_mem",
    "ACQUIRE_GEN", "RELEASE_GEN", "INIT_MEM_GEN",
    "SweepSpec", "SweepCell", "run_sweep", "run_sweeps", "sweep_curves",
    "sweep_engine_args",
    "pack_engine_cells", "hist_percentile", "latency_percentiles",
    "fig1_invalidation_diameter", "fig2_interlock_interference",
    "mutexbench_curve", "run_contention", "median_throughput",
]
