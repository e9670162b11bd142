"""The port's CUDA kernels (the lockVM, the MoE ticket dispatch and routing
plan, the Mamba selective scan and the RG-LRU scan): their build, their
wrappers and their entry points.

Runs here on the CPU for what does not need a card — the build commands and
the generated constants headers, the parallel build, the device rules of
the entry points (no quiet CPU fallback), the wrapper's plain version on
CPU tensors.  The kernel-vs-plain cases need a CUDA device: they are marked
``cuda`` and skip with "no CUDA device" where there is none.  On a GPU host:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: bit-identical int32 outputs, and bit-identical tokens for the
serve runs whose MoE layers go through the routing-plan kernel or the
ticket kernel.  The routing plan is bit-identical to its plain version but
for the aux loss's gate sums, which the kernel sums in another order
(rtol 1e-6).  The scan kernel
keeps its state in float32: it is held to the plain loop on float32 casts
of its inputs within rtol = atol = 1e-5 for float32 inputs and 5e-2 for
bf16 (the reference's tolerances for its kernel); the two-layer Mamba
serve in float32 gives the plain path's tokens, with first-token logits
within 1e-4 (float32 sums in other orders across 4,096-wide layers).  The
RG-LRU kernel keeps its state in float32 too and is held to the plain
loop the same way; the three-layer recurrentgemma serve in float32 gives
the plain path's tokens and first-token logits within 1e-4.
"""

import dataclasses
import os
import re
import secrets
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import _build
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_ref
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_ref
from repro_torch.kernels.ticket_dispatch import assign_slots, dispatch_ref
from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
from repro_torch.kernels.ticket_dispatch import plan as plan_kernel
from repro_torch.kernels.ticket_dispatch import plan_ref, route_plan
from repro_torch.models.layers import moe_capacity
from repro_torch.models.model import init_params
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.sim import SIM_LOCKS, SweepSpec, engine, engine_cuda, isa
from repro_torch.sim import costs, faults, run_sim, sweep_engine_args
from repro_torch.sim import workloads
from repro_torch.sim.corpus import load_scenario, scenario_sweep_args
from repro_torch.sim.programs import Layout, build_mutexbench, init_state

CORPUS = sorted(Path(__file__).parent.joinpath("corpus").glob("*.npz"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_sweep_kwargs():
    layout = Layout(n_threads=4, n_locks=1)
    pc, regs = init_state(layout)
    return build_mutexbench("ticket", layout)[None], dict(
        mem_words=layout.mem_words, n_locks=1, init_pc=pc[None],
        init_regs=regs[None], n_active=4, seeds=1, wa_base=layout.wa_base,
        wa_size=layout.wa_size, horizon=500)


# ---------------------------------------------------------------------------
# Device rules of the entry points
# ---------------------------------------------------------------------------
def test_mode_cuda_on_cpu_raises():
    progs, kw = _tiny_sweep_kwargs()
    with pytest.raises(ValueError, match="CUDA"):
        engine.run_sweep(progs, **kw, mode="cuda", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        engine.run_sweep(progs, **kw, mode="pallas", device="cpu")
    assert engine.choose_mode("cpu") == "torch"
    assert engine.choose_mode("cuda") == "cuda"


def test_entry_points_without_device_raise_without_cuda(no_cuda):
    progs, kw = _tiny_sweep_kwargs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_sweep(progs, **kw)
    spec = SweepSpec(locks="ticket", threads=2, seeds=1, horizon=300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads.run_sweep(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads.run_contention("ticket", 2, horizon=300)
    layout = Layout(n_threads=2, n_locks=1)
    pc, regs = init_state(layout)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sim(build_mutexbench("ticket", layout), n_threads=2,
                mem_words=layout.mem_words, n_locks=1, init_pc=pc,
                init_regs=regs, wa_base=layout.wa_base,
                wa_size=layout.wa_size, horizon=300)
    # with the device named, the same calls run the plain engine
    assert workloads.run_sweep(spec, device="cpu")[0]["mode"] == "torch"


def test_wrapper_runs_its_plain_version_on_cpu_tensors():
    progs, kw, _ = sweep_engine_args([SweepSpec(
        locks=("ticket", "twa-timo"), threads=(2, 5), seeds=1, horizon=600,
        preempt_faults=1, spurious_faults=1, fault_evt_span=200)])
    kw.pop("live_mem_words")
    n_locks = kw.pop("n_locks")
    args = engine.sweep_inputs(progs, **kw, device=torch.device("cpu"))
    before = engine_cuda.launches
    out = engine_cuda.run_cells(*args, n_locks=n_locks)
    ref = engine.run_cells(*args, n_locks=n_locks)
    assert engine_cuda.launches == before  # no kernel launched on the CPU
    for k in engine.OUT_KEYS:
        assert out[k].dtype == torch.int32
        assert torch.equal(out[k], ref[k]), k


def test_wrapper_checks_its_inputs():
    progs, kw = _tiny_sweep_kwargs()
    kw.pop("n_locks")
    args = list(engine.sweep_inputs(progs, **kw, device=torch.device("cpu")))
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError, match="init_pc"):
        engine_cuda.run_cells(*bad, n_locks=1)
    bad = list(args)
    bad[0] = bad[0][:, :, :4].contiguous()
    with pytest.raises(ValueError, match="shape"):
        engine_cuda.run_cells(*bad, n_locks=1)
    bad = list(args)
    bad[2] = bad[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        engine_cuda.run_cells(*bad, n_locks=1)


def test_state_placement_keyword_is_checked():
    """``cuda_state``, on the kernel's wrapper and on the engine alike,
    picks where the kernel keeps a cell's state; it belongs to the kernel
    alone."""
    progs, kw = _tiny_sweep_kwargs()
    n_locks = kw.pop("n_locks")
    args = engine.sweep_inputs(progs, **kw, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="cuda_state must be one of"):
        engine_cuda.run_cells(*args, n_locks=n_locks, cuda_state="shared")
    assert engine_cuda.STATE_PLACEMENTS == ("auto", "smem", "global")
    progs, kw = _tiny_sweep_kwargs()
    with pytest.raises(ValueError, match="cuda_state only applies"):
        engine.run_sweep(progs, **kw, mode="torch", device="cpu",
                         cuda_state="global")


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------
def test_build_command_targets_sm90a_from_csrc_only(tmp_path):
    header = tmp_path / "h.h"
    cmd = _build.build_command("lockvm", tmp_path / "lib.so", header)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-O3", "-shared", "-fPIC"):
        assert flag in cmd
    csrc = Path(_build.__file__).parent / "csrc"
    assert _build.CSRC == csrc.resolve()
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".h"))]
    assert inputs == [str(header), str(csrc.resolve() / "lockvm.cu")]
    assert cmd[cmd.index("-I") + 1] == str(csrc.resolve())
    # every source the build hashes and reads lies under csrc/
    for path in _build.sources("lockvm"):
        assert path.parent == csrc.resolve() and path.is_file()
    # and the kernel source includes nothing of the repository outside it
    for path in _build.sources("lockvm"):
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert (csrc / inc).is_file(), inc


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(Path, "is_file", lambda self: False)
    monkeypatch.delitem(_build._libs, "lockvm", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library("lockvm")


def test_generated_header_matches_the_python_constants():
    text = _build.constants_header()
    defs = dict(re.findall(r"#define (\w+) (-?\d+)", text))
    defs = {k: int(v) for k, v in defs.items()}
    for op, name in isa.OP_NAMES.items():
        assert defs[f"OP_{name}"] == op
    assert defs["N_OPS"] == isa.N_OPS == len(isa.OP_NAMES)
    assert defs["N_REGS"] == isa.N_REGS
    assert defs["LINE_SHIFT"] == isa.LINE_SHIFT
    assert defs["WORDS_PER_SECTOR"] == isa.WORDS_PER_SECTOR
    assert defs["N_COSTS"] == len(costs.DEFAULT_COSTS.to_array())
    for name in ("I_LOCAL", "I_HIT", "I_MISS", "I_XFER", "I_ST_OWNED",
                 "I_ST_SHARED", "I_INV", "I_ATOMIC", "I_WAKE"):
        assert defs[name] == getattr(costs, name)
    assert defs["INF"] == engine.INF
    assert defs["N_LAT_BUCKETS"] == engine.N_LAT_BUCKETS
    for name in ("F_PREEMPT", "F_SPURIOUS", "F_ABORT"):
        assert defs[name] == getattr(faults, name)
    # the kernel source never types one of these constants itself
    src = "".join(p.read_text() for p in _build.sources("lockvm"))
    for name in defs:
        assert not re.search(rf"#define\s+{name}\b", src), name


def test_ticket_build_command_and_generated_header(tmp_path):
    header = tmp_path / "h.h"
    cmd = _build.build_command("ticket_dispatch", tmp_path / "lib.so",
                               header)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    csrc = _build.CSRC
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".h"))]
    assert inputs == [str(header), str(csrc / "ticket_dispatch.cu")]
    srcs = _build.sources("ticket_dispatch")
    assert [p.name for p in srcs] == ["ticket_dispatch.cu",
                                      "ticket_dispatch_kernel.cuh"]
    for path in srcs:
        assert path.is_file()
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert (csrc / inc).is_file(), inc
    defs = {k: int(v) for k, v in re.findall(
        r"#define (\w+) (-?\d+)", _build.ticket_constants_header())}
    assert defs == {"TD_THREADS": ticket_kernel.THREADS,
                    "TD_SMEM_LIMIT": ticket_kernel.SMEM_LIMIT}
    assert ticket_kernel.THREADS % 32 == 0
    src = "".join(p.read_text() for p in srcs)
    for name in defs:
        assert not re.search(rf"#define\s+{name}\b", src), name
    with pytest.raises(ValueError, match="unknown kernel"):
        _build.sources("nope")


def test_scan_build_command_and_generated_header(tmp_path):
    header = tmp_path / "h.h"
    cmd = _build.build_command("mamba_scan", tmp_path / "lib.so", header)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "--use_fast_math" not in cmd    # expf, as the reference's exp
    csrc = _build.CSRC
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".h"))]
    assert inputs == [str(header), str(csrc / "mamba_scan.cu")]
    srcs = _build.sources("mamba_scan")
    assert [p.name for p in srcs] == ["mamba_scan.cu",
                                      "mamba_scan_kernel.cuh"]
    for path in srcs:
        assert path.is_file() and path.parent == csrc
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert (csrc / inc).is_file(), inc
    defs = {k: int(v) for k, v in re.findall(
        r"#define (\w+) (-?\d+)", _build.mamba_constants_header())}
    assert defs == {"MS_THREADS": scan_kernel.THREADS,
                    "MS_LANES": scan_kernel.LANES,
                    "MS_CHUNK": scan_kernel.CHUNK,
                    "MS_MIN_N": min(scan_kernel.STATE_SIZES),
                    "MS_MAX_N": max(scan_kernel.STATE_SIZES),
                    "MS_BF16_X": 1, "MS_BF16_DT": 2, "MS_BF16_A": 4,
                    "MS_BF16_B": 8, "MS_BF16_C": 16, "MS_BF16_D_SKIP": 32,
                    "MS_BF16_H0": 64}
    # each input its own bit, and the kernel reads every one of them
    assert sorted(scan_kernel.BF16_BITS.values()) == [1 << i
                                                      for i in range(7)]
    # every state size divides a warp and the block, and the lanes of a
    # channel divide every state size
    for n in scan_kernel.STATE_SIZES:
        assert 32 % n == 0 and scan_kernel.THREADS % n == 0
        assert n % scan_kernel.LANES == 0
    src = "".join(p.read_text() for p in srcs)
    for name in defs:
        assert not re.search(rf"#define\s+{name}\b", src), name
        if name.startswith("MS_BF16_"):
            assert re.search(rf"bf16 & {name}\b", src), name


def test_rglru_build_command_and_generated_header(tmp_path):
    header = tmp_path / "h.h"
    cmd = _build.build_command("rglru_scan", tmp_path / "lib.so", header)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "--use_fast_math" not in cmd
    csrc = _build.CSRC
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".h"))]
    assert inputs == [str(header), str(csrc / "rglru_scan.cu")]
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    srcs = _build.sources("rglru_scan")
    assert [p.name for p in srcs] == ["rglru_scan.cu",
                                      "rglru_scan_kernel.cuh"]
    for path in srcs:
        assert path.is_file() and path.parent == csrc
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert (csrc / inc).is_file(), inc
    defs = {k: int(v) for k, v in re.findall(
        r"#define (\w+) (-?\d+)", _build.rglru_constants_header())}
    assert defs == {"RG_CHANNELS": rglru_kernel.CHANNELS,
                    "RG_THREADS": rglru_kernel.THREADS,
                    "RG_STEPS": rglru_kernel.STEPS,
                    "RG_STAGES": rglru_kernel.STAGES, "RG_BF16_A": 1,
                    "RG_BF16_B": 2, "RG_BF16_H0": 4}
    assert sorted(rglru_kernel.BF16_BITS.values()) == [1, 2, 4]
    # a chain warp of 32 channels, a copy and a store warp (the header's
    # #error)
    assert (rglru_kernel.CHANNELS, rglru_kernel.THREADS) == (32, 96)
    # every dtype's ring fits a block's shared memory on sm_90 (227 KB)
    assert max(rglru_kernel.smem_bytes(ba, bb) for ba in (False, True)
               for bb in (False, True)) <= 232_448
    src = "".join(p.read_text() for p in srcs)
    for name in defs:
        assert not re.search(rf"#define\s+{name}\b", src), name
        if name.startswith("RG_BF16_"):
            assert re.search(rf"bf16 & {name}\b", src), name


def test_libraries_build_in_parallel(monkeypatch, tmp_path):
    """One nvcc per missing library, all started before any is waited on."""
    log = tmp_path / "log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n"
                    f"echo start >> {log}\nsleep 2\necho end >> {log}\n"
                    'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Path(path))
    names = list(_build.KERNELS)
    assert names == ["lockvm", "ticket_dispatch", "mamba_scan", "rglru_scan",
                     "moe_plan"]
    libs = _build.load_libraries(names)
    assert log.read_text().split() == ["start"] * 5 + ["end"] * 5
    assert [p.name.split("-")[0] for p in libs] == [f"lib{n}" for n in names]
    assert all(p.exists() for p in libs)
    assert set(_build.build_logs) == set(names)
    # a second call builds nothing: the hashed libraries are reused
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.load_libraries(["ticket_dispatch"]) == libs[1:2]
    assert log.read_text().split().count("start") == 5


def test_cell_state_bytes_fits_fig3_in_shared_memory():
    mem64 = Layout(n_threads=64, n_locks=1).mem_words
    assert engine_cuda.cell_state_bytes(64, mem64) <= 48 * 1024
    big = Layout(n_threads=64, n_locks=1, wa_size=65536).mem_words
    assert engine_cuda.cell_state_bytes(64, big) > engine_cuda.SMEM_LIMIT


def test_state_placement_of_fig2_pools():
    """fig2's private-array cells: 8 locks (37,376 memory words) fit shared
    memory, 64 locks (284,672) run from global scratch; a forced placement
    wins where it can."""
    def place(n_locks, cuda_state="auto"):
        layout = Layout(n_threads=64, n_locks=n_locks, private_arrays=True)
        return engine_cuda.state_placement(64, layout.mem_words, n_locks,
                                           cuda_state=cuda_state)
    assert Layout(n_threads=64, n_locks=64,
                  private_arrays=True).mem_words == 284_672
    assert [place(n) for n in (1, 8, 64)] == ["smem", "smem", "global"]
    assert place(8, "global") == "global" and place(8, "smem") == "smem"
    with pytest.raises(ValueError, match="does not fit"):
        place(64, "smem")
    with pytest.raises(ValueError, match="cuda_state must be one of"):
        place(8, "shared")


# ---------------------------------------------------------------------------
# Kernel vs plain engine (CUDA device only)
# ---------------------------------------------------------------------------
def _kernel_vs_plain(args, n_locks):
    before = engine_cuda.launches
    k_out = engine_cuda.run_cells(*args, n_locks=n_locks)
    torch.cuda.synchronize()
    assert engine_cuda.launches == before + 1
    p_out = engine.run_cells(*args, n_locks=n_locks)
    for key in engine.OUT_KEYS:
        assert torch.equal(k_out[key], p_out[key]), key
    return k_out


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_corpus(cuda_device):
    progs, kw = scenario_sweep_args([load_scenario(p) for p in CORPUS])
    n_locks = kw.pop("n_locks")
    _kernel_vs_plain(engine.sweep_inputs(progs, **kw, device=cuda_device),
                     n_locks)


@pytest.mark.cuda
def test_kernel_matches_plain_on_faults_and_fig3_cells(cuda_device):
    specs = [SweepSpec(locks=tuple(SIM_LOCKS), threads=(1, 3, 8), seeds=2,
                       horizon=3_000, preempt_faults=2, spurious_faults=2,
                       abort_faults=1, fault_evt_span=1_500,
                       collect_latency=True),
             SweepSpec(locks=("ticket", "twa", "mcs"), threads=(33, 64),
                       seeds=1, horizon=1_500, collect_latency=True)]
    progs, kw, _ = sweep_engine_args(specs)
    kw.pop("live_mem_words")
    n_locks = kw.pop("n_locks")
    _kernel_vs_plain(engine.sweep_inputs(progs, **kw, device=cuda_device),
                     n_locks)


@pytest.mark.cuda
def test_kernel_state_in_global_scratch_matches_plain(cuda_device):
    """A cell too large for shared memory runs from global scratch."""
    spec = SweepSpec(locks=("twa", "twa-id"), threads=(8, 40), seeds=1,
                     wa_size=65536, horizon=2_000)
    progs, kw, _ = sweep_engine_args([spec])
    assert engine_cuda.cell_state_bytes(
        40, kw["mem_words"]) > engine_cuda.SMEM_LIMIT
    kw.pop("live_mem_words")
    n_locks = kw.pop("n_locks")
    _kernel_vs_plain(engine.sweep_inputs(progs, **kw, device=cuda_device),
                     n_locks)


@pytest.mark.cuda
def test_forced_state_placements_are_bit_identical(cuda_device):
    """The checker's ``cuda_state`` pins: the same fuzz batch with every
    cell's state forced into shared memory and into global scratch (rows in
    memory, not registers) gives the same stats, which are the plain
    engine's; a cell too large for shared memory refuses ``"smem"``."""
    from repro_torch.sim.check import generate_batch, run_engine_batch
    batch = generate_batch(64, 3, fault_fraction=0.5, trace_fraction=0.2)
    outs = {}
    for state in ("smem", "global"):
        pinned = [s.replace(meta={**s.meta, "cuda_state": state})
                  for s in batch]
        before = engine_cuda.launches
        outs[state] = run_engine_batch(pinned, "cuda", device=cuda_device)
        assert engine_cuda.launches == before + 1
    plain = run_engine_batch(
        [s.replace(meta={**s.meta, "torch_chunk": 16}) for s in batch],
        "torch", device="cpu")
    for i, (a, b, c) in enumerate(zip(outs["smem"], outs["global"], plain)):
        for key in engine.STAT_KEYS:
            assert np.array_equal(a[key], b[key]), (i, key)
            assert np.array_equal(a[key], c[key]), (i, key)
    spec = SweepSpec(locks="twa", threads=40, seeds=1, wa_size=65536,
                     horizon=500)
    progs, kw, _ = sweep_engine_args([spec])
    kw.pop("live_mem_words")
    with pytest.raises(ValueError, match="does not fit"):
        engine.run_sweep(progs, **kw, mode="cuda", device=cuda_device,
                         cuda_state="smem")


@pytest.mark.cuda
def test_checker_cuda_lane_on_a_fresh_fault_batch(cuda_device):
    """1,024 cases at a seed drawn anew, a quarter with fault schedules and
    a tenth trace-compiled, through the kernel against the batch oracle: no
    failing case but the reference's known ``twa-staged`` stall (no
    differential), one launch per state placement, both placements
    drawn."""
    from repro_torch.sim.check import fuzz, generate_batch, reference_stall
    seed = secrets.randbelow(1 << 31)
    batch = generate_batch(1024, seed, fault_fraction=0.25,
                           trace_fraction=0.1)
    before = engine_cuda.launches
    report = fuzz(batch, modes=("cuda",), sched_seed=seed,
                  batch_oracle=True, device=cuda_device)
    assert all(reference_stall(s, msgs) for _, s, msgs in report.failures), \
        f"seed {seed}: " + report.summary()
    assert engine_cuda.launches == before + 2
    assert set(report.placements) == {"cuda:smem", "cuda:global"}
    assert sum(report.placements.values()) == 1024


@pytest.mark.cuda
def test_checker_cuda_lane_replays_the_corpus(cuda_device):
    from repro_torch.sim.check import failure_classes, replay_corpus
    problems = replay_corpus(CORPUS, modes=("cuda",), device=cuda_device)
    for path, probs in zip(CORPUS, problems):
        expect = set(load_scenario(path).meta.get("expect_classes", []))
        assert failure_classes(probs) == expect, (path.stem, probs[:4])


@pytest.mark.cuda
def test_fig2_figure_kernel_matches_plain(cuda_device, monkeypatch):
    """One reduced figure end to end on the card: fig2 at pools 8 and 64
    (the 64-lock launch from global scratch) at horizon 1,000, through the
    kernel and through the plain engine, prints the same rows."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.bench import fig2_interlock_interference as fig2

    orig = workloads.run_sweep

    def rows(mode):
        monkeypatch.setattr(workloads, "run_sweep", lambda spec, **kw: orig(
            dataclasses.replace(spec, horizon=1_000), mode=mode, **kw))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            fig2.run((8, 64), device=cuda_device)
        return out.getvalue().splitlines()

    before = engine_cuda.launches
    kernel = rows("cuda")
    assert engine_cuda.launches == before + 2
    assert rows("torch") == kernel
    assert engine_cuda.launches == before + 2
    assert len(kernel) == 3 and kernel[1].startswith("fig2/locks=64,")


@pytest.mark.cuda
def test_kernel_rows_in_memory_past_128_threads_match_plain(cuda_device):
    """130 threads: past the 128 whose rows the kernel keeps in the
    registers of their lanes, so the rows live in shared memory."""
    spec = SweepSpec(locks=("ticket", "twa"), threads=(130,), seeds=1,
                     horizon=600, collect_latency=True)
    progs, kw, _ = sweep_engine_args([spec])
    kw.pop("live_mem_words")
    n_locks = kw.pop("n_locks")
    _kernel_vs_plain(engine.sweep_inputs(progs, **kw, device=cuda_device),
                     n_locks)


@pytest.mark.cuda
def test_auto_mode_resolves_to_the_kernel(cuda_device):
    spec = SweepSpec(locks=("ticket", "twa"), threads=(2, 16), seeds=1,
                     horizon=5_000, collect_latency=True)
    before = engine_cuda.launches
    rows = workloads.run_sweep(spec, device=cuda_device)
    assert engine_cuda.launches == before + 1
    assert {r["mode"] for r in rows} == {"cuda"}
    plain = workloads.run_sweep(spec, device=cuda_device, mode="torch")
    for a, b in zip(rows, plain):
        for k in ("acquisitions", "events", "mem", "lat_hist"):
            assert np.array_equal(a[k], b[k]), k
    assert engine_cuda.state_words_from_kernel(64, 6464, 1) * 4 == \
        engine_cuda.cell_state_bytes(64, 6464, 1)
    assert os.path.exists(_build.build_dir())


# ---------------------------------------------------------------------------
# Ticket-dispatch kernel and the serve path (CUDA device only)
# ---------------------------------------------------------------------------
def _ticket_cases():
    """(ids (G, n), E, capacity): granite-moe's prefill groups (N·K = 8·Lp)
    and decode group (8 lanes), 16 groups at once, a million arrivals in
    one group, E from 1 to the shared-memory limit, a skewed draw and ids
    outside [0, E)."""
    rng = np.random.default_rng(0)

    def ids(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=shape)
                                .astype(np.int32))

    granite = get_config("granite-moe-1b-a400m")
    cases = [(ids((1, 8 * lp), 0, 32), 32, moe_capacity(granite, lp))
             for lp in (16, 128, 512)]
    cases += [(ids((1, 64), 0, 32), 32, 8), (ids((16, 1024), 0, 32), 32, 40),
              (ids((1, 1 << 20), 0, 32), 32, 40_960)]
    cases += [(ids((3, 777), 0, e), e, 64)
              for e in (1, 5, 8, 100, 128, ticket_kernel.MAX_EXPERTS)]
    cases += [(torch.full((2, 5000), 7, dtype=torch.int32), 32, 160),
              (ids((2, 999), -3, 35), 32, 20),
              # wrapped ids and the INT32_MIN fill, as the reference
              (ids((2, 999), -64, 64), 32, 20)]
    return cases


@pytest.mark.cuda
def test_ticket_kernel_matches_plain(cuda_device):
    for ids, n_experts, capacity in _ticket_cases():
        d_ids = ids.to(cuda_device)
        before = ticket_kernel.launches
        t, s = ticket_kernel.ticket_dispatch(d_ids, n_experts, capacity)
        torch.cuda.synchronize()
        assert ticket_kernel.launches == before + 1
        p_t, p_s = dispatch_ref(d_ids, n_experts, capacity, grouped=True)
        assert torch.equal(t, p_t), (tuple(ids.shape), n_experts)
        assert torch.equal(s, p_s), (tuple(ids.shape), n_experts)
        c_t, c_s = dispatch_ref(ids, n_experts, capacity, grouped=True)
        assert torch.equal(t.cpu(), c_t) and torch.equal(s.cpu(), c_s)
    # the public op: auto launches, torch does not
    ids = torch.randint(0, 8, (4, 16, 2), dtype=torch.int32,
                        device=cuda_device)
    before = ticket_kernel.launches
    a = assign_slots(ids, 8, 6, grouped=True)
    b = assign_slots(ids, 8, 6, grouped=True, mode="torch")
    assert ticket_kernel.launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _plan_cases():
    """(name, gates_full (G, N, E) float32 softmax, K, capacity, dtype):
    granite-moe's prefill groups and decode group, 16 groups at once, a
    group longer than the kernel's stage, gates tied to the bit, all mass
    on one expert (drops), grok-1's E 8 / K 2, float32 gates."""
    rng = np.random.default_rng(3)
    granite = get_config("granite-moe-1b-a400m")

    def soft(G, N, E, logits=None):
        if logits is None:
            logits = rng.normal(size=(G, N, E))
        return torch.softmax(torch.from_numpy(logits.astype(np.float32)), -1)

    bf16 = torch.bfloat16
    cases = [(f"prefill_Lp{lp}", soft(1, lp, 32), 8,
              moe_capacity(granite, lp), bf16) for lp in (16, 128, 512)]
    cases += [("decode", soft(1, 8, 32), 8, 8, bf16),
              ("16_groups", soft(16, 128, 32), 8, 40, bf16),
              ("two_chunks", soft(1, 1100, 32), 8, 280, torch.float32),
              ("ties", soft(2, 64, 32, np.round(rng.normal(size=(2, 64, 32))
                                                 * 2) / 2), 8, 16, bf16),
              ("one_expert_drops", soft(1, 64, 32, np.where(
                  np.arange(32) == 5, 20.0, 0.0) + np.zeros((1, 64, 32))),
               8, 16, bf16),
              ("grok_E8_K2", soft(3, 40, 8), 2, 16, bf16)]
    return cases


@pytest.mark.cuda
def test_plan_kernel_matches_plain(cuda_device):
    """Every output of the routing-plan kernel equals the plain plan's bit
    for bit, but the gate sums, which are summed in another order (within
    1e-6 relative); the plan on the CPU equals the plain plan on the card."""
    for name, gates_full, K, cap, dtype in _plan_cases():
        d_gates = gates_full.to(cuda_device)
        before = plan_kernel.launches
        got = route_plan(d_gates, gates_full.shape[-1], K, cap, dtype)
        torch.cuda.synchronize()
        assert plan_kernel.launches == before + 1
        want = plan_ref(d_gates, K, cap, dtype)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, (name, key)
            if key == "gate_sums":
                torch.testing.assert_close(got[key], value, rtol=1e-6,
                                           atol=0, msg=name)
            else:
                assert torch.equal(got[key], value), (name, key)
        host = plan_ref(gates_full, K, cap, dtype)
        for key in ("top_ids", "slot", "kept", "safe_idx", "slot_tok",
                    "valid", "first_counts"):
            assert torch.equal(want[key].cpu(), host[key]), (name, key)


@pytest.mark.cuda
def test_two_layer_granite_serve_kernel_matches_plain_dispatch(cuda_device):
    """Full-width granite-moe cut to two layers, bf16 on the card: the
    tokens with the routing-plan kernel, and with the plain plan around the
    ticket kernel, equal the tokens of the plain plan, bit for bit, and
    every MoE layer launched its kernel once per pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(16, 120)))
               .tolist() for _ in range(6)]
    out = {}
    for dispatch in ("auto", "ticket", "torch"):
        eng = ServeEngine(cfg, params, lanes=4, max_ctx=160,
                          device=cuda_device, dispatch=dispatch)
        before = (plan_kernel.launches, ticket_kernel.launches)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        launched = (plan_kernel.launches - before[0],
                    ticket_kernel.launches - before[1])
        passes = cfg.n_layers * (eng.prefill_count + eng.step_count)
        assert launched == {"auto": (passes, 0), "ticket": (0, passes),
                            "torch": (0, 0)}[dispatch]
        out[dispatch] = [r.tokens_out for r in reqs]
        assert all(len(t) == 8 for t in out[dispatch])
    assert out["auto"] == out["ticket"] == out["torch"]


# ---------------------------------------------------------------------------
# Selective-scan kernel and the Mamba serve path (CUDA device only)
# ---------------------------------------------------------------------------
def _scan_cases():
    """(name, inputs as float32 numpy, dtype): falcon-mamba-7b's full-width
    prefill (L 256, D 8,192, N 16) in bf16 and float32, tests/test_kernels
    .py's shapes, L 1 and 33, D 20, N 4 and 8, a batch of 2 with h0 shared
    and per sequence, and mixed dtypes (float32 A and D_skip, bf16 rest)."""
    rng = np.random.default_rng(0)

    def draw(L, D, N, lead=(), per_seq=False, h0=False):
        own = lead if per_seq else ()
        arrays = [rng.normal(size=lead + (L, D)),
                  rng.uniform(0.01, 0.2, size=lead + (L, D)),
                  -rng.uniform(0.5, 2.0, size=own + (D, N)),
                  rng.normal(size=lead + (L, N)),
                  rng.normal(size=lead + (L, N)), rng.normal(size=own + (D,)),
                  rng.normal(size=own + (D, N)) if h0 else None]
        return [None if a is None else a.astype(np.float32) for a in arrays]

    cases = [("prefill_bf16", draw(256, 8192, 16), "bf16"),
             ("prefill_f32", draw(256, 8192, 16), "f32")]
    cases += [(f"L{L}_D{D}_N{N}", draw(L, D, N), dt) for L, D, N, dt in (
        (16, 8, 4, "f32"), (100, 96, 16, "f32"), (256, 128, 16, "f32"),
        (33, 20, 8, "f32"), (64, 64, 16, "bf16"), (1, 40, 16, "f32"),
        (33, 40, 16, "bf16"), (70, 20, 4, "f32"), (70, 20, 8, "f32"))]
    cases += [("batch2_h0_shared", draw(40, 24, 8, (2,), h0=True), "f32"),
              ("batch2_h0_per_seq", draw(40, 24, 8, (2,), True, True),
               "bf16"),
              ("mixed_dtypes", draw(50, 30, 16), "mixed")]
    return cases


def _on(arrays, dtype, device):
    """The inputs on ``device``: all in ``dtype`` ("f32", "bf16"), or bf16
    with float32 A and D_skip ("mixed")."""
    out = []
    for i, a in enumerate(arrays):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(a).to(device)
        bf16 = dtype == "bf16" or (dtype == "mixed" and i not in (2, 5))
        out.append(t.to(torch.bfloat16) if bf16 else t)
    return out


@pytest.mark.cuda
def test_scan_kernel_matches_plain(cuda_device):
    cases = _scan_cases()
    for name, arrays, dtype in cases:
        args = _on(arrays, dtype, cuda_device)
        before = scan_kernel.launches
        y, h = scan_kernel.selective_scan(*args)
        torch.cuda.synchronize()
        assert scan_kernel.launches == before + 1
        assert y.dtype == h.dtype == args[0].dtype
        ry, rh = selective_scan_ref(*(None if a is None else a.float()
                                      for a in args))
        tol = 1e-5 if dtype == "f32" else 5e-2
        torch.testing.assert_close(y.float(), ry, rtol=tol, atol=tol,
                                   msg=name)
        torch.testing.assert_close(h.float(), rh, rtol=tol, atol=tol,
                                   msg=name)
    # h0 threads through: two halves equal one scan
    x, dt, A, B, C, Dsk, _ = _on(cases[2][1], "f32", cuda_device)
    y_full, h_full = selective_scan_ref(x, dt, A, B, C, Dsk)
    y_a, h_a = scan_kernel.selective_scan(x[:5], dt[:5], A, B[:5], C[:5],
                                          Dsk)
    y_b, h_b = scan_kernel.selective_scan(x[5:], dt[5:], A, B[5:], C[5:],
                                          Dsk, h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)
    # the public op: auto launches (strided B and C made contiguous),
    # torch does not
    before = scan_kernel.launches
    proj = torch.randn(2, 7, 32, device=cuda_device)
    Bm, Cm = proj[..., :16], proj[..., 16:]
    args = (torch.randn(2, 7, 24, device=cuda_device),
            torch.rand(2, 7, 24, device=cuda_device) * 0.2,
            -0.5 - torch.rand(24, 16, device=cuda_device), Bm, Cm,
            torch.randn(24, device=cuda_device))
    a = selective_scan(*args)
    b = selective_scan(*args, mode="torch")
    assert scan_kernel.launches == before + 1
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_two_layer_falcon_mamba_serve_kernel_matches_plain_scan(
        cuda_device, monkeypatch):
    """Full-width falcon-mamba-7b cut to two layers, float32 on the card:
    the tokens with the scan kernel equal the plain scan's, every prefill
    launched the kernel once per layer and decode none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2,
                              dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(1, 120)))
               .tolist() for _ in range(6)]
    out, first = {}, {}
    real = engine_mod.sample
    for scan in ("auto", "torch"):
        logits = []
        monkeypatch.setattr(engine_mod, "sample", lambda lg, *a, **k: (
            logits.append(lg.float().cpu()), real(lg, *a, **k))[1])
        eng = ServeEngine(cfg, params, lanes=4, max_ctx=160,
                          device=cuda_device, scan=scan)
        before = scan_kernel.launches
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        assert scan_kernel.launches - before == (
            cfg.n_layers * eng.prefill_count if scan == "auto" else 0)
        out[scan] = [r.tokens_out for r in reqs]
        first[scan] = [lg for lg in logits if lg.shape[0] == 1]
        assert all(len(t) == 8 for t in out[scan])
    assert len(first["auto"]) == len(prompts)
    for a, b in zip(first["auto"], first["torch"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert out["auto"] == out["torch"]


# ---------------------------------------------------------------------------
# RG-LRU scan kernel and the Griffin serve path (CUDA device only)
# ---------------------------------------------------------------------------
def _rglru_cases():
    """(name, (a, b, h0) as float32 numpy, dtype): recurrentgemma-9b's
    full-width prefills (L 256 and 2,600, D 4,096) in bf16 and float32,
    tests/test_kernels.py's shapes, L 1 and 33, D 20 (ragged), a batch of
    3 with h0 per sequence and of 2 with h0 shared, and mixed dtypes
    (float32 a, bf16 b and h0)."""
    rng = np.random.default_rng(0)

    def draw(L, D, lead=(), h0=None):
        return [rng.uniform(0.3, 0.999, size=lead + (L, D)).astype(
                    np.float32),
                rng.normal(size=lead + (L, D)).astype(np.float32),
                None if h0 is None else rng.normal(size=h0).astype(
                    np.float32)]

    cases = [("prefill_L256_bf16", draw(256, 4096), "bf16"),
             ("prefill_L2600_bf16", draw(2600, 4096), "bf16"),
             ("prefill_L256_f32", draw(256, 4096), "f32")]
    cases += [(f"L{L}_D{D}", draw(L, D), dt) for L, D, dt in (
        (16, 8, "f32"), (100, 96, "f32"), (256, 256, "f32"), (33, 20, "f32"),
        (128, 64, "bf16"), (1, 20, "f32"), (31, 70, "bf16"), (65, 129,
                                                             "f32"))]
    cases += [("batch3_h0_per_seq", draw(40, 24, (3,), (3, 24)), "f32"),
              ("batch2_h0_shared", draw(40, 24, (2,), (24,)), "bf16"),
              ("mixed_dtypes", draw(50, 30, (), (30,)), "mixed")]
    return cases


def _rglru_on(arrays, dtype, device):
    """a, b, h0 on ``device``: all in ``dtype`` ("f32", "bf16"), or float32
    a with bf16 b and h0 ("mixed")."""
    out = []
    for i, a in enumerate(arrays):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(a).to(device)
        bf16 = dtype == "bf16" or (dtype == "mixed" and i > 0)
        out.append(t.to(torch.bfloat16) if bf16 else t)
    return out


@pytest.mark.cuda
def test_rglru_kernel_matches_plain(cuda_device):
    cases = _rglru_cases()
    for name, arrays, dtype in cases:
        a, b, h0 = _rglru_on(arrays, dtype, cuda_device)
        before = rglru_kernel.launches
        y, h = rglru_kernel.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        assert rglru_kernel.launches == before + 1
        assert y.dtype == h.dtype == a.dtype
        ry, rh = rglru_scan_ref(a.float(), b.float(),
                                None if h0 is None else h0.float())
        tol = 1e-5 if dtype == "f32" else 5e-2
        torch.testing.assert_close(y.float(), ry, rtol=tol, atol=tol,
                                   msg=name)
        torch.testing.assert_close(h.float(), rh, rtol=tol, atol=tol,
                                   msg=name)
        if dtype == "f32":
            # the product and the sum rounded apart, as the loop does
            assert torch.equal(y, ry) and torch.equal(h, rh), name
        # a float32 state rounds only at the output: within one ulp of the
        # output's dtype of the float32 loop rounded to it
        eps = torch.finfo(a.dtype).eps
        torch.testing.assert_close(y, ry.to(y.dtype), rtol=eps, atol=1e-6,
                                   msg=name)
        torch.testing.assert_close(h, rh.to(h.dtype), rtol=eps, atol=1e-6,
                                   msg=name)
    # h0 threads through: two halves equal one scan
    a, b, _ = _rglru_on(cases[4][1], "f32", cuda_device)
    y_full, h_full = rglru_scan_ref(a, b)
    y_a, h_a = rglru_kernel.rglru_scan(a[:37], b[:37])
    y_b, h_b = rglru_kernel.rglru_scan(a[37:], b[37:], h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)
    # the public op: auto launches (strided halves made contiguous),
    # torch does not
    before = rglru_kernel.launches
    ab = torch.rand(2, 7, 48, device=cuda_device)
    args = (ab[..., :24] * 0.5 + 0.4, ab[..., 24:])
    u = rglru_scan(*args)
    v = rglru_scan(*args, mode="torch")
    assert rglru_kernel.launches == before + 1
    for p, q in zip(u, v):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_three_layer_recurrentgemma_serve_kernel_matches_plain_scan(
        cuda_device, monkeypatch):
    """Full-width recurrentgemma-9b cut to one period (two RG-LRU layers
    and a local one), float32 on the card, prompts up to 2,100 tokens
    (past the window of 2,048): the tokens with the RG-LRU kernel equal
    the plain scan's, every prefill launched the kernel once per RG-LRU
    layer and decode none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3,
                              dtype="float32")
    n_rglru = cfg.layer_kinds().count("rglru")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist()
               for n in (1, 2, 57, 300, 2_100)]
    out, first = {}, {}
    real = engine_mod.sample
    for scan in ("auto", "torch"):
        logits = []
        monkeypatch.setattr(engine_mod, "sample", lambda lg, *a, **k: (
            logits.append(lg.float().cpu()), real(lg, *a, **k))[1])
        eng = ServeEngine(cfg, params, lanes=2, max_ctx=2_200,
                          device=cuda_device, scan=scan)
        before = rglru_kernel.launches
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        assert rglru_kernel.launches - before == (
            n_rglru * eng.prefill_count if scan == "auto" else 0)
        out[scan] = [r.tokens_out for r in reqs]
        first[scan] = [lg for lg in logits if lg.shape[0] == 1]
        assert all(len(t) == 8 for t in out[scan])
    assert len(first["auto"]) == len(prompts)
    for a, b in zip(first["auto"], first["torch"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert out["auto"] == out["torch"]
