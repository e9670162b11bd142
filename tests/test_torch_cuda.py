"""The port's CUDA kernels (the lockVM and the MoE ticket dispatch): their
build, their wrappers and their entry points.

Runs here on the CPU for what does not need a card — the build commands and
the generated constants headers, the parallel build, the device rules of
the entry points (no quiet CPU fallback), the wrapper's plain version on
CPU tensors.  The kernel-vs-plain cases need a CUDA device: they are marked
``cuda`` and skip with "no CUDA device" where there is none.  On a GPU host:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance everywhere: bit-identical int32 outputs, and bit-identical tokens
for the serve run whose MoE layers go through the ticket kernel.
"""

import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import _build
from repro_torch.configs import get_config
from repro_torch.kernels.ticket_dispatch import assign_slots, dispatch_ref
from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
from repro_torch.models.layers import moe_capacity
from repro_torch.models.model import init_params
from repro_torch.serve import ServeEngine
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
    libs = _build.load_libraries(["lockvm", "ticket_dispatch"])
    assert log.read_text().split() == ["start", "start", "end", "end"]
    assert [p.name.split("-")[0] for p in libs] == ["liblockvm",
                                                    "libticket_dispatch"]
    assert all(p.exists() for p in libs)
    assert set(_build.build_logs) == {"lockvm", "ticket_dispatch"}
    # a second call builds nothing: the hashed libraries are reused
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.load_libraries(["ticket_dispatch"]) == libs[1:]
    assert log.read_text().split().count("start") == 2


def test_cell_state_bytes_fits_fig3_in_shared_memory():
    mem64 = Layout(n_threads=64, n_locks=1).mem_words
    assert engine_cuda.cell_state_bytes(64, mem64) <= 48 * 1024
    big = Layout(n_threads=64, n_locks=1, wa_size=65536).mem_words
    assert engine_cuda.cell_state_bytes(64, big) > engine_cuda.SMEM_LIMIT


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
              (ids((2, 999), -3, 35), 32, 20)]
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


@pytest.mark.cuda
def test_two_layer_granite_serve_kernel_matches_plain_dispatch(cuda_device):
    """Full-width granite-moe cut to two layers, bf16 on the card: the
    tokens with the ticket kernel equal the tokens with the plain version,
    bit for bit, and every MoE layer launched the kernel once per pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(16, 120)))
               .tolist() for _ in range(6)]
    out = {}
    for dispatch in ("auto", "torch"):
        eng = ServeEngine(cfg, params, lanes=4, max_ctx=160,
                          device=cuda_device, dispatch=dispatch)
        before = ticket_kernel.launches
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        launched = ticket_kernel.launches - before
        assert launched == (cfg.n_layers * (eng.prefill_count
                                            + eng.step_count)
                            if dispatch == "auto" else 0)
        out[dispatch] = [r.tokens_out for r in reqs]
        assert all(len(t) == 8 for t in out[dispatch])
    assert out["auto"] == out["torch"]
