"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each kernel is a plain C shared library built from ``csrc/`` (no PyTorch
headers, so a build takes seconds) and loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -include <build>/<name>_consts.h \\
         -o <build>/lib<name>-<hash>.so csrc/<name>.cu

:data:`KERNELS` names each library, the files under ``csrc/`` it is built
from, and the generator of the constants header it shares with the Python
side, so that no constant is typed a second time: the lockVM's opcodes,
register count, layout, cost indices, ``INF``, histogram size and fault
kinds (:func:`constants_header`, from :mod:`repro_torch.sim`), the
ticket kernel's block size and shared-memory limit
(:mod:`repro_torch.kernels.ticket_dispatch.kernel`), the selective
scan's block size, lanes per channel, chunk, state sizes and input dtype
bits
(:mod:`repro_torch.kernels.mamba_scan.kernel`), and the RG-LRU scan's
channels and threads a block, steps a stage, stages of the ring and
input dtype bits
(:mod:`repro_torch.kernels.rglru.kernel`).  A library's name
carries a hash of its sources and header, so an edit rebuilds and an
unchanged tree reuses the earlier build.  :func:`load_libraries` starts one
``nvcc`` per library that is missing, all at once, and waits for them all.
A failed build raises; nothing falls back to a plain version.

The build directory is ``build/`` at the root of the checkout, or
``$REPRO_TORCH_BUILD_DIR`` when set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) of each build
build_logs: dict[str, str] = {}


def constants_header() -> str:
    """The C header of every constant the lockVM kernel takes from the
    Python side."""
    from .sim import costs, engine, faults, isa

    defs = [(f"OP_{name}", op) for op, name in sorted(isa.OP_NAMES.items())]
    defs += [("N_OPS", isa.N_OPS), ("N_REGS", isa.N_REGS),
             ("LINE_SHIFT", isa.LINE_SHIFT),
             ("WORDS_PER_SECTOR", isa.WORDS_PER_SECTOR),
             ("N_COSTS", len(costs.DEFAULT_COSTS.to_array()))]
    defs += [(name, getattr(costs, name)) for name in (
        "I_LOCAL", "I_HIT", "I_MISS", "I_XFER", "I_ST_OWNED", "I_ST_SHARED",
        "I_INV", "I_ATOMIC", "I_WAKE")]
    defs += [("INF", engine.INF), ("N_LAT_BUCKETS", engine.N_LAT_BUCKETS),
             ("F_PREEMPT", faults.F_PREEMPT),
             ("F_SPURIOUS", faults.F_SPURIOUS), ("F_ABORT", faults.F_ABORT)]
    return _header("repro_torch.sim (isa, costs, engine, faults)", defs)


def ticket_constants_header() -> str:
    """The C header of the ticket-dispatch kernel's launch constants."""
    from .kernels.ticket_dispatch import kernel

    return _header("repro_torch.kernels.ticket_dispatch.kernel",
                   [("TD_THREADS", kernel.THREADS),
                    ("TD_SMEM_LIMIT", kernel.SMEM_LIMIT)])


def mamba_constants_header() -> str:
    """The C header of the selective-scan kernel's launch constants."""
    from .kernels.mamba_scan import kernel

    return _header("repro_torch.kernels.mamba_scan.kernel",
                   [("MS_THREADS", kernel.THREADS),
                    ("MS_LANES", kernel.LANES),
                    ("MS_CHUNK", kernel.CHUNK),
                    ("MS_MIN_N", min(kernel.STATE_SIZES)),
                    ("MS_MAX_N", max(kernel.STATE_SIZES))]
                   + [(f"MS_BF16_{name.upper()}", bit)
                      for name, bit in kernel.BF16_BITS.items()])


def rglru_constants_header() -> str:
    """The C header of the RG-LRU scan kernel's launch constants."""
    from .kernels.rglru import kernel

    return _header("repro_torch.kernels.rglru.kernel",
                   [("RG_CHANNELS", kernel.CHANNELS),
                    ("RG_THREADS", kernel.THREADS),
                    ("RG_STEPS", kernel.STEPS),
                    ("RG_STAGES", kernel.STAGES)]
                   + [(f"RG_BF16_{name.upper()}", bit)
                      for name, bit in kernel.BF16_BITS.items()])


def _header(origin: str, defs) -> str:
    lines = [f"// Generated by repro_torch/_build.py from {origin}.",
             "#pragma once"]
    lines += [f"#define {name} {int(value)}" for name, value in defs]
    return "\n".join(lines) + "\n"


# library name -> (files under csrc/, the first one compiled; header maker)
KERNELS = {
    "lockvm": (("lockvm.cu", "lockvm_step.cuh"), constants_header),
    "ticket_dispatch": (("ticket_dispatch.cu", "ticket_dispatch_kernel.cuh"),
                        ticket_constants_header),
    "mamba_scan": (("mamba_scan.cu", "mamba_scan_kernel.cuh"),
                   mamba_constants_header),
    "rglru_scan": (("rglru_scan.cu", "rglru_scan_kernel.cuh"),
                   rglru_constants_header),
}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build"


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def _kernel(name: str):
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel library {name!r}; "
                         f"options: {sorted(KERNELS)}") from None


def sources(name: str) -> list[Path]:
    """Every file under ``csrc/`` that the kernel ``name`` is built from."""
    return [CSRC / f for f in _kernel(name)[0]]


def build_command(name: str, out: Path, header: Path,
                  nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-include", str(header), "-I", str(CSRC),
            "-o", str(out), str(sources(name)[0])]


def load_libraries(names) -> list[ctypes.CDLL]:
    """Build every library of ``names`` not built yet (one ``nvcc`` each,
    run in parallel), then load them all; returns them in order.  Libraries
    already loaded are returned without touching the file system (a
    wrapper asks for its library on every launch)."""
    names = list(names)
    if all(n in _libs for n in names):
        return [_libs[n] for n in names]
    out_dir = build_dir()
    missing = []
    for name in dict.fromkeys(n for n in names if n not in _libs):
        header_text = _kernel(name)[1]()
        digest = hashlib.sha256(header_text.encode())
        for path in sources(name):
            digest.update(path.read_bytes())
        tag = digest.hexdigest()[:16]
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / f"lib{name}-{tag}.so"
        if lib_path.exists():
            _libs[name] = ctypes.CDLL(str(lib_path))
        else:
            missing.append((name, tag, header_text, lib_path))
    nvcc = nvcc_path() if missing else None
    jobs, failed = [], []
    try:
        for name, tag, header_text, lib_path in missing:
            header = out_dir / f"{name}-{tag}-{name}_consts.h"
            header.write_text(header_text)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = build_command(name, Path(tmp), header, nvcc)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, cmd, proc, tmp, lib_path))
        for name, cmd, proc, tmp, lib_path in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
                continue
            build_logs[name] = log
            os.replace(tmp, lib_path)
            _libs[name] = ctypes.CDLL(str(lib_path))
    finally:
        for _, _, proc, _, _ in jobs:   # none outlives an interrupted build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_libs[n] for n in names]


def load_library(name: str = "lockvm") -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library ``name``."""
    return load_libraries([name])[0]
