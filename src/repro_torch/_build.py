"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each kernel is a plain C shared library built from ``csrc/`` (no PyTorch
headers, so a build takes seconds) and loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -include <build>/lockvm_consts.h \\
         -o <build>/liblockvm-<hash>.so csrc/lockvm.cu

The constants the kernel shares with the Python side (opcodes, register
count, layout, cost indices, ``INF``, the latency-histogram size and the
fault kinds) are never typed a second time: :func:`constants_header`
generates them from :mod:`repro_torch.sim.isa`, ``costs``, ``engine`` and
``faults`` into the build directory.  The library's name carries a hash of
the sources and that header, so an edit rebuilds and an unchanged tree
reuses the earlier build.  A failed build raises; nothing falls back to the
plain engine.

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
HEADER_NAME = "lockvm_consts.h"

_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) of each build
build_logs: dict[str, str] = {}


def constants_header() -> str:
    """The C header of every constant the kernel takes from the Python side."""
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
    lines = ["// Generated by repro_torch/_build.py from repro_torch.sim "
             "(isa, costs, engine, faults).", "#pragma once"]
    lines += [f"#define {name} {int(value)}" for name, value in defs]
    return "\n".join(lines) + "\n"


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


def sources(name: str) -> list[Path]:
    """Every file under ``csrc/`` that the kernel ``name`` is built from."""
    return [CSRC / f"{name}.cu", CSRC / f"{name}_step.cuh"]


def build_command(name: str, out: Path, header: Path,
                  nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-include", str(header), "-I", str(CSRC),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def load_library(name: str = "lockvm") -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library ``name``."""
    if name in _libs:
        return _libs[name]
    header_text = constants_header()
    digest = hashlib.sha256(header_text.encode())
    for path in sources(name):
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{name}-{tag}.so"
    if not lib_path.exists():
        header = out_dir / f"{name}-{tag}-{HEADER_NAME}"
        header.write_text(header_text)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = build_command(name, Path(tmp), header, nvcc_path())
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _libs[name] = lib
    return lib
