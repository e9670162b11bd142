"""What a run and the references load, and the command's refusals, each
in a process of its own."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from chipbench import bench

JAX_SIDE = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _python(code: str, cwd=bench.ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def _loaded(code: str) -> set:
    out = _python(code + "\nimport sys, json\n"
                  "print(json.dumps(sorted({m.split('.')[0] "
                  "for m in sys.modules})))")
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax():
    tops = _loaded(
        "from chipbench.tests import tiny\n"
        "for cell in ('lockvm-64t.mutexbench',"
        " 'falcon-mamba-7b.code-batch'):\n"
        "    out, _, _ = tiny.run(cell, seconds=0.5)\n"
        "    assert out.correct\n")
    assert "repro_torch" in tops
    assert not tops & JAX_SIDE


def test_the_references_load_nothing_of_the_program():
    tops = _loaded(
        "import torch\n"
        "from chipbench import work\n"
        "from chipbench.reference import lockvm, mamba1\n"
        "from chipbench.tests.test_chipbench_references import _cell\n"
        "lockvm.replay(_cell('twa', 4, 1))\n"
        "from chipbench.tests.tiny import ARCH\n"
        "w = mamba1.make_weights(ARCH, 1, 'cpu', torch.float32)\n"
        "mamba1.served_gaps(w, ARCH, [1, 2, 3], [4, 5], control=True)\n")
    assert not tops & (JAX_SIDE | {"repro_torch"})


def test_the_command_refuses_without_a_card():
    out = _python("import sys\nfrom chipbench import run\n"
                  "sys.exit(run.main(['--workload', 'lockvm-64t.mutexbench',"
                  " '--seed', '1', '--seconds', '1', '--trace', '0']))")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "chipbench.run", "--workload",
         "lockvm-64t.mutexbench", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "program" in out.stderr
