"""The port's checker CLI, ``python -m repro_torch.sim.check``, as a user
runs it on the CPU: a fresh batch through the plain engine against the
batch oracle, with 0 failing.

The plain engine pays about a millisecond a step on the CPU and a batch
costs one dispatch per drawn chunk, each as long as the batch's longest
case: 200 cases take about 40 s on one worker.  The card runs 1,024
through the kernel (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_cli_fuzz_on_the_cpu_reports_zero_failing():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.check", "--device", "cpu",
         "--cases", "200", "--seed", "0", "--batch-oracle"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "fuzz: 200 cases" in out and "0 failing" in out, out
    assert re.search(r"oracle: (c|numpy); engines: torch on cpu", out), out
    placements = re.search(r"placements: (.*)", out).group(1)
    assert placements.count("torch:") == 3, placements
