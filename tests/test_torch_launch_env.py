"""The launchers' allocator default, on the CPU.

``repro_torch.device.default_allocator`` gives the CUDA caching allocator
``expandable_segments:True`` when the device is CUDA and the caller set
neither ``$PYTORCH_CUDA_ALLOC_CONF`` nor ``$PYTORCH_ALLOC_CONF``; a caller's
value is left as it is, and a CPU run sets nothing.  ``launch.train`` and
``launch.serve`` apply it before their first CUDA allocation.  There is no
GPU here, so the device check is faked and the allocator's setter is a spy;
every test restores the variables it touches.  Last, chip_smoke's child
process (the entry_points phase's way of starting a launcher) runs
``launch.train``'s command line in a clean environment and gives the
in-process run's losses bit for bit.
"""

import importlib.util
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REDUCED = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
           "--steps", "2"]


class _FirstAllocation(Exception):
    """Raised where a launcher would make its first CUDA allocation."""


@pytest.fixture
def unset(monkeypatch):
    """Neither allocator variable set, both restored after the test (a
    variable absent before is registered by setting it first)."""
    for name in D.ALLOC_CONF_VARS:
        monkeypatch.setenv(name, "registered")
        monkeypatch.delenv(name)
    return monkeypatch


@pytest.fixture
def setter(monkeypatch):
    """The allocator's runtime setter, replaced by a spy."""
    calls = []
    monkeypatch.setattr(torch._C, "_accelerator_setAllocatorSettings",
                        calls.append, raising=False)
    return calls


def test_cuda_gets_expandable_segments(unset, setter):
    assert D.default_allocator(torch.device("cuda", 0)) == D.ALLOC_DEFAULT
    assert D.ALLOC_DEFAULT == "expandable_segments:True"
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == D.ALLOC_DEFAULT
    assert setter == [D.ALLOC_DEFAULT]


@pytest.mark.parametrize("name", D.ALLOC_CONF_VARS)
def test_a_callers_value_is_left_alone(unset, setter, name):
    unset.setenv(name, "expandable_segments:False")
    assert D.default_allocator(torch.device("cuda", 0)) is None
    assert os.environ[name] == "expandable_segments:False"
    if name != "PYTORCH_CUDA_ALLOC_CONF":
        assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
    assert setter == []


def test_cpu_sets_nothing(unset, setter):
    assert D.default_allocator(torch.device("cpu")) is None
    res = launch_train.main(REDUCED[:-1] + ["1"])
    assert len(res["losses"]) == 1
    res = launch_serve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--device", "cpu", "--requests", "1",
                             "--max-new", "2"])
    assert len(res["requests"][0].tokens_out) == 2
    assert not any(name in os.environ for name in D.ALLOC_CONF_VARS)
    assert setter == []


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_set_it_before_their_first_allocation(unset, setter,
                                                        launcher):
    """No ``--device``, as a user starts them, on a faked GPU: at the first
    call that would allocate on the card the setting is in place."""
    unset.setattr(torch.cuda, "is_available", lambda: True)
    unset.setattr(torch.cuda, "current_device", lambda: 0)
    seen = []

    def first_allocation(*args, **kw):
        seen.append((os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
                     list(setter)))
        raise _FirstAllocation

    if launcher == "train":
        unset.setattr(launch_train, "make_state", first_allocation)
        main = launch_train.main
    else:
        unset.setattr(torch, "Generator", first_allocation)
        main = launch_serve.main
    with pytest.raises(_FirstAllocation):
        main(["--arch", "granite-moe-1b-a400m", "--reduced"])
    assert seen == [(D.ALLOC_DEFAULT, [D.ALLOC_DEFAULT])]


def _chip_smoke(monkeypatch):
    """chip_smoke, imported with its allocator line kept out of this
    process's environment (it sets the variable only where unset)."""
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "registered")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_command_line_in_a_clean_child_equals_main(monkeypatch):
    """``launch.train``'s command line in a child process of a clean
    environment (no allocator setting, PYTHONPATH=src), one CPU thread on
    both sides: the losses of the in-process ``main`` bit for bit."""
    cs = _chip_smoke(monkeypatch)
    env = cs.child_env({"OMP_NUM_THREADS": "1"})
    assert env["PYTHONPATH"] == "src"
    assert not any(name in env for name in D.ALLOC_CONF_VARS)
    child = cs.run_child(ROOT, {"launcher": "train", "runs": [REDUCED]},
                         {"OMP_NUM_THREADS": "1"})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = launch_train.main(list(REDUCED))["losses"]
    finally:
        torch.set_num_threads(threads)
    (run,) = child["runs"]
    assert len(want) == 2 and run["losses"] == want
    assert run["argv"] == REDUCED and child["alloc_conf"] is None
    assert run["ticket_launches"] == run["plan_launches"] == 0
