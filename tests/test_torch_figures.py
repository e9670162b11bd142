"""The port's lockVM figure scripts (``repro_torch.bench.fig*``) against the
reference's (``benchmarks/fig*``), on the CPU.

Both sides run the same shortened grid and horizon: each figure module's
own sweep entry (``run_sweep``, ``sweep_curves``,
``fig1_invalidation_diameter``, ``fig2_interlock_interference``) is
patched, in the reference's module and in the port's alike, with one
wrapper that shortens the spec (``dataclasses.replace(spec, horizon=H)``;
for fig12 also the derived ``max_events`` and ``fault_evt_span``) and runs
the reference's engine in ``mode="map"`` and the port's plain engine on
``device="cpu"``.  Where a figure takes a grid (threads, runs, pools) both
sides get the same shortened one.

Exact equality: the CSV text line for line, and where a figure asserts,
both sides raise the same assertion (type and message) or neither does,
with the rows printed before it equal.  This file holds the helper the
other ``test_torch_figures_*.py`` files import, and fig1, fig2 and fig5.
"""

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:       # the reference's scripts: benchmarks/
    sys.path.insert(0, str(REPO))

from benchmarks import fig1_invalidation_diameter as ref_fig1  # noqa: E402
from benchmarks import fig2_interlock_interference as ref_fig2  # noqa: E402
from benchmarks import fig5_throw as ref_fig5  # noqa: E402
from repro_torch.bench import fig1_invalidation_diameter as fig1  # noqa: E402
from repro_torch.bench import fig2_interlock_interference as fig2  # noqa: E402
from repro_torch.bench import fig5_throw as fig5  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_wrapper(orig, side: str, horizon: int, *, mode_kw: bool = True,
                 fault_span: bool = False):
    """``orig`` (a ``run_sweep`` or ``sweep_curves``) on the spec shortened
    to ``horizon`` — with fig12's derived event budget and fault span when
    ``fault_span`` — on the reference's ``map`` engine (``side="ref"``;
    ``mode_kw=False`` for an entry that takes no ``mode``) or the port's
    plain engine on the CPU (``side="port"``)."""
    def wrapper(spec, *args, **kw):
        short = {"horizon": horizon}
        if fault_span:
            short.update(max_events=2 * horizon,
                         fault_evt_span=horizon // 8)
        spec = dataclasses.replace(spec, **short)
        if side == "port":
            kw["device"] = "cpu"
        elif mode_kw:
            kw["mode"] = "map"
        return orig(spec, *args, **kw)
    return wrapper


def figure_wrapper(orig, side: str, horizon: int):
    """``orig`` (``fig1_invalidation_diameter`` or
    ``fig2_interlock_interference``) at ``horizon``, on the CPU."""
    def wrapper(*args, **kw):
        kw["horizon"] = horizon
        if side == "port":
            kw["device"] = "cpu"
        return orig(*args, **kw)
    return wrapper


def capture(fn, *args, **kw):
    """``(printed lines, (exception type, message) or None)`` of a call."""
    out = io.StringIO()
    err = None
    with contextlib.redirect_stdout(out):
        try:
            fn(*args, **kw)
        except AssertionError as e:
            err = (type(e), str(e))
    return out.getvalue().splitlines(), err


def assert_same_figure(ref_call, port_call, *, expect_rows: int):
    """Both sides print the same lines and raise alike; a run that does not
    raise prints ``expect_rows`` lines."""
    ref_rows, ref_err = capture(ref_call)
    port_rows, port_err = capture(port_call)
    assert port_rows == ref_rows
    assert port_err == ref_err
    if port_err is None:
        assert len(port_rows) == expect_rows, port_rows
    return port_rows, port_err


def test_fig1_rows_match_the_reference(monkeypatch):
    h = 600
    for mod, side in ((ref_fig1, "ref"), (fig1, "port")):
        monkeypatch.setattr(mod, "fig1_invalidation_diameter", figure_wrapper(
            mod.fig1_invalidation_diameter, side, h))
    rows, err = assert_same_figure(ref_fig1.run, fig1.run,
                                   expect_rows=len(fig1.READERS) + 1)
    assert err is None
    assert rows[-1].startswith("fig1/throughput_ratio_63r_vs_0r,")


def test_fig2_rows_match_the_reference(monkeypatch):
    """All three pools, 64 locks with private arrays included (284,672
    memory words a cell)."""
    h = 400
    for mod, side in ((ref_fig2, "ref"), (fig2, "port")):
        monkeypatch.setattr(mod, "fig2_interlock_interference",
                            figure_wrapper(mod.fig2_interlock_interference,
                                           side, h))
    rows, err = assert_same_figure(ref_fig2.run, fig2.run,
                                   expect_rows=len(fig2.POOLS) + 1)
    assert err is None and rows[-1].startswith("fig2/worst_penalty,")


def test_fig5_rows_match_the_reference(monkeypatch):
    h, threads = 800, (1, 8, 64)
    for mod, side in ((ref_fig5, "ref"), (fig5, "port")):
        monkeypatch.setattr(mod, "run_sweep",
                            spec_wrapper(mod.run_sweep, side, h))
    rows, err = assert_same_figure(
        lambda: ref_fig5.run(threads, runs=1),
        lambda: fig5.run(threads, runs=1),
        expect_rows=3 * len(threads) * 4 + 1)
    assert err is None and rows[-1].startswith("fig5/twa_over_ticket@64,")
