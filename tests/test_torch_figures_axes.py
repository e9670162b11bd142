"""fig8, fig9 and fig10 of the port against the reference's
scripts on the CPU, at ``smoke=True`` grids on the same shortened horizon
(the helper and the rules are in ``test_torch_figures.py``): the CSV text
equal line for line, and each assertion raised alike.  fig9's and fig10's
sub-functions run separately, so that one assertion does not hide the
next."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_figures import assert_same_figure, spec_wrapper  # noqa: E402

from benchmarks import fig8_collisions as ref_fig8  # noqa: E402
from benchmarks import fig9_cost_grid as ref_fig9  # noqa: E402
from benchmarks import fig10_rw_scaling as ref_fig10  # noqa: E402
from repro_torch.bench import fig8_collisions as fig8  # noqa: E402
from repro_torch.bench import fig9_cost_grid as fig9  # noqa: E402
from repro_torch.bench import fig10_rw_scaling as fig10  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch(monkeypatch, ref_mod, port_mod, horizon, **kw):
    for mod, side in ((ref_mod, "ref"), (port_mod, "port")):
        monkeypatch.setattr(mod, "run_sweep",
                            spec_wrapper(mod.run_sweep, side, horizon, **kw))


def test_fig8_rows_match_the_reference(monkeypatch):
    """The collision counters, the birthday and sequential models and
    their per-cell checks."""
    _patch(monkeypatch, ref_fig8, fig8, 3_000)
    rows, err = assert_same_figure(
        lambda: ref_fig8.run(smoke=True), lambda: fig8.run(smoke=True),
        expect_rows=2 * 2 + 1)
    assert err is None and rows[-1].startswith("fig8/decay/T=16/thr=1,")


def test_fig9_cost_grid_rows_match_the_reference(monkeypatch):
    """The whole ``run`` (the cost grid, then the permits cell)."""
    _patch(monkeypatch, ref_fig9, fig9, 1_500)
    rows, err = assert_same_figure(
        lambda: ref_fig9.run(smoke=True), lambda: fig9.run(smoke=True),
        expect_rows=3 * 2 + 2 + 1 + 4 + 1)
    assert err is None and rows[0].startswith("fig9/ticket/cinv=0/cxfer=90,")


def test_fig9_sem_permits_rows_match_the_reference(monkeypatch):
    _patch(monkeypatch, ref_fig9, fig9, 1_500)
    rows, err = assert_same_figure(
        lambda: ref_fig9.run_sem_permits(smoke=True),
        lambda: fig9.run_sem_permits(smoke=True), expect_rows=5)
    assert err is None and rows[-1].startswith("fig9/sem_scaling,")


@pytest.mark.parametrize("part", ["run_rw_scaling", "run_fissile_handover"])
def test_fig10_rows_match_the_reference(monkeypatch, part):
    """At this horizon both cells' checks fail on both sides alike: the rw
    cell's monotone check after its 8 rows (a few acquisitions a cell
    leave equal throughputs), the handover cell's contended check
    (fissile-twa within 10% of twa at 16 threads) after 15."""
    _patch(monkeypatch, ref_fig10, fig10, 1_500)
    rows, err = assert_same_figure(
        lambda: getattr(ref_fig10, part)(smoke=True),
        lambda: getattr(fig10, part)(smoke=True),
        expect_rows=8 if part == "run_rw_scaling" else 12 + 4)
    assert err is not None
    if part == "run_fissile_handover":
        assert err[1].startswith("(16, ")
        assert len(rows) == 15 and rows[-1].startswith(
            "fig10/fissile_over_twa@16,")
    else:
        assert len(rows) == 8 and rows[-1].startswith(
            "fig10/read_only_gain,")

