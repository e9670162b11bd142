"""fig6 (both profiles), fig7 and fig11 of the port against the
reference's scripts on the CPU, on the same shortened grid and horizon
(the helper and the rules are in ``test_torch_figures.py``): the CSV text
equal line for line."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_figures import assert_same_figure, spec_wrapper  # noqa: E402

from benchmarks import fig6_rrc as ref_fig6  # noqa: E402
from benchmarks import fig7_stress_latency as ref_fig7  # noqa: E402
from benchmarks import fig11_locktorture as ref_fig11  # noqa: E402
from repro_torch.bench import fig6_rrc as fig6  # noqa: E402
from repro_torch.bench import fig7_stress_latency as fig7  # noqa: E402
from repro_torch.bench import fig11_locktorture as fig11  # noqa: E402

THREADS = (1, 8, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_curves(monkeypatch, ref_mod, port_mod, horizon):
    """``sweep_curves`` takes no ``mode``: the reference's resolves its
    own on the CPU (results are mode-independent)."""
    monkeypatch.setattr(ref_mod, "sweep_curves", spec_wrapper(
        ref_mod.sweep_curves, "ref", horizon, mode_kw=False))
    monkeypatch.setattr(port_mod, "sweep_curves", spec_wrapper(
        port_mod.sweep_curves, "port", horizon))


@pytest.mark.parametrize("profile", ["rrc", "db"])
def test_fig6_rows_match_the_reference(monkeypatch, profile):
    _patch_curves(monkeypatch, ref_fig6, fig6, 1_000)
    rows, err = assert_same_figure(
        lambda: ref_fig6.run(THREADS, runs=1, profile=profile),
        lambda: fig6.run(THREADS, runs=1, profile=profile),
        expect_rows=3 * len(THREADS) + 1)
    assert err is None
    assert rows[-1].startswith(f"fig6[{profile}]/twa_over_ticket@64,")


def test_fig7_rows_match_the_reference(monkeypatch):
    """The fixed ``outside_work`` leg and the latency tail."""
    for mod, side in ((ref_fig7, "ref"), (fig7, "port")):
        monkeypatch.setattr(mod, "run_sweep",
                            spec_wrapper(mod.run_sweep, side, 1_500))
    rows, err = assert_same_figure(
        lambda: ref_fig7.run(THREADS, runs=1),
        lambda: fig7.run(THREADS, runs=1),
        expect_rows=3 * len(THREADS) * 4)
    assert err is None
    assert rows[-4].startswith("fig7/mcs/threads=64,")


def test_fig11_rows_match_the_reference(monkeypatch):
    """Both contention levels, under the ``fig11/`` and ``fig12/``
    prefixes."""
    _patch_curves(monkeypatch, ref_fig11, fig11, 800)
    rows, err = assert_same_figure(
        lambda: ref_fig11.run(THREADS, runs=1),
        lambda: fig11.run(THREADS, runs=1),
        expect_rows=2 * (3 * len(THREADS) + 1))
    assert err is None
    assert rows[-1].startswith("fig12/twa_over_ticket@64,")
