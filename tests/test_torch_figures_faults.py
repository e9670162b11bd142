"""fig12deg of the port against the reference's script on the CPU, at
the ``smoke=True`` grid on the same shortened horizon, event budget and
fault span (the helper and the rules are in ``test_torch_figures.py``):
the CSV text equal line for line, and the assertions raised alike."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_figures import assert_same_figure, spec_wrapper  # noqa: E402

from benchmarks import fig12_degradation as ref_fig12  # noqa: E402
from repro_torch.bench import fig12_degradation as fig12  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fig12_rows_match_the_reference(monkeypatch):
    """The fault axis, the zero-fault bit-identity check against the
    ``faults=None`` sweep and the retention assertion."""
    for mod, side in ((ref_fig12, "ref"), (fig12, "port")):
        monkeypatch.setattr(mod, "run_sweep", spec_wrapper(
            mod.run_sweep, side, 4_000, fault_span=True))
    rows, err = assert_same_figure(
        lambda: ref_fig12.run(smoke=True), lambda: fig12.run(smoke=True),
        expect_rows=1 + 4 * 3 + 4 + 1)
    assert err is None
    assert rows[0].startswith("fig12deg/zero_fault_bitidentical,1,")
