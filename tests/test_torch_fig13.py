"""fig13, the serve↔lockVM loop, of the port against the reference's script
on the CPU, at ``smoke=True``.

A LockTrace is recorded by each package's own continuous-batching serve
(gemma3-1b reduced; the reference's weights from its ``init_params``, the
port's from a seeded ``torch.Generator``), saved, and replayed by both
scripts through ``REPRO_SERVE_TRACE``: a trace recorded by the port loads in
the reference, and the other way round.  The sweep entry is shortened alike
on both sides (``test_torch_figures.spec_wrapper``).  Then the
``fig13/trace/*``, ``fig13/sim/*`` and ``fig13/loop/*`` rows are equal as
text; the ``fig13/e2e/*`` rows have the same names (their values are wall
clock).  The reference's end-to-end leg is stubbed (it is only timed); the
port's runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_figures import capture, spec_wrapper  # noqa: E402

from benchmarks import fig13_serve_e2e as ref_fig13  # noqa: E402
from repro.sim import workloads as ref_workloads  # noqa: E402
from repro_torch.bench import fig13_serve_e2e as fig13  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.trace import load_trace  # noqa: E402
from repro_torch.sim.workloads import RESULTS_STORE_ENV  # noqa: E402

HORIZON = 1_500
N_REQUESTS, MAX_NEW = 6, 4          # the scripts' smoke traffic


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """``{"port": path, "ref": path}``: a trace recorded by each package."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models.model import init_params as ref_init_params
    tmp = tmp_path_factory.mktemp("traces")
    cfg = get_config("gemma3-1b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    port = fig13._record_trace(cfg, params, n_requests=N_REQUESTS,
                               max_new=MAX_NEW, device=torch.device("cpu"))
    ref_cfg = ref_get_config("gemma3-1b").reduced()
    ref = ref_fig13._record_trace(
        ref_cfg, ref_init_params(ref_cfg, jax.random.PRNGKey(0)),
        n_requests=N_REQUESTS, max_new=MAX_NEW)
    paths = {"port": tmp / "port.npz", "ref": tmp / "ref.npz"}
    port.save(paths["port"])
    ref.save(paths["ref"])
    return paths


def _split(rows):
    """(rows compared as text, the names of the e2e rows)."""
    same = [r for r in rows if not r.startswith("fig13/e2e/")]
    e2e = [r.split(",")[0] for r in rows if r.startswith("fig13/e2e/")]
    return same, e2e


@pytest.mark.parametrize("recorded_by", ["port", "ref"])
def test_fig13_rows_match_the_reference(monkeypatch, traces, recorded_by):
    path = traces[recorded_by]
    trace = load_trace(path)
    assert len(trace) == N_REQUESTS
    monkeypatch.setenv("REPRO_SERVE_TRACE", str(path))
    monkeypatch.delenv(RESULTS_STORE_ENV, raising=False)
    # the reference imports its sweep entry inside run()
    monkeypatch.setattr(ref_workloads, "run_sweep", spec_wrapper(
        ref_workloads.run_sweep, "ref", HORIZON))
    monkeypatch.setattr(ref_fig13, "_e2e_throughput",
                        lambda *args, **kw: 0.0)
    monkeypatch.setattr(fig13, "run_sweep", spec_wrapper(
        fig13.run_sweep, "port", HORIZON))
    ref_rows, ref_err = capture(lambda: ref_fig13.run(smoke=True))
    out = {}
    port_rows, port_err = capture(
        lambda: out.update(fig13.run(smoke=True, device="cpu")))
    assert ref_err is None and port_err is None
    ref_same, ref_e2e = _split(ref_rows)
    port_same, port_e2e = _split(port_rows)
    assert port_same == ref_same
    assert port_e2e == ref_e2e and len(port_e2e) == len(fig13.GATES)
    assert port_same[0] == f"fig13/trace/requests,{N_REQUESTS},recorded"
    assert [r.split(",")[0] for r in port_same[3:]] == \
        [f"fig13/sim/{lk}" for lk in fig13.SIM_SWEEP_LOCKS] + \
        ["fig13/loop/recommend", "fig13/loop/auto_gate"]
    assert all(r["mode"] == "torch" for r in out["sim_rows"])
    assert sorted({g for g, _ in out["e2e"]}) == sorted(fig13.GATES)
    assert all(np.isfinite(v) and v > 0 for v in out["e2e"].values())
