"""The port's results store, lock advisor and ``lock="auto"``
(``repro_torch.sim.results``, the ``REPRO_RESULTS_STORE`` hook of
``run_sweeps``, ``ServeEngine._make_gate``) against the JAX reference, on
the CPU with the plain engine.

One JSONL file is readable by both packages: rows written by either load
in the other, migrate alike, and give the same recommendation and the same
gate.  The sweep numbers behind the rows (throughput, handover, the latency
percentiles) equal the reference's exactly, NaN matching NaN.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro.sim import workloads as ref_workloads  # noqa: E402
from repro.sim import results as ref_results  # noqa: E402
from repro.sim.results.__main__ import main as ref_cli  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.sim import SIM_LOCKS, workloads  # noqa: E402
from repro_torch.sim import results  # noqa: E402
from repro_torch.sim.results.__main__ import main as port_cli  # noqa: E402

# The plain engine pays about a millisecond a batched event step on the
# CPU, so the sweeps here run a few thousand cycles.
SMOKE = dict(locks=("ticket", "twa"), threads=(2, 4), seeds=(1, 2),
             cs_work=2, outside_work=(0, 10), ncs_max=20, horizon=3_000,
             max_events=20_000, collect_latency=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain engine's tensors are small: one intra-op thread per test
    worker is faster than many contending ones."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    monkeypatch.delenv(workloads.RESULTS_STORE_ENV, raising=False)


@pytest.fixture(scope="module")
def port_rows():
    return workloads.run_sweep(workloads.SweepSpec(**SMOKE), device="cpu")


@pytest.fixture(scope="module")
def ref_rows():
    return ref_workloads.run_sweep(ref_workloads.SweepSpec(**SMOKE),
                                   mode="map")


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return bool(np.isnan(b))
    return a == b


def _rows_equal_but_mode(port: list, ref: list):
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        bad = [k for k in r if k != "mode" and not _same(p[k], r[k])]
        assert not bad, (r["lock"], r["n_threads"], bad)


def test_port_rows_equal_the_reference_rows(port_rows, ref_rows):
    """Row for row the same coordinates and values; only the engine that
    measured them differs."""
    port = [results.row_from_result(r) for r in port_rows]
    ref = [ref_results.row_from_result(r) for r in ref_rows]
    _rows_equal_but_mode(port, ref)
    assert {r["mode"] for r in port} == {"torch"}
    assert {r["mode"] for r in ref} == {"map"}
    assert all(r["lat_hist"] is not None for r in port)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_rows_load_in_the_other_package(tmp_path, port_rows, ref_rows,
                                        writer):
    path = tmp_path / "r.jsonl"
    if writer == "port":
        n = results.ResultsStore(path).append_sweep(port_rows)
    else:
        n = ref_results.ResultsStore(path).append_sweep(ref_rows)
    assert n == len(port_rows)
    mine = results.ResultsStore(path).load()
    theirs = ref_results.ResultsStore(path).load()
    assert mine == theirs
    assert all(r["schema_version"] == results.SCHEMA_VERSION == 2
               for r in mine)
    assert results.ResultsStore(path).query(lock="twa", outside_work=10) \
        == ref_results.ResultsStore(path).query(lock="twa", outside_work=10)
    for row in mine:   # every loaded row is writable by both packages
        results.ResultsStore(path).validate_row(row)
        ref_results.ResultsStore(path).validate_row(row)


def test_schema_constants_match_the_reference():
    assert results.SCHEMA_VERSION == ref_results.SCHEMA_VERSION
    assert results.COORD_KEYS == ref_results.COORD_KEYS
    assert results.VALUE_KEYS == ref_results.VALUE_KEYS
    assert results.ALL_KEYS == ref_results.ALL_KEYS
    assert results.WORKLOAD_KEYS == ref_results.WORKLOAD_KEYS


_V0 = {  # a pre-versioning row: no stamp, no outside_work, no latency
    "lock": "twa", "n_threads": 8, "seed": 1, "cs_work": 4,
    "private_arrays": False, "wa_size": 4096,
    "long_term_threshold": 1, "sem_permits": 4, "reader_fraction": 50,
    "n_locks": 1, "horizon": 100_000, "costs": [1] * 9,
    "throughput": 0.01, "avg_handover": 100.0, "acquisitions": 1000,
    "waited_acquisitions": 900, "events": 5000, "sleeping": 0,
}
_V1 = {**_V0, "schema_version": 1, "outside_work": 20, "preempt_faults": 1,
       "spurious_faults": 0, "abort_faults": 0, "mode": "pallas",
       "lat_p50": 3.0, "lat_p99": 15.0, "lat_p999": 31.0,
       "lat_hist": [0, 1, 2] + [0] * 29, "pad_stats": None}


@pytest.mark.parametrize("old", [_V0, _V1], ids=["v0", "v1"])
def test_migration_matches_the_reference(tmp_path, old):
    assert results.migrate(dict(old)) == ref_results.migrate(dict(old))
    path = tmp_path / "old.jsonl"
    path.write_text(json.dumps(old) + "\n")
    row = results.ResultsStore(path).load()[0]
    assert row == ref_results.ResultsStore(path).load()[0]
    assert row["schema_version"] == 2 and row["workload"] == "synthetic"
    results.ResultsStore(path).validate_row(row)
    results.ResultsStore(path).rewrite()
    raw = json.loads(path.read_text().splitlines()[0])
    assert raw == ref_results.migrate(dict(old))
    for bad, match in (({**row, "schema_version": 3}, "newer"),
                       ({"throughput": 1.0}, "lock")):
        for pkg in (results, ref_results):
            with pytest.raises(ValueError, match=match):
                pkg.migrate(bad)


@pytest.fixture
def mixed_store(tmp_path, port_rows, ref_rows):
    """One file holding the port's rows and the reference's, as a user's
    store does once both packages have swept into it."""
    path = tmp_path / "mixed.jsonl"
    results.ResultsStore(path).append_sweep(port_rows)
    ref_results.ResultsStore(path).append_sweep(ref_rows)
    return path


@pytest.mark.parametrize("workload", [
    {"n_threads": 4, "cs_work": 2, "outside_work": 10},   # exact
    {"n_threads": 2},                                       # exact, partial
    {"n_threads": 3, "cs_work": 3},                         # nearest
    {"n_threads": 64, "reader_fraction": 0},                # nearest
    {"cs_work": 2},                                         # threads free
], ids=["exact", "exact-partial", "nearest", "nearest-far", "free"])
def test_recommend_lock_matches_the_reference(mixed_store, workload):
    mine = results.recommend_lock(results.ResultsStore(mixed_store),
                                  workload)
    theirs = ref_results.recommend_lock(
        ref_results.ResultsStore(mixed_store), workload)
    assert mine == theirs
    # mode is not a workload key: both packages' rows are aggregated
    assert mine["n_rows"] % 2 == 0


def test_recommend_lock_errors_match_the_reference(tmp_path):
    for pkg in (results, ref_results):
        with pytest.raises(ValueError, match="unknown workload keys"):
            pkg.recommend_lock(pkg.ResultsStore(tmp_path / "x.jsonl"),
                               {"mode": "torch"})
        with pytest.raises(ValueError, match="empty"):
            pkg.recommend_lock(pkg.ResultsStore(tmp_path / "x.jsonl"),
                               {"n_threads": 4})


def _cli(main, argv, capsys) -> str:
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["recommend", "--threads", "4", "--cs-work", "2", "--outside-work",
     "10"],
    ["recommend", "--threads", "3"],
    ["summary"],
], ids=["recommend-exact", "recommend-nearest", "summary"])
def test_cli_matches_the_reference(mixed_store, capsys, argv):
    argv = ["--store", str(mixed_store), *argv]
    assert _cli(port_cli, argv, capsys) == _cli(ref_cli, argv, capsys)


def test_cli_migrate_and_env_store(tmp_path, monkeypatch, capsys):
    path = tmp_path / "old.jsonl"
    path.write_text(json.dumps(_V0) + "\n")
    monkeypatch.setenv(workloads.RESULTS_STORE_ENV, str(path))
    out = _cli(port_cli, ["migrate"], capsys)
    assert "rewrote 1 rows at schema v2" in out
    assert json.loads(path.read_text())["schema_version"] == 2
    monkeypatch.delenv(workloads.RESULTS_STORE_ENV)
    with pytest.raises(SystemExit, match="no store"):
        port_cli(["summary"])


def _gate(engine_cls, lock, **kw):
    kw = {"lanes": 4, "two_tier": True, "threshold": 1, "store": None,
          "workload": None, **kw}
    return engine_cls._make_gate(lock, **kw)


@pytest.mark.parametrize("how", ["store", "env", "workload"])
def test_lock_auto_resolves_as_the_reference(mixed_store, monkeypatch, how):
    kw = {}
    if how == "store":
        kw["store"] = str(mixed_store)
    else:
        monkeypatch.setenv(workloads.RESULTS_STORE_ENV, str(mixed_store))
    if how == "workload":
        kw["workload"] = {"n_threads": 2, "outside_work": 0}
    gate, choice = _gate(ServeEngine, "auto", **kw)
    ref_gate, ref_choice = _gate(RefServeEngine, "auto", **kw)
    assert choice == ref_choice
    assert gate.kind == ref_gate.kind == choice["gate"]
    assert choice["source"] == "advisor"
    assert set(choice) == {"source", "gate", "sim_lock", "confidence",
                           "throughput"}


def test_lock_auto_without_a_store_raises_as_the_reference():
    for engine_cls in (ServeEngine, RefServeEngine):
        with pytest.raises(ValueError, match="results store"):
            _gate(engine_cls, "auto")


def test_hook_appends_each_cell_once(tmp_path, monkeypatch):
    """``run_sweeps`` over two specs (``run_sweep`` delegates to it) writes
    each cell to the store exactly once, in engine order."""
    path = tmp_path / "hook.jsonl"
    monkeypatch.setenv(workloads.RESULTS_STORE_ENV, str(path))
    specs = [workloads.SweepSpec(locks="ticket", threads=2, seeds=(1, 2),
                                 horizon=1_500, max_events=10_000),
             workloads.SweepSpec(locks=("twa", "mcs"), threads=3, seeds=1,
                                 horizon=1_000, max_events=10_000)]
    out = workloads.run_sweeps(specs, device="cpu")
    rows = results.ResultsStore(path).load()
    want = [results.row_from_result(r) for res in out for r in res]
    assert len(rows) == 4 and rows == want
    assert [(r["lock"], r["seed"]) for r in rows] == \
        [("ticket", 1), ("ticket", 2), ("twa", 1), ("mcs", 1)]
    assert all(r["lat_hist"] is None and r["mode"] == "torch" for r in rows)
    workloads.run_sweep(specs[0], device="cpu")
    assert len(results.ResultsStore(path)) == 6


# Reduced-horizon versions of tests/test_sim_paper_claims.py's sweeps, with
# latency collected.  The horizons keep each near a few seconds on the CPU.
PAPER_SPECS = {
    "fig3": dict(locks=("ticket", "twa", "mcs"),
                 threads=(1, 2, 4, 8, 16, 64), horizon=600),
    "locks16": dict(locks=tuple(SIM_LOCKS), threads=16, horizon=500),
    "variants": dict(locks=("ticket", "tkt-dual", "twa", "twa-id",
                            "anderson"), threads=48, horizon=500),
    "interlock": dict(locks="twa", threads=32, cs_work=50, ncs_max=100,
                      private_arrays=(False, True), n_locks=4,
                      horizon=1_500),
    "staged": dict(locks=("ticket", "twa", "twa-staged"), threads=64,
                   horizon=500),
}


@pytest.mark.parametrize("name", sorted(PAPER_SPECS))
def test_paper_claims_sweeps_match_the_reference(name):
    kw = dict(PAPER_SPECS[name], seeds=1, collect_latency=True)
    port = workloads.run_sweep(workloads.SweepSpec(**kw), device="cpu")
    ref = ref_workloads.run_sweep(ref_workloads.SweepSpec(**kw), mode="map")
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        for k in ("lock", "n_threads", "throughput", "avg_handover",
                  "lat_p50", "lat_p99", "lat_p999"):
            assert _same(p[k], r[k]), (name, r["lock"], r["n_threads"], k,
                                       p[k], r[k])
        assert np.array_equal(p["lat_hist"], r["lat_hist"])
        assert np.array_equal(p["acquisitions"], r["acquisitions"])
