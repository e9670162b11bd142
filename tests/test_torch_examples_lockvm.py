"""``repro_torch.examples.quickstart`` and ``lock_playground`` against the
reference's functions on the CPU, their lockVM sweeps shortened alike to
``HORIZON`` (helpers and tolerances: ``test_torch_examples.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.sim import workloads as RW  # noqa: E402
from repro.sim.programs import SIM_LOCKS  # noqa: E402
from repro_torch.examples import lock_playground, quickstart  # noqa: E402
from repro_torch.sim import workloads as W  # noqa: E402
from test_torch_examples import (CPU, HORIZON, LOSS_TOL, _ref_losses,  # noqa: E402,E501
                                 _ref_weights, _short, ref_map_engine)

assert ref_map_engine  # a fixture, used by name


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_matches_the_reference(monkeypatch, ref_map_engine,
                                          capsys):
    monkeypatch.setattr(quickstart, "median_throughput",
                        _short(W.median_throughput))
    rcfg = ref_config(quickstart.TRAIN_ARCH).reduced()
    _ref_weights(monkeypatch, quickstart, rcfg)
    out = quickstart.main(CPU)
    assert out["counter"] == 4000
    for T in quickstart.THREADS:
        for lock in quickstart.LOCKS:
            assert out["mutexbench"][T][lock] == RW.median_throughput(
                lock, T, runs=1, horizon=HORIZON), (lock, T)
    batches = [synthetic_batch(rcfg, step=s, batch=quickstart.BATCH,
                               seq=quickstart.SEQ)
               for s in range(quickstart.TRAIN_STEPS)]
    ref = _ref_losses(rcfg, RefAdamW(lr=1e-3), batches)
    np.testing.assert_allclose(out["losses"], ref, **LOSS_TOL)
    printed = capsys.readouterr().out
    assert "counter=4000" in printed and printed.rstrip().endswith("done.")


def test_lock_playground_matches_the_reference(monkeypatch, ref_map_engine):
    """The lockVM table, the semaphore and collision rows bit for bit with
    the reference's functions on the same specs (the reference's script
    raises at its first sweep: ``twa-timo``'s generator asserts T <= 32,
    and the port cuts it there); every host lock acquires 2,000 times."""
    monkeypatch.setattr(lock_playground, "run_sweeps", lambda specs, **kw:
                        W.run_sweeps([dataclasses.replace(
                            s, horizon=HORIZON) for s in specs], **kw))
    monkeypatch.setattr(lock_playground, "run_contention",
                        _short(W.run_contention))
    out = lock_playground.main(CPU)
    with pytest.raises(AssertionError, match="ring slots would alias"):
        RW.run_sweep(RW.SweepSpec(locks=tuple(SIM_LOCKS), threads=(2, 16, 64),
                                  seeds=1, horizon=HORIZON))
    ref = {}
    for spec in lock_playground.sweep_specs():
        for r in RW.run_sweep(dataclasses.replace(spec, horizon=HORIZON),
                              mode="map"):
            ref[r["lock"], r["n_threads"]] = (r["throughput"],
                                              r["avg_handover"])
    assert len(ref) == len(SIM_LOCKS) * 3 - 1
    np.testing.assert_equal(out["sweep"], ref)
    for permits in lock_playground.SEM_PERMITS:
        r = RW.run_contention("twa-sem", 32, sem_permits=permits,
                              horizon=HORIZON)
        assert out["sem"][permits] == r["throughput"], permits
    from repro.sim import read_collision_counters
    for wa in lock_playground.WA_SIZES:
        r = RW.run_contention("twa", 32, n_locks=4, wa_size=wa,
                              count_collisions=True, horizon=HORIZON)
        wakes, futile = read_collision_counters(r["mem"], r["layout"])
        assert out["collisions"][wa] == (int(futile.sum()),
                                         int(wakes.sum())), wa
    assert set(out["host_threads"].values()) == {2000}
    assert all(grant > 0 for grant, _ in out["distributed"].values())
