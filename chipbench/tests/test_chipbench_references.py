"""The frozen references against the program at small sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench import bench
from chipbench.reference import lockvm as lref
from chipbench.reference import mamba1
from chipbench.tests import tiny

SPEC = bench.load_benchmark()
LOCKVM = bench.config(SPEC, "lockvm-64t")


def _cell(lock, threads, seed, **kw):
    return {"lock": lock, "n_threads": threads, "seed": seed, "cs_work": 4,
            "ncs_max": 200, "n_locks": 1, "private_arrays": False,
            "wa_size": LOCKVM["wa_size"], "collect_latency": True,
            "horizon": 2000, "max_events": LOCKVM["max_events"],
            "costs": LOCKVM["costs"], **kw}


def test_the_reference_has_every_lock_of_the_program_and_the_config():
    from repro_torch import sim

    assert lref.programs.SIM_LOCKS == sorted(sim.SIM_LOCKS)
    assert sorted(LOCKVM["locks"]) == lref.programs.SIM_LOCKS


@pytest.mark.parametrize("lock", lref.programs.SIM_LOCKS)
def test_lockvm_reference_equals_the_program(lock):
    from repro_torch import sim

    threads = (1, 3, 8, 32)
    spec = sim.SweepSpec(locks=lock, threads=threads, seeds=(2**31 - 5,),
                         cs_work=4, ncs_max=200, horizon=2000,
                         collect_latency=True,
                         costs=sim.Costs(**LOCKVM["costs"]))
    rows = sim.run_sweeps([spec], device="cpu")[0]
    for row in rows:
        want = lref.replay(_cell(lock, int(row["n_threads"]), 2**31 - 5))
        assert lref.mismatches(row, want) == []


def test_lockvm_reference_many_locks_private_arrays():
    from repro_torch import sim

    spec = sim.SweepSpec(locks="twa", threads=8, seeds=(17,), cs_work=50,
                         ncs_max=100, n_locks=8,
                         private_arrays=(False, True), horizon=2000)
    for row in sim.run_sweeps([spec], device="cpu")[0]:
        want = lref.replay(_cell("twa", 8, 17, cs_work=50, ncs_max=100,
                                 n_locks=8, collect_latency=False,
                                 private_arrays=bool(row["private_arrays"])))
        assert lref.mismatches(row, want) == []
        assert "lat_hist" not in want


def test_lockvm_control_differs():
    cell = _cell("twa", 8, 3)
    assert lref.mismatches(lref.replay(cell),
                           lref.replay(cell, ("free_invalidation",)))


def _port(arch, weights):
    from repro_torch.configs.base import ArchConfig

    cfg = ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in arch.items()})
    return cfg, weights


def test_mamba_reference_logits_equal_the_program_forward():
    from repro_torch.models.model import forward

    arch = tiny.ARCH
    w = mamba1.make_weights(arch, 5, "cpu", torch.float32, 0.3)
    cfg, params = _port(arch, w)
    tokens = torch.randint(0, arch["vocab"], (37,),
                           generator=torch.Generator().manual_seed(1))
    got, _, _ = forward(params, {"tokens": tokens[None]}, cfg, scan="torch")
    want = mamba1.logits(w, arch, tokens, torch.arange(37))
    assert torch.allclose(got[0], want, atol=2e-5, rtol=1e-5)


def test_mamba_served_tokens_are_the_references_best():
    from repro_torch.serve import ServeEngine

    arch = tiny.ARCH
    w = mamba1.make_weights(arch, 6, "cpu", torch.float32, 0.3)
    cfg, params = _port(arch, w)
    eng = ServeEngine(cfg, params, lanes=2, max_ctx=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, arch["vocab"], n).tolist(),
                       max_new_tokens=6) for n in (5, 23, 11)]
    eng.run()
    for r in reqs:
        gaps, ctrl = mamba1.served_gaps(w, arch, r.prompt, r.tokens_out,
                                        control=True)
        assert float(gaps.max()) <= 1e-4
        assert ctrl.shape == gaps.shape


def test_mamba_control_departs():
    arch = tiny.ARCH
    w = mamba1.make_weights(arch, 7, "cpu", torch.float32, 0.3)
    tokens = torch.randint(0, arch["vocab"], (40,),
                           generator=torch.Generator().manual_seed(2))
    pos = torch.arange(40)
    ref = mamba1.logits(w, arch, tokens, pos)
    ctrl = mamba1.logits(w, arch, tokens, pos, control=True)
    assert (ctrl - ref).abs().max() > 1e-2


def test_same_seed_same_weights():
    a = mamba1.make_weights(tiny.ARCH, 9, "cpu", torch.float32)
    b = mamba1.make_weights(tiny.ARCH, 9, "cpu", torch.float32)
    c = mamba1.make_weights(tiny.ARCH, 10, "cpu", torch.float32)
    assert torch.equal(a["stack"]["slot0"]["in_proj"],
                       b["stack"]["slot0"]["in_proj"])
    assert not torch.equal(a["embed"], c["embed"])


def test_weights_have_the_programs_shapes():
    from repro_torch.models.model import param_shapes

    cfg, _ = _port(tiny.ARCH, None)
    w = mamba1.make_weights(tiny.ARCH, 1, "cpu", torch.float32)
    shapes = param_shapes(cfg)
    assert tuple(w["embed"].shape) == tuple(shapes["embed"])
    assert tuple(w["lm_head"].shape) == tuple(shapes["lm_head"])
    for k, v in shapes["stack"]["slot0"].items():
        assert tuple(w["stack"]["slot0"][k].shape) == tuple(v), k
