"""The port's example scripts (``repro_torch.examples``) against the
reference's (``examples/``), on the CPU.  This file holds the helpers
``test_torch_examples_lockvm.py`` (quickstart, lock_playground) imports.

Each script runs through its ``main(argv)`` with ``--device cpu``.  Where
the reference script would run for minutes here (a lockVM spec at its full
horizon, a 100M-parameter model), both sides are shortened alike: the
port module's sweep entries (``median_throughput``, ``run_sweeps``,
``run_contention``) are patched to run at ``HORIZON``, and the port is
compared with the reference functions the script calls, given the same
arguments at the same horizon (the reference's engine in ``mode="map"``).
The training scripts start from the reference's weights
(``init_params(cfg, PRNGKey(0))`` through ``params_from_numpy``: the
port's ``make_state`` is patched to return them) and take the same
batches, so their losses must lie within rtol 1e-5 (``LOSS_TOL``) of the
reference's jitted train step's.  lockVM rows must be equal bit for bit.
``elastic_restart`` keeps its own check (the resumed run within 5e-3 of
the uninterrupted one).
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim.schedules import warmup_cosine as ref_warmup_cosine  # noqa: E402,E501
from repro.sim import workloads as RW  # noqa: E402
from repro.train import train_step as RT  # noqa: E402
from repro_torch.examples import (elastic_restart,  # noqa: E402
                                  serve_continuous_batching, train_moe)
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.train.train_step import TrainState  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HORIZON = 1_000
LOSS_TOL = dict(rtol=1e-5, atol=0)
CPU = ["--device", "cpu"]
EXAMPLES = ("quickstart", "lock_playground", "elastic_restart",
            "serve_continuous_batching", "train_moe")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_map_engine(monkeypatch):
    """The reference's sweeps (``run_contention`` and ``median_throughput``
    call its module's ``run_sweep``) on its ``map`` engine."""
    orig = RW.run_sweep
    monkeypatch.setattr(RW, "run_sweep",
                        lambda spec, **kw: orig(spec, mode="map"))


def _short(orig, **fixed):
    """``orig`` (a port sweep entry that takes ``horizon=``) at HORIZON."""
    @functools.wraps(orig)
    def wrapper(*args, **kw):
        return orig(*args, **{**kw, "horizon": HORIZON, **fixed})
    return wrapper


@functools.lru_cache(maxsize=None)
def _ref_tree(rcfg):
    init = jax.jit(RM.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(rcfg, jax.random.PRNGKey(0)))


def _ref_weights(monkeypatch, module, rcfg):
    """The port module's ``make_state`` returning the reference's weights
    from PRNGKey(0) and zero moments."""
    def make_state(cfg, optimizer, seed=0, *, device=None):
        params = params_from_numpy(cfg, _ref_tree(rcfg), device=device)
        return TrainState(params, optimizer.init(params))
    monkeypatch.setattr(module, "make_state", make_state)


def _ref_losses(rcfg, optimizer, batches):
    """The reference's jitted train step from PRNGKey(0) over ``batches``."""
    params = jax.tree.map(jnp.asarray, _ref_tree(rcfg))
    state = RT.TrainState(params, optimizer.init(params))
    step = jax.jit(RT.build_train_step(rcfg, optimizer, RT.TrainOptions()))
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses


def test_elastic_restart_keeps_its_check_and_the_reference_losses(
        monkeypatch, tmp_path):
    rcfg = ref_config(elastic_restart.ARCH).reduced()
    _ref_weights(monkeypatch, elastic_restart, rcfg)
    out = elastic_restart.main(CPU + ["--ckpt-dir", str(tmp_path)])
    assert out["verdict"] == "OK" and out["drift"] < 5e-3
    assert out["dead"] == [3] and out["resumed_at"] == 6
    assert out["plan"].mesh_shape == (2, 16)
    batches = [synthetic_batch(rcfg, step=s, batch=elastic_restart
                               .GLOBAL_BATCH, seq=elastic_restart.SEQ)
               for s in range(10)]
    ref = _ref_losses(rcfg, RefAdamW(lr=1e-3), batches)
    np.testing.assert_allclose(out["uninterrupted_losses"], ref, **LOSS_TOL)
    np.testing.assert_allclose(out["phase1_losses"] + out["phase2_losses"],
                               ref, **LOSS_TOL)


def test_serve_continuous_batching_admits_in_fifo_order(tmp_path):
    """The requests are the script's seeded draws; every request gets its
    drawn number of tokens (no eos) and the admissions follow the tickets
    (the script's own FIFO check); the recorded trace holds them all."""
    path = tmp_path / "trace.npz"
    out = serve_continuous_batching.main(CPU + ["--record", str(path)])
    draws = []
    for i in range(10):
        rng = np.random.default_rng(1000 + i)
        n = int(rng.integers(4, 20))
        rng.integers(1, 512, size=n)
        draws.append((n, int(rng.integers(4, 11))))
    res = out["results"]
    assert sorted((r["prompt_len"], r["max_new"]) for r in res.values()) \
        == sorted(draws)
    assert all(len(r["generated"]) == r["max_new"] for r in res.values())
    assert out["gate"] == "twa" and len(out["trace"]) == 10 and path.exists()


# the reference script's model (examples/train_moe.py), and the cut both
# sides take here
TRAIN_MOE_CFG = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                     head_dim=64, d_ff=768, n_experts=8, top_k=2, vocab=32768,
                     tie_embeddings=False, dtype="float32", remat="none",
                     scan_layers=True)
TRAIN_MOE_CUT = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=96, vocab=512)
TRAIN_MOE_ARGS = dict(steps=20, batch=2, seq=16)


def test_train_moe_matches_the_reference(monkeypatch, tmp_path):
    rcfg = dataclasses.replace(ref_config("granite-moe-1b-a400m"),
                               **TRAIN_MOE_CFG)
    orig = train_moe.model_config
    assert dataclasses.asdict(orig()) == dataclasses.asdict(rcfg)
    rcfg = dataclasses.replace(rcfg, **TRAIN_MOE_CUT)
    monkeypatch.setattr(train_moe, "model_config", lambda: dataclasses
                        .replace(orig(), **TRAIN_MOE_CUT))
    _ref_weights(monkeypatch, train_moe, rcfg)
    a = TRAIN_MOE_ARGS
    out = train_moe.main(CPU + ["--steps", str(a["steps"]), "--batch",
                                str(a["batch"]), "--seq", str(a["seq"]),
                                "--ckpt-dir", str(tmp_path)])
    batches = [synthetic_batch(rcfg, step=s, batch=a["batch"], seq=a["seq"])
               for s in range(a["steps"])]
    ref = _ref_losses(rcfg, RefAdamW(lr=1e-3, schedule=ref_warmup_cosine(
        20, a["steps"])), batches)
    np.testing.assert_allclose(out["losses"], ref, **LOSS_TOL)
    assert out["last10"] < out["first10"]
    assert out["checkpoints"] == []


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_run_as_modules(name):
    """Each example is a module with the reference's arguments plus
    ``--device``."""
    run = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=60, env={"PYTHONPATH": str(REPO / "src"),
                                          "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    assert "--device" in run.stdout
