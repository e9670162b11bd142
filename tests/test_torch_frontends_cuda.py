"""The frontends, remat and the examples on the card: chip_smoke's
``train_hubert``, ``frontends`` and ``examples`` phase functions at reduced
size, and a remat train step through the ticket kernel.  Tests marked
``cuda`` skip with "no CUDA device" here; the rest check, on the CPU, the
helpers those phases use (no JAX: the card's tests compare with the plain
PyTorch path).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel  # noqa: E402,E501
from repro_torch.kernels.ticket_dispatch import plan as plan_kernel  # noqa: E402,E501
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.sim import engine_cuda  # noqa: E402
from repro_torch.train.train_step import (TrainOptions, TrainState,  # noqa: E402,E501
                                          build_train_step)
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def test_frontend_batches_carry_three_distinct_streams():
    cs = _chip_smoke()
    cfg = get_config("qwen2-vl-72b").reduced()
    b = cs.frontend_batch(synthetic_batch, cfg, 1, 2, 64)
    pos = b["positions"]
    n_vis = int(b["vision_mask"][0].sum())
    assert pos.shape == (3, 2, 64) and n_vis == 16
    assert (pos[0, :, :n_vis] == pos[0, :, :1]).all()
    assert len({tuple(pos[s, 0, :n_vis]) for s in range(3)}) == 3
    assert (pos[:, :, n_vis:] == pos[:1, :, n_vis:]).all()
    assert (np.diff(pos[0, :, n_vis:], axis=-1) == 1).all()
    plain = get_config("deepseek-7b").reduced()
    assert "positions" not in cs.frontend_batch(synthetic_batch, plain, 0,
                                                2, 16)


def test_configured_swaps_one_config_and_restores():
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("hubert-xlarge"), remat="none")
    with cs.configured(launch_train, cfg):
        assert launch_train.get_config("hubert-xlarge") is cfg
        assert launch_train.get_config("gemma3-1b").remat == "full"
    assert launch_train.get_config("hubert-xlarge").remat == "full"


@pytest.mark.cuda
def test_train_hubert_phase(cuda_device):
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("hubert-xlarge").reduced(),
                              remat="full")
    out = cs.train_hubert_phase(cuda_device, launch_train, cfg, batch=2,
                                seq=64, steps=3)
    assert set(out) >= {"remat_full", "remat_none"}
    assert out["max_rel_diff"] <= cs.TRAIN_LOSS_RTOL


@pytest.mark.cuda
def test_frontends_phase(cuda_device):
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen2-vl-72b").reduced(),
                              remat="full", dtype="bfloat16")
    out = cs.frontends_phase(cuda_device, M, synthetic_batch, cfg, batch=2,
                             seq=64)
    assert out["decode_vs_prefill"]["rows"] == 2
    assert all(p["grads_finite"] for p in out["passes"])


@pytest.mark.cuda
def test_examples_phase(cuda_device):
    cs = _chip_smoke()
    out = cs.examples_phase(cuda_device, engine_cuda,
                            names=("elastic_restart",
                                   "serve_continuous_batching"))
    assert out["scripts"]["elastic_restart"]["drift"] < 5e-3
    assert out["scripts"]["serve_continuous_batching"]["requests"] == 10


@pytest.mark.cuda
def test_remat_train_step_runs_the_ticket_kernel_in_the_recompute(
        cuda_device):
    """Reduced granite with ``remat="full"`` and ``use_pallas=True``: the
    ticket kernel launches twice a MoE layer (the forward and the backward
    pass's recompute), and the step's loss equals ``remat="none"``'s bit
    for bit."""
    base = get_config("granite-moe-1b-a400m").reduced()
    tree = tree_map(lambda t: t.numpy(), M.init_params(
        base, torch.Generator().manual_seed(0), device="cpu"))
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             synthetic_batch(base, step=0, batch=4, seq=32).items()}
    losses = {}
    for remat, passes in (("none", 1), ("full", 2)):
        cfg = dataclasses.replace(base, remat=remat)
        opt = AdamW()
        p = M.params_from_numpy(cfg, tree, device=cuda_device)
        step = build_train_step(cfg, opt, TrainOptions(use_pallas=True))
        before = (ticket_kernel.launches, plan_kernel.launches)
        _, m = step(TrainState(p, opt.init(p)), batch)
        torch.cuda.synchronize()
        assert ticket_kernel.launches - before[0] == passes * cfg.n_layers
        assert plan_kernel.launches == before[1]
        losses[remat] = m["loss"].item()
    assert losses["full"] == losses["none"]
