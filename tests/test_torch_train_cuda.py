"""Training and the kernels: the gradient guard of the kernel wrappers, and
a train step through the ticket kernel on the card.

No kernel has a backward pass.  The routing-plan, selective-scan and RG-LRU
wrappers raise when grad mode is on and a floating input requires grad,
rather than return outputs with no ``grad_fn`` (the router, dt, B, C, a
and b would train with zero gradient and no error).  On the CPU the guard
is checked on ``meta`` tensors (the wrapper checks it before refusing a
non-CUDA device); the ``cuda`` tests check it where the kernels launch,
and that the same calls under ``torch.no_grad()`` (the serve paths) still
launch.  A reduced granite train step with ``use_pallas=True`` on the card
launches the ticket kernel once a MoE layer and gives the step-0 loss of
``use_pallas=False`` bit for bit (the kernel's slots are the plain ones).
Tests marked ``cuda`` skip with "no CUDA device" here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.data import synthetic_batch
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
from repro_torch.kernels.ticket_dispatch import plan as plan_kernel
from repro_torch.models import model as M
from repro_torch.optim import AdamW
from repro_torch.train.train_step import (TrainOptions, TrainState,
                                          build_train_step)
from repro_torch.tree import tree_map


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _plan_args(dev, grad):
    g = torch.rand((2, 16, 8), device=dev).softmax(-1)
    return (g.requires_grad_(grad), 2, 8, torch.float32)


def _scan_args(dev, grad, which):
    L, D, N = 16, 8, 4
    t = [torch.rand(s, device=dev) for s in ((L, D), (L, D), (D, N),
                                            (L, N), (L, N), (D,))]
    t[which].requires_grad_(grad)
    return t


def _rglru_args(dev, grad, which):
    a, b = torch.rand((2, 16, 8), device=dev), torch.rand((2, 16, 8),
                                                          device=dev)
    (a, b)[which].requires_grad_(grad)
    return a, b


CALLS = {
    "routing-plan": lambda dev, grad, w: plan_kernel.moe_plan(
        *_plan_args(dev, grad)),
    "selective-scan": lambda dev, grad, w: scan_kernel.selective_scan(
        *_scan_args(dev, grad, w)),
    "RG-LRU": lambda dev, grad, w: rglru_kernel.rglru_scan(
        *_rglru_args(dev, grad, w)),
}
CASES = [("routing-plan", 0)] + [("selective-scan", w) for w in range(6)] + \
    [("RG-LRU", w) for w in range(2)]


@pytest.mark.parametrize("name,which", CASES)
def test_guard_raises_before_the_device_check(name, which):
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match=f"the {name} kernel has no "
                       "backward pass"):
        CALLS[name](meta, True, which)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        CALLS[name](meta, True, which)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CALLS[name](meta, False, which)


def test_guard_leaves_the_cpu_plain_versions_differentiable():
    """On CPU tensors a wrapper runs its plain version, which autograd
    differentiates: no guard there."""
    out = CALLS["RG-LRU"](torch.device("cpu"), True, 0)
    assert out[0].grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("name,which", CASES)
def test_guard_raises_on_the_card_and_serve_calls_still_launch(
        cuda_device, name, which):
    mod = {"routing-plan": plan_kernel, "selective-scan": scan_kernel,
           "RG-LRU": rglru_kernel}[name]
    before = mod.launches
    with pytest.raises(RuntimeError, match=f"the {name} kernel has no "
                       "backward pass"):
        CALLS[name](cuda_device, True, which)
    assert mod.launches == before
    with torch.no_grad():
        CALLS[name](cuda_device, True, which)
    CALLS[name](cuda_device, False, which)
    torch.cuda.synchronize()
    assert mod.launches == before + 2


@pytest.mark.cuda
def test_reduced_train_step_through_the_ticket_kernel(cuda_device):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tree = tree_map(lambda t: t.numpy(), params)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             synthetic_batch(cfg, step=0, batch=4, seq=32).items()}
    losses = {}
    for use_pallas in (False, True):
        opt = AdamW()
        p = M.params_from_numpy(cfg, tree, device=cuda_device)
        step = build_train_step(cfg, opt, TrainOptions(use_pallas=use_pallas))
        before = (ticket_kernel.launches, plan_kernel.launches)
        state, m = step(TrainState(p, opt.init(p)), batch)
        torch.cuda.synchronize()
        assert ticket_kernel.launches - before[0] == (
            cfg.n_layers if use_pallas else 0)
        assert plan_kernel.launches == before[1]
        losses[use_pallas] = m["loss"].item()
        assert np.isfinite(losses[use_pallas])
        assert int(state.opt.step) == 1
    assert losses[True] == losses[False]
