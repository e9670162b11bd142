"""The MoE layer's backward pass: the port's gradients against the
reference's ``jax.grad`` on the CPU in float32, and a sum whose order is
fixed.

On CUDA a scatter-add sums the terms that land on one element with
atomics, in whatever order the threads arrive, so a backward that routes
two non-zero terms into one element through a scatter-add gives other bits
run after run, and a training run parts from itself step by step.  The
port's dispatch gather therefore sums each token's K slots through the
pair→slot map (``layers._Dispatch``); the combine's scatter-add gets one
non-zero term a slot.  ``test_no_scatter_add_sums_two_terms_into_one_
element`` records every ``aten`` call of the backward and counts, for
each scatter-add, the non-zero terms an element receives.

Tolerance: each gradient leaf within 1e-4 of that leaf's largest magnitude
in the reference, plus 1e-6, as ``test_torch_train.py`` holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.models import layers as L

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CASES = [(2, 16, 1.25), (8, 1, 1.25), (2, 16, 0.25)]
SCATTER_ADDS = {torch.ops.aten.scatter_add.default,
                torch.ops.aten.scatter_add_.default}


def _setup(B, S, capacity_factor):
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              capacity_factor=capacity_factor)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(20)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32),
         "wi": 0.2 * rng.standard_normal((E, d, ff)).astype(np.float32),
         "wg": 0.2 * rng.standard_normal((E, d, ff)).astype(np.float32),
         "wo": 0.2 * rng.standard_normal((E, ff, d)).astype(np.float32)}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((B, S, d)).astype(np.float32)
    return cfg, p, x, w


def _port_grads(cfg, p, x, w):
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = L.moe(pt, xt, cfg, dispatch="torch")
    ((y * torch.tensor(w)).sum() + aux).backward()
    return {"x": xt.grad, **{k: t.grad for k, t in pt.items()}}


@pytest.mark.parametrize("B,S,capacity_factor", CASES)
def test_moe_gradients_match_the_reference(B, S, capacity_factor):
    cfg, p, x, w = _setup(B, S, capacity_factor)
    grads = _port_grads(cfg, p, x, w)

    def loss(p, x):
        y, aux = RL.moe(p, x, cfg)
        return (y * jnp.asarray(w)).sum() + aux

    r_p, r_x = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ref = {"x": np.asarray(r_x), **{k: np.asarray(v) for k, v in r_p.items()}}
    assert set(grads) == set(ref)
    for name, r in ref.items():
        g = grads[name].numpy()
        tol = GRAD_RTOL * np.abs(r).max() + GRAD_ATOL
        assert np.abs(g - r).max() <= tol, (name, np.abs(g - r).max(), tol)
        assert np.abs(r).max() > 0, name


class _ScatterTerms(TorchDispatchMode):
    """For each scatter-add, the most non-zero terms one element receives
    (the index's duplicates among the non-zero source entries)."""

    def __init__(self):
        super().__init__()
        self.most = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in SCATTER_ADDS:
            _, dim, index, src = args[:4]
            hits = torch.zeros(args[0].shape, dtype=torch.int64)
            hits.scatter_add_(dim, index,
                              (src[tuple(slice(0, n) for n in index.shape)]
                               != 0).long())
            self.most.append(int(hits.max()))
        return func(*args, **kwargs)


@pytest.mark.parametrize("B,S,capacity_factor", CASES)
def test_no_scatter_add_sums_two_terms_into_one_element(B, S,
                                                         capacity_factor):
    cfg, p, x, w = _setup(B, S, capacity_factor)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = L.moe(pt, xt, cfg, dispatch="torch")
    loss = (y * torch.tensor(w)).sum() + aux
    mode = _ScatterTerms()
    with mode:
        loss.backward()
    assert xt.grad is not None and bool((xt.grad != 0).any())
    assert mode.most, "the combine's gather scatters its gradient"
    assert max(mode.most) <= 1, mode.most
