"""Three train steps of the port against the reference's, by their losses,
on the CPU at reduced size (float32), with ``accum_steps`` 1 and 2.

Both start from the reference's ``init_params`` with ``PRNGKey(0)``
(converted by ``params_from_numpy``) and the optimizer's zero moments, and
take the reference's ``synthetic_batch`` of steps 0-2.  Each step's loss
(and ce and aux) must lie within rtol 1e-5 (``STEP_TOL``) of the
reference's; the parameters are not compared element by element (Adam's
first step moves each by about ±lr whatever its gradient, so a gradient
differing at rounding level can flip one update; ``test_torch_train.py``
holds the gradients and one update directly).  This file takes the MoE
and dense archs, ``test_torch_train_steps_recurrent.py`` the Mamba and
Griffin ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config
from repro.data import synthetic_batch
from repro.models import model as RM
from repro.optim import AdamW as RefAdamW
from repro.train import train_step as ref_train_step
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.optim import AdamW
from repro_torch.train.train_step import (TrainOptions, TrainState,
                                          build_train_step)

STEP_TOL = dict(rtol=1e-5, atol=0)
STEPS, BATCH, SEQ = 3, 4, 16
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    rcfg = ref_config(arch).reduced()
    init = jax.jit(RM.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(rcfg, jax.random.PRNGKey(0)))


def check_steps(arch: str, accum: int, seq: int = SEQ) -> None:
    """STEPS steps of BATCH × ``seq`` tokens in both packages from the same
    state and batches; the metrics of each step within STEP_TOL."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    tree = _ref_tree(arch)
    batches = [synthetic_batch(rcfg, step=s, batch=BATCH, seq=seq)
               for s in range(STEPS)]

    ropt = RefAdamW()
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = ref_train_step.TrainState(rparams, ropt.init(rparams))
    rstep = jax.jit(ref_train_step.build_train_step(
        rcfg, ropt, ref_train_step.TrainOptions(accum_steps=accum)))
    ref = []
    for b in batches:
        rstate, m = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append({k: float(m[k]) for k in ("loss", "ce", "aux",
                                             "grad_norm")})

    opt = AdamW()
    params = M.params_from_numpy(cfg, tree, device=CPU)
    state = TrainState(params, opt.init(params))
    step = build_train_step(cfg, opt, TrainOptions(accum_steps=accum))
    port = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert not any(t.requires_grad for t in (m["loss"], m["grad_norm"]))
        port.append({k: float(m[k]) for k in ref[0]})
    assert int(state.opt.step) == STEPS
    for s, (p, r) in enumerate(zip(port, ref)):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(p[k], r[k], **STEP_TOL,
                                       err_msg=f"step {s} {k}")
    # the losses moved: the steps trained something
    assert port[0]["loss"] != port[-1]["loss"]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-7b"])
def test_train_steps_match_the_reference(arch, accum):
    check_steps(arch, accum)
