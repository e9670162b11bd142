"""Three train steps of qwen2-vl-72b and hubert-xlarge against the
reference's, by their losses, on the CPU at reduced size (float32), with
``accum_steps`` 1 and 2 (the second splits qwen2-vl's (3, B, S) positions
on axis 1 and hubert's frames on axis 0).

Both start from the reference's ``init_params`` with ``PRNGKey(0)`` and
take the reference's synthetic batches of steps 0-2, qwen2-vl's with three
distinct position streams (``test_torch_frontends.frontend_batch``).  Each
step's loss, ce and aux within rtol 1e-5, as in
``test_torch_train_steps.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.train import train_step as ref_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train.train_step import (TrainOptions, TrainState,  # noqa: E402,E501
                                          build_train_step)
from test_torch_frontends import _ref_tree, frontend_batch  # noqa: E402

STEP_TOL = dict(rtol=1e-5, atol=0)
STEPS, BATCH, SEQ = 3, 4, 16
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_train_steps_match_the_reference(arch, accum):
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    tree = _ref_tree(arch)
    batches = [frontend_batch(rcfg, step=s, batch=BATCH, seq=SEQ)
               for s in range(STEPS)]

    ropt = RefAdamW()
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = ref_train_step.TrainState(rparams, ropt.init(rparams))
    rstep = jax.jit(ref_train_step.build_train_step(
        rcfg, ropt, ref_train_step.TrainOptions(accum_steps=accum)))
    ref = []
    for b in batches:
        rstate, m = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append({k: float(m[k]) for k in ("loss", "ce", "aux")})

    opt = AdamW()
    params = M.params_from_numpy(cfg, tree, device=CPU)
    state = TrainState(params, opt.init(params))
    step = build_train_step(cfg, opt, TrainOptions(accum_steps=accum))
    port = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        port.append({k: float(m[k]) for k in ref[0]})
    for s, (p, r) in enumerate(zip(port, ref)):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(p[k], r[k], **STEP_TOL,
                                       err_msg=f"step {s} {k}")
    assert port[0]["loss"] != port[-1]["loss"]
