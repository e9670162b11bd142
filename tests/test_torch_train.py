"""The port's training path against the reference's, on the CPU at reduced
size: the loss and its gradients, with ``use_pallas`` False and True
(``test_torch_optim.py`` holds the optimizer and the launcher).

Weights come from the reference's ``init_params`` with ``PRNGKey(0)``,
converted by ``params_from_numpy``; batches from the reference's
``synthetic_batch`` (the port's is bit-equal, ``test_torch_substrates``).
Four archs: granite-moe-1b-a400m (MoE), deepseek-7b (dense attention),
falcon-mamba-7b (Mamba) and recurrentgemma-9b (Griffin), each float32.
Tolerances: the loss, ce and aux within rtol 1e-5 (``LOSS_TOL``); each
gradient leaf within 1e-4 of that leaf's largest magnitude in the
reference, plus 1e-6 (``GRAD_RTOL``, ``GRAD_ATOL``: the frameworks sum in
other orders, and a leaf's small entries carry the rounding of its large
ones).  Multi-step training is held to the reference by its
losses (``test_torch_train_steps.py``), never element by element: Adam
moves every parameter by about ±lr on the first step whatever its
gradient, so rounding-level gradient differences can flip single updates.
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
from repro_torch.configs import get_config
from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel
from repro_torch.models import model as M
from repro_torch.tree import flatten_with_path

ARCHS = ("granite-moe-1b-a400m", "deepseek-7b", "falcon-mamba-7b",
         "recurrentgemma-9b")
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference's reduced float32 parameters from PRNGKey(0), as
    numpy (initialised under ``jax.jit``: one compile, not one an op)."""
    rcfg = ref_config(arch).reduced()
    init = jax.jit(RM.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(rcfg, jax.random.PRNGKey(0)))


def _setup(arch, step=0):
    """(port cfg, ref cfg, numpy params, numpy batch)."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    batch = synthetic_batch(rcfg, step=step, batch=BATCH, seq=SEQ)
    return cfg, rcfg, _ref_tree(arch), batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    cfg, rcfg, tree, batch = _setup(arch)
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        functools.partial(RM.loss_fn, cfg=rcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = M.params_from_numpy(cfg, tree, device=CPU)
    leaves = flatten_with_path(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss, m = M.loss_fn(params, _port_batch(batch), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for k in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(m[k].item(), float(r_m[k]), **LOSS_TOL,
                                   err_msg=k)
    assert loss.item() == m["loss"].item()
    if cfg.n_experts:
        assert m["aux"].item() > 0
    r_flat = {k: np.asarray(v) for k, v in
              flatten_with_path(jax.tree.map(np.asarray, r_grads)).items()}
    assert list(r_flat) == list(leaves)
    for (k, g) in zip(leaves, grads):
        r = r_flat[k]
        assert g.shape == r.shape and str(g.dtype)[6:] == str(r.dtype), k
        bound = GRAD_RTOL * float(np.abs(r).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - r).max())
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_use_pallas(arch):
    """use_pallas=True: the MoE model's loss and gradients equal the plain
    plan's (the ticket kernel's slots are the plain ones; on the CPU its
    wrapper runs the plain version), its wrapper called once a MoE layer;
    a dense model is unaffected; a model with Mamba or RG-LRU layers
    raises, as the reference's cannot train through its kernels."""
    cfg, _, tree, batch = _setup(arch)
    params = M.params_from_numpy(cfg, tree, device=CPU)
    if arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        with pytest.raises(ValueError, match="use_pallas=True"):
            M.loss_fn(params, _port_batch(batch), cfg, use_pallas=True)
        return
    out = {}
    for use_pallas in (False, True):
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  flatten_with_path(params).items()}
        tracked = _with_leaves(params, leaves)
        calls = []
        orig = ticket_kernel.ticket_dispatch

        def counted(*a, **kw):
            calls.append(a[0].shape)
            return orig(*a, **kw)

        ticket_kernel.ticket_dispatch = counted
        try:
            loss, _ = M.loss_fn(tracked, _port_batch(batch), cfg,
                                use_pallas=use_pallas)
        finally:
            ticket_kernel.ticket_dispatch = orig
        out[use_pallas] = (loss, torch.autograd.grad(loss, list(
            leaves.values())))
        n_moe = cfg.n_layers if cfg.n_experts else 0
        assert len(calls) == (n_moe if use_pallas else 0)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def _with_leaves(params, leaves):
    from repro_torch.tree import tree_map_with_path
    return tree_map_with_path(lambda k, _: leaves[k], params)


def _rand_like(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                        .astype(np.float32), tree)
