"""The remat policy (``cfg.remat``) of the port's forward against its own
``"none"`` and against the reference's same setting, on the CPU at reduced
float32 size (granite-moe-1b-a400m and deepseek-7b).

``"full"`` and ``"dots"`` only choose what a period keeps for the backward
pass, so the port's loss and gradients must equal its ``"none"`` bit for
bit; against the reference's (``dataclasses.replace(rcfg, remat=...)``,
``jax.checkpoint`` around the period) they are held to
``test_torch_train.py``'s tolerances: the loss within rtol 1e-5, each
gradient leaf within 1e-4 of that leaf's largest, plus 1e-6.  What a period
keeps is read with a saved-tensor hook (autograd's own saves) and from the
``"dots"`` policy's decisions.  Outside training (``torch.no_grad``)
nothing is checkpointed: prefill and decode logits, and the ticket
wrapper's calls, are those of ``"none"``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ticket_dispatch import kernel as ticket_kernel  # noqa: E402,E501
from repro_torch.models import model as M  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "deepseek-7b")
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")
BATCH, SEQ = 2, 16
AT = torch.ops.aten
PRODUCTS = (AT.mm.default, AT.addmm.default, AT.bmm.default)


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


def _cfg(arch, remat):
    return dataclasses.replace(get_config(arch).reduced(), remat=remat)


def _batch(arch):
    return synthetic_batch(ref_config(arch).reduced(), step=0, batch=BATCH,
                           seq=SEQ)


def _loss_and_grads(arch, remat, hooks=None, use_pallas=False):
    """The port's loss and gradients at ``remat`` from the reference's
    weights, under ``hooks`` (a saved-tensor hook pair) if given."""
    cfg = _cfg(arch, remat)
    params = M.params_from_numpy(cfg, _ref_tree(arch), device=CPU)
    leaves = {k: v.requires_grad_(True) for k, v in
              flatten_with_path(params).items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    if hooks is None:
        loss, m = M.loss_fn(params, batch, cfg, use_pallas=use_pallas)
    else:
        with torch.autograd.graph.saved_tensors_hooks(*hooks):
            loss, m = M.loss_fn(params, batch, cfg, use_pallas=use_pallas)
    return loss, m, leaves, torch.autograd.grad(loss, list(leaves.values()))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_none_bit_for_bit(arch, remat):
    loss0, m0, _, g0 = _loss_and_grads(arch, "none")
    loss, m, _, g = _loss_and_grads(arch, remat)
    assert torch.equal(loss, loss0)
    for k in m0:
        assert torch.equal(m[k], m0[k]), k
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_the_reference(arch, remat):
    rcfg = dataclasses.replace(ref_config(arch).reduced(), remat=remat)
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        functools.partial(RM.loss_fn, cfg=rcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, _ref_tree(arch)),
        {k: jnp.asarray(v) for k, v in _batch(arch).items()})
    loss, _, leaves, grads = _loss_and_grads(arch, remat)
    np.testing.assert_allclose(loss.item(), float(r_loss), **LOSS_TOL)
    r_flat = flatten_with_path(jax.tree.map(np.asarray, r_grads))
    for k, g in zip(leaves, grads):
        r = np.asarray(r_flat[k])
        bound = GRAD_RTOL * float(np.abs(r).max()) + GRAD_ATOL
        assert float(np.abs(g.numpy() - r).max()) <= bound, k


def _batch_free_products(cfg) -> int:
    """Products with no batch dimension in one forward of the stack: q, k,
    v, the output projection and the three MLP products of each layer, or
    the router in place of the MLP's (the experts' products run over E)."""
    return cfg.n_layers * (4 + (1 if cfg.n_experts else 3))


@pytest.mark.parametrize("arch", ARCHS)
def test_what_a_period_keeps(arch, monkeypatch):
    """A saved-tensor hook sees every tensor autograd saves: inside a
    period under ``"none"``, none under ``"full"`` or ``"dots"`` (the
    checkpoint's own hook takes them), and outside the periods the same
    saves plus, under checkpointing, each period's input (what the
    recompute starts from, as ``jax.checkpoint`` keeps its arguments).
    ``"dots"`` keeps exactly the batch-free products' outputs: its policy
    saves ``mm``/``addmm`` and the ``bmm`` of batch extent 1, and
    recomputes every other op, the batched products (attention's, the
    experts') among them."""
    inside = [False]
    orig_period = M._period

    def period(*a, **kw):
        inside[0] = True
        try:
            return orig_period(*a, **kw)
        finally:
            inside[0] = False

    monkeypatch.setattr(M, "_period", period)
    decisions = []
    orig_policy = M._dots_policy

    def policy(ctx, op, *args, **kw):
        d = orig_policy(ctx, op, *args, **kw)
        if not ctx.is_recompute:
            shape = tuple(args[0].shape) if op in PRODUCTS else ()
            decisions.append((op, shape, d))
        return d

    monkeypatch.setattr(M, "_dots_policy", policy)
    saved = {}
    for remat in ("none", "full", "dots"):
        where = []

        def pack(t):
            where.append(inside[0])
            return t

        _loss_and_grads(arch, remat, hooks=(pack, lambda t: t))
        saved[remat] = (sum(where), len(where) - sum(where))
    assert saved["none"][0] > 0
    n_periods = _cfg(arch, "none").n_periods
    assert saved["full"] == saved["dots"] == (0, saved["none"][1] + n_periods)

    keep = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    kept = [(op, shape) for op, shape, d in decisions if d == keep]
    products = [(op, shape, d) for op, shape, d in decisions
                if op in PRODUCTS]
    assert len(kept) == _batch_free_products(_cfg(arch, "dots"))
    for op, shape, d in products:
        batch_free = op is not AT.bmm.default or shape[0] == 1
        assert (d == keep) == batch_free, (op, shape, d)
    assert any(shape[0] > 1 for _, shape, _ in products)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_is_unchanged_under_no_grad(arch):
    """prefill and decode_step under ``torch.no_grad`` give the same logits
    and call the ticket wrapper as often at every ``remat``: nothing is
    checkpointed outside training."""
    tree = _ref_tree(arch)
    tokens = torch.from_numpy(_batch(arch)["tokens"])
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = _cfg(arch, remat)
        params = M.params_from_numpy(cfg, tree, device=CPU)
        calls = []
        orig = ticket_kernel.ticket_dispatch

        def counted(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)

        ticket_kernel.ticket_dispatch = counted
        try:
            with torch.no_grad():
                last, cache = M.prefill(params, {"tokens": tokens}, cfg,
                                        dispatch="ticket")
                grown = M.init_cache(cfg, BATCH, SEQ + 1, device=CPU)
                for j, slot in cache["stack"].items():
                    for k, v in slot.items():
                        grown["stack"][j][k][:, :, :SEQ] = v
                step, _ = M.decode_step(params, grown,
                                        last.argmax(-1)[:, None], SEQ, cfg,
                                        dispatch="ticket")
        finally:
            ticket_kernel.ticket_dispatch = orig
        out[remat] = (last, step, len(calls))
    n_moe = _cfg(arch, "none").n_layers if get_config(arch).n_experts else 0
    assert out["none"][2] == 2 * n_moe
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert torch.equal(out[remat][1], out["none"][1])
        assert out[remat][2] == out["none"][2]


def test_recompute_runs_the_ticket_kernel_again():
    """Training through the ticket kernel (``use_pallas=True``): under
    ``"full"`` each MoE layer's forward runs twice, once in the forward
    pass and once in the backward pass's recompute, with the same slots
    (top-k is deterministic), so the gradients are those of ``"none"``."""
    arch = "granite-moe-1b-a400m"
    out = {}
    for remat in ("none", "full"):
        calls = []
        orig = ticket_kernel.ticket_dispatch

        def counted(*a, **kw):
            calls.append(a[0].clone())
            return orig(*a, **kw)

        ticket_kernel.ticket_dispatch = counted
        try:
            loss, _, _, grads = _loss_and_grads(arch, remat, use_pallas=True)
        finally:
            ticket_kernel.ticket_dispatch = orig
        out[remat] = (loss, grads, calls)
    n_moe = _cfg(arch, "none").n_layers
    assert len(out["none"][2]) == n_moe and len(out["full"][2]) == 2 * n_moe
    for i in range(n_moe):          # forward, then the recompute, per layer
        assert torch.equal(out["full"][2][i], out["none"][2][i])
        assert torch.equal(out["full"][2][2 * n_moe - 1 - i],
                           out["none"][2][i])
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_unknown_remat_raises():
    cfg = _cfg("deepseek-7b", "everything")
    params = M.params_from_numpy(cfg, _ref_tree("deepseek-7b"), device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch("deepseek-7b").items()}
    with pytest.raises(ValueError, match="unknown remat 'everything'"):
        M.loss_fn(params, batch, cfg)
