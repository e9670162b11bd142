"""The softcapped paths under autograd (gemma2-27b's attention cap 50 and
logit cap 30) keep one float32 copy of the scores and of the logits for the
backward pass, where autograd's own ops keep tanh's output beside the
softmax's (or the logsumexp's) input: at gemma2's 4,160-token training
step a local layer's banded scores are 8.6 GB a copy.

The copies are counted on the CPU, on a reduced float32 gemma2-27b (two
local layers and one global) at 64 tokens, past its window of 32, with
every saved tensor recorded by
``torch.autograd.graph.saved_tensors_hooks``; the functions are held to
autograd's ops on the same inputs: the forward bit for bit, the gradients
within 1e-6 of the largest in float64 (the loss and gradients against the
reference are ``test_torch_train_archs.py``'s)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = torch.device("cpu")
GRAD_RTOL = 1e-6


def _saved_storages(fn):
    """Run ``fn`` with every tensor autograd saves recorded: {(shape,
    dtype): the number of distinct storages saved at that shape}."""
    seen = {}

    def pack(t):
        key = (tuple(t.shape), t.dtype)
        seen.setdefault(key, set()).add(t.untyped_storage().data_ptr())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return {k: len(v) for k, v in seen.items()}, out


def test_one_float32_copy_of_scores_and_logits():
    cfg = dataclasses.replace(get_config("gemma2-27b").reduced(),
                              remat="none")
    B, S = 2, 64
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device=CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, step=0, batch=B, seq=S).items()}
    counts, (loss, _) = _saved_storages(
        lambda: M.loss_fn(params, batch, cfg))
    f32 = torch.float32
    w, H = cfg.window, cfg.n_heads
    banded = (B, S // w, H, w, 2 * w)          # the local layer's scores
    full = (B, H, S, S)                        # the global layer's
    logits = (B, S, cfg.padded_vocab)
    kinds = cfg.layer_kinds()
    assert kinds.count("local") == 2 and kinds.count("global") == 1
    # one a layer, and one of the logits
    assert counts.get((banded, f32)) == kinds.count("local"), counts
    assert counts.get((full, f32)) == kinds.count("global"), counts
    assert counts.get((logits, f32)) == 1, counts
    torch.autograd.grad(loss, leaves)


def _plain_capped_softmax(s, cap, mask):
    return torch.softmax((cap * torch.tanh(s / cap)).masked_fill(
        ~mask, L.NEG_INF), dim=-1)


def _rows():
    """Scores (3, 5, 40) of std 60 around the cap, a causal mask with one
    row masked whole, and an upstream gradient."""
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.normal(0, 60, (3, 5, 40)).astype(np.float32))
    mask = torch.ones(40, 40, dtype=torch.bool).tril()[:5][None].expand(
        3, 5, 40).clone()
    mask[1, 2] = False
    g = torch.from_numpy(rng.normal(size=(3, 5, 40)).astype(np.float32))
    return s, mask, g


@pytest.mark.parametrize("cap", [50.0, 30.0])
def test_capped_softmax_matches_autograds_ops(cap):
    s, mask, g = _rows()
    x = s.clone().requires_grad_(True)
    p = L._CappedSoftmax.apply(x, cap, mask)
    (dx,) = torch.autograd.grad(p, x, g)
    ref = _plain_capped_softmax(s, cap, mask)
    assert torch.equal(p.detach(), ref)
    x64 = s.double().requires_grad_(True)
    (want,) = torch.autograd.grad(_plain_capped_softmax(x64, cap, mask),
                                  x64, g.double())
    assert torch.isfinite(dx).all()
    assert (dx[~mask] == 0).all()
    err = (dx.double() - want).abs().max().item()
    assert err <= GRAD_RTOL * want.abs().max().item(), err


def test_softcap_matches_autograds_ops():
    s, _, g = _rows()
    x = s.clone().requires_grad_(True)
    y = L.softcap(x, 30.0)
    assert y.grad_fn is not None and "Softcap" in type(y.grad_fn).__name__
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(y.detach(), 30.0 * torch.tanh(s / 30.0))
    x64 = s.double().requires_grad_(True)
    (want,) = torch.autograd.grad(30.0 * torch.tanh(x64 / 30.0), x64,
                                  g.double())
    err = (dx.double() - want).abs().max().item()
    assert err <= GRAD_RTOL * want.abs().max().item(), err
