"""The port's counterpart of ``tests/test_ring_cache.py``: decoding through
the ring-buffer KV cache of sliding-window layers, past the ring's wrap,
reproduces the reference's decode step by step and a full forward pass of
the same tokens, for gemma3-1b, gemma2-27b and recurrentgemma-9b at
reduced size (window 32), with the same weights in both packages.

Tolerance: each decode step equals the reference's within rtol = atol =
1e-5 (``TOL``, float32 sums in other orders).  Decode against a full
forward pass is a different computation (a ring of keys against a banded
chunked pass) and is held to the reference's own tolerance for that
check, 2e-3 (``RING_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as RM
from repro.serve.kv_cache import insert_prefill as ref_insert_prefill
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve.kv_cache import insert_prefill

TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=2e-3, atol=2e-3)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.mark.parametrize("arch,prefix", [
    ("gemma3-1b", 20), ("gemma2-27b", 20), ("recurrentgemma-9b", 20),
    ("recurrentgemma-9b", 45)])
def test_ring_decode_matches_the_reference_and_forward(arch, prefix):
    """The port's counterpart of ``tests/test_ring_cache.py``: prefill
    ``prefix`` tokens (45: longer than the window, so the prefill's cache
    arrives in ring order), then decode one token at a time past the
    ring's wrap.  Every step equals the reference's decode; around the
    wrap it agrees with a full forward pass of the same tokens."""
    cfg = get_config(arch).reduced()
    W = cfg.window
    total = max(prefix, W) + 10
    ref_params = RM.init_params(cfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params),
                                 device=CPU)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(1, total)).astype(np.int32)
    tt = torch.from_numpy(tokens)

    last, pcache = M.prefill(params, {"tokens": tt[:, :prefix]}, cfg)
    r_last, r_pcache = RM.prefill(ref_params,
                                  {"tokens": jnp.asarray(tokens[:, :prefix])},
                                  cfg)
    _close(last, r_last)
    cache = insert_prefill(M.init_cache(cfg, 1, total, device=CPU), pcache,
                           0)
    r_cache = ref_insert_prefill(RM.init_cache(cfg, 1, total), r_pcache,
                                 jnp.int32(0))
    ring = [leaf for j, kind in enumerate(cfg.layer_pattern)
            if kind == "local"
            for leaf in cache["stack"][f"slot{j}"].values()]
    assert ring and all(leaf.shape[2] == W < total for leaf in ring)

    check_at = {prefix, W - 1, W, W + 2, total - 2}
    r_decode = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, cfg))
    for pos in range(prefix, total - 1):
        logits, cache = M.decode_step(params, cache, tt[:, pos:pos + 1],
                                      pos, cfg)
        r_logits, r_cache = r_decode(ref_params, r_cache,
                                     jnp.asarray(tokens[:, pos:pos + 1]),
                                     jnp.int32(pos))
        _close(logits, r_logits)
        if pos in check_at:
            full, _, _ = M.forward(params, {"tokens": tt[:, :pos + 1]}, cfg)
            _close(logits, full[:, -1], **RING_TOL)
