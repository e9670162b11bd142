"""The port's sliding-window attention, its ring cache and the RG-LRU
block against the reference's, layer by layer and as whole models
(recurrentgemma-9b, the Griffin hybrid, and gemma3-1b and gemma2-27b, which
interleave local and global attention), on the same numpy-seeded inputs
and the same weights (the reference's ``init_params`` with ``PRNGKey(0)``,
converted by ``params_from_numpy``).

Everything runs on the CPU in float32 unless a test names bf16.
Tolerance: rtol 1e-5 and atol 1e-5 (``TOL``): the two frameworks sum in
other orders, which moves float32 results by a few ulp per reduction.
Decoding through the ring's wrap is checked in
``tests/test_torch_ring_cache.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
ARCHS = ("recurrentgemma-9b", "gemma3-1b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _layer_params(shapes, seed):
    """One layer's weights, as numpy, in the reference's layout: normals
    for the products, small noise around the constant inits, Λ from the
    reference's init formula."""
    out = {}
    for i, (k, (s, init)) in enumerate(shapes.items()):
        if init == "lam":
            u = np.random.default_rng(seed + i).uniform(0.9, 0.999, size=s)
            out[k] = np.log(np.expm1(-np.log(u) / L.RGLRU_C)).astype(
                np.float32)
        else:
            out[k] = _rand(seed + i, *s,
                           scale=0.2 if init == "normal" else 0.1)
    return out


def test_configs_are_the_reference_configs():
    for name in ("recurrentgemma-9b", "gemma3-1b", "gemma2-27b"):
        port, ref = get_config(name), ref_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced())


def test_recurrentgemma_parameter_tree_at_full_width():
    """38 layers (26 RG-LRU, 12 local), 9,396,195,328 parameters in the
    tree; ``param_count()``'s formula, kept as the reference has it, leaves
    out one of ``conv_b``/``lam`` per RG-LRU layer and the final norm."""
    cfg = get_config("recurrentgemma-9b")
    kinds = cfg.layer_kinds()
    assert len(kinds) == 38 and kinds.count("rglru") == 26
    shapes = M.param_shapes(cfg)
    n = int(np.prod(shapes["embed"])) + int(np.prod(shapes["final_norm"]))
    n += sum(int(np.prod(s)) for slot in shapes["stack"].values()
             for s in slot.values())
    n += sum(int(np.prod(s)) for layer in shapes["tail"]
             for s in layer.values())
    assert n == 9_396_195_328
    assert cfg.param_count() == 9_396_084_736 == \
        n - 26 * cfg.lru_width - cfg.d_model
    assert "lm_head" not in shapes                     # tied embeddings


@pytest.mark.parametrize("arch,S", [
    ("gemma3-1b", 20), ("gemma3-1b", 32), ("gemma3-1b", 64),
    ("gemma3-1b", 70), ("gemma2-27b", 45), ("recurrentgemma-9b", 40)])
def test_attention_local(arch, S):
    """S ≤ w: plain causal; S a multiple of w; S > w with a padded tail and
    chunk 0's masked previous keys; gemma2 softcaps the scores."""
    cfg = get_config(arch).reduced()
    p = _layer_params(M._attn_layer_shapes(cfg), 10)
    x = _rand(2, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    out, (k, v) = L.attention_local({n: _t(a) for n, a in p.items()}, _t(x),
                                    cfg, torch.from_numpy(pos.copy()))
    r_out, (r_k, r_v) = RL.attention_local(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), cfg,
        jnp.asarray(pos))
    assert k.shape == (2, S, cfg.n_kv_heads, cfg.head_dim)
    _close(out, r_out)
    _close(k, r_k)
    _close(v, r_v)


def test_windowed_attention_decode_across_the_wrap():
    """A ring of W slots with per-lane positions before the wrap, at it
    and past it (slot = pos % W; every slot live once pos ≥ W), and one
    position for every lane."""
    cfg = get_config("gemma2-27b").reduced()
    W = cfg.window
    p = _layer_params(M._attn_layer_shapes(cfg), 20)
    pj = {n: jnp.asarray(a) for n, a in p.items()}
    pt = {n: _t(a) for n, a in p.items()}
    B = 5
    x = _rand(3, B, 1, cfg.d_model)
    ck = _rand(4, B, W, cfg.n_kv_heads, cfg.head_dim)
    cv = _rand(5, B, W, cfg.n_kv_heads, cfg.head_dim)
    for pos in (np.array([0, 17, W - 1, W, 3 * W + 5], np.int32), W + 2):
        r_out, r_k, r_v = RL.attention_decode(
            pj, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(pos), cfg, window=W)
        k_t, v_t = _t(ck), _t(cv)
        out, k2, v2 = L.attention_decode(pt, _t(x), k_t, v_t,
                                         torch.as_tensor(pos), cfg,
                                         window=W)
        assert k2 is k_t and v2 is v_t                 # written in place
        _close(out, r_out)
        _close(k2, r_k)
        _close(v2, r_v)


@pytest.mark.parametrize("S", [1, 2, 40])
def test_rglru_block_and_decode(S):
    """Prompts shorter than the conv's kw-1 = 3 leave zeros in its tail;
    two decode steps follow from the block's states."""
    cfg = get_config("recurrentgemma-9b").reduced()
    p = _layer_params(M._rglru_layer_shapes(cfg), 30)
    pt = {k: _t(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    x = _rand(31, 2, S, cfg.d_model)
    out, (h, conv) = L.rglru_block(pt, _t(x), cfg)
    r_out, (r_h, r_conv) = RL.rglru_block(pj, jnp.asarray(x), cfg)
    assert h.shape == (2, cfg.lru_width)
    assert conv.shape == (2, cfg.conv_width - 1, cfg.lru_width)
    _close(out, r_out)
    _close(h, r_h)
    _close(conv, r_conv)
    if S < cfg.conv_width - 1:
        assert float(conv[:, :cfg.conv_width - 1 - S].abs().max()) == 0.0
    plain, _ = L.rglru_block(pt, _t(x), cfg, scan="torch")
    assert torch.equal(plain, out)
    tok = _rand(32, 2, 1, cfg.d_model)
    for _ in range(2):
        out, h, conv = L.rglru_decode(pt, _t(tok), h, conv, cfg)
        r_out, r_h, r_conv = RL.rglru_decode(pj, jnp.asarray(tok), r_h,
                                             r_conv, cfg)
        _close(out, r_out)
        _close(h, r_h)
        _close(conv, r_conv)
        tok = np.array(r_out)


def test_bf16_rglru_keeps_lam_float32_and_makes_b_from_the_rounded_a():
    """In a bf16 model Λ stays float32, a is rounded to bf16 before b is
    made from it, and the gate is the tanh GELU: the block equals the
    reference's bf16 block."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device=CPU)
    layer = {k: v[0] for k, v in params["stack"]["slot0"].items()}
    assert layer["lam"].dtype == torch.float32
    assert layer["w_x"].dtype == torch.bfloat16
    # a at σ(r) = 1 is the u ~ U(0.9, 0.999) Λ was drawn from
    a_max = torch.exp(-L.RGLRU_C * L.softplus(layer["lam"]))
    assert float(a_max.min()) > 0.9 - 1e-5
    assert float(a_max.max()) < 0.999 + 1e-5
    tree = jax.tree.map(lambda t: t.float().numpy(), params)
    back = M.params_from_numpy(cfg, tree, device=CPU)
    assert back["stack"]["slot0"]["lam"].dtype == torch.float32
    assert torch.equal(back["stack"]["slot0"]["lam"],
                       params["stack"]["slot0"]["lam"])

    conv = torch.from_numpy(_rand(40, 3, 5, cfg.lru_width)).bfloat16()
    a, b = L._rglru_gates(layer, conv, torch.bfloat16)
    assert a.dtype == b.dtype == torch.bfloat16
    r, i = torch.einsum("...w,wk->...k", conv, layer["w_rg"]).chunk(2, -1)
    gated = torch.sigmoid(i) * conv
    af = a.float()
    want = torch.sqrt(1 - af * af).bfloat16() * gated
    assert torch.equal(b, want)
    a32 = torch.exp(-L.RGLRU_C * L.softplus(layer["lam"])
                    * torch.sigmoid(r.float()))
    from_f32 = torch.sqrt(1 - a32 * a32).bfloat16() * gated
    assert not torch.equal(b, from_f32)                # the rounding shows

    pj = jax.tree.map(lambda t: jnp.asarray(t.float().numpy(),
                                            jnp.bfloat16), layer)
    pj["lam"] = jnp.asarray(layer["lam"].numpy())
    x = _rand(41, 2, 9, cfg.d_model)
    out, (h, _) = L.rglru_block(layer, torch.from_numpy(x).bfloat16(), cfg)
    r_out, (r_h, _) = RL.rglru_block(pj, jnp.asarray(x, jnp.bfloat16), cfg)
    assert out.dtype == h.dtype == torch.bfloat16
    _close(out, r_out, rtol=2e-2, atol=2e-3)
    _close(h, r_h, rtol=2e-2, atol=2e-3)
    erf = torch.nn.functional.gelu(torch.tensor([0.5, -1.5]))
    assert not torch.equal(erf, L._act("gelu")(torch.tensor([0.5, -1.5])))


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    cfg = get_config(request.param).reduced()
    ref_params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    return cfg, ref_params, M.params_from_numpy(cfg, tree, device=CPU)


def test_forward_and_prefill(model_pair):
    """A prompt longer than the reduced window of 32: the banded chunked
    path, and the ring-ordered cache of the local layers."""
    cfg, ref_params, params = model_pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 45)).astype(np.int32)
    logits, aux, cache = M.forward(params, {"tokens": torch.from_numpy(
        tokens)}, cfg, collect_cache=True)
    r_logits, r_aux, r_cache = RM.forward(
        ref_params, {"tokens": jnp.asarray(tokens)}, cfg, collect_cache=True)
    assert logits.shape == (2, 45, cfg.padded_vocab)
    _close(logits, r_logits)
    _close(aux, r_aux)
    for j, slot in cache["stack"].items():
        assert slot.keys() == r_cache["stack"][j].keys()
        for k, leaf in slot.items():
            _close(leaf, r_cache["stack"][j][k])
    for port, ref in zip(cache["tail"], r_cache["tail"]):
        for k, leaf in port.items():
            _close(leaf, ref[k])
    last, _ = M.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    r_last, _ = RM.prefill(ref_params, {"tokens": jnp.asarray(tokens)}, cfg)
    _close(last, r_last)


def test_decode_steps_match(model_pair):
    """Decode three tokens into a zero cache with per-lane positions, lane
    1 idle at its last position (its RG-LRU state advances all the same,
    as in the reference)."""
    cfg, ref_params, params = model_pair
    B, S_ctx = 2, 48
    cache = M.init_cache(cfg, B, S_ctx, device=CPU)
    r_cache = RM.init_cache(cfg, B, S_ctx)
    assert jax.tree.map(lambda t: tuple(t.shape), cache) == \
        jax.tree.map(lambda a: tuple(a.shape), r_cache)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab, size=(B, 1)).astype(np.int32)
    pos = np.array([3, 40], np.int32)
    r_decode = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, cfg))
    for _ in range(3):
        logits, cache = M.decode_step(params, cache, torch.from_numpy(
            tokens), torch.from_numpy(pos), cfg)
        r_logits, r_cache = r_decode(ref_params, r_cache,
                                     jnp.asarray(tokens), jnp.asarray(pos))
        _close(logits, r_logits)
        for j, slot in cache["stack"].items():
            for k, leaf in slot.items():
                _close(leaf, r_cache["stack"][j][k])
        tokens = np.asarray(r_logits).argmax(-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0], np.int32)


def test_every_layer_kind_resolves_and_an_unknown_kind_raises():
    cfg = get_config("recurrentgemma-9b").reduced()
    for kind in ("global", "local", "mamba", "rglru"):
        M._require_ported(kind, cfg)
        assert M._layer_shapes(kind, cfg)
    assert set(M.KINDS) == {"global", "local", "mamba", "rglru"}
    with pytest.raises(ValueError, match="nope"):
        M._require_ported("nope", cfg)
    with pytest.raises(ValueError, match="nope"):
        M.apply_layer("nope", {}, torch.zeros(1, 2, cfg.d_model), cfg, None)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma2-27b"])
def test_init_params_and_cache_shapes(arch):
    """The reference's shapes and dtypes, in float32 and in bf16 (Λ float32
    there too), and its cache: a ring of min(S_ctx, window) slots for local
    layers, the state and conv tail for RG-LRU layers."""
    base = get_config(arch).reduced()
    for cfg in (base, dataclasses.replace(base, dtype="bfloat16")):
        ref = jax.eval_shape(lambda: RM.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=CPU)
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            params) == \
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
        for s_ctx in (16, 100):
            cache = M.init_cache(cfg, 3, s_ctx, device=CPU)
            r_cache = jax.eval_shape(lambda: RM.init_cache(cfg, 3, s_ctx))
            assert jax.tree.map(lambda t: (tuple(t.shape),
                                           str(t.dtype)[6:]), cache) == \
                jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                             r_cache)
