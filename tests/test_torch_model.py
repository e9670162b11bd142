"""The port's layers and decoder against the reference's, on the same
numpy-seeded inputs and the same weights (the reference's ``init_params``
with ``PRNGKey(0)``, converted by ``params_from_numpy``).

Everything runs in float32 on the CPU.  Tolerance: rtol 1e-5 and atol 1e-5
(``TOL``): the two frameworks sum in other orders, which moves float32
results by a few ulp per reduction; nothing else may differ.  Integer
results (MoE slots, caches written at positions) must be equal.
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
from repro_torch.kernels.ticket_dispatch import assign_slots
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
ARCHS = ("granite-moe-1b-a400m", "deepseek-7b")
MODEL_ARCHS = ARCHS + ("falcon-mamba-7b",)


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
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _params(cfg, seed):
    """One attention layer's weights, as numpy, in the reference's layout."""
    shapes = M._attn_layer_shapes(cfg)
    return {k: (_rand(seed + i, *s, scale=0.2) if init == "normal"
                else _rand(seed + i, *s, scale=0.1))
            for i, (k, (s, init)) in enumerate(shapes.items())}


def test_configs_are_the_reference_configs():
    for name in ARCHS + ("falcon-mamba-7b", "recurrentgemma-9b"):
        port, ref = get_config(name), ref_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert port.param_count() == ref.param_count()
    assert get_config("granite-moe-1b-a400m").padded_vocab == 49408


def test_rms_norm_and_rope():
    x = _rand(0, 2, 5, 3, 16)
    scale = _rand(1, 16, scale=0.1)
    _close(L.rms_norm(_t(scale), _t(x), 1e-6),
           RL.rms_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6))
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 100, 511, 2048]], np.int32)
    _close(L.apply_rope(_t(x), torch.from_numpy(pos), 10000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    _close(L.softcap(_t(x), 5.0), RL.softcap(jnp.asarray(x), 5.0))


@pytest.mark.parametrize("S", [7, 2 * L.Q_CHUNK + 52])
def test_attention_full_short_and_chunked(S):
    """S > 2·Q_CHUNK takes the chunked-query path in both packages."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = _params(cfg, 10)
    x = _rand(2, 1, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    out, (k, v) = L.attention_full({n: _t(a) for n, a in p.items()}, _t(x),
                                   cfg, torch.from_numpy(pos.copy()))
    r_out, (r_k, r_v) = RL.attention_full(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), cfg,
        jnp.asarray(pos))
    _close(out, r_out)
    _close(k, r_k)
    _close(v, r_v)


def test_attention_decode_with_per_lane_positions():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = _params(cfg, 20)
    B, S_ctx = 3, 16
    x = _rand(3, B, 1, cfg.d_model)
    ck = _rand(4, B, S_ctx, cfg.n_kv_heads, cfg.head_dim)
    cv = _rand(5, B, S_ctx, cfg.n_kv_heads, cfg.head_dim)
    pos = np.array([0, 5, S_ctx - 1], np.int32)
    r_out, r_k, r_v = RL.attention_decode(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), cfg)
    k_t, v_t = _t(ck), _t(cv)
    out, k2, v2 = L.attention_decode({n: _t(a) for n, a in p.items()},
                                     _t(x), k_t, v_t,
                                     torch.from_numpy(pos), cfg)
    assert k2 is k_t and v2 is v_t        # written in place
    _close(out, r_out)
    _close(k2, r_k)
    _close(v2, r_v)
    # one scalar position for every lane
    r_out, _, _ = RL.attention_decode(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), 6, cfg)
    out, _, _ = L.attention_decode({n: _t(a) for n, a in p.items()}, _t(x),
                                   _t(ck), _t(cv), 6, cfg)
    _close(out, r_out)


def test_mlp():
    cfg = get_config("deepseek-7b").reduced()
    p = {"wi": _rand(6, cfg.d_model, cfg.d_ff, scale=0.2),
         "wg": _rand(7, cfg.d_model, cfg.d_ff, scale=0.2),
         "wo": _rand(8, cfg.d_ff, cfg.d_model, scale=0.2)}
    x = _rand(9, 2, 5, cfg.d_model)
    _close(L.mlp({k: _t(v) for k, v in p.items()}, _t(x), cfg),
           RL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  cfg))


@pytest.mark.parametrize("B,S,capacity_factor", [
    (2, 16, 1.25), (8, 1, 1.25), (2, 16, 0.25), (24, 1, 0.25)])
def test_moe_matches_and_drops_fifo(B, S, capacity_factor):
    """Prefill groups (one per sequence) and the decode group (S == 1: one
    group over all lanes); capacity factor 0.25 drops pairs."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              capacity_factor=capacity_factor)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": _rand(11, d, E), "wi": _rand(12, E, d, ff, scale=0.2),
         "wg": _rand(13, E, d, ff, scale=0.2),
         "wo": _rand(14, E, ff, d, scale=0.2)}
    x = _rand(15, B, S, d)
    pt = {k: _t(v) for k, v in p.items()}
    y, aux = L.moe(pt, _t(x), cfg)
    y_plain, aux_plain = L.moe(pt, _t(x), cfg, dispatch="torch")
    assert torch.equal(y, y_plain) and torch.equal(aux, aux_plain)
    for use_pallas in (False, True):
        r_y, r_aux = RL.moe({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), cfg, use_pallas=use_pallas)
        _close(y, r_y)
        _close(aux, r_aux)
    G = B if S > 1 else 1
    N = B * S // G
    _, _, top_ids = L.moe_route(pt, _t(x).reshape(G, N, d), cfg)
    _, slots = assign_slots(top_ids, E, L.moe_capacity(cfg, N), grouped=True)
    kept = int((slots >= 0).sum())
    if capacity_factor < 1:
        assert kept < G * N * cfg.top_k
    else:
        assert kept == G * N * cfg.top_k


def test_top_k_breaks_ties_to_the_lower_index():
    """``lax.top_k`` order; many equal gates, as bf16 router logits give."""
    g = np.array([[0.1, 0.3, 0.3, 0.1, 0.3, 0.0, 0.3, 0.1]], np.float32)
    vals, idx = L.top_k_stable(torch.from_numpy(g), 5)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(g), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def model_pair(request):
    cfg = get_config(request.param).reduced()
    ref_params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    return cfg, ref_params, M.params_from_numpy(cfg, tree, device=CPU)


def test_forward_and_prefill(model_pair):
    cfg, ref_params, params = model_pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 12)).astype(np.int32)
    logits, aux, cache = M.forward(params, {"tokens": torch.from_numpy(
        tokens)}, cfg, collect_cache=True)
    r_logits, r_aux, r_cache = RM.forward(
        ref_params, {"tokens": jnp.asarray(tokens)}, cfg, collect_cache=True)
    assert logits.shape == (2, 12, cfg.padded_vocab)
    _close(logits, r_logits)
    _close(aux, r_aux)
    assert bool((logits[..., cfg.vocab:] == -1e30).all())
    assert cache["stack"].keys() == r_cache["stack"].keys()
    for j, slot in cache["stack"].items():
        assert slot.keys() == r_cache["stack"][j].keys()
        for k, leaf in slot.items():
            _close(leaf, r_cache["stack"][j][k])
    last, _ = M.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    r_last, _ = RM.prefill(ref_params, {"tokens": jnp.asarray(tokens)}, cfg)
    _close(last, r_last)


def test_decode_steps_match(model_pair):
    """Decode three tokens into a zero cache with per-lane positions, lane
    1 idle at its last position (a Mamba lane advances its state all the
    same, as in the reference)."""
    cfg, ref_params, params = model_pair
    B, S_ctx = 2, 32
    cache = M.init_cache(cfg, B, S_ctx, device=CPU)
    r_cache = RM.init_cache(cfg, B, S_ctx)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, r_cache)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jax.tree.map(
            lambda t: t.numpy(), cache)))
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab, size=(B, 1)).astype(np.int32)
    pos = np.array([3, 9], np.int32)
    for _ in range(3):
        logits, cache = M.decode_step(params, cache, torch.from_numpy(
            tokens), torch.from_numpy(pos), cfg)
        r_logits, r_cache = RM.decode_step(ref_params, r_cache,
                                           jnp.asarray(tokens),
                                           jnp.asarray(pos), cfg)
        _close(logits, r_logits)
        for j, slot in cache["stack"].items():
            for k, leaf in slot.items():
                _close(leaf, r_cache["stack"][j][k])
        tokens = np.asarray(r_logits).argmax(-1).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0], np.int32)


def test_params_from_numpy_checks_shapes(model_pair):
    cfg, ref_params, _ = model_pair
    tree = jax.tree.map(np.asarray, ref_params)
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        M.params_from_numpy(cfg, tree, device=CPU)


def test_init_params_shapes_and_device_rules(monkeypatch):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen, device=CPU)
    ref = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    port_shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert port_shapes == ref_shapes
    w = params["stack"]["slot0"]["wi"]
    assert w.dtype == torch.float32 and abs(float(w.std()) - 0.02) < 2e-3
    assert float(params["final_norm"].abs().sum()) == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 2, 16)


def test_kernel_bounds_of_the_mamba_and_rglru_scans(capsys):
    """``repro_torch.bench.kernel_bounds`` counts each input and output
    once at the serve traffic's prompts (256 tokens, and the Griffin
    serve's 2,600); a prefill starts from a zero state, so neither kernel
    reads an h0."""
    from repro_torch.bench import kernel_bounds

    mamba, rglru, rglru_long = kernel_bounds.main()
    D, N, L = 8192, 16, kernel_bounds.PROMPT
    assert mamba["bytes"] == 2 * (3 * L * D + 2 * D * N + 2 * L * N + D)
    assert rglru["bytes"] == 2 * (3 * L * 4096 + 4096)
    assert rglru_long["bytes"] == 2 * (3 * 2600 * 4096 + 4096)
    for row in (mamba, rglru, rglru_long):
        assert row["bound_by"] == "bytes"
        assert row["bound_ms"] == row["bytes"] / 3.35e12 * 1e3
    assert abs(rglru["bound_ms"] - 0.0019) < 1e-4
    assert abs(rglru_long["bound_ms"] - 0.019) < 1e-3
    assert len(capsys.readouterr().out.splitlines()) == 3


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def _mamba_params(cfg, seed):
    """One Mamba layer's weights, as numpy: the reference's constant inits
    (A_log = log(1..N), D_skip ones, dt_bias -4.6, zeros) plus noise, and
    normals for the projections."""
    base = {"zeros": 0.0, "ones": 1.0, "dt_bias": -4.6}
    out = {}
    for i, (k, (s, init)) in enumerate(M._mamba_layer_shapes(cfg).items()):
        noise = _rand(seed + i, *s, scale=0.2 if init == "normal" else 0.1)
        if init == "a_log":
            noise += np.log(np.arange(1, s[-1] + 1, dtype=np.float32))
        out[k] = noise + base.get(init, 0.0)
    return out


@pytest.mark.parametrize("S", [1, 2, 40])
def test_mamba_block_and_decode(S):
    """Prompts shorter than the conv's kw-1 = 3 leave zeros in its tail."""
    cfg = get_config("falcon-mamba-7b").reduced()
    p = _mamba_params(cfg, 30)
    pt = {k: _t(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    x = _rand(31, 2, S, cfg.d_model)
    out, (ssm, conv) = L.mamba_block(pt, _t(x), cfg)
    r_out, (r_ssm, r_conv) = RL.mamba_block(pj, jnp.asarray(x), cfg)
    assert ssm.shape == (2, cfg.d_inner, cfg.ssm_state)
    assert conv.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    _close(out, r_out)
    _close(ssm, r_ssm)
    _close(conv, r_conv)
    if S < cfg.ssm_conv - 1:
        assert float(conv[:, :cfg.ssm_conv - 1 - S].abs().max()) == 0.0
    plain, _ = L.mamba_block(pt, _t(x), cfg, scan="torch")
    assert torch.equal(plain, out)
    # two decode steps from the prefill's states
    tok = _rand(32, 2, 1, cfg.d_model)
    for _ in range(2):
        out, ssm, conv = L.mamba_decode(pt, _t(tok), ssm, conv, cfg)
        r_out, r_ssm, r_conv = RL.mamba_decode(pj, jnp.asarray(tok), r_ssm,
                                               r_conv, cfg)
        _close(out, r_out)
        _close(ssm, r_ssm)
        _close(conv, r_conv)
        tok = np.array(r_out)


def test_softplus_is_logaddexp_beyond_20():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0], np.float32)
    _close(L.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)))


def test_mamba_init_params_and_cache_shapes():
    """The reference's shapes and constant inits (A_log float32 in a bf16
    model), and the SSM/conv cache the reference's ``init_cache`` builds."""
    for cfg in (get_config("falcon-mamba-7b").reduced(),
                dataclasses.replace(get_config("falcon-mamba-7b"),
                                    n_layers=1, vocab=512)):
        ref = jax.eval_shape(lambda: RM.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=CPU)
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            params) == \
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
        layer = params["stack"]["slot0"]
        n = torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32)
        assert torch.equal(layer["A_log"][0, 5], torch.log(n))
        assert float(layer["D_skip"].float().min()) == 1.0 == \
            float(layer["D_skip"].float().max())
        assert torch.equal(layer["dt_bias"], torch.full_like(
            layer["dt_bias"], -4.6))
        assert float(layer["conv_b"].abs().max()) == 0.0
        cache = M.init_cache(cfg, 3, 64, device=CPU)
        r_cache = jax.eval_shape(lambda: RM.init_cache(cfg, 3, 64))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            cache) == \
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), r_cache)
