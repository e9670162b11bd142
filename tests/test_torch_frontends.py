"""The vision and audio frontends (qwen2-vl-72b: patch embeddings and M-RoPE;
hubert-xlarge: precomputed frames, bidirectional attention) against the
reference's, on the CPU at reduced float32 size.

Weights come from the reference's ``init_params`` with ``PRNGKey(0)``,
converted by ``params_from_numpy``; batches from the reference's
``synthetic_batch``, with qwen2-vl's three position streams replaced by
three *different* ones (``repro_torch.data.mrope_positions``: equal streams
make M-RoPE plain RoPE and would hide every section bug). Tolerances are
those of ``test_torch_train.py``: the loss within rtol 1e-5; each gradient
leaf within 1e-4 of that leaf's largest magnitude, plus 1e-6; logits within
rtol/atol 1e-5 (``TOL``, ``test_torch_model.py``); M-RoPE within float32
rounding of the reference (``ROPE_TOL``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import mrope_positions  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train.train_step import (TrainState,  # noqa: E402
                                          build_train_step)
from repro_torch.tree import flatten_with_path  # noqa: E402

VLM, AUDIO = "qwen2-vl-72b", "hubert-xlarge"
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TOL = dict(rtol=1e-5, atol=1e-5)
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
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
    rcfg = ref_config(arch).reduced()
    init = jax.jit(RM.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(rcfg, jax.random.PRNGKey(0)))


def frontend_batch(rcfg, step=0, batch=BATCH, seq=SEQ):
    """The reference's synthetic batch, with distinct M-RoPE streams for a
    vision model."""
    b = synthetic_batch(rcfg, step=step, batch=batch, seq=seq)
    if rcfg.frontend == "vision_patches":
        b["positions"] = mrope_positions(step, batch, seq, seq // 4)
        assert not (b["positions"][0] == b["positions"][1]).all()
    return b


def _setup(arch, **kw):
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    return cfg, rcfg, _ref_tree(arch), frontend_batch(rcfg, **kw)


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_mrope_positions_are_three_streams():
    p = mrope_positions(0, 2, 16, 4)
    assert p.shape == (3, 2, 16)
    assert (p[0, :, :4] == p[0, :, :1]).all()            # t constant
    assert (p[1, 0, :4] - p[1, 0, 0]).tolist() == [0, 0, 1, 1]
    assert (p[2, 0, :4] - p[2, 0, 0]).tolist() == [0, 1, 0, 1]
    assert (p[0, :, 4:] == p[1, :, 4:]).all() and (p[1, :, 4:] ==
                                                   p[2, :, 4:]).all()


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 16), ((16, 24, 24), 128)])
def test_apply_rope_with_three_streams_matches_the_reference(sections, hd):
    """(4, 6, 6) at hd 16 is the reduced config's: the sections overrun
    hd/2 = 8 and are clipped alike; (16, 24, 24) at hd 128 is qwen2-vl's
    full width, which fills hd/2 = 64 exactly."""
    B, S, H = 2, 12, 3
    x = np.random.default_rng(1).normal(size=(B, S, H, hd)).astype(np.float32)
    pos = mrope_positions(2, B, S, 6) * 37          # far-apart angles
    theta = 1_000_000.0
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    out = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                       sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ROPE_TOL)
    plain = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), theta)
    assert not torch.allclose(out, plain)


def test_reduced_sections_clip_to_the_head():
    """At (4, 6, 6) and hd 16, stream 0 rotates half-dim columns 0-3,
    stream 1 columns 4-7, and stream 2 none, as the reference's slices
    clip: moving stream 2 changes nothing, moving stream 1 changes only
    its columns (in both halves)."""
    B, S, H, hd = 1, 5, 2, 16
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, S, H, hd)).astype(np.float32))
    pos = torch.from_numpy(mrope_positions(4, B, S, 4).astype(np.int64))
    base = L.apply_rope(x, pos, 10000.0, (4, 6, 6))
    moved = pos.clone()
    moved[2] += 11
    assert torch.equal(L.apply_rope(x, moved, 10000.0, (4, 6, 6)), base)
    moved = pos.clone()
    moved[1] += 11
    diff = (L.apply_rope(x, moved, 10000.0, (4, 6, 6)) != base).any(
        dim=(0, 1, 2))
    cols = [c for c in range(hd) if diff[c]]
    assert cols == [4, 5, 6, 7, 12, 13, 14, 15]


def test_apply_rope_refuses_two_dimensional_positions_with_sections():
    x = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        L.apply_rope(x, torch.zeros((1, 4)), 10000.0, (4, 6, 6))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_loss_and_grads_match_the_reference(arch):
    """The logits, the loss and every gradient leaf.  hubert's ``embed`` is
    a dead leaf (frames go in, not tokens): its gradient is zero in both,
    where the port's autograd gives none."""
    cfg, rcfg, tree, batch = _setup(arch)
    rparams = jax.tree.map(jnp.asarray, tree)
    r_logits, _, _ = jax.jit(functools.partial(RM.forward, cfg=rcfg))(
        rparams, _jax(batch))
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        functools.partial(RM.loss_fn, cfg=rcfg), has_aux=True))(
        rparams, _jax(batch))
    params = M.params_from_numpy(cfg, tree, device=CPU)
    leaves = flatten_with_path(params)
    for p in leaves.values():
        p.requires_grad_(True)
    logits, _, _ = M.forward(params, _port(batch), cfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(r_logits),
                               **TOL)
    loss, m = M.loss_fn(params, _port(batch), cfg)
    for k in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(m[k].item(), float(r_m[k]), **LOSS_TOL,
                                   err_msg=k)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    r_flat = {k: np.asarray(v) for k, v in
              flatten_with_path(jax.tree.map(np.asarray, r_grads)).items()}
    assert list(r_flat) == list(leaves)
    for k, g in zip(leaves, grads):
        r = r_flat[k]
        if g is None:
            assert arch == AUDIO and k == "embed" and not r.any(), k
            continue
        assert g.shape == r.shape, k
        bound = GRAD_RTOL * float(np.abs(r).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - r).max())
        assert err <= bound, (k, err, bound)


def test_vision_spans_take_the_unscaled_patch_embeddings():
    """Where ``vision_mask`` holds, the stack's input is ``vision_embeds``
    itself; elsewhere the token embedding × sqrt(d_model)."""
    cfg, rcfg, tree, batch = _setup(VLM)
    params = M.params_from_numpy(cfg, tree, device=CPU)
    x, positions = M._embed_inputs(params, _port(batch), cfg)
    mask = torch.from_numpy(batch["vision_mask"])
    assert torch.equal(x[mask], torch.from_numpy(batch["vision_embeds"])[mask])
    scaled = params["embed"][torch.from_numpy(batch["tokens"])] \
        * float(np.float32(np.sqrt(cfg.d_model)))
    assert torch.equal(x[~mask], scaled[~mask])
    assert torch.equal(positions, torch.from_numpy(batch["positions"]))


def test_audio_frames_need_no_tokens():
    """hubert's batch shape comes from ``frames``: a batch without tokens
    runs, at positions arange(S)."""
    cfg, rcfg, tree, batch = _setup(AUDIO)
    params = M.params_from_numpy(cfg, tree, device=CPU)
    frames = {"frames": torch.from_numpy(batch["frames"])}
    x, positions = M._embed_inputs(params, frames, cfg)
    assert torch.equal(x, frames["frames"])
    assert torch.equal(positions[1], torch.arange(SEQ))
    logits, _, _ = M.forward(params, frames, cfg)
    full, _, _ = M.forward(params, _port(batch), cfg)
    assert torch.equal(logits, full)


def test_vlm_prefill_and_decode_match_the_reference():
    """qwen2-vl's prefill over a vision span with distinct streams, then
    two decode steps (one position broadcast to all three streams), into a
    cache longer than the prompt."""
    cfg, rcfg, tree, batch = _setup(VLM)
    S_ctx = SEQ + 4
    rparams = jax.tree.map(jnp.asarray, tree)
    r_last, r_cache = jax.jit(functools.partial(RM.prefill, cfg=rcfg))(
        rparams, _jax(batch))
    params = M.params_from_numpy(cfg, tree, device=CPU)
    last, cache = M.prefill(params, _port(batch), cfg)
    np.testing.assert_allclose(last.numpy(), np.asarray(r_last), **TOL)

    def grow(c, xp):
        pad = [(0, 0)] * c.ndim
        pad[2] = (0, S_ctx - c.shape[2])
        return xp.pad(c, pad) if xp is jnp else torch.nn.functional.pad(
            c, (0, 0, 0, 0, 0, S_ctx - c.shape[2]))

    r_cache = jax.tree.map(lambda c: grow(c, jnp), r_cache)
    cache = {"stack": {j: {k: grow(v, torch) for k, v in s.items()}
                       for j, s in cache["stack"].items()}, "tail": []}
    r_dec = jax.jit(functools.partial(RM.decode_step, cfg=rcfg))
    tok = np.random.default_rng(5).integers(1, cfg.vocab, size=(BATCH, 1))
    for pos in (SEQ, SEQ + 1):
        r_logits, r_cache = r_dec(rparams, r_cache, jnp.asarray(tok),
                                  jnp.int32(pos))
        logits, cache = M.decode_step(params, cache, torch.from_numpy(tok),
                                      pos, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   **TOL)
        tok = np.asarray(r_logits).argmax(-1)[:, None]
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["stack"]["slot0"][k].numpy(),
                                   np.asarray(r_cache["stack"]["slot0"][k]),
                                   **TOL)


def test_audio_embedding_trains_with_a_zero_gradient():
    """A hubert train step: ``embed``'s gradient is zeros (filled where
    autograd gives none), so AdamW moves it by weight decay alone and its
    moments stay zero; every other leaf's first moment moves."""
    cfg, rcfg, tree, batch = _setup(AUDIO)
    opt = AdamW()
    params = M.params_from_numpy(cfg, tree, device=CPU)
    state, m = build_train_step(cfg, opt)(TrainState(params,
                                                     opt.init(params)),
                                          _port(batch))
    assert np.isfinite(m["loss"].item())
    moments = flatten_with_path(state.opt.m)
    assert not moments.pop("embed").any()
    assert all(v.any() for v in moments.values())
    decay = 1 - opt.lr * opt.weight_decay
    np.testing.assert_allclose(state.params["embed"].numpy(),
                               tree["embed"] * decay, rtol=1e-6)


def test_audio_encoder_attends_both_ways_in_chunks():
    """S > 2·Q_CHUNK takes the chunked path, here non-causal: the forward
    equals the reference's (which chunks alike), and the first frame's
    output depends on the last frame."""
    cfg, rcfg, tree, _ = _setup(AUDIO)
    S = 2 * L.Q_CHUNK + 52
    batch = synthetic_batch(rcfg, step=0, batch=1, seq=S)
    frames = {"frames": batch["frames"]}
    r_logits, _, _ = jax.jit(functools.partial(RM.forward, cfg=rcfg))(
        jax.tree.map(jnp.asarray, tree), _jax(frames))
    params = M.params_from_numpy(cfg, tree, device=CPU)
    with torch.no_grad():
        logits, _, _ = M.forward(params, _port(frames), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   **TOL)
        moved = torch.from_numpy(frames["frames"]).clone()
        moved[0, -1] += 1.0
        first, _, _ = M.forward(params, {"frames": moved}, cfg)
    assert not torch.equal(first[0, 0], logits[0, 0])
