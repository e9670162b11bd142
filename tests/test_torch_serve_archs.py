"""The port's serve path against the reference's on the decoders
``tests/test_torch_serve.py`` does not serve: gemma2-27b (local and global
attention, softcaps), grok-1-314b (E 8, top-2) and mistral-large-123b
(GQA 4 on 2 at reduced width), and gemma2-27b and gemma3-1b on prompts of
48 and 64 tokens, past the reduced window of 32 (the banded prefill, the
ring reorder, decode in a wrapped ring; multiples of 16, so that no pad
key rings).  qwen2-vl-72b is served by neither package: both read a
``vision_mask`` that a serve's prefill batch does not carry.

Tolerance (``test_torch_serve.py``'s rule): the logits of every sampling
call agree within rtol 1e-5 and atol 1e-5 (float32 on the CPU), and at
every call the top-2 margin of every row that yields a token is above 10×
that; tokens and admission steps must be equal.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve.engine as ref_engine_mod  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402

LOGIT_TOL = 1e-5
CPU = torch.device("cpu")
# prompt lengths past the reduced window, multiples of 16, and one within
LONG = (48, 64, 48, 64, 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_sampling(monkeypatch, module, box, calls):
    """Wrap ``module.sample`` to keep each call's logits and the lanes that
    held a request when it ran (``box[0]`` is the engine)."""
    original = module.sample

    def recording(logits, *args, **kw):
        eng = box[0]
        active = [l for l in range(eng.lanes) if eng.lane_req[l] is not None]
        host = logits.cpu().numpy() if hasattr(logits, "cpu") else logits
        calls.append((np.asarray(host, np.float32), active))
        return original(logits, *args, **kw)

    monkeypatch.setattr(module, "sample", recording)


def _params(arch):
    cfg = get_config(arch).reduced()
    ref_params = ref_init_params(ref_config(arch).reduced(),
                                 jax.random.PRNGKey(0))
    return cfg, ref_params, params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device=CPU)


@pytest.mark.parametrize("arch,lengths", [
    ("gemma2-27b", None), ("grok-1-314b", None),
    ("mistral-large-123b", None), ("gemma2-27b", LONG),
    ("gemma3-1b", LONG)], ids=["gemma2-27b", "grok-1-314b",
                               "mistral-large-123b", "gemma2-27b-long",
                               "gemma3-1b-long"])
def test_greedy_tokens_match_the_reference_engine(arch, lengths,
                                                  monkeypatch):
    cfg, ref_params, params = _params(arch)
    rng = np.random.default_rng(0)
    if lengths is None:
        lengths = [int(rng.integers(3, 21)) for _ in range(5)]
    else:
        assert max(lengths) > cfg.window
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in lengths]
    max_ctx = 96
    runs = {}
    for name, module, make in (
            ("ref", ref_engine_mod,
             lambda: ref_engine_mod.ServeEngine(cfg, ref_params, lanes=2,
                                                max_ctx=max_ctx)),
            ("port", engine_mod,
             lambda: ServeEngine(cfg, params, lanes=2, max_ctx=max_ctx,
                                 device=CPU))):
        box, calls = [None], []
        _record_sampling(monkeypatch, module, box, calls)
        eng = box[0] = make()
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        runs[name] = ([r.tokens_out for r in reqs], calls,
                      [r.admitted_at_step for r in reqs])
    (ref_toks, ref_calls, ref_adm), (toks, calls, adm) = runs["ref"], \
        runs["port"]
    assert len(calls) == len(ref_calls) > 5
    for (lg, active), (r_lg, r_active) in zip(calls, ref_calls):
        assert active == r_active and lg.shape == r_lg.shape
        np.testing.assert_allclose(lg, r_lg, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        rows = [0] if r_lg.shape[0] == 1 else r_active
        for r in rows:
            top2 = np.sort(r_lg[r])[-2:]
            assert top2[1] - top2[0] > 10 * LOGIT_TOL, (r, top2)
    assert toks == ref_toks
    assert adm == ref_adm


def test_qwen2_vl_is_served_by_neither_package():
    """A serve's prefill batch holds only ``tokens``, and both packages'
    ``_embed_inputs`` read ``batch["vision_mask"]`` for a vision model."""
    cfg, ref_params, params = _params("qwen2-vl-72b")
    prompt = list(range(1, 9))
    for eng in (ref_engine_mod.ServeEngine(cfg, ref_params, lanes=2,
                                           max_ctx=32),
                ServeEngine(cfg, params, lanes=2, max_ctx=32, device=CPU)):
        eng.submit(prompt, max_new_tokens=2)
        with pytest.raises(KeyError, match="vision_mask"):
            eng.run()
