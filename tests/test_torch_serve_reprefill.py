"""chip_smoke's checks of a full-width serve, on the CPU at reduced size:
the re-prefill rule and its rolled-cache control (``reprefill_rule``), the
partings of two runs' token streams (``parting_rule``); and the prefill's
float32 copies: the softcap, the score scale and the softmax of a fresh
tensor are computed in place outside autograd, so that a serve's prefill
holds one float32 copy of its logits and scores, as the reference's fused
elementwise ops do, with the same bits.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ticket_dispatch import plan as plan_kernel  # noqa: E402,E501
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-7b"])
def test_reprefill_rule_passes_the_engine_and_its_control_departs(arch):
    """The engine's decode rows within 1e-5 of a fresh prefill at the first,
    the window-crossing (gemma3: 21 + 12 and 16 + 17 reach the reduced
    window of 32) and the last step, a prompt past the window included;
    the rolled-cache control departs from it on every row by far more than
    that."""
    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist()
               for n in (21, 16, 48)]
    run = cs.timed_serve(ServeEngine, cfg, params, CPU, prompts,
                         cs.SERVE_NEW, plan_kernel, max_ctx=96, lanes=2,
                         keep=range(3))
    cs.check_served(run, cfg, 3)
    out = cs.reprefill_rule(M, cfg, params, run, range(3), CPU, 96)
    steps = [(r["request"], r["step"]) for r in out["rows"]]
    crossing = [(0, 12), (1, 17)] if "local" in cfg.layer_pattern else []
    assert steps == sorted([(0, 1), (0, 31), (1, 1), (1, 31), (2, 1),
                            (2, 31)] + crossing)
    assert out["max_abs_diff"] <= 1e-5
    assert all(r["keys_roll_max_abs_diff"] > 1e-4 for r in out["rows"])
    assert out["tokens_equal"] == len(out["rows"])


def test_reprefill_rule_fails_a_misplaced_cache():
    """The rule raises when the engine's rows are the control's."""
    cs = _chip_smoke()
    cfg = get_config("gemma3-1b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    prompt = np.random.default_rng(1).integers(1, cfg.vocab, 16).tolist()
    run = cs.timed_serve(ServeEngine, cfg, params, CPU, [prompt],
                         cs.SERVE_NEW, plan_kernel, max_ctx=64, lanes=2,
                         keep=[0])
    req = run["reqs"][0]
    for step in cs.reprefill_steps(cfg, 16):
        run["rows"][0][step] = cs.outside_decodes(
            M, cfg, params, prompt + req.tokens_out[:step], CPU, 64)["keys"]
    with pytest.raises(AssertionError):
        cs.reprefill_rule(M, cfg, params, run, [0], CPU, 64)


def test_reprefill_steps_take_the_window_crossing():
    cs = _chip_smoke()
    local = SimpleNamespace(window=512, layer_pattern=("local", "global"))
    dense = SimpleNamespace(window=512, layer_pattern=("global",))
    assert cs.reprefill_steps(local, 496) == [1, 17, cs.SERVE_NEW - 1]
    assert cs.reprefill_steps(local, 1024) == [1, cs.SERVE_NEW - 1]
    assert cs.reprefill_steps(dense, 496) == [1, cs.SERVE_NEW - 1]


def _run(streams, rows):
    reqs = [SimpleNamespace(rid=i, tokens_out=s) for i, s in
            enumerate(streams)]
    return {"reqs": reqs, "rows": dict(enumerate(rows))}


def test_parting_rule_finds_the_first_parting_step():
    cs = _chip_smoke()
    base = torch.tensor([[0.0, 5.0, 1.0], [0.0, 1.0, 4.0]])
    tie = torch.tensor([[0.0, 5.0, 1.0], [0.0, 3.0, 3.05]])
    near = tie + torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.1, 0.0]])
    a = _run([[1, 2], [1, 2]], [list(base), list(tie)])
    b = _run([[1, 2], [1, 1]], [list(base), list(near)])
    out = cs.parting_rule(a, b)
    assert out["streams_parted"] == 1
    (p,) = out["partings"]
    assert p["request"] == 1 and p["step"] == 1 and p["explained"]
    assert p["max_abs_diff"] == pytest.approx(0.1)
    assert out["first_logit_max_abs_diff"] == 0.0


def test_softcap_in_place_has_the_same_bits_and_spares_autograd():
    x = torch.randn(4, 300, generator=torch.Generator().manual_seed(0)) * 80
    want = 30.0 * torch.tanh(x / 30.0)
    y = x.clone()
    out = L.softcap(y, 30.0, in_place=True)
    assert out.data_ptr() == y.data_ptr() and torch.equal(out, want)
    leaf = x.clone().requires_grad_(True)
    out = L.softcap(leaf, 30.0, in_place=True)
    assert out.data_ptr() != leaf.data_ptr() and torch.equal(out, want)
    out.sum().backward()
    torch.testing.assert_close(leaf.grad, 1 - torch.tanh(x / 30.0) ** 2)


def test_masked_softmax_in_place_has_the_same_bits():
    g = torch.Generator().manual_seed(1)
    scores = torch.randn(2, 3, 5, 40, generator=g)
    mask = torch.rand(1, 1, 5, 40, generator=g) > 0.3
    for dtype in (torch.float32, torch.bfloat16):
        want = L._masked_softmax(scores.clone(), mask, dtype)
        s = scores.clone()
        probs = L._masked_softmax(s, mask, dtype, in_place=True)
        assert torch.equal(probs, want)
        if dtype == torch.float32:
            assert probs.data_ptr() == s.data_ptr()


class _Allocations(TorchDispatchMode):
    """The names of the ops that return a new float32 tensor of ``numel``
    elements (in-place ops and views return no new storage)."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.ops = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if (isinstance(out, torch.Tensor) and out.dtype == torch.float32
                and out.numel() == self.numel and not schema.is_mutable
                and not any(a.alias_info for a in schema.returns)):
            self.ops.append(func.__name__)
        return out


def test_softcapped_prefill_makes_one_float32_logits_tensor():
    """gemma2's final softcap: the logits' product is the only float32
    (B, S, V) tensor a prefill makes (cap · tanh(x / cap) out of place made
    three more)."""
    cfg = get_config("gemma2-27b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(1, 40)))
    want, _, _ = M.forward(params, {"tokens": tokens}, cfg)
    with _Allocations(40 * cfg.padded_vocab) as seen:
        logits, _, _ = M.forward(params, {"tokens": tokens}, cfg,
                                 collect_cache=True)
    assert len(seen.ops) == 1, seen.ops
    assert torch.equal(logits, want)
    with torch.enable_grad():
        params["final_norm"].requires_grad_(True)
        with _Allocations(40 * cfg.padded_vocab) as seen:
            M.forward(params, {"tokens": tokens}, cfg)
    # under autograd: the product and the softcap's output, which its
    # backward keeps (layers._Softcap; tanh's own op kept a third)
    assert seen.ops == ["bmm.default", "div.Tensor"], seen.ops


def test_init_params_scales_each_draw():
    cfg = get_config("gemma3-1b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device=CPU)
    g = torch.Generator().manual_seed(3)
    embed = torch.randn(params["embed"].shape, generator=g,
                        dtype=torch.float32)
    assert torch.equal(params["embed"], (embed * 0.02).to(torch.float32))
