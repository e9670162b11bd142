"""AdamW's update of a large leaf, slice by slice (``optim.adamw
.UPDATE_CHUNK`` elements at a time), against the whole-leaf update: the
same bits, and no float32 temporary larger than a slice.  A whole-leaf
update holds four float32 copies of the leaf beside the old and new state
(gemma2-27b's tied embedding: 4.7 GB each), which the reference's jitted
update, a fused loop a leaf, does not.  Temporaries are seen by a
``TorchDispatchMode`` that records the size of every op's float32 output
after the gradient norm (whose reduction squares one leaf at a time
before any new state exists, so it does not add to the update's peak)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CHUNK = 1000


class _Float32Outputs(TorchDispatchMode):
    """The largest float32 tensor any op but ``empty`` (the update's new
    leaves) allocates once ``armed`` (views and in-place results, whose
    storage is an input's, allocate nothing)."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self.armed = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.armed and func not in (torch.ops.aten.empty.memory_format,
                                       torch.ops.aten.empty_like.default):
            inputs = {t.untyped_storage().data_ptr() for t in
                      (*args, *(kwargs or {}).values())
                      if isinstance(t, torch.Tensor)}
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                        and t.untyped_storage().data_ptr() not in inputs):
                    self.largest = max(self.largest, t.numel())
        return out


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"big": torch.from_numpy(rng.normal(size=(7, 1501)).astype(
        np.float32)).to(dtype),
        "small": torch.from_numpy(rng.normal(size=(33,)).astype(
            np.float32)).to(dtype)}


def _steps(opt, chunk, monkeypatch, n_steps=2):
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
    params = _tree(0, torch.bfloat16)
    state = opt.init(params)
    for s in range(n_steps):
        params, state, _ = opt.update(_tree(s + 1, torch.bfloat16), state,
                                      params)
    return params, state


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sliced_update_equals_the_whole_leaf(moments, monkeypatch):
    opt = AdamW(moment_dtype=moments)
    whole = _steps(opt, 1 << 40, monkeypatch)
    sliced = _steps(opt, CHUNK, monkeypatch)
    for a, b in ((whole[0], sliced[0]), (whole[1].m, sliced[1].m),
                 (whole[1].v, sliced[1].v)):
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert torch.equal(a[k], b[k]), k


def test_no_float32_temporary_larger_than_a_slice(monkeypatch):
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", CHUNK)
    opt = AdamW()
    params = _tree(0, torch.bfloat16)
    state = opt.init(params)
    grads = _tree(1, torch.bfloat16)
    seen = _Float32Outputs()
    norm = adamw.global_norm

    def norm_then_arm(tree):
        out = norm(tree)
        seen.armed = True
        return out

    monkeypatch.setattr(adamw, "global_norm", norm_then_arm)
    with seen:
        opt.update(grads, state, params)
    assert params["big"].numel() > CHUNK
    assert 0 < seen.largest <= CHUNK, seen.largest
