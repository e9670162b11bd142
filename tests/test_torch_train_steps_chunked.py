"""Three train steps of the port against the reference's, by their losses
(rtol 1e-5), for the Mamba (falcon-mamba-7b) and Griffin
(recurrentgemma-9b) archs at reduced size under ``$REPRO_SCAN_CHUNK``: the
chunked selective scan and RG-LRU scan under autograd, the formulation the
reference's hillclimb trains these archs with.  The check is
``test_torch_train_steps.check_steps``; the variable is set before the
reference's step is traced (it is read at trace time, and ``check_steps``
jits a fresh step each call), and spies on both packages' chunked and
sequential scans show that every scan of both steps took the chunked form.
"""

import pytest

pytest.importorskip("torch")

from repro.kernels.mamba_scan import ops as ref_mamba_ops  # noqa: E402
from repro.kernels.rglru import ops as ref_rglru_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from test_torch_train_steps import SEQ, check_steps  # noqa: E402

# a divisor of SEQ below it: four chunks, so the carry crosses three
# boundaries
CHUNK = 4
SCANS = {"falcon-mamba-7b": "selective_scan", "recurrentgemma-9b": "rglru_scan"}


@pytest.mark.parametrize("arch", sorted(SCANS))
def test_chunked_train_steps_match_the_reference(arch, monkeypatch):
    assert SEQ % CHUNK == 0 and CHUNK < SEQ
    calls = {}

    def spy(package, name, real):
        def counted(*args, **kw):
            calls[package, name] = calls.get((package, name), 0) + 1
            return real(*args, **kw)
        return counted

    scan = SCANS[arch]
    for package, ops in (("port", mamba_ops), ("port", rglru_ops),
                         ("reference", ref_mamba_ops),
                         ("reference", ref_rglru_ops)):
        for form in ("chunked", "ref"):
            name = f"{scan}_{form}"
            if hasattr(ops, name):
                monkeypatch.setattr(ops, name,
                                    spy(package, name, getattr(ops, name)))
    monkeypatch.setenv("REPRO_SCAN_CHUNK", str(CHUNK))
    check_steps(arch, 1)
    # the port scans at every step (eagerly), the reference once, when
    # its jitted step is traced; neither takes the sequential loop
    assert calls.get(("port", f"{scan}_chunked"), 0) > 0, calls
    assert calls.get(("reference", f"{scan}_chunked"), 0) > 0, calls
    assert not any(name.endswith("_ref") for _, name in calls), calls


def _chunked_scan(scan):
    """(function, inputs) of a chunked scan at a small shape: 4 chunks,
    a batch of 3 (so that a time-major step's shape, which leads with
    CHUNK, is told from a chunk's, which leads with the batch)."""
    import torch

    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked
    from repro_torch.kernels.rglru.ref import rglru_scan_chunked

    g = torch.Generator().manual_seed(0)
    Bt, L, D, N = 3, 4 * CHUNK, 8, 4
    if scan == "selective_scan":
        return selective_scan_chunked, (
            torch.randn(Bt, L, D, generator=g),
            torch.rand(Bt, L, D, generator=g), -torch.rand(D, N, generator=g),
            torch.randn(Bt, L, N, generator=g),
            torch.randn(Bt, L, N, generator=g), torch.randn(D, generator=g))
    return rglru_scan_chunked, (torch.rand(Bt, L, D, generator=g),
                                torch.randn(Bt, L, D, generator=g))


@pytest.mark.parametrize("scan", sorted(SCANS.values()))
def test_chunked_backward_stacks_the_steps_once(scan):
    """The chunked scans' backward gathers the per-step gradients of each
    time-major input with one stack, not one zero-filled (Lc, Bt, nc, ...)
    tensor a step (``select_backward``: Lc of them an input, which made
    falcon-mamba-7b's chunked train step several times its forward)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Selects(TorchDispatchMode):
        shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.select_backward:
                self.shapes.append(tuple(out.shape))
            return out

    fn, args = _chunked_scan(scan)
    args = [a.requires_grad_() for a in args]
    y, h = fn(*args, chunk=CHUNK)
    with Selects() as selects:
        (y.square().sum() + h.sum()).backward()
    per_step = [s for s in selects.shapes if s[0] == CHUNK]
    assert not per_step, per_step
    assert all(a.grad is not None and bool(torch.isfinite(a.grad).all())
               for a in args)
