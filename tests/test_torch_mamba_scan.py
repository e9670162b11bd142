"""The port's Mamba-1 selective scan against the reference's, on the same
numpy-seeded inputs: ``selective_scan_ref``, ``selective_scan_chunked`` and
the public op of ``repro_torch`` against ``selective_scan_ref``,
``selective_scan_chunked`` and ``selective_scan`` of ``repro``.  The
reference's Pallas kernel does not trace on this JAX (``pl.load`` is gone),
so the plain versions are the reference here; the CUDA kernel needs a card
and is held to the plain version in ``tests/test_torch_cuda.py``.

Tolerance: float32 within rtol = atol = 1e-5 (``TOL``, the reference's own
for its kernel); bf16 within 5e-2, the port's bf16 loop against the
reference's bf16 loop (both keep h in bf16 and round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.mamba_scan import ops as ref_ops
from repro.kernels.mamba_scan.ref import selective_scan_chunked as R_chunked
from repro.kernels.mamba_scan.ref import selective_scan_ref as R_ref
from repro_torch.kernels.mamba_scan import (MODES, kernel, ops,
                                            selective_scan,
                                            selective_scan_chunked,
                                            selective_scan_ref)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# tests/test_kernels.py's shapes: L, D, N, the Pallas kernel's l_chunk, dtype
SHAPES = [(16, 8, 4, 8, "float32"), (100, 96, 16, 32, "float32"),
          (256, 128, 16, 64, "float32"), (33, 20, 8, 16, "float32"),
          (64, 64, 16, 32, "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, L, D, N, lead=(), per_seq=False, h0=False):
    """x, dt, A, B, C, D_skip, h0 as float32 numpy arrays, as
    ``tests/test_kernels.py`` draws them; ``lead`` is a batch shape, and
    ``per_seq`` gives A, D_skip and h0 one per sequence."""
    rng = np.random.default_rng(seed)
    own = lead if per_seq else ()
    out = [rng.normal(size=lead + (L, D)),
           rng.uniform(0.01, 0.2, size=lead + (L, D)),
           -rng.uniform(0.5, 2.0, size=own + (D, N)),
           rng.normal(size=lead + (L, N)), rng.normal(size=lead + (L, N)),
           rng.normal(size=own + (D,)),
           rng.normal(size=own + (D, N)) if h0 else None]
    return [None if a is None else a.astype(np.float32) for a in out]


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _divisor(L, most):
    return max(c for c in range(1, most + 1) if L % c == 0)


@pytest.mark.parametrize("L,D,N,l_chunk,dtype", SHAPES)
def test_plain_scans_match_the_reference(L, D, N, l_chunk, dtype):
    a = _inputs(L * 1000 + D, L, D, N)
    if dtype == "bfloat16":
        # both loops in bf16 (state rounded to bf16 each step)
        y, h = selective_scan_ref(*_torch(a, torch.bfloat16))
        r_y, r_h = R_ref(*_jax(a, jnp.bfloat16))
        assert y.dtype == h.dtype == torch.bfloat16
        assert r_y.dtype == r_h.dtype == jnp.bfloat16
        _close(y, r_y, BF16_TOL)
        _close(h, r_h, BF16_TOL)
        # and within the kernel's bf16 tolerance of the float32 loop
        f_y, f_h = R_ref(*_jax(a))
        _close(y, f_y, BF16_TOL)
        _close(h, f_h, BF16_TOL)
        return
    y, h = selective_scan_ref(*_torch(a))
    r_y, r_h = R_ref(*_jax(a))
    _close(y, r_y)
    _close(h, r_h)
    chunk = _divisor(L, l_chunk)
    c_y, c_h = selective_scan_chunked(*_torch(a), chunk=chunk)
    rc_y, rc_h = R_chunked(*_jax(a), chunk=chunk)
    _close(c_y, rc_y)
    _close(c_h, rc_h)
    _close(c_y, r_y)


def test_initial_state_threads_through():
    """Two half-scans, the second from the first's h, equal one scan."""
    x, dt, A, B, C, Dsk, _ = _torch(_inputs(7, 64, 16, 8))
    y_full, h_full = R_ref(*(jnp.asarray(t.numpy())
                             for t in (x, dt, A, B, C, Dsk)))
    for fn in (selective_scan_ref,
               lambda *a, **k: selective_scan_chunked(*a, chunk=8, **k)):
        y_a, h_a = fn(x[:32], dt[:32], A, B[:32], C[:32], Dsk)
        y_b, h_b = fn(x[32:], dt[32:], A, B[32:], C[32:], Dsk, h_a)
        _close(torch.cat([y_a, y_b]), y_full)
        _close(h_b, h_full)


@pytest.mark.parametrize("per_seq,h0", [(False, False), (True, True),
                                        (False, True)])
def test_batch_dimension_is_the_reference_vmap(per_seq, h0):
    a = _inputs(11, 24, 12, 8, lead=(3,), per_seq=per_seq, h0=h0)
    x, dt, A, B, C, Dsk, H0 = a
    in_axes = (0, 0, 0 if per_seq else None, 0, 0, 0 if per_seq else None,
               None if H0 is None else (0 if per_seq else None))
    r_y, r_h = jax.vmap(R_ref, in_axes=in_axes)(*_jax(a))
    for y, h in (selective_scan_ref(*_torch(a)),
                 selective_scan_chunked(*_torch(a), chunk=6)):
        assert y.shape == (3, 24, 12) and h.shape == (3, 12, 8)
        _close(y, r_y)
        _close(h, r_h)


def test_the_chunk_rule_of_the_plain_path(monkeypatch):
    """``$REPRO_SCAN_CHUNK`` picks the chunked scan when it divides L, in
    both packages, and is read at each call."""
    calls = []
    real = ops.selective_scan_chunked

    def spy(*args, **kw):
        calls.append(kw["chunk"])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "selective_scan_chunked", spy)
    for L, chunk, taken in ((48, "16", True), (50, "16", False),
                            (48, "0", False)):
        monkeypatch.setenv("REPRO_SCAN_CHUNK", chunk)
        a = _inputs(L, L, 10, 4)
        calls.clear()
        y, h = selective_scan(*_torch(a), mode="torch")
        assert calls == ([16] if taken else [])
        r_y, r_h = ref_ops.selective_scan(*_jax(a))
        _close(y, r_y)
        _close(h, r_h)


def test_the_wrapper_runs_its_plain_version_on_cpu_tensors():
    a = _torch(_inputs(3, 40, 20, 16, lead=(2,), h0=True))
    before = kernel.launches
    y, h = kernel.selective_scan(*a)
    ry, rh = selective_scan_ref(*a)
    assert kernel.launches == before      # no kernel launched on the CPU
    assert torch.equal(y, ry) and torch.equal(h, rh)
    # the public op: auto on CPU tensors is the plain path, as torch is
    for mode in MODES:
        my, mh = selective_scan(*a, mode=mode)
        assert torch.equal(my, ry) and torch.equal(mh, rh)
    assert kernel.launches == before
    with pytest.raises(ValueError, match="scan mode"):
        selective_scan(*a, mode="pallas")


def test_the_wrapper_checks_its_inputs():
    good = _torch(_inputs(5, 8, 6, 4))

    def call(i, t):
        args = list(good)
        args[i] = t
        return kernel.selective_scan(*args)

    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        call(0, good[0].half())
    with pytest.raises(TypeError, match="A must be"):
        call(2, good[2].double())
    with pytest.raises(ValueError, match="dt has shape"):
        call(1, good[1][:7])
    with pytest.raises(ValueError, match="D_skip has shape"):
        call(5, good[5][None].expand(2, 6).contiguous())
    with pytest.raises(ValueError, match="h0 has shape"):
        call(6, torch.zeros(6, 8))
    with pytest.raises(ValueError, match="contiguous"):
        call(3, good[3].t().contiguous().t())
    with pytest.raises(ValueError, match="state size"):
        kernel.selective_scan(*_torch(_inputs(5, 8, 6, 32))[:6])
    with pytest.raises(ValueError, match="x must be"):
        call(0, good[0][0])
    with pytest.raises(ValueError, match="is on"):
        call(4, good[4].to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.selective_scan(*(None if t is None else t.to("meta")
                                for t in good))
