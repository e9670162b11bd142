"""The port's RG-LRU scan against the reference's, on the same
numpy-seeded inputs: ``rglru_scan_ref``, ``rglru_scan_chunked``, the gates
and the public op of ``repro_torch`` against ``rglru_scan_ref``,
``rglru_scan_chunked``, ``rglru_gates_ref`` and ``rglru_scan`` of
``repro``, and against the reference's Pallas kernel
``rglru_scan_pallas`` in interpret mode.  The CUDA kernel needs a card and
is held to the plain version in ``tests/test_torch_cuda.py``.

Tolerance: float32 within rtol = atol = 1e-5 (``TOL``, the reference's own
for its kernel); bf16 within 5e-2 (``BF16_TOL``, likewise): the port's
bf16 loop against the reference's bf16 loop (both keep h in bf16 and
round at other places), and the Pallas kernel (float32 state, bf16 out)
against the float32 loop on float32 casts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rglru import ops as ref_ops
from repro.kernels.rglru.kernel import rglru_scan_pallas
from repro.kernels.rglru.ref import rglru_gates_ref as R_gates
from repro.kernels.rglru.ref import rglru_scan_chunked as R_chunked
from repro.kernels.rglru.ref import rglru_scan_ref as R_ref
from repro_torch.kernels.rglru import (MODES, kernel, ops, rglru_gates_ref,
                                       rglru_scan, rglru_scan_chunked,
                                       rglru_scan_ref)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# tests/test_kernels.py's shapes: L, D, the Pallas kernel's l_chunk, dtype
SHAPES = [(16, 8, 8, "float32"), (100, 96, 32, "float32"),
          (256, 256, 128, "float32"), (33, 20, 16, "float32"),
          (128, 64, 64, "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, L, D, lead=(), h0=None):
    """a ∈ (0.3, 0.999) and b normal, as ``tests/test_kernels.py`` draws
    them, float32 numpy; ``lead`` is a batch shape, ``h0`` the shape of an
    initial state (None: no h0)."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(0.3, 0.999, size=lead + (L, D)),
           rng.normal(size=lead + (L, D)),
           None if h0 is None else rng.normal(size=h0)]
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


@pytest.mark.parametrize("L,D,l_chunk,dtype", SHAPES)
def test_plain_scans_match_the_reference(L, D, l_chunk, dtype):
    arrays = _inputs(L * 1000 + D, L, D)
    f_y, f_h = R_ref(*_jax(arrays))
    if dtype == "bfloat16":
        # both loops in bf16 (state rounded to bf16 each step)
        y, h = rglru_scan_ref(*_torch(arrays, torch.bfloat16))
        r_y, r_h = R_ref(*_jax(arrays, jnp.bfloat16))
        assert y.dtype == h.dtype == torch.bfloat16
        assert r_y.dtype == r_h.dtype == jnp.bfloat16
        _close(y, r_y, BF16_TOL)
        _close(h, r_h, BF16_TOL)
        # and within the kernel's bf16 tolerance of the float32 loop
        _close(y, f_y, BF16_TOL)
        _close(h, f_h, BF16_TOL)
        return
    y, h = rglru_scan_ref(*_torch(arrays))
    _close(y, f_y)
    _close(h, f_h)
    chunk = _divisor(L, l_chunk)
    c_y, c_h = rglru_scan_chunked(*_torch(arrays), chunk=chunk)
    rc_y, rc_h = R_chunked(*_jax(arrays), chunk=chunk)
    _close(c_y, rc_y)
    _close(c_h, rc_h)
    _close(c_y, f_y)


@pytest.mark.parametrize("L", [256, 2600])
def test_one_ulp_of_the_rounded_float32_loop_rejects_a_bf16_state(L):
    """The limit that holds a float32-state scan at bf16 (its output within
    one bf16 ulp of the float32 loop rounded to bf16) is one the bf16-state
    loop fails at recurrentgemma-9b's prefill lengths, although it passes
    the 5e-2 tolerance: so that limit, unlike 5e-2 alone, tells the
    kernel's float32 state from a state rounded to bf16 every step."""
    a, b, _ = _torch(_inputs(L, L, 512), torch.bfloat16)
    f_y, _ = rglru_scan_ref(a.float(), b.float())
    rounded = f_y.to(torch.bfloat16)
    y, _ = rglru_scan_ref(a, b)
    _close(y, f_y, BF16_TOL)
    eps = torch.finfo(torch.bfloat16).eps
    outside = (y.float() - rounded.float()).abs() > (
        1e-6 + eps * rounded.float().abs())
    assert float(outside.float().mean()) > 0.05


@pytest.mark.parametrize("L,D,l_chunk,dtype", SHAPES)
def test_the_pallas_kernel_in_interpret_mode_matches_the_port(L, D, l_chunk,
                                                              dtype):
    """The TPU kernel the CUDA kernel replaces, traced in interpret mode,
    against the port's plain loop on float32 casts of its inputs (the
    contract the CUDA kernel is held to on the card)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    a, b, _ = _jax(_inputs(L + D, L, D), jdt)
    p_y, p_h = rglru_scan_pallas(a, b, l_chunk=l_chunk, interpret=True)
    assert p_y.dtype == p_h.dtype == jdt
    y, h = rglru_scan_ref(torch.from_numpy(np.array(a, np.float32)),
                          torch.from_numpy(np.array(b, np.float32)))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    _close(y, p_y, tol)
    _close(h, p_h, tol)


def test_initial_state_threads_through():
    """Two half-scans, the second from the first's h, equal one scan."""
    a, b, _ = _torch(_inputs(7, 64, 16))
    y_full, h_full = R_ref(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    for fn in (rglru_scan_ref,
               lambda *x: rglru_scan_chunked(*x, chunk=8)):
        y_a, h_a = fn(a[:32], b[:32])
        y_b, h_b = fn(a[32:], b[32:], h_a)
        _close(torch.cat([y_a, y_b]), y_full)
        _close(h_b, h_full)


@pytest.mark.parametrize("h0", [None, "shared", "per_seq"])
def test_batch_dimension_is_the_reference_vmap(h0):
    Bt, L, D = 3, 24, 12
    shape = {None: None, "shared": (D,), "per_seq": (Bt, D)}[h0]
    arrays = _inputs(11, L, D, lead=(Bt,), h0=shape)
    a, b, H0 = _jax(arrays)
    if h0 is None:
        r_y, r_h = jax.vmap(R_ref)(a, b)
    else:
        r_y, r_h = jax.vmap(R_ref, in_axes=(0, 0, 0 if h0 == "per_seq"
                                            else None))(a, b, H0)
    for y, h in (rglru_scan_ref(*_torch(arrays)),
                 rglru_scan_chunked(*_torch(arrays), chunk=6)):
        assert y.shape == (Bt, L, D) and h.shape == (Bt, D)
        _close(y, r_y)
        _close(h, r_h)


def test_the_chunk_rule_of_the_plain_path(monkeypatch):
    """``$REPRO_SCAN_CHUNK`` picks the chunked scan when it divides L, in
    both packages, and is read at each call."""
    calls = []
    real = ops.rglru_scan_chunked

    def spy(*args, **kw):
        calls.append(kw["chunk"])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "rglru_scan_chunked", spy)
    for L, chunk, taken in ((48, "16", True), (50, "16", False),
                            (48, "0", False)):
        monkeypatch.setenv("REPRO_SCAN_CHUNK", chunk)
        arrays = _inputs(L, L, 10, h0=(10,))
        calls.clear()
        y, h = rglru_scan(*_torch(arrays), mode="torch")
        assert calls == ([16] if taken else [])
        r_y, r_h = ref_ops.rglru_scan(*_jax(arrays))
        _close(y, r_y)
        _close(h, r_h)


def test_gates_match_the_reference():
    rng = np.random.default_rng(4)
    x, r, i = (rng.normal(size=(32, 16)).astype(np.float32)
               for _ in range(3))
    lam = rng.normal(size=(16,)).astype(np.float32)
    a, b = rglru_gates_ref(*(torch.from_numpy(t) for t in (x, r, i, lam)))
    r_a, r_b = R_gates(*(jnp.asarray(t) for t in (x, r, i, lam)))
    _close(a, r_a)
    _close(b, r_b)
    assert bool(((a > 0) & (a < 1)).all())


def test_the_wrapper_runs_its_plain_version_on_cpu_tensors():
    arrays = _inputs(3, 40, 20, lead=(2,), h0=(2, 20))
    before = kernel.launches
    for dtype in (torch.float32, torch.bfloat16):
        a, b, h0 = _torch(arrays, dtype)
        y, h = kernel.rglru_scan(a, b, h0)
        ry, rh = rglru_scan_ref(a, b, h0)
        assert torch.equal(y, ry) and torch.equal(h, rh)
        assert y.dtype == h.dtype == dtype
        # the public op: auto on CPU tensors is the plain path, as torch is
        for mode in MODES:
            my, mh = rglru_scan(a, b, h0, mode=mode)
            assert torch.equal(my, ry) and torch.equal(mh, rh)
    assert kernel.launches == before      # no kernel launched on the CPU
    with pytest.raises(ValueError, match="scan mode"):
        rglru_scan(a, b, mode="pallas")


def test_the_wrapper_checks_its_inputs():
    good = _torch(_inputs(5, 8, 6, lead=(2,), h0=(2, 6)))

    def call(i, t):
        args = list(good)
        args[i] = t
        return kernel.rglru_scan(*args)

    with pytest.raises(TypeError, match="a must be float32 or bfloat16"):
        call(0, good[0].half())
    with pytest.raises(TypeError, match="h0 must be"):
        call(2, good[2].double())
    with pytest.raises(ValueError, match="b has shape"):
        call(1, good[1][:, :7])
    with pytest.raises(ValueError, match="h0 has shape"):
        call(2, torch.zeros(3, 6))
    with pytest.raises(ValueError, match="h0 has shape"):
        kernel.rglru_scan(good[0][0], good[1][0], good[2])
    with pytest.raises(ValueError, match="contiguous"):
        call(1, good[1].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="a must be"):
        call(0, good[0][0, 0])
    with pytest.raises(ValueError, match="empty"):
        kernel.rglru_scan(good[0][:, :0], good[1][:, :0])
    with pytest.raises(ValueError, match="is on"):
        call(1, good[1].to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.rglru_scan(*(t.to("meta") for t in good))
