"""The RG-LRU scan kernel's device code, run on the host, against the
plain loop.

``repro_torch.rehearse`` compiles ``csrc/rglru_scan_kernel.cuh`` with
``g++`` and the generated constants header the ``nvcc`` build uses, and
runs each block's threads as host threads (``csrc/rehearse/warp_emu.h``).
So the kernel's block function is held to the plain loop here, without a
card: on float32 inputs bit for bit (the kernel rounds the product and the
sum apart, as the loop does), on bf16 inputs within one ulp of bf16 (rtol
= bf16 eps, atol 1e-6) of the float32 loop on float32 casts rounded to
bf16 (the kernel's state is float32 and rounds only at the output).  The
cases cover ragged channel blocks (D not a multiple of the block's
channels, and rows whose bytes are not whole 16-byte copies), a tail
stage, scans longer than the ring, a batch with h0 shared and per
sequence, mixed dtypes, and h0 threading two halves into one scan.

Each test decides for itself whether ``g++`` is there, and skips if not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import rehearse
from repro_torch.kernels.rglru.ref import rglru_scan_ref


@pytest.fixture
def gxx():
    if rehearse.gxx_path() is None:
        pytest.skip("no g++: the rehearsal programs are built from source")


def _inputs(L, D, lead=(), h0=None, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(0.3, 0.999, size=lead + (L, D)),
              rng.normal(size=lead + (L, D)),
              None if h0 is None else rng.normal(size=h0)]
    return [None if a is None else torch.from_numpy(a.astype(np.float32))
            for a in arrays]


def _one_ulp(got, want):
    torch.testing.assert_close(got, want.to(got.dtype),
                               rtol=torch.finfo(got.dtype).eps, atol=1e-6)


CASES = {
    "L16_D8": (16, 8), "L100_D96": (100, 96), "L33_D20": (33, 20),
    "L1_D40": (1, 40), "L65_D129": (65, 129), "L300_D70": (300, 70),
    "L900_D64": (900, 64),
    "batch2_h0_shared": (40, 24, (2,), (24,)),
    "batch3_h0_per_seq": (70, 48, (3,), (3, 48)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rglru_device_code_matches_plain(gxx, case):
    args = _inputs(*CASES[case])
    y, h = rehearse.rglru_scan(*args)
    assert y.dtype == h.dtype == torch.float32
    ry, rh = rglru_scan_ref(*args)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    cast = [None if a is None else a.to(torch.bfloat16) for a in args]
    y, h = rehearse.rglru_scan(*cast)
    assert y.dtype == h.dtype == torch.bfloat16
    ry, rh = rglru_scan_ref(*(None if a is None else a.float()
                              for a in cast))
    _one_ulp(y, ry)
    _one_ulp(h, rh)


def test_rglru_device_code_threads_h0_through_two_halves(gxx):
    a, b, _ = _inputs(100, 96, seed=1)
    y_full, h_full = rglru_scan_ref(a, b)
    y_a, h_a = rehearse.rglru_scan(a[:37], b[:37])
    y_b, h_b = rehearse.rglru_scan(a[37:], b[37:], h_a)
    assert torch.equal(torch.cat([y_a, y_b]), y_full)
    assert torch.equal(h_b, h_full)


@pytest.mark.parametrize("D", [30, 64])
def test_rglru_device_code_mixed_dtypes(gxx, D):
    """float32 a, bf16 b and h0: each input is read in its own dtype, y and
    h_final come back in a's."""
    a, b, h0 = _inputs(50, D, (), (D,), seed=2)
    b, h0 = b.to(torch.bfloat16), h0.to(torch.bfloat16)
    y, h = rehearse.rglru_scan(a, b, h0)
    assert y.dtype == h.dtype == torch.float32
    ry, rh = rglru_scan_ref(a, b.float(), h0.float())
    assert torch.equal(y, ry) and torch.equal(h, rh)
