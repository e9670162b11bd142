"""The selective-scan kernel's device code, run on the host, against the
plain loop.

``repro_torch.rehearse`` compiles ``csrc/mamba_scan_kernel.cuh`` with
``g++`` and the generated constants header the ``nvcc`` build uses, and
runs each block's threads as host threads (``csrc/rehearse/warp_emu.h``: a
barrier per ``__syncthreads`` and per warp shuffle).  So the kernel's block
function is held to the plain loop on float32 casts here, without a card:
within 1e-5 on float32 inputs and 5e-2 on bf16, including ragged channel
blocks, partial chunks, every state size, a batch with h0 shared and per
sequence, mixed dtypes, and h0 threading two halves into one scan.

Each test decides for itself whether ``g++`` is there, and skips if not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import rehearse
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref


@pytest.fixture
def gxx():
    if rehearse.gxx_path() is None:
        pytest.skip("no g++: the rehearsal programs are built from source")


def _scan_inputs(L, D, N, lead=(), per_seq=False, h0=False, seed=0):
    rng = np.random.default_rng(seed)
    own = lead if per_seq else ()
    arrays = [rng.normal(size=lead + (L, D)),
              rng.uniform(0.01, 0.2, size=lead + (L, D)),
              -rng.uniform(0.5, 2.0, size=own + (D, N)),
              rng.normal(size=lead + (L, N)), rng.normal(size=lead + (L, N)),
              rng.normal(size=own + (D,)),
              rng.normal(size=own + (D, N)) if h0 else None]
    return [None if a is None else torch.from_numpy(a.astype(np.float32))
            for a in arrays]


SCAN_CASES = {
    "L16_D8_N4": (16, 8, 4), "L100_D96_N16": (100, 96, 16),
    "L33_D20_N8": (33, 20, 8), "L70_D130_N4": (70, 130, 4),
    "L1_D40_N16": (1, 40, 16), "L65_D64_N16": (65, 64, 16),
    "batch2_h0_shared": (40, 24, 8, (2,), False, True),
    "batch2_h0_per_seq": (40, 24, 8, (2,), True, True),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_device_code_matches_plain(gxx, case):
    args = _scan_inputs(*SCAN_CASES[case])
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        cast = [None if a is None else a.to(dtype) for a in args]
        y, h = rehearse.mamba_scan(*cast)
        assert y.dtype == h.dtype == dtype
        ry, rh = selective_scan_ref(*(None if a is None else a.float()
                                      for a in cast))
        torch.testing.assert_close(y.float(), ry, rtol=tol, atol=tol)
        torch.testing.assert_close(h.float(), rh, rtol=tol, atol=tol)


def test_scan_device_code_threads_h0_through_two_halves(gxx):
    x, dt, A, B, C, Dsk, _ = _scan_inputs(100, 96, 16, seed=1)
    y_full, h_full = selective_scan_ref(x, dt, A, B, C, Dsk)
    y_a, h_a = rehearse.mamba_scan(x[:37], dt[:37], A, B[:37], C[:37], Dsk)
    y_b, h_b = rehearse.mamba_scan(x[37:], dt[37:], A, B[37:], C[37:], Dsk,
                                   h_a)
    torch.testing.assert_close(torch.cat([y_a, y_b]), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_b, h_full, rtol=1e-5, atol=1e-5)


def test_scan_device_code_mixed_dtypes(gxx):
    """float32 A and D_skip, bf16 everything else: each input is read in
    its own dtype, y and h_final come back in x's."""
    args = _scan_inputs(50, 30, 16, seed=2)
    mixed = [a if i in (2, 5) else a.to(torch.bfloat16)
             for i, a in enumerate(args[:6])]
    y, h = rehearse.mamba_scan(*mixed)
    assert y.dtype == h.dtype == torch.bfloat16
    ry, rh = selective_scan_ref(*(a.float() for a in mixed))
    torch.testing.assert_close(y.float(), ry, rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(h.float(), rh, rtol=5e-2, atol=5e-2)

