"""The ticket-dispatch kernel's device code, run on the host, against the
plain version.

``repro_torch.rehearse`` compiles ``csrc/ticket_dispatch_kernel.cuh`` with
``g++`` and the generated constants header the ``nvcc`` build uses, and
runs each group's block of threads as host threads
(``csrc/rehearse/warp_emu.h``: ``__match_any_sync`` and ``__ballot_sync``
as one barrier phase over the warp, ``__syncthreads`` over the block).  So
the kernel's group function is held to ``dispatch_ref`` here, exactly:
ids in range, ids in [-E, 0) that wrap once, ids that take the fill value
INT32_MIN, groups of several chunks, and more experts than threads.

Each test decides for itself whether ``g++`` is there, and skips if not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import rehearse
from repro_torch.kernels.ticket_dispatch import kernel
from repro_torch.kernels.ticket_dispatch.ref import dispatch_ref


@pytest.fixture
def gxx():
    if rehearse.gxx_path() is None:
        pytest.skip("no g++: the rehearsal programs are built from source")


# name -> (groups, n, E, capacity, ids drawn in [lo, hi))
CASES = {
    "E1_wrap_fill": (2, 700, 1, 300, -2, 2),
    "E4_wrap_fill": (1, 1100, 4, 200, -8, 8),
    "E32_wrap_fill_3_chunks": (2, 1300, 32, 30, -64, 64),
    "E32_in_range": (3, 520, 32, 20, 0, 32),
    "E700_more_experts_than_threads": (1, 1030, 700, 2, -1400, 1400),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ticket_device_code_matches_plain(gxx, case):
    G, n, E, cap, lo, hi = CASES[case]
    ids = torch.from_numpy(np.random.default_rng(n).integers(
        lo, hi, size=(G, n)).astype(np.int32))
    t, s = rehearse.ticket_dispatch(ids, E, cap)
    want_t, want_s = dispatch_ref(ids, E, cap, grouped=True)
    assert torch.equal(t, want_t) and torch.equal(s, want_s)


def test_ticket_device_code_on_the_reference_fault_ids(gxx):
    """The ids that showed the fault: a wrapped id counts the earlier
    arrivals to id + E, an id past [-E, E) takes INT32_MIN, and no counter
    moves for either."""
    ids = torch.tensor([[3, 3, -1, -4, -5, 4, 3]], dtype=torch.int32)
    t, s = rehearse.ticket_dispatch(ids, 4, 8)
    fill = -2**31
    assert t.tolist() == s.tolist() == [[0, 1, 2, 0, fill, fill, 2]]
    t, s = rehearse.ticket_dispatch(ids, 4, kernel.INT32_MAX)
    assert t.tolist() == [[0, 1, 2, 0, fill, fill, 2]]
