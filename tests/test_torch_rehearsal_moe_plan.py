"""The routing-plan kernel's device code, and the one-pass ticket walk it
shares with the ticket kernel, run on the host against the plain versions.

``repro_torch.rehearse`` compiles ``csrc/moe_plan_kernel.cuh`` (which
includes ``csrc/ticket_dispatch_kernel.cuh``) with ``g++`` and the
generated constants header the ``nvcc`` build uses, and runs each group's
block of threads as host threads (``csrc/rehearse/warp_emu.h``).  So the
kernel's group function is held to ``plan_ref`` here: every output bit for
bit, but the aux loss's gate sums, which it sums in double in another order
(within 1e-6 relative).  The cases are granite-moe's prefill groups and
decode group, several groups, a group walked in two chunks, gates tied to
the bit, all mass on one expert (drops), grok-1's E 8 / K 2, bf16 and
float32 gates.  The standalone ticket kernel's td_group runs on
``chip_smoke.py``'s ticket sets against ``dispatch_ref``.

Each test decides for itself whether ``g++`` is there, and skips if not.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import rehearse
from repro_torch.configs import get_config
from repro_torch.kernels.ticket_dispatch import kernel, plan, plan_ref
from repro_torch.kernels.ticket_dispatch.ref import dispatch_ref
from repro_torch.models.layers import moe_capacity

GRANITE = get_config("granite-moe-1b-a400m")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def gxx():
    if rehearse.gxx_path() is None:
        pytest.skip("no g++: the rehearsal programs are built from source")


def _softmax(logits) -> torch.Tensor:
    return torch.softmax(torch.from_numpy(np.asarray(logits, np.float32)),
                         -1)


def _gates(case: str) -> tuple[torch.Tensor, int, int, torch.dtype]:
    """(gates_full, K, capacity, gate dtype) of one case."""
    rng = np.random.default_rng(len(case))
    bf16 = torch.bfloat16
    if case.startswith("prefill_Lp"):
        lp = int(case[len("prefill_Lp"):])
        return (_softmax(rng.normal(size=(1, lp, 32))), 8,
                moe_capacity(GRANITE, lp), bf16)
    return {
        "decode": lambda: (_softmax(rng.normal(size=(1, 8, 32))), 8, 8, bf16),
        "4_groups_float32": lambda: (_softmax(rng.normal(size=(4, 40, 32))),
                                     8, 16, torch.float32),
        # 8 · 1,100 arrivals: two chunks of the stage
        "two_chunks": lambda: (_softmax(rng.normal(size=(1, 1100, 32))), 8,
                               280, bf16),
        "ties": lambda: (torch.from_numpy((rng.integers(
            0, 4, size=(2, 48, 32)) / 64).astype(np.float32)), 8, 16, bf16),
        "one_expert_drops": lambda: (_softmax(np.where(
            np.arange(32) == 5, 20.0, 0.0) * np.ones((1, 64, 32))), 8, 16,
            bf16),
        "grok_E8_K2": lambda: (_softmax(rng.normal(size=(3, 40, 8))), 2, 8,
                               bf16),
    }[case]()


CASES = ("prefill_Lp16", "prefill_Lp128", "prefill_Lp256", "decode",
         "4_groups_float32", "two_chunks", "ties", "one_expert_drops",
         "grok_E8_K2")


@pytest.mark.parametrize("case", CASES)
def test_plan_device_code_matches_plain(gxx, case):
    gates_full, K, cap, dtype = _gates(case)
    got = rehearse.moe_plan(gates_full, K, cap, dtype)
    want = plan_ref(gates_full, K, cap, dtype)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        if key == "gate_sums":
            torch.testing.assert_close(got[key], value, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got[key], value), key
    if case == "two_chunks":
        assert gates_full.shape[1] * K > plan.STAGE
    if case == "one_expert_drops":
        assert not bool(got["kept"].all())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ticket_walk_on_the_chip_smoke_sets(gxx):
    """The one-pass walk of the standalone ticket kernel on every ticket set
    of ``chip_smoke.py`` (granite-moe's groups, a million arrivals in one
    group, 1 to 3,418 experts, drops, wrapped and filled ids)."""
    cases = _chip_smoke().ticket_cases(torch.device("cpu"), moe_capacity,
                                       GRANITE, kernel.MAX_EXPERTS)
    assert len(cases) == 16
    for name, ids, n_experts, capacity in cases:
        t, s = rehearse.ticket_dispatch(ids, n_experts, capacity)
        want_t, want_s = dispatch_ref(ids, n_experts, capacity, grouped=True)
        assert torch.equal(t, want_t) and torch.equal(s, want_s), name
