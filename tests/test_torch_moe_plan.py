"""The port's MoE routing plan (``plan_ref``, ``route_plan``, ``aux_loss``)
against the reference's, on the same numpy-seeded router softmax.

The reference side is what ``repro.models.layers.moe`` computes between its
softmax and its D-wide gather: ``jax.lax.top_k``, the renormalisation, the
aux loss's one-hot means, ``dispatch_combine_plan`` ``vmap``\\ ped over the
groups, the flat index and the slot→token scatter of ``_group_dispatch``
(``src/repro/models/layers.py:336-365``).

Tolerance: exact for every integer output and mask; the renormalised gates
within one float32 ulp of the reference's before the cast to the model's
dtype (the port sums the K gates left to right, XLA in an order of its
own); the aux loss within 1e-6 relative.  The routing-plan kernel needs a
card: ``tests/test_torch_cuda.py`` holds it to ``plan_ref`` there, and
``tests/test_torch_rehearsal_moe_plan.py`` its device code here.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ticket_dispatch.ops import (
    dispatch_combine_plan as ref_plan)
from repro_torch import _build
from repro_torch.configs import get_config
from repro_torch.kernels.ticket_dispatch import (PLAN_MODES, aux_loss, plan,
                                                 plan_ref, route_plan)
from repro_torch.kernels.ticket_dispatch.ref import renormalize, top_k_stable
from repro_torch.models.layers import moe_capacity

GRANITE = get_config("granite-moe-1b-a400m")
GROK = get_config("grok-1-314b")
AUX_WEIGHT = GRANITE.router_aux_weight


def _softmax(logits) -> np.ndarray:
    """The router's float32 softmax, as the port computes it."""
    return torch.softmax(torch.from_numpy(np.asarray(logits, np.float32)),
                         -1).numpy()


def _reference(gates_full: np.ndarray, K: int, capacity: int):
    """The reference's plan of (G, N, E) gates: top-k ids, renormalised
    float32 gates, slot, kept, flat index, slot→token map (with -1) and
    aux loss."""
    G, N, E = gates_full.shape
    gf = jnp.asarray(gates_full)
    top_gates, top_ids = jax.lax.top_k(gf, K)
    top_gates = top_gates / jnp.maximum(top_gates.sum(-1, keepdims=True),
                                        1e-9)
    density = jnp.mean(jax.nn.one_hot(top_ids[..., 0], E), axis=(0, 1))
    router_prob = jnp.mean(gf, axis=(0, 1))
    aux = AUX_WEIGHT * E * jnp.sum(density * router_prob)
    p = jax.vmap(lambda ids, g: ref_plan(ids, g, E, capacity))(
        top_ids, top_gates)
    flat_idx = jnp.where(p["kept"], top_ids * capacity + p["slot"],
                         E * capacity)

    def group_map(flat_idx_g):
        pair_tok = jnp.arange(N * K, dtype=jnp.int32) // K
        slot_tok = jnp.full((E * capacity + 1,), -1, jnp.int32)
        return slot_tok.at[flat_idx_g.reshape(-1)].set(pair_tok)[:-1]

    slot_tok = jax.vmap(group_map)(flat_idx)
    return {k: np.asarray(v) for k, v in dict(
        top_ids=top_ids, top_gates=top_gates, slot=p["slot"],
        kept=p["kept"], flat_idx=flat_idx, slot_tok=slot_tok,
        aux=aux).items()}


def _check(gates_full: np.ndarray, K: int, capacity: int,
           gate_dtype=torch.bfloat16) -> dict:
    """plan_ref against the reference; every mode of route_plan equals
    plan_ref on the CPU.  Returns the port's plan."""
    G, N, E = gates_full.shape
    gf = torch.from_numpy(gates_full)
    got = plan_ref(gf, K, capacity, gate_dtype)
    want = _reference(gates_full, K, capacity)
    np.testing.assert_array_equal(got["top_ids"].numpy(), want["top_ids"])
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    np.testing.assert_array_equal(got["kept"].numpy(), want["kept"])
    n_slots = E * capacity
    np.testing.assert_array_equal(
        got["safe_idx"].numpy(),
        np.minimum(want["flat_idx"], n_slots - 1).reshape(G, N * K))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  want["slot_tok"] >= 0)
    np.testing.assert_array_equal(got["slot_tok"].numpy(),
                                  np.maximum(want["slot_tok"], 0))
    # the renormalised gates before the cast: one float32 ulp
    top = renormalize(top_k_stable(gf, K)[0]).numpy()
    ulp = np.spacing(np.abs(want["top_gates"]).astype(np.float32))
    assert (np.abs(top - want["top_gates"]) <= ulp).all()
    cast = torch.from_numpy(top).to(gate_dtype)
    assert torch.equal(got["gates"], torch.where(got["kept"], cast,
                                                 torch.zeros_like(cast)))
    np.testing.assert_array_equal(
        got["first_counts"].numpy(),
        (want["top_ids"][..., :1] == np.arange(E)).sum(1))
    aux = aux_loss(got, AUX_WEIGHT)
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=1e-6)
    for mode in PLAN_MODES:
        other = route_plan(gf, E, K, capacity, gate_dtype, mode=mode)
        for key, value in got.items():
            assert torch.equal(other[key], value), (mode, key)
    return got


# name -> (G, N, config, capacity or None for the config's rule)
CASES = {
    "granite_decode": (1, 8, GRANITE, None),
    "granite_prefill_2_groups": (2, 64, GRANITE, None),
    "granite_prefill_drops": (1, 64, GRANITE, 8),
    "grok_decode": (1, 8, GROK, None),
    "grok_prefill_3_groups": (3, 40, GROK, None),
    "grok_drops": (2, 48, GROK, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_the_reference(case):
    G, N, cfg, capacity = CASES[case]
    E, K = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, N) if capacity is None else capacity
    rng = np.random.default_rng(len(case))
    got = _check(_softmax(rng.normal(size=(G, N, E))), K, cap)
    dropped = int((~got["kept"]).sum())
    assert (dropped > 0) == case.endswith("drops"), dropped


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gates_tied_to_the_bit_go_to_the_lower_index(dtype):
    """Gates with many exact ties (multiples of 1/64, as bf16 logits give
    equal softmax rows): the order is lax.top_k's, ties to the lower
    expert, in every group."""
    rng = np.random.default_rng(5)
    gates = (rng.integers(0, 4, size=(3, 24, 32)) / 64).astype(np.float32)
    gates[0, 0] = 1 / 64                             # one row all tied
    got = _check(gates, 8, 16, dtype)
    assert got["top_ids"][0, 0].tolist() == list(range(8))


def test_all_mass_on_one_expert_drops_all_but_the_first_tokens():
    """Every token's softmax is one-hot on expert 3: each token's choices
    are 3 and then the tied zeros in index order, and expert 3's capacity
    goes to the earliest tokens, FIFO."""
    G, N, E, K, cap = 2, 32, 32, 8, 8
    gates = np.zeros((G, N, E), np.float32)
    gates[..., 3] = 1.0
    got = _check(gates, K, cap)
    assert got["top_ids"][1, 5].tolist() == [3, 0, 1, 2, 4, 5, 6, 7]
    kept_tokens = got["kept"][..., 0].nonzero()[:, 1].reshape(G, -1)
    assert kept_tokens.tolist() == [list(range(cap))] * G
    assert got["gates"][0, 0, 0] == 1 and got["gates"][0, cap, 0] == 0
    # every choice of a kept token went to an expert with room
    assert int(got["valid"].sum()) == int(got["kept"].sum())


def test_all_mass_on_one_expert_from_softmax_logits():
    """The same with a softmax of logits 20 above the rest (the gates of
    the other experts tiny and tied), granite's decode capacity."""
    logits = np.where(np.arange(32) == 7, 20.0, 0.0) * np.ones((1, 64, 32))
    got = _check(_softmax(logits), 8, moe_capacity(GRANITE, 8))
    assert int(got["kept"][..., 0].sum()) == moe_capacity(GRANITE, 8)


def test_plan_wrapper_checks_its_inputs():
    gf = torch.softmax(torch.zeros(2, 4, 8), -1)
    with pytest.raises(ValueError, match=f"1 to {plan.MAX_EXPERTS} experts"):
        plan.moe_plan(torch.softmax(torch.zeros(1, 2, 33), -1), 2, 8,
                      torch.float32)
    with pytest.raises(TypeError, match="float32"):
        plan.moe_plan(gf.double(), 2, 8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        plan.moe_plan(gf.transpose(0, 1), 2, 8, torch.float32)
    with pytest.raises(ValueError, match="top_k"):
        plan.moe_plan(gf, 9, 8, torch.float32)
    with pytest.raises(ValueError, match="capacity"):
        plan.moe_plan(gf, 2, 0, torch.float32)
    with pytest.raises(TypeError, match="gate_dtype"):
        plan.moe_plan(gf, 2, 8, torch.float16)
    with pytest.raises(ValueError, match="mode"):
        route_plan(gf, 8, 2, 8, torch.float32, mode="pallas")
    with pytest.raises(ValueError, match="experts"):
        route_plan(gf, 9, 2, 8, torch.float32)
    # a CPU tensor takes the plain version and launches nothing
    before = plan.launches
    got = plan.moe_plan(gf, 2, 8, torch.float32)
    assert plan.launches == before
    for key, value in plan_ref(gf, 2, 8, torch.float32).items():
        assert torch.equal(got[key], value), key
    # the shared-memory rule of the kernel: every group fits in 48 KB
    assert plan.smem_bytes(plan.MAX_EXPERTS, 10**6, 1) <= 48 * 1024


def test_plan_build_command_and_generated_header(tmp_path):
    header = tmp_path / "h.h"
    cmd = _build.build_command("moe_plan", tmp_path / "lib.so", header)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert not any("fast" in a for a in cmd)       # IEEE division
    csrc = _build.CSRC
    inputs = [a for a in cmd if a.endswith((".cu", ".cuh", ".h"))]
    assert inputs == [str(header), str(csrc / "moe_plan.cu")]
    srcs = _build.sources("moe_plan")
    assert [p.name for p in srcs] == ["moe_plan.cu", "moe_plan_kernel.cuh",
                                      "ticket_dispatch_kernel.cuh"]
    included = set()
    for path in srcs:
        assert path.is_file()
        for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert (csrc / inc).is_file(), inc
            included.add(inc)
    # the hash covers every header the source includes
    assert included <= {p.name for p in srcs}
    defs = {k: int(v) for k, v in re.findall(
        r"#define (\w+) (-?\d+)", _build.plan_constants_header())}
    assert defs == {"TD_THREADS": plan.kernel.THREADS,
                    "MP_STAGE": plan.STAGE,
                    "MP_MAX_EXPERTS": plan.MAX_EXPERTS}
    src = "".join(p.read_text() for p in srcs)
    for name in defs:
        assert not re.search(rf"#define\s+{name}\b", src), name
