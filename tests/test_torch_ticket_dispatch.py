"""The port's MoE ticket dispatch against the reference's, on the same
numpy-seeded expert ids: ``ticket_ref``, ``dispatch_ref`` and
``assign_slots`` of ``repro_torch`` against ``ticket_ref``, ``dispatch_ref``
and the Pallas kernel ``ticket_dispatch_pallas`` of ``repro`` (run in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it).

Tolerance: exact equality (tickets are integers).  The kernel itself needs
a card: ``tests/test_torch_cuda.py`` holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ticket_dispatch.kernel import ticket_dispatch_pallas
from repro.kernels.ticket_dispatch.ops import assign_slots as ref_assign
from repro.kernels.ticket_dispatch.ref import dispatch_ref as ref_dispatch
from repro.kernels.ticket_dispatch.ref import ticket_ref as ref_ticket
from repro_torch.kernels.ticket_dispatch import (assign_slots,
                                                 dispatch_combine_plan,
                                                 dispatch_ref, kernel,
                                                 ticket_ref)

# test_kernels.py's shapes, plus granite-moe's prefill and decode groups
SHAPES = [((1,), 2), ((7,), 4), ((64,), 8), ((100, 2), 8), ((513, 8), 32),
          ((2048,), 64), ((33, 3), 5), ((16, 8), 32), ((8, 8), 32)]


def _ids(seed, shape, n_experts):
    return np.random.default_rng(seed).integers(
        0, n_experts, size=shape).astype(np.int32)


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,n_experts", SHAPES)
def test_tickets_match_the_reference_and_its_pallas_kernel(shape, n_experts):
    ids = _ids(len(shape) * 1000 + shape[0], shape, n_experts)
    want = ref_ticket(jnp.asarray(ids), n_experts)
    np.testing.assert_array_equal(
        np.asarray(ticket_dispatch_pallas(jnp.asarray(ids), n_experts,
                                          block_n=32)), np.asarray(want))
    got = ticket_ref(torch.from_numpy(ids), n_experts)
    assert got.shape == shape and got.dtype == torch.int32
    _same(got, want)
    capacity = max(1, int(np.prod(shape)) // n_experts)
    r_t, r_s = ref_dispatch(jnp.asarray(ids), n_experts, capacity)
    p_t, p_s = dispatch_ref(torch.from_numpy(ids), n_experts, capacity)
    _same(p_t, r_t)
    _same(p_s, r_s)
    # the public op on a CPU tensor (auto -> the wrapper's plain version)
    # and forced to the plain version, against the reference's Pallas path
    _, k_s = ref_assign(jnp.asarray(ids), n_experts, capacity,
                        use_pallas=True)
    before = kernel.launches
    for mode in ("auto", "torch"):
        a_t, a_s = assign_slots(torch.from_numpy(ids), n_experts, capacity,
                                mode=mode)
        _same(a_t, r_t)
        _same(a_s, k_s)
    assert kernel.launches == before      # no kernel launch on the CPU


def test_single_expert_is_iota():
    ids = np.zeros((50,), np.int32)
    want = np.asarray(ticket_dispatch_pallas(jnp.asarray(ids), 1,
                                             block_n=16))
    np.testing.assert_array_equal(want, np.arange(50))
    _same(ticket_ref(torch.from_numpy(ids), 1), want)
    t, s = assign_slots(torch.from_numpy(ids), 1, 20)
    _same(t, np.arange(50))
    _same(s, np.where(np.arange(50) < 20, np.arange(50), -1))


def test_capacity_drop_is_fifo_fair():
    """Only the latest arrivals are dropped: the earliest ``capacity`` per
    expert keep their slots, as in the reference's pin."""
    ids = np.asarray([0, 0, 0, 1, 0, 1, 0], np.int32)
    _, want = ref_dispatch(jnp.asarray(ids), 2, capacity=2)
    np.testing.assert_array_equal(np.asarray(want), [0, 1, -1, 0, -1, 1, -1])
    for mode in ("auto", "torch"):
        _, slots = assign_slots(torch.from_numpy(ids), 2, 2, mode=mode)
        _same(slots, want)


@pytest.mark.parametrize("shape,n_experts,capacity", [
    ((3, 8, 8), 8, 5), ((16, 8, 8), 32, 8), ((2, 512, 8), 32, 160),
    ((4, 33), 5, 2)])
def test_groups_match_the_reference_vmap(shape, n_experts, capacity):
    """``grouped=True``: each slice along dim 0 is ticketed on its own
    counters, as the reference's ``jax.vmap`` over groups in ``layers.moe``
    ((G, N, K) ids, token-major arrivals)."""
    ids = _ids(int(np.prod(shape)), shape, n_experts)
    r_t, r_s = jax.vmap(lambda x: ref_dispatch(x, n_experts, capacity))(
        jnp.asarray(ids))
    k_s = jax.vmap(lambda x: ref_assign(x, n_experts, capacity,
                                        use_pallas=True)[1])(
        jnp.asarray(ids))
    np.testing.assert_array_equal(np.asarray(k_s), np.asarray(r_s))
    p_t, p_s = dispatch_ref(torch.from_numpy(ids), n_experts, capacity,
                            grouped=True)
    _same(p_t, r_t)
    _same(p_s, r_s)
    a_t, a_s = assign_slots(torch.from_numpy(ids), n_experts, capacity,
                            grouped=True)
    _same(a_t, r_t)
    _same(a_s, r_s)
    gates = np.random.default_rng(1).random(ids.shape).astype(np.float32)
    plan = dispatch_combine_plan(torch.from_numpy(ids),
                                 torch.from_numpy(gates), n_experts,
                                 capacity, grouped=True)
    _same(plan["slot"], r_s)
    _same(plan["kept"], np.asarray(r_s) >= 0)
    _same(plan["gates"], np.where(np.asarray(r_s) >= 0, gates, 0.0))


def test_skewed_groups_drop_all_but_capacity():
    ids = np.full((4, 300), 3, np.int32)
    t, s = assign_slots(torch.from_numpy(ids), 8, 16, grouped=True)
    _same(t, np.broadcast_to(np.arange(300), (4, 300)))
    assert int((s >= 0).sum()) == 4 * 16


def test_ids_outside_the_experts_take_no_ticket():
    """Ids outside [0, E) take no ticket of their own: neither moves an
    expert's counter.  What they read follows the reference's
    ``dispatch_ref`` (JAX's gather rule): an id in [-E, 0) wraps once and
    reads the count of earlier arrivals to id + E, any other reads
    INT32_MIN as ticket and slot.  On the ids that showed the port's old
    rule (ticket and slot -1) to differ."""
    ids = np.asarray([3, 3, -1, -4, -5, 4, 3], np.int32)
    r_t, r_s = ref_dispatch(jnp.asarray(ids), 4, 8)
    fill = -2**31
    np.testing.assert_array_equal(np.asarray(r_t),
                                  [0, 1, 2, 0, fill, fill, 2])
    np.testing.assert_array_equal(np.asarray(r_s), np.asarray(r_t))
    for t, s in (dispatch_ref(torch.from_numpy(ids), 4, 8),
                 kernel.ticket_dispatch(torch.from_numpy(ids[None]), 4, 8)):
        _same(t.reshape(-1), r_t)
        _same(s.reshape(-1), r_s)


@pytest.mark.parametrize("n_experts", [1, 4, 32])
@pytest.mark.parametrize("grouped", [False, True])
def test_ids_drawn_past_the_experts_match_the_reference(n_experts, grouped):
    """Ids drawn in [-2E, 2E): in range, wrapped once, and filled with
    INT32_MIN, against the reference's ``dispatch_ref`` element for
    element (grouped: its ``jax.vmap`` over groups), INT32_MIN included."""
    shape = (3, 40, 2) if grouped else (257, 3)
    ids = np.random.default_rng(n_experts + 10 * grouped).integers(
        -2 * n_experts, 2 * n_experts, size=shape).astype(np.int32)
    capacity = max(1, int(np.prod(shape)) // (4 * n_experts))

    def ref(x):
        return ref_dispatch(x, n_experts, capacity)

    r_t, r_s = (jax.vmap(ref) if grouped else ref)(jnp.asarray(ids))
    assert int((np.asarray(r_t) == -2**31).sum()) > 0
    p_t, p_s = dispatch_ref(torch.from_numpy(ids), n_experts, capacity,
                            grouped=grouped)
    _same(p_t, r_t)
    _same(p_s, r_s)
    t = ticket_ref(torch.from_numpy(ids), n_experts, grouped=grouped)
    _same(t, r_t)
    a_t, a_s = assign_slots(torch.from_numpy(ids), n_experts, capacity,
                            grouped=grouped)
    _same(a_t, r_t)
    _same(a_s, r_s)


def test_wrapper_checks_its_inputs():
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        kernel.ticket_dispatch(ids.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.ticket_dispatch(torch.zeros((8, 2), dtype=torch.int32).T, 4)
    with pytest.raises(ValueError, match="groups, n"):
        kernel.ticket_dispatch(ids[0], 4)
    for bad in (0, kernel.MAX_EXPERTS + 1):
        with pytest.raises(ValueError, match="n_experts"):
            kernel.ticket_dispatch(ids, bad)
    with pytest.raises(ValueError, match="capacity"):
        kernel.ticket_dispatch(ids, 4, -1)
    with pytest.raises(ValueError, match="mode"):
        assign_slots(ids, 4, 2, mode="pallas")
    # the shared-memory rule the kernel applies
    assert kernel.smem_bytes(kernel.MAX_EXPERTS) <= kernel.SMEM_LIMIT
    assert kernel.smem_bytes(kernel.MAX_EXPERTS + 1) > kernel.SMEM_LIMIT
