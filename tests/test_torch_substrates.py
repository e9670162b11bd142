"""The port's data, checkpoint and runtime substrates against the reference's
tests of them and against the reference itself.

The reference's ``tests/test_substrates.py`` runs here against
``repro_torch`` (synthetic data, the Prefetcher on every lock kind, the
checkpoint round trip, GC and ``latest_step``, uncommitted dirs ignored,
the async save, ``WriterGate`` bounds, heartbeat, straggler tickets,
``remesh_plan``), every thread joined with a timeout.  Then the two
packages side by side: ``synthetic_batch`` equal bit for bit over several
(step, shard, num_shards); a float32 ``TrainState`` saved by the reference
restores in the port and the reverse, bit for bit with the same manifest
keys; a bfloat16 leaf saved by the reference reads back in the port with
the same bits, and the port writes it with the reference's bytes.
Tolerance: exact.
"""

import json
import os
import threading
import time
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as ref_ckpt
from repro.configs import get_config as ref_config
from repro.data import synthetic_batch as ref_synthetic_batch
from repro.models import model as RM
from repro.optim import AdamW as RefAdamW
from repro.train.train_step import TrainState as RefTrainState
from repro_torch.ckpt import (AsyncCheckpointer, WriterGate, latest_step,
                              restore, save)
from repro_torch.configs import get_config
from repro_torch.core import LOCK_CLASSES, InMemoryKVStore
from repro_torch.data import Prefetcher, SyntheticLM, synthetic_batch
from repro_torch.models import model as M
from repro_torch.optim import AdamW
from repro_torch.runtime import HeartbeatMonitor, StepTickets, remesh_plan
from repro_torch.train.train_step import TrainState
from repro_torch.tree import flatten_with_path, tree_map

CFG = get_config("deepseek-7b").reduced()
CPU = torch.device("cpu")
JOIN_S = 30.0


def _join(threads) -> None:
    deadline = time.monotonic() + JOIN_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a thread wedged"


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
def test_synthetic_deterministic_and_elastic():
    """The same global rows appear regardless of shard factorization."""
    full = synthetic_batch(CFG, step=3, batch=8, seq=16, num_shards=1)
    halves = [synthetic_batch(CFG, step=3, batch=8, seq=16, shard=s,
                              num_shards=2) for s in range(2)]
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([h["tokens"] for h in halves]))
    again = synthetic_batch(CFG, step=3, batch=8, seq=16)
    np.testing.assert_array_equal(full["tokens"], again["tokens"])
    assert full["tokens"].max() < CFG.vocab
    assert (full["labels"][:, :-1] == full["tokens"][:, 1:]).all()


def test_synthetic_steps_differ():
    a = synthetic_batch(CFG, step=0, batch=4, seq=8)
    b = synthetic_batch(CFG, step=1, batch=4, seq=8)
    assert (a["tokens"] != b["tokens"]).any()


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m",
                                  "hubert-xlarge", "qwen2-vl-72b"])
@pytest.mark.parametrize("step,shard,num_shards,seed", [
    (0, 0, 1, 0), (3, 1, 2, 0), (17, 3, 4, 5), (2**20 + 7, 0, 8, 123)])
def test_synthetic_batch_equals_the_references(arch, step, shard,
                                               num_shards, seed):
    """Every leaf (tokens, labels, and the audio/vision frontends' inputs)
    bit for bit, full-width and reduced vocabularies."""
    for reduced in (False, True):
        port_cfg, ref_cfg = get_config(arch), ref_config(arch)
        if reduced:
            port_cfg, ref_cfg = port_cfg.reduced(), ref_cfg.reduced()
        kw = dict(step=step, batch=8, seq=12, seed=seed, shard=shard,
                  num_shards=num_shards)
        port, ref = synthetic_batch(port_cfg, **kw), \
            ref_synthetic_batch(ref_cfg, **kw)
        assert sorted(port) == sorted(ref)
        for k in ref:
            assert port[k].dtype == ref[k].dtype and \
                port[k].shape == ref[k].shape, k
            assert port[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("lock_kind", sorted(LOCK_CLASSES))
def test_prefetcher_in_order(lock_kind):
    src = SyntheticLM(CFG, batch=4, seq=8)
    with Prefetcher(src, depth=3, lock_kind=lock_kind) as pf:
        assert type(pf._lock).__module__.startswith("repro_torch.core")
        assert pf._lock.name == lock_kind
        for expect in range(6):
            step, batch = pf.get(timeout=JOIN_S)
            assert step == expect
            ref = src.batch_at(expect)
            np.testing.assert_array_equal(batch["tokens"], ref["tokens"])
    assert not pf._thread.is_alive()


def test_prefetcher_takes_repro_lock(monkeypatch):
    monkeypatch.setenv("REPRO_LOCK", "ticket")
    with Prefetcher(SyntheticLM(CFG, batch=2, seq=4), start_step=5) as pf:
        assert pf._lock.name == "ticket"
        assert pf.get(timeout=JOIN_S)[0] == 5


# --------------------------------------------------------------------------
# ckpt
# --------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 8), generator=g),
            "opt": {"m": torch.zeros((4, 8)),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "stack": [torch.arange(3.0), torch.ones((2, 2))]}


def _equal_trees(a, b):
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(fa[k], fb[k]), k


def test_ckpt_roundtrip(tmp_path):
    t = _tree()
    save(t, str(tmp_path), step=5)
    assert latest_step(str(tmp_path)) == 5
    got, step = restore(str(tmp_path), like=t)
    assert step == 5
    _equal_trees(t, got)


def test_ckpt_roundtrip_bf16_and_device_of_like(tmp_path):
    t = tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point()
                 else x, _tree(1))
    save(t, str(tmp_path), step=2)
    got, _ = restore(str(tmp_path), like=t)
    _equal_trees(t, got)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["dtypes"]["w"] == "bfloat16"
    # restore casts to the like leaf's dtype, as the reference's astype
    like32 = tree_map(lambda x: x.float() if x.is_floating_point() else x, t)
    got32, _ = restore(str(tmp_path), like=like32)
    assert got32["w"].dtype == torch.float32
    assert torch.equal(got32["w"], t["w"].float())


def test_ckpt_gc_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        save(t, str(tmp_path), step=s, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_ckpt_uncommitted_ignored(tmp_path):
    t = _tree()
    save(t, str(tmp_path), step=1)
    d = tmp_path / "step_00000009"
    d.mkdir()  # crashed writer: no COMMIT
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), like=t)


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    t = _tree()
    ck.save(t, step=11)
    t["w"].zero_()       # the save wrote the snapshot taken before this
    ck.wait()
    assert latest_step(str(tmp_path)) == 11
    got, _ = restore(str(tmp_path), like=t)
    assert torch.equal(got["w"], _tree()["w"])
    (rec,) = ck.history
    assert rec["step"] == 11 and rec["bytes"] > 4 * 8 * 4
    assert rec["write_seconds"] >= 0 and rec["snapshot_seconds"] >= 0


def test_writer_gate_bounds_concurrency(tmp_path):
    gate = WriterGate(str(tmp_path / "kv"), slots=2)
    active, peak = [0], [0]
    mu = threading.Lock()

    def writer(h):
        gate.acquire(h)
        with mu:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.002)
        with mu:
            active[0] -= 1
        gate.release(h)

    ths = [threading.Thread(target=writer, args=(h,), daemon=True)
           for h in range(8)]
    for t in ths:
        t.start()
    _join(ths)
    assert 1 <= peak[0] <= 2


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------
XCFG = "granite-moe-1b-a400m"


def _ref_state():
    """The reference's float32 TrainState of reduced granite with non-zero
    moments and step."""
    cfg = ref_config(XCFG).reduced()
    params = RM.init_params(cfg, jax.random.PRNGKey(3))
    opt = RefAdamW().init(params)
    opt = opt._replace(step=jnp.int32(5),
                       m=jax.tree.map(lambda p: p * 0.5, params),
                       v=jax.tree.map(lambda p: p * p, params))
    return RefTrainState(params, opt)


def _port_state(seed):
    cfg = get_config(XCFG).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=CPU)
    opt = AdamW().init(params)
    g = torch.Generator().manual_seed(seed + 1)
    opt = opt._replace(step=torch.tensor(9, dtype=torch.int32),
                       m=tree_map(lambda p: torch.randn(
                           p.shape, generator=g), params),
                       v=tree_map(lambda p: torch.rand(
                           p.shape, generator=g), params))
    return TrainState(params, opt)


def test_ckpt_keys_are_the_references():
    ref_keys = list(ref_ckpt._flatten(_ref_state()))
    port_keys = list(flatten_with_path(_port_state(0)))
    assert port_keys == ref_keys
    assert ".params\x1dembed" in port_keys and ".opt\x1d.step" in port_keys
    assert ".params\x1dstack\x1dslot0\x1dwq" in port_keys


def test_ckpt_reference_saved_restores_in_the_port(tmp_path):
    ref_state = _ref_state()
    ref_ckpt.save(ref_state, str(tmp_path), step=3)
    like = _port_state(0)
    got, step = restore(str(tmp_path), like=like)
    assert step == 3 and latest_step(str(tmp_path)) == 3
    ref_flat = ref_ckpt._flatten(ref_state)
    got_flat = flatten_with_path(got)
    assert list(got_flat) == list(ref_flat)
    for k, r in ref_flat.items():
        r = np.asarray(r)
        p = got_flat[k].numpy()
        assert p.dtype == r.dtype and p.shape == r.shape, k
        assert p.tobytes() == r.tobytes(), k


def test_ckpt_port_saved_restores_in_the_reference(tmp_path):
    state = _port_state(4)
    save(state, str(tmp_path), step=7)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        _ref_state())
    got, step = ref_ckpt.restore(str(tmp_path), like=like)
    assert step == 7
    port_flat = flatten_with_path(state)
    ref_flat = ref_ckpt._flatten(got)
    assert list(ref_flat) == list(port_flat)
    for k, p in port_flat.items():
        r = np.asarray(ref_flat[k])
        assert r.dtype == p.numpy().dtype and r.shape == tuple(p.shape), k
        assert r.tobytes() == p.numpy().tobytes(), k
    # the manifests agree on keys, shapes and dtypes
    ref_dir, port_dir = tmp_path / "ref", tmp_path
    ref_ckpt.save(got, str(ref_dir), step=7)
    man = [json.loads((d / "step_00000007" / "manifest.json").read_text())
           for d in (ref_dir, port_dir)]
    assert man[0] == man[1]


def _bf16_tree():
    words = np.random.default_rng(2).integers(0, 2**16, size=(3, 5),
                                              dtype=np.uint16)
    words[0, :3] = [0x7FC0, 0xFF80, 0x0001]   # nan, -inf, a subnormal
    return words


def test_ckpt_reference_bf16_leaf_reads_back_in_the_port(tmp_path):
    words = _bf16_tree()
    ref_tree = {"w": jnp.asarray(words.view(ml_dtypes.bfloat16)),
                "b": jnp.arange(4, dtype=jnp.float32)}
    ref_ckpt.save(ref_tree, str(tmp_path), step=1)
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "b": torch.zeros(4)}
    got, _ = restore(str(tmp_path), like=like)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16),
                          words)
    assert torch.equal(got["b"], torch.arange(4, dtype=torch.float32))


def test_ckpt_port_bf16_leaf_has_the_references_bytes(tmp_path):
    words = _bf16_tree()
    ref_ckpt.save({"w": jnp.asarray(words.view(ml_dtypes.bfloat16))},
                  str(tmp_path / "ref"), step=1)
    save({"w": torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)},
         str(tmp_path / "port"), step=1)
    members = []
    for side in ("ref", "port"):
        cdir = tmp_path / side / "step_00000001"
        with zipfile.ZipFile(cdir / "shard_0.npz") as z:
            members.append({n: z.read(n) for n in z.namelist()})
        members.append(json.loads((cdir / "manifest.json").read_text()))
    assert members[0] == members[2]
    assert members[1] == members[3]
    assert members[3]["dtypes"] == {"w": "bfloat16"}


# --------------------------------------------------------------------------
# runtime
# --------------------------------------------------------------------------
def test_heartbeat_monitor():
    store = InMemoryKVStore()
    hb = HeartbeatMonitor(store, ttl_s=5.0)
    hb.beat(0, now=100.0)
    hb.beat(1, now=100.0)
    assert hb.alive(0, now=103.0)
    assert hb.dead([0, 1, 2], now=103.0) == [2]
    assert hb.dead([0, 1], now=110.0) == [0, 1]


def test_straggler_ticket_age():
    store = InMemoryKVStore()
    st = StepTickets(store, threshold=2)
    for w in range(4):
        st.arrive(w, step=10)
    st.arrive(0, step=13)  # worker 0 sprints ahead
    st.arrive(1, step=12)
    assert st.front() == 13
    assert st.age(0) == 0 and st.age(1) == 1
    assert st.stragglers(range(4)) == [2, 3]


def test_remesh_plan_shrink():
    p = remesh_plan(240, model=16, old_data=16)
    assert p.model == 16 and p.data <= 240 // 16
    assert p.chips_used <= 240 and p.reshard
    assert 256 % (p.pods * p.data) == 0


def test_remesh_plan_multi_pod():
    p = remesh_plan(512, model=16)
    assert p.mesh_shape == (2, 16, 16)
    assert p.axis_names == ("pod", "data", "model")
    p1 = remesh_plan(256, model=16)
    assert p1.mesh_shape == (16, 16)


def test_remesh_plan_too_small():
    with pytest.raises(ValueError):
        remesh_plan(8, model=16)


@pytest.mark.parametrize("chips", [8, 16, 200, 240, 256, 300, 512, 1000])
def test_remesh_plan_equals_the_references(chips):
    """The same plan, or the same refusal (1,000 chips make three pods,
    and no data axis of three pods divides 256 rows)."""
    import dataclasses

    from repro.runtime import remesh_plan as ref_remesh_plan
    try:
        ref = dataclasses.asdict(ref_remesh_plan(chips, model=16))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            remesh_plan(chips, model=16)
        return
    assert dataclasses.asdict(remesh_plan(chips, model=16)) == ref
