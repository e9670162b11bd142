"""The port's serve path against the reference's: ``ServeEngine`` on the
same prompts with the same weights gives the same greedy tokens; FIFO
admission, lane reuse, the gate registry and poll telemetry, and the
``LockTrace`` file format that both packages read.

Tolerance: the logits of every sampling call agree within rtol 1e-5 and
atol 1e-5 (``LOGIT_TOL``, float32 on the CPU), and at every call the
top-2 margin of every row that yields a token is above 10× that, so a
token mismatch names a real difference, not a near-tie.  Tokens must be
equal.
"""

import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve.engine as ref_engine_mod
from repro.configs import get_config as ref_config
from repro.models.model import init_params as ref_init_params
from repro.serve import admission as ref_admission
from repro.serve import trace as ref_trace
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import init_params, params_from_numpy
from repro_torch.serve import (FissileTWAGate, LockTraceRecorder, RWTWAGate,
                               ServeEngine, TicketGate, TWAGate,
                               gate_kind_for_lock, load_trace, make_gate)
from repro_torch.serve import admission
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.kv_cache import insert_prefill
from repro_torch.serve.trace import TRACE_VERSION
from repro_torch.sim.programs import SIM_LOCKS

LOGIT_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_sampling(monkeypatch, module, box, calls):
    """Wrap ``module.sample`` to keep each call's logits and the lanes that
    held a request when it ran (``box[0]`` is the engine)."""
    original = module.sample

    def recording(logits, *args, **kw):
        eng = box[0]
        active = [l for l in range(eng.lanes) if eng.lane_req[l] is not None]
        host = logits.cpu().numpy() if hasattr(logits, "cpu") else logits
        calls.append((np.asarray(host, np.float32), active))
        return original(logits, *args, **kw)

    monkeypatch.setattr(module, "sample", recording)


# prompt lengths drawn in [lo, hi): recurrentgemma's reach past its reduced
# window of 32 (the banded prefill, the ring reorder, decode in a wrapped
# ring); gemma3's stay within it once padded to 16 (the engine pads
# attention models, and a padded prompt longer than the window would ring
# its pads, in the reference as in the port)
PROMPT_LENGTHS = {"recurrentgemma-9b": (3, 50)}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-7b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "gemma3-1b"])
def test_greedy_tokens_match_the_reference_engine(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    ref_params = ref_init_params(ref_config(arch).reduced(),
                                 jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params),
                               device=CPU)
    rng = np.random.default_rng(0)
    lo, hi = PROMPT_LENGTHS.get(arch, (3, 21))
    prompts = [rng.integers(1, cfg.vocab, size=int(rng.integers(lo, hi)))
               .tolist() for _ in range(5)]
    if arch in PROMPT_LENGTHS:
        assert max(map(len, prompts)) > cfg.window
    runs = {}
    for name, module, make in (
            ("ref", ref_engine_mod,
             lambda: ref_engine_mod.ServeEngine(cfg, ref_params, lanes=2,
                                                max_ctx=64)),
            ("port", engine_mod,
             lambda: ServeEngine(cfg, params, lanes=2, max_ctx=64,
                                 device=CPU))):
        box, calls = [None], []
        _record_sampling(monkeypatch, module, box, calls)
        eng = box[0] = make()
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        runs[name] = ([r.tokens_out for r in reqs], calls,
                      [r.admitted_at_step for r in reqs])
    (ref_toks, ref_calls, ref_adm), (toks, calls, adm) = runs["ref"], \
        runs["port"]
    assert len(calls) == len(ref_calls) > 5
    for (lg, active), (r_lg, r_active) in zip(calls, ref_calls):
        assert active == r_active and lg.shape == r_lg.shape
        np.testing.assert_allclose(lg, r_lg, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        rows = [0] if r_lg.shape[0] == 1 else r_active
        for r in rows:
            top2 = np.sort(r_lg[r])[-2:]
            assert top2[1] - top2[0] > 10 * LOGIT_TOL, (r, top2)
    assert toks == ref_toks
    assert adm == ref_adm


@pytest.fixture(scope="module")
def small_setup():
    cfg = get_config("deepseek-7b").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


def _mk_engine(cfg, params, **kw):
    kw.setdefault("lanes", 2)
    kw.setdefault("max_ctx", 64)
    return ServeEngine(cfg, params, device=CPU, **kw)


def test_fifo_admission_order(small_setup):
    cfg, params = small_setup
    eng = _mk_engine(cfg, params)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(1, cfg.vocab,
                                    size=rng.integers(3, 9)).tolist(),
                       max_new_tokens=4) for _ in range(7)]
    eng.run()
    for r in reqs:
        assert r.done.is_set()
        assert len(r.tokens_out) == 4
    for a, b in zip(reqs, reqs[1:]):
        assert a.admitted_at_step <= b.admitted_at_step
    assert eng.prefill_count == 7


def test_lane_reuse_matches_fresh_engine(small_setup):
    """A request decoded on a reused lane produces the same tokens as on a
    fresh engine (stale cache rows are invisible)."""
    cfg, params = small_setup
    probe = [3, 1, 4, 1, 5, 9, 2, 6]
    fresh = _mk_engine(cfg, params, lanes=1)
    r_fresh = fresh.submit(probe, max_new_tokens=6)
    fresh.run()
    used = _mk_engine(cfg, params, lanes=1)
    used.submit([7, 7, 7, 7], max_new_tokens=6)
    r_used = used.submit(probe, max_new_tokens=6)
    used.run()
    assert r_fresh.tokens_out == r_used.tokens_out


@pytest.fixture(scope="module")
def mamba_setup():
    cfg = get_config("falcon-mamba-7b").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


@pytest.mark.parametrize("probe", [[3], [3, 1], [3, 1, 4, 1, 5, 9, 2, 6]])
def test_mamba_lane_reuse_matches_fresh_engine(mamba_setup, probe):
    """A Mamba lane that served a long request, and decoded on while idle,
    gives a new request the state of a fresh lane: admission writes the
    whole SSM and conv row, also for prompts shorter than the conv's
    kw-1."""
    cfg, params = mamba_setup
    fresh = ServeEngine(cfg, params, lanes=2, max_ctx=64, device=CPU)
    r_fresh = fresh.submit(probe, max_new_tokens=5)
    fresh.run()
    used = ServeEngine(cfg, params, lanes=2, max_ctx=64, device=CPU)
    used.submit(list(range(1, 31)), max_new_tokens=2)
    used.submit([7, 8, 9], max_new_tokens=9)
    r_used = used.submit(probe, max_new_tokens=5)
    used.run()
    assert r_used.admitted_at_step > 0
    assert r_fresh.tokens_out == r_used.tokens_out


@pytest.fixture(scope="module")
def griffin_setup():
    cfg = get_config("recurrentgemma-9b").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


@pytest.mark.parametrize("probe", [[3], [3, 1], list(range(2, 42))])
def test_griffin_lane_reuse_matches_fresh_engine(griffin_setup, probe):
    """A recurrentgemma lane that served a request longer than the window,
    and decoded on while idle, gives a new request the state of a fresh
    lane: admission writes the whole RG-LRU row and the ring's prompt
    slots, and decode masks the ring's stale slots."""
    cfg, params = griffin_setup
    fresh = ServeEngine(cfg, params, lanes=2, max_ctx=64, device=CPU)
    r_fresh = fresh.submit(probe, max_new_tokens=5)
    fresh.run()
    used = ServeEngine(cfg, params, lanes=2, max_ctx=64, device=CPU)
    used.submit(list(range(1, 46)), max_new_tokens=2)
    used.submit([7, 8, 9], max_new_tokens=9)
    r_used = used.submit(probe, max_new_tokens=5)
    used.run()
    assert r_used.admitted_at_step > 0
    assert r_fresh.tokens_out == r_used.tokens_out


def test_insert_prefill_writes_rings_and_rglru_states(griffin_setup):
    """A local layer's prefill cache is a sequence leaf: a short prompt
    fills slots [0, S) of the ring, a prompt longer than the window fills
    the ring, already in ring order; the RG-LRU ``h`` and ``conv`` leaves
    are written whole."""
    from repro_torch.models.model import forward, init_cache

    cfg, params = griffin_setup
    W = cfg.window
    batch = init_cache(cfg, 2, 64, device=CPU)
    for leaves in (batch["stack"]["slot0"], batch["stack"]["slot2"],
                   batch["tail"][0]):
        for leaf in leaves.values():
            leaf.fill_(7.0)
    for S in (10, W + 13):
        tokens = torch.arange(1, S + 1)[None]
        _, _, new = forward(params, {"tokens": tokens}, cfg,
                            collect_cache=True)
        insert_prefill(batch, new, 1)
        ring = batch["stack"]["slot2"]["k"]             # the local layer
        assert ring.shape[2] == W
        n = min(S, W)
        assert torch.equal(ring[:, 1, :n], new["stack"]["slot2"]["k"][:, 0])
        if S < W:
            assert float(ring[:, 1, n:].min()) == 7.0
        assert batch["stack"]["slot0"].keys() == {"h", "conv"}
        for k in ("h", "conv"):
            assert torch.equal(batch["stack"]["slot0"][k][:, 1],
                               new["stack"]["slot0"][k][:, 0])
            assert torch.equal(batch["tail"][0][k][1], new["tail"][0][k][0])
        assert float(ring[:, 0].min()) == 7.0           # other lane intact


def test_insert_prefill_writes_whole_state_rows():
    """Sequence leaves take the prompt's positions, state leaves the whole
    row; a state leaf that does not fill the row raises."""
    batch = {"stack": {"slot0": {"k": torch.ones(2, 3, 8, 1),
                                 "ssm": torch.ones(2, 3, 4, 2)}},
             "tail": [{"conv": torch.ones(3, 3, 4)}]}
    new = {"stack": {"slot0": {"k": torch.zeros(2, 1, 5, 1),
                               "ssm": torch.zeros(2, 1, 4, 2)}},
           "tail": [{"conv": torch.zeros(1, 3, 4)}]}
    out = insert_prefill(batch, new, 1)
    assert out is batch
    k, ssm = batch["stack"]["slot0"]["k"], batch["stack"]["slot0"]["ssm"]
    assert float(k[:, 1, :5].sum()) == 0 and float(k[:, 1, 5:].min()) == 1
    assert float(ssm[:, 1].abs().sum()) == 0
    assert float(ssm[:, 0].min()) == float(ssm[:, 2].min()) == 1
    assert float(batch["tail"][0]["conv"][1].abs().sum()) == 0
    new["tail"][0]["conv"] = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="state leaf 'conv'"):
        insert_prefill(batch, new, 0)
    new["tail"][0]["conv"] = torch.zeros(1, 3, 4)
    new["stack"]["slot0"]["k"] = torch.zeros(2, 1, 9, 1)
    with pytest.raises(ValueError, match="exceeds"):
        insert_prefill(batch, new, 0)


def test_two_tier_waiting_telemetry(small_setup):
    """Clients far from admission park on the waiting array (slot polls),
    not on the grant counter."""
    cfg, params = small_setup
    eng = _mk_engine(cfg, params, lanes=1)
    n = 6
    reqs = [eng.submit([1 + i, 2, 3], max_new_tokens=3) for i in range(n)]
    waiters = [threading.Thread(target=eng.wait, args=(r,)) for r in reqs]
    for w in waiters:
        w.start()
    runner = threading.Thread(target=eng.run)
    runner.start()
    runner.join(60)
    for w in waiters:
        w.join(10)
    assert not runner.is_alive()
    assert not any(w.is_alive() for w in waiters)
    stats = eng.stats()
    assert stats["long_term_entries"] >= n - 3
    assert stats["slot_polls"] > 0
    assert stats["lock"] == {"source": "default", "gate": "twa"}


def test_gate_registry_matches_the_reference():
    """Every lock of the port's ``SIM_LOCKS`` maps to the same gate in both
    packages, and the map is the reference's."""
    assert admission._GATE_FOR_SIM_LOCK == ref_admission._GATE_FOR_SIM_LOCK
    assert sorted(admission.GATES) == sorted(ref_admission.GATES)
    for lock in SIM_LOCKS:
        gate = make_gate(lock, 2)
        assert gate.kind == gate_kind_for_lock(lock) \
            == ref_admission.make_gate(lock, 2).kind
    g = make_gate("ticket", 2)
    assert isinstance(g, TicketGate) and g.two_tier is False
    assert isinstance(make_gate("fissile-twa", 2), FissileTWAGate)
    with pytest.raises(ValueError, match="unknown gate"):
        make_gate("nope", 2)


def test_gate_counting_semaphore_and_hash_once():
    g = TicketGate(lanes=3, two_tier=True)
    t = [g.draw() for _ in range(5)]
    assert [g.admitted(x) for x in t] == [True, True, True, False, False]
    g.advance()
    assert g.admitted(t[3]) and not g.admitted(t[4])
    assert g.queue_depth() == 1
    gate = TWAGate(1, threshold=1)
    txs = [gate.draw() for _ in range(4)]
    ths = [threading.Thread(target=gate.wait, args=(tx,),
                            kwargs={"timeout_s": 20}) for tx in txs[1:]]
    for th in ths:
        th.start()
    time.sleep(0.08)
    for _ in txs:
        time.sleep(0.02)
        gate.advance()
    for th in ths:
        th.join(20)
    assert not any(th.is_alive() for th in ths)
    st = gate.poll_stats()
    assert st["long_term_entries"] >= 1
    assert st["slot_hashes"] == st["long_term_entries"]
    assert st["slot_polls"] > st["slot_hashes"]
    rw = RWTWAGate(2)
    assert rw.read_metadata(lambda: 42) == 42
    assert rw.poll_stats()["reader_overlap_max"] == 1


def test_lock_trace_files_load_in_both_packages(small_setup, tmp_path):
    cfg, params = small_setup
    eng = _mk_engine(cfg, params, record_trace=True, lock="fissile-twa")
    for i in range(3):
        eng.submit([5 + i, 6, 7], max_new_tokens=3)
    eng.run()
    eng.queue_depth()
    tr = eng.finish_trace()
    assert len(tr) == 3 and tr.gate == "fissile-twa" and len(tr.read_s) == 1
    tr.save(tmp_path / "port.npz")
    back = ref_trace.load_trace(tmp_path / "port.npz")
    rec = ref_trace.LockTraceRecorder(lanes=2, gate="twa")
    for t in range(3):
        rec.on_draw(t)
        rec.on_grant(t)
    rec.on_release(0)
    rec.on_release(2)
    rec.on_read()
    rec.to_trace().save(tmp_path / "ref.npz")
    fwd = load_trace(tmp_path / "ref.npz")
    assert list(fwd.tickets) == [0, 2] and fwd.reader_fraction == 33
    for a, b in ((tr, back), (fwd, ref_trace.load_trace(tmp_path
                                                        / "ref.npz"))):
        for k in ("arrival_s", "grant_s", "release_s", "tickets", "read_s"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
        assert (a.lanes, a.gate, a.name) == (b.lanes, b.gate, b.name)
    assert TRACE_VERSION == ref_trace.TRACE_VERSION
    own = LockTraceRecorder(lanes=1)
    own.on_draw(0)
    with pytest.raises(ValueError, match="no completed"):
        own.to_trace()


def test_engine_lock_resolution_and_auto_raises(monkeypatch):
    monkeypatch.delenv("REPRO_RESULTS_STORE", raising=False)

    def resolve(lock, **kw):
        kw = {"lanes": 2, "two_tier": True, "threshold": 1, "store": None,
              "workload": None, **kw}
        return ServeEngine._make_gate(lock, **kw)

    gate, choice = resolve(None, two_tier=False)
    assert gate.kind == "ticket" and choice["source"] == "default"
    gate, choice = resolve("mcs")
    assert gate.kind == "ticket" and choice == {"source": "explicit",
                                                "gate": "ticket"}
    inst = TWAGate(2)
    assert resolve(inst)[0] is inst
    # "auto" asks the results-store advisor (tests/test_torch_results.py);
    # with no store to ask it raises
    with pytest.raises(ValueError, match="needs a results store"):
        resolve("auto")


def test_engine_device_rules(small_setup, monkeypatch):
    cfg, params = small_setup
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(cfg, params, device="meta")
    with pytest.raises(ValueError, match="dispatch"):
        ServeEngine(cfg, params, device=CPU, dispatch="pallas")
    with pytest.raises(ValueError, match="scan mode"):
        ServeEngine(cfg, params, device=CPU, scan="pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "deepseek-7b", "--reduced"])


def test_launch_serve_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--device", "cpu", "--requests", "3",
                             "--max-new", "4"])
    assert [len(r.tokens_out) for r in out["requests"]] == [4, 4, 4]
    text = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in text and "on cpu" in text


def test_launch_serve_recurrentgemma_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                             "--device", "cpu", "--requests", "3",
                             "--max-new", "4"])
    assert [len(r.tokens_out) for r in out["requests"]] == [4, 4, 4]
    text = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in text and "on cpu" in text


def test_launch_serve_falcon_mamba_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "falcon-mamba-7b", "--reduced",
                             "--device", "cpu", "--requests", "3",
                             "--max-new", "4"])
    assert [len(r.tokens_out) for r in out["requests"]] == [4, 4, 4]
    text = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in text and "on cpu" in text
