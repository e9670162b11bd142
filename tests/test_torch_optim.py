"""The port's optimizer and training launcher against the reference's, on
the CPU at reduced size: AdamW's update given the same numpy gradients
(with and without clipping and a schedule), the LR schedules, int8
gradient compression, and ``launch.train.main``'s checkpoint-resume.

Tolerances: AdamW's parameters, moments and grad norm, and the schedules'
multipliers, within rtol = atol = 1e-6 (``ADAM_TOL``); compression's int8
codes equal and its residuals within two float32 ulps of the largest
input; the launcher's resumed losses equal the uninterrupted run's (the
CPU's sums are deterministic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import AdamW, AdamWState  # noqa: E402
from repro_torch.tree import flatten_with_path, tree_map  # noqa: E402
from test_torch_train import _rand_like, _ref_tree, _setup  # noqa: E402

ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "falcon-mamba-7b"))
@pytest.mark.parametrize("step", [0, 6])
@pytest.mark.parametrize("clip_norm", [1.0, 0.0, 1e4])
def test_adamw_update_matches_the_reference(arch, step, clip_norm):
    """One update from the same params, moments and numpy gradients."""
    _, rcfg, tree, _ = _setup(arch)
    grads = _rand_like(tree, 1, 0.01)
    m = _rand_like(tree, 2, 0.001)
    v = jax.tree.map(np.abs, _rand_like(tree, 3, 1e-5))
    ref_opt = RefAdamW(clip_norm=clip_norm)
    r_state = ref_opt.init(tree)._replace(
        step=jnp.int32(step), m=jax.tree.map(jnp.asarray, m),
        v=jax.tree.map(jnp.asarray, v))
    r_p, r_s, r_metrics = jax.jit(ref_opt.update)(
        jax.tree.map(jnp.asarray, grads), r_state,
        jax.tree.map(jnp.asarray, tree))

    t = lambda tr: tree_map(lambda a: torch.from_numpy(np.array(a)), tr)
    opt = AdamW(clip_norm=clip_norm)
    state = AdamWState(torch.tensor(step, dtype=torch.int32), t(m), t(v))
    params = t(tree)
    p, s, metrics = opt.update(t(grads), state, params)
    assert int(s.step) == step + 1 and s.step.dtype == torch.int32
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(r_metrics["grad_norm"]), **ADAM_TOL)
    for port, ref in ((p, r_p), (s.m, r_s.m), (s.v, r_s.v)):
        fp, fr = flatten_with_path(port), flatten_with_path(
            jax.tree.map(np.asarray, ref))
        assert list(fp) == list(fr)
        for k in fp:
            assert fp[k].dtype == torch.float32, k
            np.testing.assert_allclose(fp[k].numpy(), fr[k], **ADAM_TOL,
                                       err_msg=k)
    # functional: the inputs are untouched
    for k, a in flatten_with_path(params).items():
        assert np.array_equal(a.numpy(), flatten_with_path(tree)[k])


def test_launcher_resumes_at_the_saved_step(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 4 steps with a checkpoint every 2,
    then a run to 6 with ``--resume`` that starts at step 4 and gives the
    uninterrupted run's losses (the CPU's sums are deterministic)."""
    base = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = launch_train.main(base + ["--steps", "4"])
    assert len(first["losses"]) == 4 and first["start_step"] == 0
    assert [c["step"] for c in first["checkpoints"]] == [2, 4]
    resumed = launch_train.main(base + ["--steps", "6", "--resume"])
    assert resumed["start_step"] == 4 and len(resumed["losses"]) == 2
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "[train] step     5 loss" in out
    straight = launch_train.main(["--arch", "granite-moe-1b-a400m",
                                  "--reduced", "--device", "cpu", "--batch",
                                  "2", "--seq", "16", "--steps", "6"])
    assert straight["losses"][4:] == resumed["losses"]
    assert straight["losses"][:4] == first["losses"]
    assert int(resumed["final_state"].opt.step) == 6
    for k, a in flatten_with_path(straight["final_state"]).items():
        assert torch.equal(a, flatten_with_path(resumed["final_state"])[k]), k


def test_launcher_refuses_without_a_gpu_and_on_bad_args(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                           "--steps", "1"])
    with pytest.raises(ValueError, match="use_pallas=True"):
        launch_train.main(["--arch", "falcon-mamba-7b", "--reduced",
                           "--device", "cpu", "--steps", "1",
                           "--use-pallas"])


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5)])
def test_schedules_equal_the_references(warmup, total):
    from repro.optim.schedules import constant as ref_constant
    from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
    from repro_torch.optim.schedules import constant, warmup_cosine
    port, ref = warmup_cosine(warmup, total), ref_warmup_cosine(warmup, total)
    for step in range(14):
        np.testing.assert_allclose(
            float(port(torch.tensor(step, dtype=torch.int32))),
            float(ref(jnp.int32(step))), **ADAM_TOL, err_msg=str(step))
    assert float(constant()(torch.tensor(3, dtype=torch.int32))) == \
        float(ref_constant()(jnp.int32(3))) == 1.0


def test_adamw_with_a_schedule_matches_the_reference():
    from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
    from repro_torch.optim.schedules import warmup_cosine
    tree = _ref_tree("deepseek-7b")
    grads = _rand_like(tree, 7, 0.01)
    ref_opt = RefAdamW(schedule=ref_warmup_cosine(2, 10))
    r_state = ref_opt.init(tree)._replace(step=jnp.int32(3))
    r_p, _, r_metrics = jax.jit(ref_opt.update)(
        jax.tree.map(jnp.asarray, grads), r_state,
        jax.tree.map(jnp.asarray, tree))
    t = lambda tr: tree_map(lambda a: torch.from_numpy(np.array(a)), tr)
    opt = AdamW(schedule=warmup_cosine(2, 10))
    state = opt.init(t(tree))._replace(step=torch.tensor(3,
                                                         dtype=torch.int32))
    p, _, metrics = opt.update(t(grads), state, t(tree))
    np.testing.assert_allclose(float(metrics["lr"]), float(r_metrics["lr"]),
                               **ADAM_TOL)
    fr = flatten_with_path(jax.tree.map(np.asarray, r_p))
    for k, v in flatten_with_path(p).items():
        np.testing.assert_allclose(v.numpy(), fr[k], **ADAM_TOL, err_msg=k)


def test_compress_grads_equal_the_references():
    """int8 quantisation with error feedback: the same int8 codes and
    scales, and residuals within two float32 ulps of the largest input."""
    from repro.optim import compress_grads as ref_compress_grads
    from repro.optim import init_residual as ref_init_residual
    from repro_torch.optim import compress_grads, dequantize_int8, \
        init_residual
    grads = _rand_like(_ref_tree("granite-moe-1b-a400m"), 5, 0.01)
    residual = _rand_like(grads, 6, 1e-4)
    rq, rs, rr = jax.jit(ref_compress_grads)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, residual))
    t = lambda tr: tree_map(lambda a: torch.from_numpy(np.array(a)), tr)
    q, s, r = compress_grads(t(grads), t(residual))
    fq, fs, fr = (flatten_with_path(x) for x in (q, s, r))
    rfq, rfs, rfr = (flatten_with_path(jax.tree.map(np.asarray, x))
                     for x in (rq, rs, rr))
    for k in rfq:
        assert fq[k].dtype == torch.int8, k
        assert np.array_equal(fq[k].numpy(), rfq[k]), k
        np.testing.assert_allclose(float(fs[k]), float(rfs[k]), rtol=1e-7)
        # the residual x - q·scale within two float32 ulps of the largest
        # |x|: XLA may fuse the product into the subtraction (no rounding
        # of q·scale, up to half an ulp of it here), and each rounds the
        # difference (half an ulp of it each)
        x = flatten_with_path(grads)[k] + flatten_with_path(residual)[k]
        ulp = 2 * float(np.spacing(np.abs(x).max()))
        np.testing.assert_allclose(fr[k].numpy(), rfr[k], rtol=0, atol=ulp)
        back = dequantize_int8(fq[k], fs[k]) + fr[k]
        np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=ulp)
    zeros = init_residual(t(grads))
    ref_zeros = ref_init_residual(grads)
    assert list(flatten_with_path(zeros)) == list(flatten_with_path(
        ref_zeros))
    assert all(not z.any() for z in flatten_with_path(zeros).values())
