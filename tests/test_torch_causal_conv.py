"""The causal conv's wrapper and its routing in the Mamba mixer, on the CPU.

``kernels/causal_conv`` holds the Mamba-1 mixer's depthwise causal conv
with its bias and SiLU as one CUDA kernel (``csrc/causal_conv.cu``) beside
its plain version (``ref.py``, the stack of shifted views and the einsum
that ``layers.mamba_block`` ran before).  The mixer's ``scan`` mode picks
both of its kernels: ``"auto"`` launches the conv kernel for CUDA tensors,
``"torch"`` or a CPU tensor runs the plain version.  So on the CPU the
wrapper and ``mamba_block`` give the pre-kernel stack + einsum bit for bit
and launch nothing.  The kernel's device code is held to the plain version
in ``tests/test_torch_rehearsal_conv.py``, and on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import get_config
from repro_torch.kernels.causal_conv import (MODES, causal_conv,
                                             causal_conv_ref, kernel)
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.models import layers as L
from repro_torch.models import model as M


def _args(B=2, S=12, d=16, kw=4, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    full = torch.randn((B, S, 2 * d), generator=gen).to(dtype)
    return (full.chunk(2, -1)[0],
            torch.randn((d, kw), generator=gen).to(dtype),
            torch.randn((d,), generator=gen).to(dtype))


def _stack_einsum(x, w, b):
    """The conv as ``mamba_block`` computed it before the kernel: the pad,
    kw shifted copies stacked, the einsum, the bias, the SiLU; the tail the
    padded input's last kw-1 rows."""
    S, kw = x.shape[1], w.shape[1]
    xpad = F.pad(x, (0, 0, kw - 1, 0))
    shifted = torch.stack([xpad[:, i:i + S] for i in range(kw)], dim=3)
    conv = torch.einsum("bsdk,dk->bsd", shifted, w) + b
    return F.silu(conv), xpad[:, -(kw - 1):].clone()


def _old_mamba_block(p, x, cfg, scan):
    """``layers.mamba_block`` as it was before the conv kernel."""
    xin, z = L._halves(x, p["in_proj"], "inner")
    xin, tail = _stack_einsum(xin, p["conv_w"], p["conv_b"])
    xin = L._inner(xin)
    dt, Bm, Cm = L._ssm_inputs(p, xin, cfg)
    y, h_final = L.selective_scan(xin, L._inner(dt), L._ssm_A(p, xin.dtype),
                                  Bm, Cm, p["D_skip"], mode=scan)
    y = L._inner(y) * F.silu(z)
    out = L._residual(torch.einsum("bsk,kd->bsd", y, p["out_proj"]))
    return out, (h_final, tail)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_is_the_stack_and_einsum(dtype):
    for S in (1, 2, 3, 40):
        args = _args(S=S, dtype=dtype, seed=S)
        y, tail = causal_conv_ref(*args)
        old_y, old_tail = _stack_einsum(*args)
        assert torch.equal(y, old_y) and torch.equal(tail, old_tail)
        assert y.dtype == tail.dtype == dtype


def test_the_wrapper_runs_its_plain_version_on_cpu_tensors():
    args = _args(B=3, S=20, d=24)
    before = kernel.launches
    y, tail = kernel.causal_conv(*args)
    ry, rtail = causal_conv_ref(*args)
    assert torch.equal(y, ry) and torch.equal(tail, rtail)
    # the public op: auto on CPU tensors is the plain path, as torch is
    for mode in MODES:
        my, mtail = causal_conv(*args, mode=mode)
        assert torch.equal(my, ry) and torch.equal(mtail, rtail)
    assert kernel.launches == before      # no kernel launched on the CPU
    with pytest.raises(ValueError, match="scan mode"):
        causal_conv(*args, mode="pallas")


def test_the_wrapper_checks_its_inputs():
    x, w, b = _args()

    def call(i, t):
        args = [x, w, b]
        args[i] = t
        return kernel.causal_conv(*args)

    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        kernel.causal_conv(x.half(), w.half(), b.half())
    with pytest.raises(TypeError, match="w must be x's dtype"):
        call(1, w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="b must be x's dtype"):
        call(2, b.double())
    with pytest.raises(ValueError, match="x must be"):
        call(0, x[0])
    with pytest.raises(ValueError, match="w has shape"):
        call(1, w[:-1])
    with pytest.raises(ValueError, match="w has shape"):
        call(1, torch.zeros(16, 5))       # a width the kernel does not take
    with pytest.raises(ValueError, match="b has shape"):
        call(2, b[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        call(1, torch.zeros(4, 16).t())
    with pytest.raises(ValueError, match="channels must be contiguous"):
        call(0, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="is on"):
        call(2, b.to("meta"))
    with pytest.raises(ValueError, match="empty"):
        call(0, x[:, :0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.causal_conv(*(t.to("meta") for t in (x, w, b)))


def test_the_guard_refuses_autograd_before_the_device_check():
    meta = [t.to("meta") for t in _args()]
    for which in range(3):
        args = [t.clone() for t in meta]
        args[which].requires_grad_(True)
        with pytest.raises(RuntimeError, match="the causal-conv kernel has "
                           "no backward pass"):
            kernel.causal_conv(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            kernel.causal_conv(*args)
    # on CPU tensors the plain version runs, and autograd differentiates it
    x, w, b = (t.requires_grad_(True) for t in _args())
    y, _ = kernel.causal_conv(x, w, b)
    y.sum().backward()
    assert all(t.grad is not None for t in (x, w, b))


def test_the_run_length_adapts_to_the_shape():
    """Long prompts walk the longest runs; a short one still gives each of
    132 SMs kernel.FILL threads, down to kernel.MIN_RUN."""
    di = 8192
    assert kernel.run_length(1, 10_857, di) == kernel.MAX_RUN
    assert kernel.run_length(1, 256, di) == kernel.MIN_RUN
    for S in (1, 256, 2048, 10_857):
        run = kernel.run_length(1, S, di)
        assert kernel.MIN_RUN <= run <= kernel.MAX_RUN
        assert run & (run - 1) == 0 and run % kernel.UNROLL == 0
        threads = di // kernel.CHANNELS * -(-S // run)
        assert run == kernel.MIN_RUN or threads >= 132 * kernel.FILL
        assert run == kernel.MAX_RUN or \
            di // kernel.CHANNELS * -(-S // (2 * run)) < 132 * kernel.FILL
    assert kernel.run_length(3, 2048, di) >= kernel.run_length(1, 2048, di)


@pytest.mark.parametrize("S", [1, 2, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_takes_the_plain_conv_on_the_cpu(S, dtype):
    """``mamba_block`` on CPU tensors, with ``scan`` "auto" and "torch",
    gives the pre-kernel block's output, state and tail bit for bit, and
    launches neither kernel."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              dtype=dtype)
    gen = torch.Generator().manual_seed(S)
    params = M.init_params(cfg, gen, device="cpu")
    p = {k: v[0] for k, v in params["stack"]["slot0"].items()}
    # the init's bias is zeros: give it values
    p["conv_b"] = (0.5 * torch.randn(p["conv_b"].shape, generator=gen)).to(
        p["conv_b"].dtype)
    x = torch.randn((2, S, cfg.d_model), generator=gen).to(
        getattr(torch, dtype))
    before = (kernel.launches, scan_kernel.launches)
    old = _old_mamba_block(p, x, cfg, "torch")
    for scan in MODES:
        out, (ssm, tail) = L.mamba_block(p, x, cfg, scan)
        assert torch.equal(out, old[0])
        assert torch.equal(ssm, old[1][0]) and torch.equal(tail, old[1][1])
        assert tail.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    assert (kernel.launches, scan_kernel.launches) == before
