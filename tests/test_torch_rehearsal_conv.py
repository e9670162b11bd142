"""The causal conv kernel's device code, run on the host, against the plain
version.

``repro_torch.rehearse`` compiles ``csrc/causal_conv_kernel.cuh`` with
``g++`` and the generated constants header the ``nvcc`` build uses, and
runs its thread function for every (sequence, run, channel group).  So the
kernel's output, silu(conv(x) + b), and its tail are held to
``kernels/causal_conv/ref.py`` here, without a card: prompts of 1-5 and
257 positions, the shortest run length ± 1 and twice it + 1, the longest
± 1 (forced), batches of 1 and 3, d_inner 64, 24, 20 (its rows
on 16-byte boundaries in the chunk view, and not a multiple of 8) and 22
(a partial group of channels, its rows on no boundary), x as the
in-projection's strided ``chunk`` view and as a contiguous tensor, widths
2-4, float32 and bf16.  A tail of a prompt shorter than kw-1 is
zero-filled.

Tolerance.  The kernel rounds where the plain version rounds (the conv's
float32 sum to x's dtype, the bias added, the SiLU), and sums k = 0 ..
kw-1 in order with fused multiply-adds; the CPU's einsum takes that order
for a batch but rounds each product first for one sequence, and its SiLU
takes its exponential from another library.  So in bf16, whose products
are exact in float32, the output is within one ulp of the dtype (bit for
bit on every case here).  In float32 one ulp of the output says nothing
where the sum cancels the bias, so the bound is that of
``repro_torch.bench.kernel_pair.conv_bound`` (the sums' forward error
through the SiLU, and 4 ulps of the output for the exponentials), which
the card's tests hold the kernel to as well.  The tail is a copy: bit for
bit.

Each test decides for itself whether ``g++`` is there, and skips if not.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import rehearse
from repro_torch.bench.kernel_pair import conv_bound, ulps_apart
from repro_torch.kernels.causal_conv import causal_conv_ref, kernel


@pytest.fixture
def gxx():
    if rehearse.gxx_path() is None:
        pytest.skip("no g++: the rehearsal programs are built from source")


def _inputs(B, S, d, kw, strided, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    full = torch.randn((B, S, 2 * d), generator=gen).to(dtype)
    # the in-projection's x half as the model takes it, or a copy of it
    x = full.chunk(2, -1)[0] if strided else full[..., :d].clone(
        memory_format=torch.contiguous_format)
    w = torch.randn((d, kw), generator=gen).to(dtype)
    b = torch.randn((d,), generator=gen).to(dtype)
    return x, w, b


# the run length at these shapes (the shortest), and the longest, forced
RUN = kernel.run_length(1, 9, 64)
LONG = kernel.MAX_RUN
S_CASES = sorted({1, 2, 3, 4, 5, 257, RUN - 1, RUN, RUN + 1, 2 * RUN + 1})
CASES = [(S, B, 64, 4, layout, dtype, None) for S in S_CASES
         for B in (1, 3) for layout in ("chunk", "contiguous")
         for dtype in ("float32", "bfloat16")]
CASES += [(S, B, 64, 4, "chunk", dtype, LONG) for S in (LONG - 1, LONG + 1)
          for B in (1, 3) for dtype in ("float32", "bfloat16")]
CASES += [(S, B, d, 4, layout, dtype, None) for S in (3, 257) for B in (1, 3)
          for d in (20, 22) for layout in ("chunk", "contiguous")
          for dtype in ("float32", "bfloat16")]
CASES += [(9, 3, 24, kw, "chunk", dtype, None) for kw in (2, 3)
          for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("S,B,d,kw,layout,dtype,run", CASES)
def test_conv_device_code_matches_plain(gxx, S, B, d, kw, layout, dtype,
                                        run):
    dt = getattr(torch, dtype)
    x, w, b = _inputs(B, S, d, kw, layout == "chunk", dt,
                      seed=S * 1000 + B * 100 + d + kw)
    assert x.stride(1) == (2 * d if layout == "chunk" else d)
    # a run length ± 1 covers one run short, whole and one over
    assert kernel.run_length(B, S, d) == RUN
    y, tail = rehearse.causal_conv(x, w, b, run=run)
    ry, rtail = causal_conv_ref(x, w, b)
    assert y.dtype == tail.dtype == dt
    assert y.shape == (B, S, d) and tail.shape == (B, kw - 1, d)
    assert torch.equal(tail, rtail)
    if S < kw - 1:
        assert not tail[:, :kw - 1 - S].any()
    assert bool(torch.isfinite(y).all())
    if dt == torch.bfloat16:
        assert int(ulps_apart(y, ry).max()) <= 1
    else:
        err = (y.double() - ry.double()).abs()
        assert bool((err <= conv_bound(x, w, b, ry)).all()), float(err.max())
