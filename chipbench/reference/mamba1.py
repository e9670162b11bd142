"""The Mamba-1 stack's plain reference, and the weights both sides take.

:func:`make_weights` draws the weights from the seed on the device, leaf by
stacked leaf, in the tree the program takes (``embed``, ``final_norm``,
``stack/slot0/<name>`` stacked over the layers, ``tail``, ``lm_head``).
Initial values follow the repo's convention for this stack: normal × 0.02
(the configuration's ``init_std``) for the projections, the conv, the
embedding and the head; ``A_log`` = log(1..N) in float32; ``dt_bias`` -4.6
(softplus⁻¹(0.01)); ``D_skip`` ones; the norms' scales and the conv bias
zeros.

:func:`served_gaps` is the check: the reference's float32 forward over a
prompt and the tokens served for it, and for each served token the gap by
which its logit lies below the reference's best at its position.  The
forward follows the program's equations for this stack, in float32 with
TF32 off, layer by layer (each layer's weights cast as it is reached):

    x = embed[tokens] · sqrt(d)
    per layer: h = rmsnorm(x)·(1 + ln1); (u, z) = h W_in;
      u = silu(causal depthwise conv(u) + conv_b);
      (dt_in, B, C) = u W_x; dt = softplus(dt_in W_dt + dt_bias);
      A = -exp(A_log); h_t = exp(dt_t ⊗ A) h_{t-1} + (dt_t u_t) ⊗ B_t;
      y_t = h_t · C_t + D u_t; x = x + (y ⊙ silu(z)) W_out
    logits = rmsnorm(x)·(1 + final_norm) W_head

The scan is the plain sequential loop, one step at a time, its state in
float32.  With ``control=True`` the forward is computed one precision below
the program's bfloat16: every weight and every activation that the program
holds in bfloat16 is rounded to float8 e4m3, with one scale a row.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8 e4m3fn
SCAN_BLOCK = 256    # steps of the scan's inputs expanded at a time


def shapes(arch: dict) -> dict:
    """(shape, init) of each leaf of the program's parameter tree."""
    d, V = arch["d_model"], arch["vocab"]
    Vp = (V + 255) // 256 * 256
    di = arch["ssm_expand"] * d
    N, kw = arch["ssm_state"], arch["ssm_conv"]
    dtr = arch.get("dt_rank") or math.ceil(d / 16)
    P = arch["n_layers"]
    layer = {"ln1": ((d,), "zeros"), "in_proj": ((d, 2 * di), "normal"),
             "conv_w": ((di, kw), "normal"), "conv_b": ((di,), "zeros"),
             "A_log": ((di, N), "a_log"),
             "x_proj": ((di, dtr + 2 * N), "normal"),
             "dt_proj": ((dtr, di), "normal"),
             "dt_bias": ((di,), "dt_bias"), "D_skip": ((di,), "ones"),
             "out_proj": ((di, d), "normal")}
    return {"embed": ((Vp, d), "normal"), "final_norm": ((d,), "zeros"),
            "slot0": {k: ((P,) + s, init) for k, (s, init) in layer.items()},
            "lm_head": ((d, Vp), "normal")}


def make_weights(arch: dict, seed: int, device, dtype=torch.bfloat16,
                 std: float = 0.02):
    """The weights, drawn on ``device`` from ``seed`` (a generator on that
    device; one draw a stacked leaf, in the weights' dtype); ``std`` is
    the normal leaves' scale."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def leaf(shape, init):
        if init == "normal":
            return torch.randn(shape, generator=g, dtype=dtype,
                               device=device).mul_(std)
        if init == "a_log":
            n = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(n).expand(shape).contiguous()
        value = {"zeros": 0.0, "ones": 1.0, "dt_bias": -4.6}[init]
        return torch.full(shape, value, dtype=dtype, device=device)

    tree = shapes(arch)
    return {"embed": leaf(*tree["embed"]),
            "final_norm": leaf(*tree["final_norm"]),
            "stack": {"slot0": {k: leaf(*v)
                                for k, v in tree["slot0"].items()}},
            "tail": [], "lm_head": leaf(*tree["lm_head"])}


def _fp8(t):
    """``t`` rounded to float8 e4m3 with one scale a row of its last dim:
    what the control holds wherever the program holds bfloat16."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _keep(t):
    return t


def _rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _scan(u, dt, A, B, C, D):
    """The selective scan over one sequence, float32, one step at a time:
    u, dt (L, di); A (di, N); B, C (L, N); D (di,)."""
    L, di = u.shape
    h = torch.zeros(di, A.shape[1], dtype=torch.float32, device=u.device)
    ys = []
    for t0 in range(0, L, SCAN_BLOCK):
        t1 = min(L, t0 + SCAN_BLOCK)
        dA = torch.exp(dt[t0:t1, :, None] * A)
        H = (dt[t0:t1] * u[t0:t1])[:, :, None] * B[t0:t1, None, :]
        for i in range(t1 - t0):     # h_t = dA_t h_{t-1} + dBu_t, in place
            h = torch.addcmul(H[i], dA[i], h, out=H[i])
        ys.append((H * C[t0:t1, None, :]).sum(-1))
        del dA, H
    return torch.cat(ys) + D * u


def _layer(p, x, arch: dict, q):
    """One layer; ``q`` rounds what the program holds in its dtype (the
    identity, or :func:`_fp8` for the control)."""
    eps = arch.get("rms_eps", 1e-6)
    kw = arch["ssm_conv"]
    N = arch["ssm_state"]
    f = {k: v.float() if k == "A_log" else q(v.float())
         for k, v in p.items()}
    h = q(_rms(x, f["ln1"], eps))
    u, z = (q(t) for t in (h @ f["in_proj"]).chunk(2, dim=-1))
    L = u.shape[0]
    upad = F.pad(u, (0, 0, kw - 1, 0))
    conv = q(sum(upad[k:k + L] * f["conv_w"][:, k] for k in range(kw))
             + f["conv_b"])
    u = q(F.silu(conv))
    proj = q(u @ f["x_proj"])
    dtr = proj.shape[-1] - 2 * N
    dt_in, B, C = proj.split([dtr, N, N], dim=-1)
    dt = q(torch.logaddexp(q(dt_in @ f["dt_proj"]) + f["dt_bias"],
                           torch.zeros((), device=x.device)))
    A = q(-torch.exp(f["A_log"]))
    y = q(q(_scan(u, dt, A, B, C, f["D_skip"])) * q(F.silu(z)))
    return q(x + q(y @ f["out_proj"]))


@torch.no_grad()
def logits(weights: dict, arch: dict, tokens, positions,
           control: bool = False):
    """Float32 logits (len(positions), vocab) of the forward over
    ``tokens`` (1-D), at ``positions``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        q = _fp8 if control else _keep
        emb = weights["embed"]
        x = q(q(emb[tokens.to(emb.device)].float())
              * math.sqrt(arch["d_model"]))
        stack = weights["stack"]["slot0"]
        for i in range(arch["n_layers"]):
            x = _layer({k: v[i] for k, v in stack.items()}, x, arch, q)
        x = q(_rms(x[positions], q(weights["final_norm"].float()),
                   arch.get("rms_eps", 1e-6)))
        return q(x @ q(weights["lm_head"].float()))[:, :arch["vocab"]]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def served_gaps(weights: dict, arch: dict, prompt, served,
                control: bool = False):
    """For each served token, the gap by which its logit lies below the
    reference's best at its position (0 where it is the best); with
    ``control``, also the gaps of the tokens that the float8 forward puts
    first at the same positions.  Returns (gaps of ``served``, gaps of
    the control's tokens or None)."""
    tokens = torch.tensor(list(prompt) + list(served[:-1]),
                          dtype=torch.long)
    positions = torch.arange(len(prompt) - 1, len(tokens),
                             device=weights["embed"].device)
    ref = logits(weights, arch, tokens, positions)
    best = ref.max(dim=-1).values
    served_t = torch.tensor(list(served), dtype=torch.long,
                            device=ref.device)
    gaps = best - ref.gather(1, served_t[:, None])[:, 0]
    ctrl_gaps = None
    if control:
        ctrl = logits(weights, arch, tokens, positions, control=True)
        pick = ctrl.argmax(dim=-1)
        ctrl_gaps = best - ref.gather(1, pick[:, None])[:, 0]
    return gaps.cpu(), None if ctrl_gaps is None else ctrl_gaps.cpu()
