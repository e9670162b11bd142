"""Least time one H100 SXM could take for the work of the two TPU kernels
not ported yet, at the shapes their serve paths give them.

    PYTHONPATH=src python -m repro_torch.bench.kernel_bounds

The bound is the larger of the bytes the function must move (each input
read once, each output written once) over the card's memory rate and its
operations over the card's 32-bit rate outside the tensor cores (NVIDIA's
data sheet, 700 W part).  Shapes are one prefill of a 256-token prompt
(the longest the serve traffic of ``chip_smoke.py`` draws), per layer and
per sequence, in the configs' bf16:

* the Mamba-1 selective scan (reference ``repro/kernels/mamba_scan``), per
  (t, d, n) ``exp(dt·A)``, ``dt·x·B``, the update of h and its product
  with C — seven operations; inputs x, dt (L, D), A (D, N), B, C (L, N),
  D_skip (D,), h0 (D, N); outputs y (L, D) and h (D, N);
* the RG-LRU scan (reference ``repro/kernels/rglru``), per (t, d) one
  multiply-add; inputs a, b (L, D), h0 (D,); outputs y (L, D), h (D,).
"""

from __future__ import annotations

import json

from ..configs import get_config

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
PROMPT = 256
ELEM = 2  # bf16


def bound_ms(nbytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mamba_scan(L: int, D: int, N: int) -> dict:
    nbytes = ELEM * (3 * L * D + 3 * D * N + 2 * L * N + D)
    return _row("_scan_kernel", f"L={L} D={D} N={N}", nbytes,
                7 * L * D * N + 2 * L * D)


def rglru_scan(L: int, D: int) -> dict:
    return _row("_rglru_kernel", f"L={L} D={D}", ELEM * (3 * L * D + 2 * D),
                2 * L * D)


def _row(kernel, shape, nbytes, n_ops) -> dict:
    ms, by = bound_ms(nbytes, n_ops)
    return {"kernel": kernel, "shape": shape, "bytes": nbytes,
            "operations": n_ops, "bound_ms": ms, "bound_by": by}


def main() -> list:
    mamba = get_config("falcon-mamba-7b")
    griffin = get_config("recurrentgemma-9b")
    rows = [dict(mamba_scan(PROMPT, mamba.d_inner, mamba.ssm_state),
                 arch=mamba.name),
            dict(rglru_scan(PROMPT, griffin.lru_width), arch=griffin.name)]
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
