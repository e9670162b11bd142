"""Small sizes at which the tests drive the benchmark on the CPU."""

from __future__ import annotations

import sys
import time

from chipbench import bench

SRC = str(bench.ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

ARCH = {"name": "tiny-mamba", "family": "ssm", "n_layers": 2, "d_model": 64,
        "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab": 512,
        "layer_pattern": ["mamba"], "ssm_state": 8, "ssm_conv": 4,
        "ssm_expand": 2, "dt_rank": 4, "subquadratic": True,
        "dtype": "float32", "rms_eps": 1e-6, "tie_embeddings": False}
# float32 throughout: the program's served tokens are the reference's best
# to rounding, so the check's limit is small.  At this width the weights'
# scale is raised so that the decode state moves the next token.
SERVE_CONFIG = {"arch": ARCH, "init_std": 0.3,
                "limits": {"served_gap": 1e-3}}
SERVE_TRAFFIC = {"prompt_tokens": {"median": 20, "sigma": 0.6, "min": 8,
                                   "max": 48},
                 "new_tokens": {"median": 5, "sigma": 0.4, "min": 2, "max": 8},
                 "lanes": 4,
                 "lead_s": 0.3, "rate_per_s": 20.0, "block": 32, "strata": 8,
                 "check_served_tokens": 30}
LOCKVM_CONFIG = {"horizon": 1500}
LOCKVM_TRAFFIC = {"calls": [[{"locks": ["ticket", "twa"], "threads": [2, 4],
                              "seeds": 1, "collect_latency": True}]],
                  "check_events": 10 ** 9}


def patches(name: str) -> tuple:
    if name.startswith("falcon-mamba-7b"):
        return SERVE_CONFIG, SERVE_TRAFFIC
    return LOCKVM_CONFIG, LOCKVM_TRAFFIC


# The serve driver's two loops: arrivals on a schedule, and clients that
# keep every lane busy.
OPEN = {"loop": "open"}
CLOSED = {"loop": "closed", "clients": 32}


def run(name: str, seed: int = 2**31 + 11, seconds: float = 1.0,
        root=bench.ROOT, traffic: dict | None = None,
        control: bool = False):
    config, patch = patches(name)
    return bench.run_cell(name, seed=seed, seconds=seconds, trace=False,
                          device="cpu", t_start=time.perf_counter(),
                          root=root, config_patch=config,
                          traffic_patch={**patch, **(traffic or {})},
                          control=control)
