"""The knee of an open-loop serve mix on a configuration: the mix at a
ladder of rates, and the highest rate the program sustains without a
growing backlog (found before a cell at a fixed rate is defined).

    python3 -m chipbench.knee --config falcon-mamba-7b \\
        --traffic code-poisson --seed 1 --seconds 30 --rates 2,2.5,3,3.5,4

One process makes the weights once; each rate gets a fresh engine, the
cell's lead-in and a window of ``--seconds``.  A rate is sustained when
the window admits at least 97% of the requests it offered and the
backlog (requests sent and not yet admitted), fitted over the window,
grows by less than one request in ten seconds.  Prints one JSON line a
rate, then the highest rate sustained.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from chipbench import bench, run as run_mod  # noqa: E402


def rung(cell, weights, serve) -> dict:
    import torch

    _, engine, loop, _, _ = serve.build(cell, weights)
    backlog = []
    with torch.inference_mode():
        serve.warm_up(engine, cell.traffic, cell.config["arch"]["vocab"])
        engine.admissions.clear()
        t0 = time.perf_counter()
        loop.start(t0)
        loop.run_until(t0 + cell.traffic["lead_s"])
        w0 = time.perf_counter()
        loop.open_window(w0)
        n_adm0 = len(engine.admissions)
        while time.perf_counter() < w0 + cell.seconds:
            loop.run_until(min(time.perf_counter() + 0.5,
                               w0 + cell.seconds))
            backlog.append((time.perf_counter() - w0,
                            len(loop.records) - len(engine.admissions)))
        w1 = time.perf_counter()
    offered = sum(1 for r in loop.records if w0 <= r["due"] < w1)
    admitted = len(engine.admissions) - n_adm0
    t, b = np.asarray(backlog, dtype=float).T
    slope = float(np.polyfit(t, b, 1)[0]) if len(t) > 1 else 0.0
    facts = serve.window_facts(loop, cell.config["arch"], w0, w1)
    return {"rate_per_s": cell.traffic["rate_per_s"],
            "offered": offered, "admitted": admitted,
            "backlog_slope_per_s": slope, "backlog_end": int(b[-1]),
            "ttft_p90_ms": bench.reader("ttft_p90_ms")(facts),
            "sustained": admitted >= 0.97 * offered and slope < 0.1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    run_mod._environment(bench.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chipbench.knee: no CUDA device is available", file=sys.stderr)
        return 4
    spec = bench.load_benchmark()
    base = bench.traffic(args.traffic)
    if base.get("loop") != "open":
        print("chipbench.knee: the mix's loop is not open", file=sys.stderr)
        return 2
    serve = bench.driver(base["driver"])
    weights, best = None, None
    for rate in (float(r) for r in args.rates.split(",")):
        cell = bench.Cell(name=f"{args.config}.{args.traffic}",
                          config=bench.config(spec, args.config),
                          traffic={**base, "rate_per_s": rate},
                          seed=args.seed, seconds=args.seconds, trace=False,
                          t_start=T_START)
        if weights is None:
            weights = serve.build(cell)[0]
        row = rung(cell, weights, serve)
        print(json.dumps(row), flush=True)
        if row["sustained"]:
            best = rate
    print(json.dumps({"highest_sustained_rate_per_s": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
