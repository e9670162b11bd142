"""The control of a cell's check, and the program's own readings, over
several seeds in one process: the numbers each limit is set from.

    python3 -m chipbench.control --workload <name> --seeds 1,2,3 --seconds 20

Each seed is one run of the cell at its own load (a window of
``--seconds``) whose check judges the control in the program's place: for
a served model the reference in float8, for the lockVM the reference with
a broken coherence cost.  Prints one JSON line a seed: whether the check
came out correct (it must not), the control's reading of each compared
number, and the program's in ``program``.  Exits 1 if any seed's control
came out correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from chipbench import bench, run as run_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    run_mod._environment(bench.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chipbench.control: no CUDA device is available",
              file=sys.stderr)
        return 4
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out, _, _ = bench.run_cell(args.workload, seed=seed,
                                   seconds=args.seconds, trace=False,
                                   t_start=time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "correct": out.correct,
                          "checks": {c.name: c.value for c in out.checks},
                          **out.notes}, default=str), flush=True)
        if out.correct:
            passed.append(seed)
        torch.cuda.empty_cache()
    if passed:
        print(f"chipbench.control: the control came out correct on seeds "
              f"{passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
