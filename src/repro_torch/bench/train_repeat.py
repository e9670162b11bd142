"""Whether a training run on the card repeats itself: the same
``repro_torch.launch.train`` command run several times in one process,
from the same seed, and each run's losses beside the first run's.

    python src/repro_torch/bench/train_repeat.py [--src DIR] [--repeats 2]
        [--remat-none] [--out FILE] [-- TRAIN ARGS]

DIR is the ``src/`` of the tree to import ``repro_torch`` from (default:
this file's tree; the file is run by path, so it works against a tree
that lacks it, for example a parent commit unpacked with ``git archive``).
TRAIN ARGS go to ``launch.train.main`` (default: granite-moe-1b-a400m at
full width, batch 8, seq 512, 6 steps, as ``chip_smoke.py``'s train
phase).  ``--remat-none`` adds one run of the same config with
``remat="none"``.  Prints one JSON object: each run's losses and median
step ms after the first (wall clock), whether each
repeat equals the first run bit for bit, and the largest
|loss - first run's loss| / loss of each.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ARGS = ["--arch", "granite-moe-1b-a400m", "--batch", "8", "--seq",
                "512", "--steps", "6"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.normpath(
        os.path.join(HERE, "..", "..")))
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--remat-none", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("train_args", nargs="*")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.launch import train as launch_train

    train_args = args.train_args or DEFAULT_ARGS

    def run(cfg=None):
        orig = launch_train.get_config
        if cfg is not None:
            launch_train.get_config = lambda name: cfg if name == cfg.name \
                else orig(name)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                res = launch_train.main(train_args)
        finally:
            launch_train.get_config = orig
        step_ms.append(statistics.median(
            res["step_seconds"][1:]) * 1e3)
        return res["losses"]

    step_ms = []
    runs = {f"run_{i}": run() for i in range(args.repeats)}
    if args.remat_none:
        cfg = launch_train.get_config(
            train_args[train_args.index("--arch") + 1])
        runs["remat_none"] = run(dataclasses.replace(cfg, remat="none"))
    first = runs["run_0"]
    out = {"src": os.path.abspath(args.src), "train_args": train_args,
           "runs": runs, "median_step_ms_after_first": step_ms,
           "bit_identical": {k: v == first for k, v in runs.items()
                             if k != "run_0"},
           "max_rel_diff": {k: max(abs(a - b) / abs(b)
                                   for a, b in zip(v, first))
                            for k, v in runs.items() if k != "run_0"}}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
