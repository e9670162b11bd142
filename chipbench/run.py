"""Run one cell of the benchmark once, and print its result line.

    python3 -m chipbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is the JSON result; the last lines
of standard error are the numbers compared, each beside its limit.  With
no CUDA device, too few of them, the program missing, or a JAX module
loaded by the end, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from chipbench import bench  # noqa: E402


def _environment(root) -> None:
    """Caches inside the checkout, at fixed paths; no library may load JAX
    on the program's behalf; no results store outside the checkout."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("REPRO_RESULTS_STORE", None)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _fail(message: str, code: int) -> int:
    print(f"chipbench: {message}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        return _fail("--seed must be a whole number >= 0", 2)

    root = bench.ROOT
    spec = bench.load_benchmark(root)
    entry = bench.workload(spec, args.workload)
    if not (root / "src" / "repro_torch" / "__init__.py").is_file():
        return _fail("the program (src/repro_torch) is not in this "
                     "checkout", 3)
    _environment(root)

    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device is available", 4)
    if torch.cuda.device_count() < entry["chips"]:
        return _fail(f"the cell needs {entry['chips']} CUDA devices, "
                     f"{torch.cuda.device_count()} are visible", 4)

    outcome, metrics, entry = bench.run_cell(
        args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), t_start=T_START, root=root)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if args.trace:
        device["busy_s"] = outcome.busy_s
        device["window_s"] = outcome.window_s

    loaded = bench.forbidden_loaded()
    if loaded:
        return _fail(f"modules loaded that no run may load: {loaded}", 5)
    line = bench.result_line(outcome, metrics, device, bool(args.trace))
    if args.trace:
        kept = {k: v for k, v in outcome.facts.items()
                if not isinstance(v, list)}
        (root / "chipbench" / "out").mkdir(exist_ok=True)
        (root / "chipbench" / "out" / f"{args.workload}.{args.seed}.json"
         ).write_text(json.dumps({"facts": kept, "notes": outcome.notes,
                                  "result": line}, default=str))
    sys.stdout.flush()
    print(f"notes {json.dumps(outcome.notes, default=str)}", file=sys.stderr)
    for text in bench.check_lines(outcome):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
