"""CLI for the results store: ``python -m repro_torch.sim.results <cmd>``.

  recommend  answer "which lock for this workload?" from the store
  summary    row counts and coverage of the store's workload space
  migrate    persist schema upgrades back into the file

The store path comes from ``--store`` or the ``REPRO_RESULTS_STORE``
environment variable (the same hook ``run_sweep`` persists through).
"""

from __future__ import annotations

import argparse
import os
import sys

from .advisor import recommend_lock
from .schema import SCHEMA_VERSION
from .store import ResultsStore


def _store_from(args) -> ResultsStore:
    path = args.store or os.environ.get("REPRO_RESULTS_STORE")
    if not path:
        sys.exit("no store: pass --store PATH or set REPRO_RESULTS_STORE")
    return ResultsStore(path)


def cmd_recommend(args) -> None:
    workload = {}
    for key, val in (("n_threads", args.threads),
                     ("cs_work", args.cs_work),
                     ("outside_work", args.outside_work),
                     ("reader_fraction", args.reader_fraction)):
        if val is not None:
            workload[key] = val
    rec = recommend_lock(_store_from(args), workload)
    print(f"workload:   " + ", ".join(f"{k}={v}"
                                      for k, v in workload.items()))
    print(f"recommend:  {rec['lock']}  (n_threads={rec['n_threads']}, "
          f"wa_size={rec['wa_size']})")
    print(f"throughput: {rec['throughput']:.6f} acq/cycle "
          f"(median of {rec['n_rows']} rows)")
    print(f"confidence: {rec['confidence']}", end="")
    if rec["confidence"] == "nearest":
        print("  [nearest measured point: "
              + ", ".join(f"{k}={v}" for k, v in rec["matched"].items())
              + "]")
    else:
        print()


def cmd_summary(args) -> None:
    store = _store_from(args)
    rows = store.load()
    print(f"store:   {store.path}")
    print(f"rows:    {len(rows)} (schema v{SCHEMA_VERSION})")
    if not rows:
        return
    locks = sorted({r["lock"] for r in rows})
    print(f"locks:   {', '.join(locks)}")
    workloads = sorted({str(r.get("workload", "synthetic")) for r in rows})
    print(f"workload:{', '.join(workloads)}")
    for axis in ("n_threads", "cs_work", "outside_work", "reader_fraction",
                 "wa_size"):
        vals = sorted({r[axis] for r in rows})
        shown = ", ".join(map(str, vals[:12]))
        if len(vals) > 12:
            shown += ", ..."
        print(f"{axis + ':':<9}{shown}")
    with_lat = sum(1 for r in rows if r.get("lat_hist") is not None)
    print(f"latency: {with_lat}/{len(rows)} rows carry lat_hist")


def cmd_migrate(args) -> None:
    store = _store_from(args)
    n = store.rewrite()
    print(f"rewrote {n} rows at schema v{SCHEMA_VERSION}: {store.path}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.results", description=__doc__)
    parser.add_argument("--store", help="results store path (JSONL); "
                        "default $REPRO_RESULTS_STORE")
    sub = parser.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("recommend", help="which lock for this workload?")
    rec.add_argument("--threads", type=int, help="target thread count")
    rec.add_argument("--cs-work", type=int, help="critical-section PRNG steps")
    rec.add_argument("--outside-work", type=int,
                     help="fixed off-lock PRNG steps per iteration")
    rec.add_argument("--reader-fraction", type=int,
                     help="percent of acquisitions that are reads")
    rec.set_defaults(fn=cmd_recommend)

    summ = sub.add_parser("summary", help="store size and axis coverage")
    summ.set_defaults(fn=cmd_summary)

    mig = sub.add_parser("migrate", help="persist schema upgrades to disk")
    mig.set_defaults(fn=cmd_migrate)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
