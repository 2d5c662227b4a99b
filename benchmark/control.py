"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control] [--fault <name>]

Runs the cell's loop once per seed in one process (one set-up of torch and
the kernel library) and prints each run's numbers as one JSON line. Plain,
the numbers are the program's against the reference: their largest over a
dozen seeds or more is a limit's lower reading. With ``--control`` the
answers judged are the control's instead: the reference in the nearest
precision below the configuration's (float32 with TF32 on, for float32
with TF32 off), from the same inputs; its smallest reading is the upper
one. With ``--fault`` a fault of ``harness/faults.py`` is planted in the
program first. The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run as bench_run  # noqa: E402


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--seconds", type=float, default=3.0)
  ap.add_argument("--control", action="store_true")
  ap.add_argument("--fault", default="")
  args = ap.parse_args(argv)
  from benchmark.harness import lookup
  cell = lookup.cell(args.workload)
  if args.fault:
    from benchmark.harness import faults
    faults.plant(args.fault)
  for seed in [int(s) for s in args.seeds.split(",")]:
    t0 = time.perf_counter()
    out = bench_run.measure(cell, seed, args.seconds, False,
                            control=args.control, t0=t0)
    print(json.dumps({"cell": cell.name, "seed": seed,
                      "control": args.control, "fault": args.fault,
                      "numbers": out["numbers"], "correct": out["correct"],
                      "e2e": out["e2e"], "attempted": out["attempted"],
                      "memory_peak_bytes": out["memory_peak_bytes"],
                      "seconds": time.perf_counter() - t0}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
