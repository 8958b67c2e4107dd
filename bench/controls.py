"""The readings that the limits of ``correct`` are set from: one cell run
over several seeds in one process, at the cell's own size on the card, with
the program as the benchmark runs it, with its lower-precision routes, or
with a fault planted underneath.

    python3 bench/controls.py --workload <cell> --reading <reading> --seeds <a>,<b>,... [--seconds 3]

Each run prints its check lines on standard error and one JSON line of its
numbers (``{"reading", "seed", "correct", "numbers"}``) on standard output.
The benchmark's own runs never run this. Readings:

  program           the program as the benchmark runs it: lower readings
  tf32              the plain route with TF32 on: the control, upper readings
  bf16              the plain route in bfloat16, the program's own lower route
  gram-bf16         phase 1's landmark gram rounded to bfloat16 before eigh
  gamma-bf16        the self-tuned gamma's rows rounded to bfloat16
  frozen-after-3    every centroid update of a fit after its third returns its input
  state-unchanged   every centroid update returns its input
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import run  # noqa: E402,F401  (the caches' fixed paths and the threads of a run)


def main(argv=None) -> int:
    from bench.harness.planted import reading
    from bench.harness.runner import run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--reading", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        policy, planted = reading(args.reading)
        with planted:
            result, lines = run_cell(args.workload, seed, args.seconds, False,
                                     device="cuda:0", t_start=time.perf_counter(),
                                     policy=policy)
        print(f"== {args.workload} {args.reading} seed {seed}", file=sys.stderr)
        print("\n".join(lines), file=sys.stderr, flush=True)
        numbers = {name: c["value"] for name, c in result["checks"].items()}
        print(json.dumps({"reading": args.reading, "seed": seed,
                          "correct": result["correct"], "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
