#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json.  The run fixes its
host conditions before torch is imported (harness/host.py), makes its inputs
from the seed and the pool of proofs through the port's prover, warms up on
the cell's own shapes (all of it set-up), drives the port for `--seconds`
seconds, compares what the window produced with the plain reference
(portbench/reference) and prints: a line of host conditions and window
counters, then on standard error each number compared beside its limit,
then as the last line of standard output one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`).  `--trace 0` reports the cell's end-to-end metrics,
`--trace 1` its per-layer ones from a torch.profiler trace of the window.

Options for the control and tests only: `--fault` breaks the timed
path (harness/faults.py), `--device cpu` runs the kernels' plain versions
without looking for a card, `--root` reads BENCHMARK.json and the files it
names from another directory.  Exits with a code other than 0, printing
no result, without the CUDA devices the cell asks for.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import host

    conditions = host.fix(os.path.abspath(args.root))
    from portbench.harness import cell

    return cell.run(args, t_start, os.path.abspath(args.root), conditions)


if __name__ == "__main__":
    sys.exit(main())
