"""Summed test time of some test files on two or more trees, run in turns.

    python3 scripts/test_time_turns.py --turns 5 --out times.json \
        --tree parent=/path/to/parent --tree change=/path/to/change -- tests/test_torch_transcript.py

Each turn runs the trees one after another, in the order given on even
turns and reversed on odd ones (A B, B A, A B, ...), so that a drift in the
machine's load falls on both alike.  A run is `python -m pytest <files> -q
-n 0 -p no:cacheprovider -p no:randomly --junitxml=...` from the tree's
root, after removing the tree's `.jax_cache_cpu*` so that JAX compiles
cold; its figure is the sum of the junit file's testcase times.  Prints,
and writes to --out, each run's figure and exit code and each tree's
median, least and most.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET


def summed_time(junit: str) -> tuple:
    cases = ET.parse(junit).getroot().iter("testcase")
    times, passed = 0.0, 0
    for case in cases:
        times += float(case.get("time", 0.0))
        passed += not any(child.tag in ("failure", "error", "skipped") for child in case)
    return times, passed


def run_once(tree: str, files: list, scratch: str) -> dict:
    for cache in glob.glob(os.path.join(tree, ".jax_cache_cpu*")):
        shutil.rmtree(cache, ignore_errors=True)
    junit = os.path.join(scratch, "junit.xml")
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-n", "0", "-p", "no:cacheprovider", "-p", "no:randomly",
           f"--junitxml={junit}"]
    rc = subprocess.run(cmd, cwd=tree, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL).returncode
    seconds, passed = summed_time(junit)
    return {"rc": rc, "seconds": seconds, "passed": passed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="NAME=PATH, two or more")
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("files", nargs="+")
    args = ap.parse_args()
    trees = [tuple(t.split("=", 1)) for t in args.tree]
    runs = {name: [] for name, _ in trees}
    with tempfile.TemporaryDirectory() as scratch:
        for turn in range(args.turns):
            for name, path in (trees if turn % 2 == 0 else trees[::-1]):
                run = run_once(os.path.abspath(path), args.files, scratch)
                runs[name].append(run)
                print(json.dumps({"turn": turn, "tree": name, **run}), flush=True)
    summary = {name: {"median_s": statistics.median(r["seconds"] for r in rs),
                      "least_s": min(r["seconds"] for r in rs), "most_s": max(r["seconds"] for r in rs),
                      "rcs": sorted({r["rc"] for r in rs}), "passed": sorted({r["passed"] for r in rs})}
               for name, rs in runs.items()}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"files": args.files, "runs": runs, "summary": summary}, f, indent=1)
    return 0 if all(r["rc"] == 0 for rs in runs.values() for r in rs) else 1


if __name__ == "__main__":
    sys.exit(main())
