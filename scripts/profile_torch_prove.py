#!/usr/bin/env python3
"""Where the time of one port batch prove goes, on one GPU.

    python3 scripts/profile_torch_prove.py [--batch 128]

Proves `--batch` 64-bit statements (one commitment, extension degree 1,
seed nonces; lane 0 is golden cell 3 of tests/golden/golden_vectors.json)
with `RangeProof.prove_batch_with_rng` of the port
(bulletproofs_plus_tpu_torch).  Prints one JSON line per measurement:
  * "tables_s": the digit tables' build, once per generator set (the
    halved generators' where the tree's prover reads them);
  * "prove_ms": median of 5 whole proves with the tables built;
  * "stages_ms": one prove with a device synchronise around each stage, so
    device time is charged where it was enqueued: the fixed-base MSMs (K5 +
    K6 and their glue), the encodings (C1: `double_and_compress` where the
    tree has it, else `compress`), the A commitment's masked sums
    (`tree_reduce`, or P4 `bit_sum` where the tree has it), the readbacks
    (of each batch of compressed points, or the one copy at the end where
    the tree has `_read_back`), the host transcript (the statement's
    absorption and alpha's draws; where the tree has no T1, also the
    challenges, RNG rebuilds and the other draws), T1's phases
    (`prove_transcript`, where the tree has it), the argument checks (each
    witness's commitment recomputed in host integers), and the rest: the
    scalar folds (P1-P3 where the tree has them, else plain torch), nonces
    and uploads;
  * "profile": torch.profiler over one whole prove: device busy time, wall
    time, the idle share, the number of device operations, its
    device-to-host copies ("Memcpy DtoH" operations), the five kernels with
    the most device time and the hand-written kernels' device time (T1's
    among them);
  * "host_profile": one prove under cProfile: its wall time (inflated by
    the profiler) and the twelve functions with the most time in their own
    code, with their calls;
  * "host_inversions": the `pow(., -1, L)` calls that the prover's module
    (models/prover_device.py) makes in one prove.
Ends with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "golden", "golden_vectors.json")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_prove: no CUDA device", file=sys.stderr)
        return 2
    import bulletproofs_plus_tpu_torch as bp
    from bulletproofs_plus_tpu_torch.models import prover_device as pd
    from bulletproofs_plus_tpu_torch.models.transcripts import BatchTranscriptRng, RangeProofTranscript

    with open(GOLDEN) as f:
        cell = next(c for c in json.load(f) if c["seed"] == 3)
    pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(1))
    params = bp.RangeParameters.init(cell["bits"], 1, pc)
    values = [(cell["values"][0] + 7919 * lane) % 2**64 for lane in range(args.batch)]
    blindings = [[3000 + 17 * lane] for lane in range(args.batch)]
    statements = [
        bp.RangeStatement.init(params, [pc.commit(v, bl)], [None], cell["seed_nonce"] + lane)
        for lane, (v, bl) in enumerate(zip(values, blindings))
    ]
    witnesses = [bp.RangeWitness.init([bp.CommitmentOpening(v, bl)]) for v, bl in zip(values, blindings)]

    def prove():
        ts = [bp.Transcript(b"golden") for _ in statements]
        out = bp.RangeProof.prove_batch_with_rng(ts, statements, witnesses, bp.SeededRng(3), device="cuda")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    pc.device_base_tables("cuda")
    if hasattr(params.bp_gens, "halved_tables_joined"):  # a tree whose prover reads halved generators' tables
        params.bp_gens.halved_tables_joined(2 * cell["bits"], pc, "cuda")
    elif hasattr(params.bp_gens, "fixed_tables_joined"):  # a tree whose prover reads the joined tables
        params.bp_gens.fixed_tables_joined(2 * cell["bits"], pc, "cuda")  # builds the kernels too
    else:
        params.bp_gens.fixed_tables_sliced(2 * cell["bits"], "cuda")
    torch.cuda.synchronize()
    print(json.dumps({"tables_s": time.perf_counter() - t0, "lanes": 2 * cell["bits"] + 2}), flush=True)

    if prove()[0].to_bytes().hex() != cell["proof"]:
        raise AssertionError("lane 0 is not golden proof 3")
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        prove()
        samples.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"prove_ms": statistics.median(samples), "samples_ms": samples, "batch": args.batch}), flush=True)

    # One prove with every stage timed between synchronises.  The stages are
    # the prover's own calls, wrapped where the prover looks them up.
    stages = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return wrapper

    patched = [
        (pd, "fixed_msm_batched", "fixed_base_msms"), (pd, "fixed_msm_grouped", "fixed_base_msms"),
        (pd.rist, "compress", "compress"), (pd.rist, "double_and_compress", "compress"),
        (pd, "tree_reduce", "a_commitment_sums"),
        (pd, "_point_bytes", "readbacks"), (pd, "_read_back", "readbacks"),
        (pd, "prove_transcript", "t1_transcript"), (RangeProofTranscript, "__init__", "host_transcript"),
        (RangeProofTranscript, "challenges_y_z", "host_transcript"),
        (RangeProofTranscript, "challenge_round_e", "host_transcript"),
        (RangeProofTranscript, "challenge_final_e", "host_transcript"),
        (BatchTranscriptRng, "random_not_zero", "host_transcript"),
        (type(pc), "commit", "argument_checks"),
    ]
    patched.append((pd, "bit_sum", "a_commitment_sums"))
    # a tree's A sum is P4 `bit_sum` or `tree_reduce`, its encoder `double_and_compress` or `compress`
    patched = [p for p in patched if hasattr(p[0], p[1])]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patched]
    try:
        for owner, attr, stage in patched:
            setattr(owner, attr, timed(stage, getattr(owner, attr)))
        t0 = time.perf_counter()
        prove()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    stages["scalar_folds_and_rest"] = total - sum(stages.values())
    stages["total"] = total
    print(json.dumps({"stages_ms": stages, "batch": args.batch}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    copies = sum(e.name.startswith("Memcpy DtoH") for e in prof.events())
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        name = e.name.split("<")[0].split("(")[0]  # template arguments dropped: one entry per kernel family
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {k: v / 1e3 for k, v in by_name.items()
            if k.endswith("_kernel") and any(part in k for part in ("fixed_", "pow_p58", "sqrt_ratio", "compress",
                                                                    "prove_", "bit_sum"))}
    print(json.dumps({
        "profile": {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                    "idle_share": 1 - busy_us / 1e3 / wall_ms if wall_ms else None,
                    "device_ops": len(kernels), "device_to_host_copies": copies,
                    "top_ms": {k: v / 1e3 for k, v in top},
                    "hand_written_kernels_ms": ours},
    }), flush=True)
    # The host's own time by function: one prove under cProfile (whose overhead inflates every figure), the
    # functions with the most time spent in their own code
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    prove()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    own = sorted(((tt, nc, f"{os.path.basename(key[0])}:{key[2]}") for key, (_, nc, tt, _, _) in
                  pstats.Stats(prof).stats.items()), reverse=True)[:12]
    print(json.dumps({"host_profile": {"wall_ms": wall_ms, "top_own_ms": {name: {"ms": tt * 1e3, "calls": nc}
                                                                          for tt, nc, name in own}}}), flush=True)
    # The host's inversions mod l: a module global `pow` shadows the builtin for the prover's own calls
    inversions = []

    def counting_pow(*a):
        if len(a) == 3 and a[1] == -1:
            inversions.append(a[2])
        return pow(*a)

    pd.pow = counting_pow
    try:
        prove()
    finally:
        del pd.pow
    print(json.dumps({"host_inversions": len(inversions), "batch": args.batch}), flush=True)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(res.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
