#!/usr/bin/env python3
"""Where the time of one port batch verification goes, on one GPU.

    python3 scripts/profile_torch_verify.py [--batch 256] [--seed 3]

Tiles a golden proof (tests/golden/golden_vectors.json, by its `seed`) to a
batch and verifies it with the port (bulletproofs_plus_tpu_torch).  Prints
one JSON line per measurement:
  * "stages": wall time of each stage of `RangeProof._verify_device`, run
    one after another with a device synchronise between them (host replay,
    weights, packing, scalar pass, decompression, MSM, identity check);
  * "profile": torch.profiler over one whole `verify_batch`: device busy
    time (sum of kernel times), wall time, the idle share, the number of
    kernel launches, the five kernels with the most device time, and the
    device time of each hand-written kernel (K1-K3, K4's fused entry).
Ends with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "golden", "golden_vectors.json")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=3, help="golden cell to tile (3: 64-bit, m=1)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_verify: no CUDA device", file=sys.stderr)
        return 2
    import bulletproofs_plus_tpu_torch as bp
    from bulletproofs_plus_tpu_torch.models.range_proof import RangeProof
    from bulletproofs_plus_tpu_torch.models.verifier_kernels import DeviceVerifier, scalar_pass
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist
    from bulletproofs_plus_tpu_torch.ops.fixed_base import mixed_msm
    from bulletproofs_plus_tpu_torch.ops.limbs import NLIMBS
    from bulletproofs_plus_tpu_torch.ops.msm import pad_msm_inputs

    with open(GOLDEN) as f:
        cell = next(c for c in json.load(f) if c["seed"] == args.seed)
    pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(cell["extension_degree"]))
    params = bp.RangeParameters.init(cell["bits"], len(cell["values"]), pc)
    commitments = [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    statement = bp.RangeStatement.init(params, commitments, mv, seed_nonce=cell["seed_nonce"])
    proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    statements, proofs = [statement] * args.batch, [proof] * args.batch
    dev = "cuda"

    def transcripts():
        return [bp.Transcript(b"golden") for _ in proofs]

    def verify():
        return bp.RangeProof.verify_batch(transcripts(), statements, proofs, bp.VerifyAction.VERIFY_ONLY, device=dev)

    verify()  # builds the kernels, warms the caches
    verify()

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    m, bits = len(commitments), cell["bits"]
    max_mn = m * bits
    rounds = len(proof.li)
    ts = transcripts()
    stage("consistency", lambda: RangeProof._verify_consistency(statements, proofs))
    challenges, seeds = stage("replay_challenges", lambda: RangeProof._replay_challenges(ts, statements, proofs))
    weights = stage("draw_weights", lambda: RangeProof._draw_weights(seeds, len(proofs)))
    packed = stage("pack", lambda: DeviceVerifier.pack(statements, proofs, challenges, weights, dev))
    y, z, es, e, w, r1, s1, d1, mins, comp = packed
    sp = stage("scalar_pass", lambda: scalar_pass(y, z, es, e, w, r1, s1, d1, mins, m=m, bit_length=bits, max_mn=max_mn))
    points, valid = stage("decompress", lambda: rist.decompress(comp))
    gi, hi, gb, hb, commit_s, a1_s, b_s, a_s, li_s, ri_s = sp
    B, K = len(proofs), m + 3 + 2 * rounds
    g_base, h_base = pc.device_bases(dev)
    inter = params.bp_gens.interleaved_device(dev)
    static_pts = ed.PointArray(*(c[: 2 * max_mn] for c in inter))

    def assemble():
        dyn = torch.cat([commit_s, a1_s[:, None], b_s[:, None], a_s[:, None], li_s, ri_s], dim=1).reshape(B * K, NLIMBS)
        dyn = torch.cat([dyn, gb, hb[None]])
        return pad_msm_inputs(dyn, ed.cat([points, g_base, h_base])), torch.stack([gi, hi], dim=1).reshape(-1, NLIMBS)

    (dyn_s, dyn_p), static_s = stage("assemble", assemble)
    result = stage("msm", lambda: mixed_msm(static_s, static_pts, dyn_s, dyn_p))
    ok = stage("identity_check", lambda: bool(rist.is_identity(result)) and bool(valid.all()))
    if not ok:
        raise AssertionError("stage-by-stage verification failed")
    stages["total"] = sum(stages.values())
    print(json.dumps({"stages_ms": stages, "batch": args.batch, "seed": args.seed}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verify()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        name = e.name.split("<")[0].split("(")[0]  # template arguments dropped: one entry per kernel family
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {k: v / 1e3 for k, v in by_name.items()
            if k.endswith("_kernel") and any(s in k for s in ("dyn_acc", "lane_fold", "horner", "sqrt_ratio", "pow_p58"))}
    print(json.dumps({
        "profile": {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                    "idle_share": 1 - busy_us / 1e3 / wall_ms if wall_ms else None,
                    "device_ops": len(kernels), "top_ms": {k: v / 1e3 for k, v in top},
                    "hand_written_kernels_ms": ours},
    }), flush=True)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(res.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
