#!/usr/bin/env python3
"""Where the time of one port batch verification goes, on one GPU.

    python3 scripts/profile_torch_verify.py [--batch 256] [--seed 3]

Tiles a golden proof (tests/golden/golden_vectors.json, by its `seed`) to a
batch and verifies it with the port (bulletproofs_plus_tpu_torch).  Prints
one JSON line per measurement:
  * "stages_ms": wall time of each stage of the device engine's
    single-shape path (`RangeProof._dispatch_device_replay`), run one after
    another with a device synchronise between them: packing and upload,
    the replay (`replay_fn` whole, which on the card is one R1 launch that
    also reduces the challenges; the median of nine calls beside it), the
    fetch of seeds and flags, the weight draws, then `verify_group_bytes`
    cut into its scalar pass, decompression, assembly, MSM and identity
    check;
  * "mixed_stages_ms": the same for the mixed-shape path on a batch of
    golden proofs 3 (m=1) and 4 (m=2) interleaved, `--batch` proofs in all:
    host replay, weights, one pack and `group_contrib` a shape group, and
    `combine_groups_msm`;
  * "profile": torch.profiler over one whole `verify_batch`: device busy
    time (sum of kernel times), wall time, the idle share, the number of
    kernel launches, the five kernels with the most device time, and the
    device time of each hand-written kernel (R1, K7 or K1, K2, K3, K4's
    fused entry).
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
    from bulletproofs_plus_tpu_torch.models.replay_device import pack_replay_inputs, replay_fn, unpack_row_buffer
    from bulletproofs_plus_tpu_torch.models.verifier_kernels import (
        DeviceVerifier,
        _u8_to_limbs,
        combine_groups_msm,
        group_contrib,
        scalar_pass,
        verify_group_bytes,
    )
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist
    from bulletproofs_plus_tpu_torch.ops.fixed_base import mixed_msm
    from bulletproofs_plus_tpu_torch.ops.limbs import NLIMBS, pack_ints
    from bulletproofs_plus_tpu_torch.ops.msm import pad_msm_inputs

    with open(GOLDEN) as f:
        all_cells = json.load(f)
    cell = next(c for c in all_cells if c["seed"] == args.seed)

    def statement_of(c, prm=None):
        if prm is None:
            pcs = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(c["extension_degree"]))
            prm = bp.RangeParameters.init(c["bits"], len(c["values"]), pcs)
        comms = [hr.decompress(bytes.fromhex(h)) for h in c["commitments"]]
        mvs = c["min_values"] if c["min_values"] is not None else [None] * len(comms)
        return bp.RangeStatement.init(prm, comms, mvs, seed_nonce=c["seed_nonce"])

    statement = statement_of(cell)
    params, pc = statement.generators, statement.generators.pc_gens
    commitments = statement.commitments
    proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    statements, proofs = [statement] * args.batch, [proof] * args.batch
    dev = "cuda"

    def transcripts():
        return [bp.Transcript(b"golden") for _ in proofs]

    def verify():
        return bp.RangeProof.verify_batch(transcripts(), statements, proofs, bp.VerifyAction.VERIFY_ONLY, device=dev)

    verify()  # builds the kernels, warms the caches
    verify()

    stages, mixed = {}, {}

    def timed(into, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        into[name] = (time.perf_counter() - t0) * 1e3
        return out

    def stage(name, fn):
        return timed(stages, name, fn)

    def mixed_stage(name, fn):
        return timed(mixed, name, fn)

    def median_of(fn, runs):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[runs // 2]

    m, bits = len(commitments), cell["bits"]
    max_mn = m * bits
    rounds = len(proof.li)
    B, K = len(proofs), m + 3 + 2 * rounds
    g_base, h_base = pc.device_bases(dev)
    inter = params.bp_gens.interleaved_device(dev)
    static_pts = ed.PointArray(*(c[: 2 * max_mn] for c in inter))
    ts = transcripts()
    stage("consistency", lambda: RangeProof._verify_consistency(statements, proofs))
    stacked = stage("stack_transcripts", lambda: bp.Transcript.stack(ts))
    rep = replay_fn(params.h_base_compressed(), tuple(params.g_bases_compressed()), bits, int(params.extension_degree()),
                    m, rounds, stacked.strobe.pos, stacked.strobe.pos_begin, stacked.strobe.cur_flags)
    buf, state = stage("pack_upload", lambda: (
        torch.as_tensor(pack_replay_inputs(statements, proofs).copy(), device=dev),
        torch.as_tensor(stacked.strobe.state, device=dev).clone()))
    y, z, es, e, seeds, bad_id, bad_zero = stage("replay_fn", lambda: rep(state, buf))
    seeds_np = stage("seed_fetch", lambda: [t.cpu().numpy() for t in (seeds, bad_id, bad_zero)])[0]
    weights = stage("draw_weights", lambda: RangeProof._draw_weights([row.tobytes() for row in seeds_np], B))
    w = stage("weights_upload", lambda: torch.as_tensor(pack_ints(weights).astype("int64"), device=dev))
    ok_all = stage("verify_group_bytes", lambda: verify_group_bytes(
        y, z, es, e, w, buf, static_pts, g_base, h_base, m=m, bit_length=bits,
        extension_degree=int(params.extension_degree()), max_mn=max_mn))
    stage("verdict_fetch", lambda: (bool(ok_all[0]), ok_all[1].cpu().numpy()))
    # verify_group_bytes again, by its parts
    f = unpack_row_buffer(buf, m, rounds, int(params.extension_degree()))
    mv = _u8_to_limbs(f["min_vals"])
    mins = torch.cat([mv, mv.new_zeros((B, m, NLIMBS - mv.shape[-1]))], dim=-1)
    comp = _u8_to_limbs(torch.cat([f["commits"], f["a1"][:, None], f["b"][:, None], f["a"][:, None], f["li"], f["ri"]],
                                  dim=1).reshape(B * K, 32))
    sp = stage("scalar_pass", lambda: scalar_pass(y, z, es, e, w, _u8_to_limbs(f["r1"]), _u8_to_limbs(f["s1"]),
                                                  _u8_to_limbs(f["d1"]), mins, m=m, bit_length=bits, max_mn=max_mn))
    points, valid = stage("decompress", lambda: rist.decompress(comp))
    gi, hi, gb, hb, commit_s, a1_s, b_s, a_s, li_s, ri_s = sp

    def assemble():
        dyn = torch.cat([commit_s, a1_s[:, None], b_s[:, None], a_s[:, None], li_s, ri_s], dim=1).reshape(B * K, NLIMBS)
        dyn = torch.cat([dyn, gb, hb[None]])
        return pad_msm_inputs(dyn, ed.cat([points, g_base, h_base])), torch.stack([gi, hi], dim=1).reshape(-1, NLIMBS)

    (dyn_s, dyn_p), static_s = stage("assemble", assemble)
    result = stage("msm", lambda: mixed_msm(static_s, static_pts, dyn_s, dyn_p))
    ok = stage("identity_check", lambda: bool(rist.is_identity(result)) and bool(valid.all()))
    if not ok or not bool(ok_all[0]) or bool(bad_id.any()) or bool(bad_zero.any()):
        raise AssertionError("stage-by-stage verification failed")
    by_parts = ("scalar_pass", "decompress", "assemble", "msm", "identity_check")
    stages["total"] = sum(v for k, v in stages.items() if k not in by_parts)
    print(json.dumps({"stages_ms": stages, "batch": args.batch, "seed": args.seed,
                      "replay_fn_median_ms": median_of(lambda: rep(state, buf), 9),
                      "note": "total counts verify_group_bytes whole; its parts are timed again after it"}),
          flush=True)

    # the mixed path: golden proofs 3 (m=1) and 4 (m=2), interleaved, on one generator set
    cells = {c["seed"]: c for c in all_cells}
    shared = bp.RangeParameters.init(64, 2, bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(1)))
    pair = [(statement_of(cells[k], shared), bp.RangeProof.from_bytes(bytes.fromhex(cells[k]["proof"]))) for k in (3, 4)]
    mixed_st = [pair[i % 2][0] for i in range(args.batch)]
    mixed_pr = [pair[i % 2][1] for i in range(args.batch)]
    mts = transcripts()
    max_mn_x, _ = mixed_stage("consistency", lambda: RangeProof._verify_consistency(mixed_st, mixed_pr))
    challenges, seeds_l = mixed_stage("replay_challenges", lambda: RangeProof._replay_challenges(mts, mixed_st, mixed_pr))
    weights = mixed_stage("draw_weights", lambda: RangeProof._draw_weights(seeds_l, len(mixed_pr)))
    parts = []
    for par in (0, 1):
        idx = list(range(par, args.batch, 2))
        packed = mixed_stage(f"pack_group{par}", lambda: DeviceVerifier.pack(
            [mixed_st[i] for i in idx], [mixed_pr[i] for i in idx], [challenges[i] for i in idx],
            [weights[i] for i in idx], dev))
        parts.append(mixed_stage(f"group_contrib{par}", lambda: group_contrib(
            *packed, m=len(mixed_st[par].commitments), bit_length=64, max_mn=max_mn_x)))
    static_x = ed.PointArray(*(c[: 2 * max_mn_x] for c in shared.bp_gens.interleaved_device(dev)))
    gis, his, gbs, hbs, dss, dps, valids = zip(*parts)
    okx = mixed_stage("combine_groups_msm", lambda: bool(combine_groups_msm(gis, his, gbs, hbs, dss, dps, static_x,
                                                                       g_base, h_base)))
    if not okx or not all(bool(v.all()) for v in valids):
        raise AssertionError("mixed stage-by-stage verification failed")
    mixed["total"] = sum(mixed.values())
    mixed["verify_batch_ms"] = median_of(lambda: bp.RangeProof.verify_batch(
        transcripts(), mixed_st, mixed_pr, bp.VerifyAction.VERIFY_ONLY, device=dev), 3)
    print(json.dumps({"mixed_stages_ms": mixed, "batch": args.batch, "seeds": [3, 4]}), flush=True)

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
            if k.endswith("_kernel") and any(s in k for s in ("replay", "dyn_acc", "lane_fold", "horner", "sqrt_ratio",
                                                                "pow_p58"))}
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
