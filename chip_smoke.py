#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bulletproofs_plus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the batch-verification path from csrc/, holds
each kernel against its plain torch version on the card, replays and
verifies the golden proofs, verifies the 256 x 64-bit and 64 x m4 batches
through `RangeProof.verify_batch(engine="device")` with launch counters
proving the kernels ran, and checks that tampered and non-canonical batches
fail with the reference's errors.  Each phase prints one JSON line; then
come the card's name and power limit (nvidia-smi), the per-kernel table
({"kernels": [...]}: time, bound, plain version's time) and, last,
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.  Without a
CUDA device, or without the package beside it, it exits non-zero with no
result.

Tolerance: exact.  The kernels do integer arithmetic, so K4 must equal its
plain version mod p, and K1-K3 must give the same points (compared as
canonical affine coordinates, since tilings differ in projective Z);
`max_abs_err` is the largest limb difference found, and must be 0.

Bounds (`bound_ms`) are the larger of bytes moved over 3.35 TB/s and the
32-bit integer multiply-adds the work needs over the card's rate: 132 SMs x
64 IMAD/clock x 1.98 GHz = 16.7e12/s, half the FMA rate behind the 67
TFLOP/s float32 peak (H100 SXM data sheet, 700 W).  A field multiplication
counts 128 multiply-adds (8 x 8 32-bit words, low and high halves), a point
addition 9 multiplications, a doubling 8.
"""

from __future__ import annotations

import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
MULADDS_PER_FMUL = 128
FMUL_PER_ADD, FMUL_PER_DBL = 9, 8
POW_SQR, POW_MUL = 251, 11  # the x^((p-5)/8) addition chain
LIMB_BYTES = 8 * 16  # one field element as 16 int64 limbs
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "golden_vectors.json")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, muladds: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muladds / IMAD_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def median_ms(fn, runs: int) -> float:
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_ms(fn, reps: int = 50) -> float:
    """Device time of one launch: CUDA events around `reps` back-to-back
    launches after a warm-up, divided by `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc -Xptxas -v output."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )_Z(\d+)(\w+)", line)
        if m:
            current = m.group(2)[: int(m.group(1))]  # the mangled name's length-prefixed identifier
            out.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
    return out


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unavailable"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(torch, cuda) -> dict:
    t0 = time.perf_counter()
    per_lib = cuda.build(force=True)
    seconds = time.perf_counter() - t0
    regs = {}
    for name in cuda.LIBRARIES:
        with open(cuda.log_path(name)) as f:
            regs.update(ptxas_report(f.read()))
    for name in cuda.LIBRARIES:
        cuda.lib(name)
    return {"seconds": seconds, "per_library": per_lib, "device": torch.cuda.get_device_name(0),
            "power": nvidia_smi(), "ptxas": regs}


def _rand_points(torch, ed, hr, n: int, rs: random.Random, dev):
    """n distinct-looking points: sums of two of 64 host multiples of the base point."""
    base = ed.from_host([hr.point_mul(rs.randrange(1, hr.L), hr.BASEPOINT) for _ in range(64)], device=dev)
    i = torch.as_tensor([rs.randrange(64) for _ in range(n)], device=dev)
    j = torch.as_tensor([rs.randrange(64) for _ in range(n)], device=dev)
    return ed.add(ed.PointArray(*(c[i] for c in base)), ed.PointArray(*(c[j] for c in base)))


def _affine(F, torch, coords):
    """(4, 16, ...) points -> canonical affine (x, y) limbs, for exact comparison."""
    zinv = F.pow25519(coords[2].movedim(0, -1), F.P - 2)
    x = F.canon25519(F.mul25519(coords[0].movedim(0, -1), zinv))
    y = F.canon25519(F.mul25519(coords[1].movedim(0, -1), zinv))
    return torch.stack([x, y])


def _point_err(F, torch, got, want) -> float:
    return float((_affine(F, torch, got) - _affine(F, torch, want)).abs().max())


def phase_kernels(torch, bp, rows: dict) -> dict:
    from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
    from bulletproofs_plus_tpu_torch.ops import cuda_pow as cp
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import field as F
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, pack_ints
    from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel

    dev = "cuda"
    rs = random.Random(20260416)
    out = {}

    # K4 on 4096 random lanes plus edge values, compared mod p (and with python pow on the edges)
    edges = [0, 1, F.P - 1, 2**256 - 30]
    vals = [rs.randrange(2**256) for _ in range(4096)] + edges
    x = torch.as_tensor(pack_ints(vals).astype("int64"), device=dev)
    got, want = cp.pow_p58_cuda(x), cp.pow_p58_plain(x)
    err = float((F.canon25519(got) - F.canon25519(want)).abs().max())
    tail = [int_from_limbs(r) % F.P for r in got[-len(edges):].cpu().numpy()]
    if err != 0 or tail != [pow(v, (F.P - 5) // 8, F.P) for v in edges]:
        raise AssertionError(f"K4 pow_p58 disagrees with its plain version (max_abs_err {err})")
    n = x.shape[0]
    b_ms, b_by = bound_ms(2 * n * LIMB_BYTES, n * (POW_SQR + POW_MUL) * MULADDS_PER_FMUL)
    rows["pow_p58"] = {
        "max_abs_err": err, "ms": kernel_ms(lambda: cp.pow_p58_cuda(x)),
        "plain_ms": median_ms(lambda: cp.pow_p58_plain(x), 3), "bound_ms": b_ms, "bound_by": b_by, "lanes": n,
    }

    # K1-K3 on the main path's MSM shape: 4098 dynamic lanes padded to 4608
    # (zero scalar, identity) plus 128 static lanes.
    n_dyn, n_pad, n_static = 4098, 510, 128
    pts = _rand_points(torch, ed, hr, n_dyn + n_static, rs, dev)
    pts = ed.cat([ed.PointArray(*(c[:n_dyn] for c in pts)), ed.identity((n_pad,), device=dev),
                  ed.PointArray(*(c[n_dyn:] for c in pts))])
    scal = [rs.randrange(hr.L) for _ in range(n_dyn)] + [0] * n_pad + [rs.randrange(hr.L) for _ in range(n_static)]
    sc_t = torch.as_tensor(pack_ints(scal).astype("int64"), device=dev).t().contiguous()
    pts_t = cm.coords_t(pts)
    n = sc_t.shape[1]
    tiles = -(-n // cm.TILE)

    parts = cm.dyn_acc(sc_t, pts_t)
    err1 = _point_err(F, torch, parts, cm.dyn_acc_plain(sc_t, pts_t))
    wsum = cm.lane_fold(parts)
    err2 = _point_err(F, torch, wsum, cm.lane_fold_plain(parts))
    res = cm.horner(wsum)
    err3 = _point_err(F, torch, res[..., None], cm.horner_plain(wsum)[..., None])
    for name, err in (("dyn_acc", err1), ("lane_fold", err2), ("horner", err3)):
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version (max_abs_err {err})")

    point_bytes = 4 * LIMB_BYTES
    b1 = bound_ms(n * (LIMB_BYTES + point_bytes) + tiles * 64 * point_bytes,
                  n * (14 * FMUL_PER_ADD + 64 * FMUL_PER_ADD) * MULADDS_PER_FMUL)
    b2 = bound_ms((tiles + 1) * 64 * point_bytes, 64 * (tiles - 1) * FMUL_PER_ADD * MULADDS_PER_FMUL)
    b3 = bound_ms(65 * point_bytes, (252 * FMUL_PER_DBL + 63 * FMUL_PER_ADD) * MULADDS_PER_FMUL)
    rows["dyn_acc"] = {"max_abs_err": err1, "ms": kernel_ms(lambda: cm.dyn_acc(sc_t, pts_t)),
                       "plain_ms": median_ms(lambda: cm.dyn_acc_plain(sc_t, pts_t), 3),
                       "bound_ms": b1[0], "bound_by": b1[1], "lanes": n}
    rows["lane_fold"] = {"max_abs_err": err2, "ms": kernel_ms(lambda: cm.lane_fold(parts)),
                         "plain_ms": median_ms(lambda: cm.lane_fold_plain(parts), 3),
                         "bound_ms": b2[0], "bound_by": b2[1], "tiles": tiles}
    rows["horner"] = {"max_abs_err": err3, "ms": kernel_ms(lambda: cm.horner(wsum)),
                      "plain_ms": median_ms(lambda: cm.horner_plain(wsum), 3),
                      "bound_ms": b3[0], "bound_by": b3[1]}

    # The whole chain against the host Pippenger on 16 lanes
    small = [hr.point_mul(rs.randrange(1, hr.L), hr.BASEPOINT) for _ in range(16)]
    small_sc = [rs.randrange(hr.L) for _ in range(16)]
    got16 = msm_kernel(torch.as_tensor(pack_ints(small_sc).astype("int64"), device=dev), ed.from_host(small, device=dev))
    if not hr.point_equal(ed.to_host(got16), host_msm(small_sc, small)):
        raise AssertionError("16-lane MSM disagrees with the host Pippenger")
    out["kernels"] = {k: {kk: v[kk] for kk in ("max_abs_err", "ms", "plain_ms", "bound_ms")} for k, v in rows.items()}
    out["host_pippenger_16"] = "equal"
    return out


def _golden_statement(bp, hr, cell):
    pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(cell["extension_degree"]))
    params = bp.RangeParameters.init(cell["bits"], len(cell["values"]), pc)
    commitments = [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    return bp.RangeStatement.init(params, commitments, mv, seed_nonce=cell["seed_nonce"])


def phase_golden(bp, hr, cells) -> dict:
    results = []
    for cell in cells:
        statement = _golden_statement(bp, hr, cell)
        proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
        if proof.to_bytes().hex() != cell["proof"]:
            raise AssertionError(f"golden seed {cell['seed']}: proof bytes do not round-trip")
        challenges, _ = bp.RangeProof._replay_challenges([bp.Transcript(b"golden")], [statement], [proof])
        y, z, es, e = challenges[0]
        if (format(y, "064x"), format(z, "064x"), [format(v, "064x") for v in es], format(e, "064x")) != (
            cell["y"], cell["z"], cell["round_es"], cell["e"]
        ):
            raise AssertionError(f"golden seed {cell['seed']}: challenges differ")
        masks = bp.RangeProof.verify_batch(
            [bp.Transcript(b"golden")], [statement], [proof], bp.VerifyAction.RECOVER_AND_VERIFY, device="cuda"
        )
        got = None if masks[0] is None else [format(b, "064x") for b in masks[0].blindings()]
        if got != cell["mask"]:
            raise AssertionError(f"golden seed {cell['seed']}: mask {got} != {cell['mask']}")
        results.append({"seed": cell["seed"], "bits": cell["bits"], "m": len(cell["values"]), "valid": True})
    return {"cells": results}


def _tiled(bp, hr, cell, batch: int):
    statement = _golden_statement(bp, hr, cell)
    proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    return [statement] * batch, [proof] * batch


def _verify(bp, statements, proofs):
    return bp.RangeProof.verify_batch(
        [bp.Transcript(b"golden") for _ in proofs], statements, proofs, bp.VerifyAction.VERIFY_ONLY,
        engine="device", device="cuda",
    )


KERNELS = ("dyn_acc", "lane_fold", "horner", "pow_p58")


def phase_main(torch, bp, hr, cells, launches: dict) -> dict:
    from bulletproofs_plus_tpu_torch.native import cuda

    out = {}
    for label, seed, batch in (("b64_m1_x256", 3, 256), ("b64_m4_x64", 6, 64)):
        cell = next(c for c in cells if c["seed"] == seed)
        statements, proofs = _tiled(bp, hr, cell, batch)
        cuda.reset_launches()
        t0 = time.perf_counter()
        _verify(bp, statements, proofs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {k: cuda.launches[k] for k in KERNELS}
        if not all(counts.values()):
            raise AssertionError(f"{label}: a kernel of the path never launched: {counts}")
        if seed == 3:
            launches.update(counts)
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            _verify(bp, statements, proofs)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        wall = statistics.median(samples)
        out[label] = {"proofs": batch, "first_s": first_s, "median_s": wall, "samples_s": samples,
                      "proofs_per_s": batch / wall, "launches": counts}
    return out


def phase_reject(bp, hr, cells) -> dict:
    cell = next(c for c in cells if c["seed"] == 3)
    statements, proofs = _tiled(bp, hr, cell, 256)
    raw = bytearray(proofs[0].to_bytes())
    r1_at = 1 + 32 * len(proofs[0].d1) + 3 * 32
    raw[r1_at] ^= 1
    tampered = list(proofs)
    tampered[17] = bp.RangeProof.from_bytes(bytes(raw))
    try:
        _verify(bp, statements, tampered)
        raise AssertionError("tampered r1 was accepted")
    except bp.VerificationFailed:
        pass
    bad = bp.RangeProof.from_bytes(proofs[0].to_bytes())
    bad.a = (hr.P + 1).to_bytes(32, "little")  # s >= p: not canonical
    noncanon = list(proofs)
    noncanon[200] = bad
    want = "Member 'a' was not the canonical encoding of a point"
    try:
        _verify(bp, statements, noncanon)
        raise AssertionError("non-canonical a was accepted")
    except bp.InvalidArgument as exc:
        if str(exc) != want:
            raise AssertionError(f"non-canonical a: got {exc!r}")
    return {"tampered_r1": "VerificationFailed", "noncanonical_a": want}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import bulletproofs_plus_tpu_torch as bp
        from bulletproofs_plus_tpu_torch.native import cuda
        from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    with open(GOLDEN) as f:
        cells = json.load(f)

    rows, launches = {}, {}
    phases = (
        ("build", lambda: phase_build(torch, cuda)),
        ("kernels", lambda: phase_kernels(torch, bp, rows)),
        ("golden", lambda: phase_golden(bp, hr, cells)),
        ("main", lambda: phase_main(torch, bp, hr, cells, launches)),
        ("reject", lambda: phase_reject(bp, hr, cells)),
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0, **result})

    replaces = {
        "dyn_acc": "bulletproofs_plus_tpu/ops/pallas_msm.py:336",
        "lane_fold": "bulletproofs_plus_tpu/ops/pallas_msm.py:422",
        "horner": "bulletproofs_plus_tpu/ops/pallas_msm.py:432",
        "pow_p58": "bulletproofs_plus_tpu/ops/pallas_pow.py:78",
    }
    source = {"dyn_acc": "msm.cu", "lane_fold": "msm.cu", "horner": "msm.cu", "pow_p58": "pow.cu"}
    table = [
        {"name": k, "route": "cuda", "source": f"bulletproofs_plus_tpu_torch/csrc/{source[k]}",
         "replaces": replaces[k], "launches": launches[k], "max_abs_err": rows[k]["max_abs_err"],
         "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
         "bound_by": rows[k]["bound_by"], "library_ms": None}
        for k in KERNELS
    ]
    print(nvidia_smi())
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
