#!/usr/bin/env python3
"""K1 (`dyn_acc`), K7 (`dyn_acc_signed`) and K2 (`lane_fold`) of the port's dynamic MSM, timed on one GPU.

    python3 scripts/profile_torch_msm.py [--lanes 4736 2048] [--tiles 4 6 8 10 12 16 18 24 32]

Run from the root of a checkout (it imports the port and chip_smoke.py from
there), so that two trees can be compared on one card, one after the other.  For
each lane count (4736: the MSM of a 256 x 64-bit verify; 2048: that of a
64 x (64-bit, m=4) verify) it makes random points and canonical scalars,
runs K1 then K2, and K7 then K2, through the wrappers' own choices, checks
the window sums against the plain versions' and K7's MSM against K1's
(ristretto point equality, exact), and prints one JSON line: K1's, K7's and
K2's CUDA-graph time (chip_smoke.graph_ms), the A/B of the two digit
recodings as K1 + K2 and K7 + K2 timed in the order K1, K7, K7, K1
(`k1_k7_k7_k1_graph_ms`), the tile widths and grids, and, where the tree
has the fixed-width launchers, K1 and K7 at every width of --tiles with K2
on their partials.  The first line gives ptxas's registers and spill bytes
of the three kernels and, from `cuobjdump -sass`, K1's and K7's spill
instructions (STL, LDL) between each two of their barriers, with a mark
where that stretch of code branches back (a loop); the last, the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def spill_by_phase(cuda, kernel: str) -> list | dict:
    """`kernel`'s SASS cut at its barriers (BAR): for each stretch, its
    instruction count, its spill stores (STL) and loads (LDL), and whether it
    branches back within itself.  {"unavailable": reason} without cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"unavailable": "no cuobjdump beside nvcc"}
    res = subprocess.run([tool, "-sass", cuda.so_path("msm")], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        return {"unavailable": res.stderr.strip()[-200:]}
    phases, mine = [], False
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            mine = re.fullmatch(rf"_Z\d+{kernel}\w*", m.group(1)) is not None
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*)", line)
        if not (mine and m):
            continue
        at, op, operands = int(m.group(1), 16), m.group(2), m.group(3)
        if not phases or op.startswith("BAR"):
            phases.append({"from": at, "instructions": 0, "stl": 0, "ldl": 0, "loops": False})
        ph = phases[-1]
        ph["instructions"] += 1
        ph["stl"] += op.startswith("STL")
        ph["ldl"] += op.startswith("LDL")
        target = re.search(r"0x([0-9a-f]+)", operands) if op.startswith("BRA") else None
        if target and ph["from"] <= int(target.group(1), 16) < at:
            ph["loops"] = True
    return phases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[4736, 2048])
    ap.add_argument("--tiles", type=int, nargs="*", default=[4, 6, 8, 10, 12, 16, 18, 24, 32])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_msm: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bulletproofs_plus_tpu_torch.native import cuda
    from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist
    from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints

    cuda.build(["msm"])  # if stale; its log has ptxas's report either way
    with open(cuda.log_path("msm")) as f:
        regs = cs.ptxas_report(f.read())
    kernels = ("dyn_acc_kernel", "dyn_acc_signed_kernel", "lane_fold_kernel")
    print(json.dumps({"ptxas": {k: regs.get(k) for k in kernels},
                      "spill_by_phase": {k: spill_by_phase(cuda, k) for k in kernels[:2]}}), flush=True)

    def windows_equal(a, b) -> bool:
        return bool(rist.point_equal(ed.PointArray(*(c.t() for c in a)), ed.PointArray(*(c.t() for c in b))).all())

    def point_equal(a, b) -> bool:
        return bool(rist.point_equal(ed.PointArray(*a), ed.PointArray(*b)))

    rs = random.Random(20261017)
    fixed = {"dyn_acc": getattr(cm, "_launch_dyn_acc", None), "dyn_acc_signed": getattr(cm, "_launch_dyn_acc_signed", None)}
    for n in args.lanes:
        pts_t = cm.coords_t(cs._rand_points(torch, ed, hr, n, rs, "cuda"))
        sc_t = torch.as_tensor(pack_ints([rs.randrange(hr.L) for _ in range(n)]).astype("int64"),
                               device="cuda").t().contiguous()
        row = {"lanes": n}
        res = None
        for name, acc, plain in (("dyn_acc", cm.dyn_acc, cm.dyn_acc_plain),
                                 ("dyn_acc_signed", cm.dyn_acc_signed, cm.dyn_acc_signed_plain)):
            parts = acc(sc_t, pts_t)
            wsum = cm.lane_fold(parts)
            if not windows_equal(wsum, cm.lane_fold_plain(plain(sc_t, pts_t))):
                raise AssertionError(f"{n} lanes: {name} -> lane_fold disagrees with the plain versions")
            got = cm.horner(wsum)
            if res is not None and not point_equal(got, res):
                raise AssertionError(f"{n} lanes: the signed-digit MSM disagrees with K1's")
            res = got
            a, b = cs.graph_ms(lambda: acc(sc_t, pts_t)), cs.graph_ms(lambda: cm.lane_fold(parts))
            row[name] = {"tiles": parts.shape[1], "graph_ms": a, "lane_fold_graph_ms": b, "with_k2_ms": a + b}
            launcher = fixed[name]
            if launcher is None:
                continue
            # (a tree older than K7's redesign has no launcher for it, and its resident_tiles no kernel name)
            resident = cm.resident_tiles(sc_t.device) if name == "dyn_acc" else cm.resident_tiles(sc_t.device, name)
            row[name]["tile"] = cm.pick_tile(n, resident)
            by_tile = {}
            for t in args.tiles:
                p_t = launcher(sc_t, pts_t, t)
                if not windows_equal(cm.lane_fold(p_t), wsum):
                    raise AssertionError(f"{n} lanes: {name} at {t} lanes a tile disagrees with the picked width")
                a, b = cs.graph_ms(lambda: launcher(sc_t, pts_t, t)), cs.graph_ms(lambda: cm.lane_fold(p_t))
                by_tile[t] = {"tiles": p_t.shape[1], "graph_ms": a, "lane_fold_graph_ms": b, "with_k2_ms": a + b}
            row[name]["by_tile"] = by_tile
        # the A/B of the two recodings, each with K2 on its partials: K1, K7, K7, K1
        chains = {"k1": lambda: cm.lane_fold(cm.dyn_acc(sc_t, pts_t)),
                  "k7": lambda: cm.lane_fold(cm.dyn_acc_signed(sc_t, pts_t))}
        row["k1_k7_k7_k1_graph_ms"] = [cs.graph_ms(chains[k]) for k in ("k1", "k7", "k7", "k1")]
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
