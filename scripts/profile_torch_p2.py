#!/usr/bin/env python3
"""Where P2's or P3's time goes, phase by phase: clock64() stamps at the
phase markers of the port's prove_round_kernel or prove_final_kernel
(csrc/prover.cu).

    python3 scripts/profile_torch_p2.py [--kernel round|final] [--source PATH] [--shape b128_mn64]

Copies prover.cu (or PATH, a prover.cu of another tree) and the headers
beside it into a scratch directory under the port's build directory, turns
each marker line `// P2 phase: <name>` (with `--kernel final`, `// P3
phase: <name>`) into a stamp (lane 0 of every warp writes clock64() to a
device buffer: no barrier is added), builds that copy with nvcc as
native/cuda.py builds the library, and runs P2 through the port's own
wrapper (ops/cuda_prover.prove_round) at every round of the prove's shape,
or P3's first entry (ops/cuda_prover.prove_final) once, on the seeded
inputs of tests/torch_prover_inputs.py, its outputs checked against the
unpatched kernel's.  For each round (or the one P3 launch) it prints one
JSON line: for each phase the SM cycles from the marker before (the last
warp of a block to pass each marker, averaged over the blocks), its share of
the stamped time and that share of the unpatched kernel's `graph_ms`
measured in the same run, and the patched kernel's own `graph_ms`, which
shows what the stamps cost.  Then the card's name and power limit.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MARKER = re.compile(r"^(\s*)// (P[23]) phase: (\S+)\s*$")
TAGS = {"round": "P2", "final": "P3"}  # --kernel -> the markers it stamps
MAX_BLOCKS, MAX_WARPS, MAX_STAMPS = 256, 32, 16
SHAPES = {"b128_mn64": (128, 1, 64, 1), "b64_mn256": (64, 4, 64, 5)}  # proofs, m, bit length, degree
STAMP_CODE = f"""
__device__ unsigned long long phase_stamp_buf[{MAX_BLOCKS * MAX_WARPS * MAX_STAMPS}];
__device__ __forceinline__ void phase_stamp(int k) {{
    if ((threadIdx.x & 31) == 0 && blockIdx.x < {MAX_BLOCKS})
        phase_stamp_buf[(blockIdx.x * {MAX_WARPS} + (threadIdx.x >> 5)) * {MAX_STAMPS} + k] = clock64();
}}
extern "C" int bppt_phase_stamps(void *buf, long bytes, int write) {{
    return (int)(write ? cudaMemcpyToSymbol(phase_stamp_buf, buf, bytes)
                       : cudaMemcpyFromSymbol(buf, phase_stamp_buf, bytes));
}}
"""


def patch(source: str, tag: str = "P2"):
    """prover.cu's text -> (the text with stamps at the `// <tag> phase:`
    markers, the phase names in order); the other kernel's markers stay
    comments."""
    names, out = [], []
    for line in source.splitlines():
        m = MARKER.match(line)
        if m and m.group(2) == tag:
            out.append(f"{m.group(1)}phase_stamp({len(names)});")
            names.append(m.group(3))
        else:
            out.append(line)
    if len(names) < 2 or len(names) > MAX_STAMPS:
        raise SystemExit(f"expected 2 to {MAX_STAMPS} `// {tag} phase:` markers, found {len(names)}")
    text = "\n".join(out) + "\n"
    at = text.index('#include "scalar_l.cuh"')
    at = text.index("\n", at) + 1
    return text[:at] + STAMP_CODE + text[at:], names


def build(source_path: str, out_dir: str, cuda, tag: str = "P2"):
    """The copy of source_path stamped at its `// <tag> phase:` markers, built
    into out_dir: (its library, the phase names, nvcc's output)."""
    os.makedirs(out_dir, exist_ok=True)
    for header in glob.glob(os.path.join(os.path.dirname(source_path), "*.cuh")):
        shutil.copy(header, out_dir)
    with open(source_path) as f:
        text, names = patch(f.read(), tag)
    cu = os.path.join(out_dir, "prover_phases.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, "libbppt_prover_phases.so")
    cmd = [cuda.nvcc(), "-gencode", f"arch=compute_{cuda.ARCH[3:]},code={cuda.ARCH}", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "prover_phases.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return so, names, res.stdout + res.stderr


def load_stamped(so: str, cuda):
    """The stamped library, its entry points typed as native/cuda.py types the prover's."""
    lib = ctypes.CDLL(so)
    for fn, argtypes in cuda.LIBRARIES["prover"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.bppt_prover_error_string.argtypes = [ctypes.c_int]
    lib.bppt_prover_error_string.restype = ctypes.c_char_p
    lib.bppt_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
    lib.bppt_phase_stamps.restype = ctypes.c_int
    return lib


def split(call, stamped, names, cuda, blocks: int, warps: int, graph_ms) -> dict:
    """One P2 or P3 launch (`call`, through the port's wrapper) timed by graph
    replays, then run once on the stamped library: each phase's mean SM
    cycles (the last warp of a block at each marker, from the first warp at
    the first marker), its share and that share of the launch's graph time;
    the stamped library's own graph time beside it."""
    import numpy as np
    import torch

    want = call()
    unstamped_ms = graph_ms(call)
    buf = np.zeros(MAX_BLOCKS * MAX_WARPS * MAX_STAMPS, dtype=np.uint64)
    plain_lib = cuda.lib("prover")
    cuda._libs["prover"] = stamped
    try:
        if stamped.bppt_phase_stamps(buf.ctypes.data, buf.nbytes, 1) != 0:
            raise RuntimeError("phases: could not clear the stamp buffer")
        got = call()
        torch.cuda.synchronize()
        if stamped.bppt_phase_stamps(buf.ctypes.data, buf.nbytes, 0) != 0:
            raise RuntimeError("phases: could not read the stamp buffer")
        stamped_ms = graph_ms(call)
    finally:
        cuda._libs["prover"] = plain_lib
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("phases: the stamped kernel's outputs differ from the kernel's")
    stamps = buf.reshape(MAX_BLOCKS, MAX_WARPS, MAX_STAMPS)[: min(blocks, MAX_BLOCKS), :warps, : len(names)]
    stamps = stamps.astype(np.float64)
    if (stamps == 0).any():
        raise RuntimeError("phases: a warp passed no stamp at some marker (markers must be uniform)")
    ends = stamps.max(axis=1) - stamps.min(axis=1)[:, :1]  # (blocks, markers), from the block's first stamp
    cycles = np.diff(ends, axis=1).mean(axis=0)
    total = float(cycles.sum())
    return {"graph_ms": unstamped_ms, "stamped_graph_ms": stamped_ms, "stamped_cycles": total,
            "phases": {name: {"cycles": float(c), "share": float(c) / total, "ms": unstamped_ms * float(c) / total}
                       for name, c in zip(names[1:], cycles)}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_p2: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import graph_ms, nvidia_smi, ptxas_report

    from bulletproofs_plus_tpu_torch.native import BUILD_DIR, cuda
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import round_inputs, to_device

    from torch_prover_inputs import final_inputs

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="round", choices=sorted(TAGS))
    ap.add_argument("--source", default=os.path.join(ROOT, "bulletproofs_plus_tpu_torch", "csrc", "prover.cu"))
    ap.add_argument("--shape", default="b128_mn64", choices=sorted(SHAPES))
    args = ap.parse_args()

    tag = TAGS[args.kernel]
    so, names, log = build(os.path.abspath(args.source), os.path.join(BUILD_DIR, f"{tag.lower()}_phases"), cuda, tag)
    stamped = load_stamped(so, cuda)
    batch, m, n, deg = SHAPES[args.shape]
    mn = m * n
    threads = getattr(cpr, "round_threads", cpr.block_threads)(mn)  # a tree before P2's redesign: P1's blocks
    source = os.path.relpath(os.path.abspath(args.source), ROOT)
    if args.kernel == "final":
        keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s", "s_s", "d_mask", "eta")
        inp = to_device(final_inputs(batch, m, n, deg, seed=2), torch, "cuda")
        row = split(lambda: cpr.prove_final(*(inp[k] for k in keys)), stamped, names, cuda, batch, threads // 32,
                    graph_ms)
        print(json.dumps({"kernel": "prove_final", "shape": args.shape, "threads": threads, "source": source, **row,
                          "stamped_ptxas": ptxas_report(log).get("prove_final_kernel", {})}), flush=True)
        print(nvidia_smi())
        return 0
    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")
    for r in range(mn.bit_length() - 1):
        inp = to_device(round_inputs(batch, m, n, deg, r, seed=10 + r), torch, "cuda")
        row = split(lambda: cpr.prove_round(*(inp[k] for k in keys), r=r), stamped, names, cuda, batch,  # noqa: B023
                    threads // 32, graph_ms)
        print(json.dumps({"round": r, "shape": args.shape, "threads": threads, "source": source, **row,
                          "stamped_ptxas": ptxas_report(log).get("prove_round_kernel", {})}), flush=True)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
