#!/usr/bin/env python3
"""Where the time of one of the prover's kernels goes, phase by phase:
clock64() stamps at the phase markers of the port's prove_prep_kernel (P1),
prove_round_kernel (P2), prove_final_kernel (P3) or bit_sum_kernel (P4) in
csrc/prover.cu, or of prove_transcript_kernel (T1) in csrc/transcript.cu.

    python3 scripts/profile_torch_p2.py [--kernel round|final|prep|bit_sum|transcript] [--source PATH]
                                        [--shape b128_mn64] [--threads N[,N..]]

Copies prover.cu (transcript.cu with `--kernel transcript`; or PATH, the
same file of another tree) and the headers beside it into a scratch
directory under the port's build directory, turns each marker line `// P2
phase: <name>` (`// P3 phase:` with `--kernel final`, `// P1 phase:` with
`prep`, `// P4 phase:` with `bit_sum`, `// T1 phase:` with `transcript`)
into a stamp (lane 0 of every warp writes clock64() to a device buffer: no
barrier is added), builds that copy with nvcc as native/cuda.py builds the
library, and runs the kernel through the port's own wrapper
(ops/cuda_prover.py, ops/cuda_transcript.py) on the seeded inputs of
tests/torch_prover_inputs.py (T1: chip_smoke.py's `_transcript_inputs` at
one of its TRANSCRIPT_SHAPES, b64_m1_x128 unless `--shape` names
another), its outputs checked against the unpatched kernel's: P2 at every
round of the prove's shape, T1 at every phase (each from its own input
state), the others once (P4 on the tables the prove sums).  For each
launch it prints one JSON line: for each phase the SM cycles from the
marker before (the last warp of a block to pass each marker, averaged
over the blocks), its share of the stamped time and that share of the
unpatched kernel's `graph_ms` measured in the same run, and the patched
kernel's own `graph_ms`, which shows what the stamps cost.  `--threads`
(P1 and P4) runs the launch at each block size given instead of the
wrapper's own (`prep_threads`, `bit_sum_threads`), one line each.  Then the
card's name and power limit.  Needs a CUDA device and nvcc.
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

MARKER = re.compile(r"^(\s*)// (P[1-4]|T1) phase: (\S+)\s*$")
TAGS = {"round": "P2", "final": "P3", "prep": "P1", "bit_sum": "P4", "transcript": "T1"}  # --kernel -> its markers
LIBRARY = {"T1": "transcript"}  # the library a tag's kernel lives in, "prover" unless named
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
    """A source's text -> (the text with stamps at the `// <tag> phase:`
    markers, the phase names in order); the other kernels' markers stay
    comments.  The stamp code goes after the source's last local include."""
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
    at = text.rindex('#include "')
    at = text.index("\n", at) + 1
    return text[:at] + STAMP_CODE + text[at:], names


def _start(source_path: str, out_dir: str, cuda, tag: str):
    """Writes the copy of source_path stamped at its `// <tag> phase:`
    markers into out_dir and starts nvcc on it: (the process, its library,
    the phase names)."""
    os.makedirs(out_dir, exist_ok=True)
    for header in glob.glob(os.path.join(os.path.dirname(source_path), "*.cuh")):
        shutil.copy(header, out_dir)
    with open(source_path) as f:
        text, names = patch(f.read(), tag)
    stem = os.path.splitext(os.path.basename(source_path))[0]
    cu = os.path.join(out_dir, f"{stem}_phases.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"libbppt_{stem}_phases.so")
    cmd = [cuda.nvcc(), "-gencode", f"arch=compute_{cuda.ARCH[3:]},code={cuda.ARCH}", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so, names


def _finish(proc, so: str, names, out_dir: str):
    out, _ = proc.communicate()
    with open(os.path.join(out_dir, "phases.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{out}")
    return so, names, out


def build(source_path: str, out_dir: str, cuda, tag: str = "P2"):
    """The copy of source_path stamped at its `// <tag> phase:` markers, built
    into out_dir: (its library, the phase names, nvcc's output)."""
    return _finish(*_start(source_path, out_dir, cuda, tag), out_dir)


def build_all(source_path: str, out_root: str, cuda, tags) -> dict:
    """`build` for each tag at once, one nvcc each, all started together:
    tag -> (its library, the phase names, nvcc's output), each under
    out_root/<tag>_phases."""
    started = {tag: (_start(source_path, os.path.join(out_root, f"{tag.lower()}_phases"), cuda, tag),
                     os.path.join(out_root, f"{tag.lower()}_phases")) for tag in tags}
    return {tag: _finish(*job, out_dir) for tag, (job, out_dir) in started.items()}


def load_stamped(so: str, cuda, library: str = "prover"):
    """The stamped library, its entry points typed as native/cuda.py types
    `library`'s (those an older tree's source lacks left out)."""
    lib = ctypes.CDLL(so)
    for fn, argtypes in cuda.LIBRARIES[library][1].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"bppt_{library}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.bppt_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
    lib.bppt_phase_stamps.restype = ctypes.c_int
    return lib


def split(call, stamped, names, cuda, blocks: int, warps: int, graph_ms, timed=None, library: str = "prover") -> dict:
    """One launch (`call`, through the port's wrapper, returning its outputs)
    timed by graph replays of `timed` (`call` unless given: a launch that
    writes in place times without its restore), then run once on the
    stamped library: each phase's mean SM cycles (the last warp of a block
    at each marker, from the first warp at the first marker), its share and
    that share of the launch's graph time; the stamped library's own graph
    time beside it."""
    import numpy as np
    import torch

    timed = timed or call
    want = call()
    unstamped_ms = graph_ms(timed)
    buf = np.zeros(MAX_BLOCKS * MAX_WARPS * MAX_STAMPS, dtype=np.uint64)
    plain_lib = cuda.lib(library)
    cuda._libs[library] = stamped
    try:
        if stamped.bppt_phase_stamps(buf.ctypes.data, buf.nbytes, 1) != 0:
            raise RuntimeError("phases: could not clear the stamp buffer")
        got = call()
        torch.cuda.synchronize()
        if stamped.bppt_phase_stamps(buf.ctypes.data, buf.nbytes, 0) != 0:
            raise RuntimeError("phases: could not read the stamp buffer")
        stamped_ms = graph_ms(timed)
    finally:
        cuda._libs[library] = plain_lib
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


PREP_KEYS = ("y", "z", "y_inv", "bits", "r_blind", "alpha0")
ROUND_KEYS = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")
FINAL_KEYS = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s", "s_s", "d_mask", "eta")


def launches(kernel: str, shape, torch, cpr, pin):
    """(name, the launch through the port's wrapper) for each launch that
    `--kernel` stamps, at `shape` (proofs, m, bit length, degree)."""
    batch, m, n, deg = shape
    if kernel == "prep":
        inp = pin.to_device(pin.prep_inputs(batch, m, n, deg, seed=1), torch, "cuda")
        return [("prove_prep", lambda: cpr.prove_prep(*(inp[k] for k in PREP_KEYS), bit_length=n))]
    if kernel == "final":
        inp = pin.to_device(pin.final_inputs(batch, m, n, deg, seed=2), torch, "cuda")
        return [("prove_final", lambda: cpr.prove_final(*(inp[k] for k in FINAL_KEYS)))]
    if kernel == "bit_sum":
        table, bits, _, start = pin.bit_sum_inputs(batch, m, n, deg, "cuda", seed=4)
        return [("bit_sum", lambda: cpr.bit_sum(start, bits, table))]
    out = []
    for r in range((m * n).bit_length() - 1):
        inp = pin.to_device(pin.round_inputs(batch, m, n, deg, r, seed=10 + r), torch, "cuda")
        out.append((f"round {r}", lambda inp=inp, r=r: cpr.prove_round(*(inp[k] for k in ROUND_KEYS), r=r)))
    return out


def transcript_launches(label: str, torch):
    """(name, checked call, bare launch) for each of T1's phases at chip_smoke.py's
    TRANSCRIPT_SHAPES `label`, and the launch's grid: the checked call
    restores the phase's input state, launches and returns the state, the
    scalars and the flags; the bare launch advances the state in place."""
    import random

    import bulletproofs_plus_tpu_torch as bp
    from chip_smoke import TRANSCRIPT_SHAPES, _transcript_inputs

    from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct

    _, batch, bits, m, deg, seeded = next(s for s in TRANSCRIPT_SHAPES if s[0] == label)
    phases, state, witness, blocks, points = _transcript_inputs(torch, bp, batch, bits, m, deg, seeded,
                                                                random.Random(7))
    out = []
    for p, ph in enumerate(phases):
        block = blocks[p] if ph.n_draws else None
        outs = torch.zeros((ph.n_wide + len(ph.invert), batch, 16), dtype=torch.int64, device="cuda")
        flags = torch.zeros((batch,), dtype=torch.uint8, device="cuda")
        start = state.clone()

        def launch(ph=ph, p=p, block=block, outs=outs, flags=flags):
            ct.transcript_cuda(ph, state, points[p], witness, block, list(outs), flags)

        def checked(launch=launch, start=start, outs=outs, flags=flags):
            state.copy_(start)
            launch()
            return [state.clone(), outs.clone(), flags.clone()]

        out.append((f"phase {p}", checked, launch))
        launch()  # the next phase's input state
    return out, ct.launch_shape(phases[0], batch, "cuda")


def block_threads(kernel: str, cpr, m: int, mn: int) -> int:
    """The wrapper's own threads a block for `--kernel`."""
    if kernel == "prep":  # a tree before P1's redesign: `block_threads`
        return cpr.prep_threads(mn, m) if hasattr(cpr, "prep_threads") else cpr.block_threads(mn)
    if kernel == "bit_sum":
        return cpr.bit_sum_threads(mn)
    return cpr.round_threads(mn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_p2: no CUDA device", file=sys.stderr)
        return 2
    import torch_prover_inputs as pin
    from chip_smoke import graph_ms, nvidia_smi, ptxas_report

    from bulletproofs_plus_tpu_torch.native import BUILD_DIR, cuda
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="round", choices=sorted(TAGS))
    ap.add_argument("--source", default=None, help="the kernel's source file of another tree")
    ap.add_argument("--shape", default=None,
                    help=f"P1-P4: one of {sorted(SHAPES)} (b128_mn64); T1: a TRANSCRIPT_SHAPES label (b64_m1_x128)")
    ap.add_argument("--threads", default="", help="P1 and P4: block sizes to run instead of the wrapper's")
    args = ap.parse_args()

    tag = TAGS[args.kernel]
    library = LIBRARY.get(tag, "prover")
    source_path = os.path.abspath(args.source or os.path.join(cuda.CSRC, cuda.LIBRARIES[library][0]))
    so, names, log = build(source_path, os.path.join(BUILD_DIR, f"{tag.lower()}_phases"), cuda, tag)
    stamped = load_stamped(so, cuda, library)
    source = os.path.relpath(source_path, ROOT)
    if tag == "T1":
        shape = args.shape or "b64_m1_x128"
        calls, grid = transcript_launches(shape, torch)
        for name, checked, launch in calls:
            row = split(checked, stamped, names, cuda, grid["blocks"], grid["warps"], graph_ms, timed=launch,
                        library=library)
            print(json.dumps({"kernel": f"prove_transcript {name}", "shape": shape, "threads": 32 * grid["warps"],
                              "source": source, **row,
                              "stamped_ptxas": ptxas_report(log).get("prove_transcript_kernel", {})}), flush=True)
        print(nvidia_smi())
        return 0
    args.shape = args.shape or "b128_mn64"
    if args.shape not in SHAPES:
        raise SystemExit(f"--shape: one of {sorted(SHAPES)}")
    batch, m, n, deg = SHAPES[args.shape]
    mn = m * n
    kernel_name = {"prep": "prove_prep_kernel", "round": "prove_round_kernel", "final": "prove_final_kernel",
                   "bit_sum": "bit_sum_kernel"}[args.kernel]
    sizes = [int(t) for t in args.threads.split(",") if t] or [None]
    if sizes != [None] and args.kernel not in ("prep", "bit_sum"):
        raise SystemExit("--threads: P1 and P4 only")
    own = getattr(cpr, {"prep": "prep_threads", "bit_sum": "bit_sum_threads"}.get(args.kernel, ""), None)
    for size in sizes:
        if size is not None:  # the wrappers look their block size up at each call
            setattr(cpr, own.__name__, lambda *_, size=size: size)
        try:
            threads = block_threads(args.kernel, cpr, m, mn)
            for name, call in launches(args.kernel, SHAPES[args.shape], torch, cpr, pin):
                row = split(call, stamped, names, cuda, batch, threads // 32, graph_ms)
                print(json.dumps({"kernel": name, "shape": args.shape, "threads": threads, "source": source, **row,
                                  "stamped_ptxas": ptxas_report(log).get(kernel_name, {})}), flush=True)
        finally:
            if own is not None:
                setattr(cpr, own.__name__, own)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
