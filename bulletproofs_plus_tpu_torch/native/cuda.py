"""The port's hand-written CUDA kernels: built with nvcc, loaded with ctypes.

Each source in ../csrc/*.cu becomes one shared library with a plain C
interface, compiled for sm_90a into BUILD_DIR at first use (or by `build()`,
which starts one nvcc per stale source, all at once).  Every C entry point
returns cudaGetLastError(); `check` raises on anything but 0.  There is no
fallback: a kernel that fails to build or launch is an error.

`launches` counts kernel launches by wrapper name; each wrapper adds one
where it launches, so a run can show which kernels its main path reached.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time

from . import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
ARCH = "sm_90a"
_VP, _LONG = ctypes.c_void_p, ctypes.c_long
# library -> (source, {entry point: argtypes})
LIBRARIES = {
    "msm": (
        "msm.cu",
        {
            "bppt_dyn_acc": [_VP, _VP, _VP, _LONG, _LONG, _LONG, _VP],
            "bppt_dyn_acc_signed": [_VP, _VP, _VP, _LONG, _LONG, _LONG, _VP],
            "bppt_lane_fold": [_VP, _VP, _LONG, _LONG, _VP],
            "bppt_horner": [_VP, _VP, _VP, _VP],
            "bppt_msm_occupancy": [_LONG, _LONG, _LONG, ctypes.POINTER(ctypes.c_int)],
        },
    ),
    "pow": (
        "pow.cu",
        {
            "bppt_pow_p58": [_VP, _VP, _LONG, _LONG, _VP],
            "bppt_sqrt_ratio_m1": [_VP, _LONG, _VP, _VP, _VP, _LONG, _LONG, _VP],
            "bppt_field_latency": [_VP, _VP, _LONG, _LONG, _LONG, _VP],
            "bppt_point_latency": [_VP, _VP, _LONG, _LONG, _LONG, _VP],
        },
    ),
    "ristretto": (
        "ristretto.cu",
        {
            "bppt_decompress": [_VP, _VP, _VP, _LONG, _LONG, _VP],
            "bppt_compress": [_VP, _VP, _VP, _VP, _VP, _LONG, _LONG, _VP],
            "bppt_double_compress": [_VP, _VP, _VP, _VP, _VP, _LONG, _VP],
            "bppt_fe_inv_latency": [_VP, _VP, _LONG, _VP],
            "bppt_is_identity": [_VP, _VP, _VP, _LONG, _VP],
        },
    ),
    "fixed": (
        "fixed.cu",
        {
            "bppt_fixed_acc": [_VP, _VP, _VP, _VP, _LONG, _LONG, _LONG, _LONG, _VP],
            "bppt_fixed_fold": [_VP, _VP, _LONG, _LONG, _LONG, _LONG, _LONG, _VP],
        },
    ),
    "replay": (
        "replay.cu",
        {
            "bppt_replay": [_VP, _VP, _LONG, _VP, _LONG, _LONG, _LONG, _LONG, _VP, _VP, _VP, _VP, _LONG, _LONG, _VP],
            "bppt_replay_occupancy": [_LONG, _LONG, _LONG, _LONG, _LONG, _LONG, ctypes.POINTER(ctypes.c_int)],
            "bppt_perm_latency": [_VP, _VP, _LONG, _VP],
            "bppt_keccak_latency": [_VP, _VP, _LONG, _VP],
            "bppt_reduce_wide": [_VP, _VP, _VP, _LONG, _VP],
        },
    ),
    "transcript": (
        "transcript.cu",
        {
            "bppt_prove_transcript": [_VP, _VP, _LONG, _VP, _LONG, _VP, _VP, _LONG, _LONG, _LONG, _LONG, _LONG,
                                      ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long), _LONG, _VP,
                                      _LONG, _LONG, _LONG, _VP],
            "bppt_transcript_occupancy": [_LONG, _LONG, _LONG, _LONG, _LONG, ctypes.POINTER(ctypes.c_int)],
            "bppt_transcript_inv_latency": [_VP, _VP, _LONG, _LONG, _VP],
        },
    ),
    "prover": (
        "prover.cu",
        {
            "bppt_prove_prep": [_VP] * 6 + [_LONG] * 5 + [_VP] * 7,
            "bppt_prove_round": [_VP] * 13 + [_LONG] * 6 + [_VP] * 8,
            "bppt_prove_final": [_VP] * 15 + [_LONG] * 5 + [_VP] * 6,
            "bppt_prove_responses": [_VP] * 8 + [_LONG] * 2 + [_VP] * 4,
            "bppt_bit_sum": [_VP, _LONG] + [_VP] * 5 + [_LONG] * 5 + [_VP] * 2,
        },
    ),
    "scalar": (
        "scalar_pass.cu",
        {
            "bppt_scalar_pass": [_VP] * 9 + [_LONG] * 15 + [_VP] * 13 + [_LONG] * 5 + [_VP],
            "bppt_scalar_latency": [_VP, _VP, _LONG, _VP],
            "bppt_scalar_inv_latency": [_VP, _VP, _LONG, _VP],
        },
    ),
}

launches: collections.Counter = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    candidates += [found] if found else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libbppt_{name}.so")


def log_path(name: str) -> str:
    """nvcc's output for the library, with ptxas's register and spill report."""
    return os.path.join(BUILD_DIR, f"libbppt_{name}.log")


def _stale(name: str) -> bool:
    so = so_path(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, LIBRARIES[name][0])] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    ]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def build(names=None, force: bool = False) -> dict:
    """Compile the named libraries (default: all) that are missing or older
    than their sources, one nvcc process each, all started together.
    Returns {name: seconds}; raises RuntimeError with nvcc's output on a
    failed build."""
    names = list(LIBRARIES) if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiler = nvcc()
    procs = {}
    start = time.perf_counter()
    for name in todo:
        tmp = f"{so_path(name)}.{os.getpid()}.tmp"
        cmd = [
            compiler, "-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
            os.path.join(CSRC, LIBRARIES[name][0]),
        ]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        with open(log_path(name), "w") as f:
            f.write(output)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
        else:
            os.replace(tmp, so_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            handle = ctypes.CDLL(so_path(name))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            err = getattr(handle, f"bppt_{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = handle
        return _libs[name]


def check(name: str, status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = getattr(lib(name), f"bppt_{name}_error_string")(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def require(t, what: str, shape: tuple, dtype: str = "torch.int64") -> None:
    """Validate a kernel argument: a contiguous CUDA tensor of `shape` and
    `dtype` (int64 limbs unless the kernel takes packed int32 words)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got one on {t.device}")
    if str(t.dtype) != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
