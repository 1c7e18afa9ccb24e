"""Native (C) runtime components, loaded via ctypes.

The keccak library is compiled at first use with the system compiler into
the package's git-ignored build directory (BUILD_DIR); every consumer falls
back to the numpy implementations when a toolchain is unavailable, so the
host native layer is an accelerator, never a requirement.  The CUDA kernels
(native/cuda.py) share BUILD_DIR but have no fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_SRC = os.path.join(_DIR, "keccak.c")
_SO = os.path.join(BUILD_DIR, f"_keccak_{sys.implementation.cache_tag}.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"  # concurrent test workers each build
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, _SO)
            return _SO
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def keccak_lib() -> Optional[ctypes.CDLL]:
    """The compiled keccak library, or None if no toolchain is available."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        so = _build()
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
                lib.keccak_f1600_batch.argtypes = [ctypes.c_void_p, ctypes.c_long]
                lib.keccak_f1600_batch.restype = None
                lib.strobe_append_seq.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_void_p,
                    ctypes.c_long,
                    ctypes.c_void_p,
                    ctypes.c_long,
                    ctypes.c_long,
                ]
                lib.strobe_append_seq.restype = None
                lib.strobe_rng_draws.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_long,
                    ctypes.c_long,
                    ctypes.c_void_p,
                ]
                lib.strobe_rng_draws.restype = None
                _lib = lib
            except (OSError, AttributeError):
                _lib = None
    return _lib
