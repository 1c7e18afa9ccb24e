"""Limb-vector codecs: 256-bit integers as (..., 16) uint32 arrays, radix 2^16.

Host copy of bulletproofs_plus_tpu/ops/limbs.py: the port keeps the JAX
package's radix-2^16 layout at its public functions, so both packages' limb
arrays compare like with like.  Device tensors hold the same limbs in int64
(see ops/field.py).  Little-endian limb order; two bytes per limb, so the
canonical 32-byte wire encodings used by the protocol map 1:1 onto limbs.

These helpers are dual-use: they work on numpy arrays (host).
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = 0xFFFF
NLIMBS = 16  # 256 bits


def limbs_from_int(value: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Host: python int -> (nlimbs,) uint32 limb array."""
    if value < 0:
        raise ValueError("negative")
    out = np.zeros(nlimbs, dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = value & LIMB_MASK
        value >>= LIMB_BITS
    if value:
        raise ValueError("value does not fit in limbs")
    return out


def int_from_limbs(limbs) -> int:
    """Host: (nlimbs,) limb array -> python int (limbs may exceed 2^16)."""
    arr = np.asarray(limbs)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr.tolist()))


def limbs_from_bytes(data: np.ndarray) -> np.ndarray:
    """(..., 32) uint8 little-endian -> (..., 16) uint32 limbs."""
    arr = np.asarray(data) if isinstance(data, (bytes, bytearray)) else data
    if isinstance(data, (bytes, bytearray)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    lo = arr[..., 0::2].astype(np.uint32)
    hi = arr[..., 1::2].astype(np.uint32)
    return lo | (hi << np.uint32(8))


def bytes_from_limbs(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) limbs (each < 2^16) -> (..., 32) uint8 little-endian."""
    arr = np.asarray(limbs)
    out = np.stack([arr & 0xFF, arr >> 8], axis=-1).astype(np.uint8)
    return out.reshape(arr.shape[:-1] + (2 * arr.shape[-1],))


def pack_ints(values, nlimbs: int = NLIMBS) -> np.ndarray:
    """Host: list of python ints (< 2^(16*nlimbs)) -> (len, nlimbs) uint32.

    Vectorised through a bytes buffer — no per-limb Python loop."""
    values = list(values)
    if not values:
        return np.zeros((0, nlimbs), np.uint32)
    nbytes = 2 * nlimbs
    data = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    arr = np.frombuffer(data, dtype=np.uint8).reshape(len(values), nbytes)
    lo = arr[:, 0::2].astype(np.uint32)
    hi = arr[:, 1::2].astype(np.uint32)
    return lo | (hi << np.uint32(8))


def unpack_ints(arr) -> list:
    """Host: (n, nlimbs) canonical limbs -> list of python ints."""
    a = np.asarray(arr)
    if a.shape[0] == 0:
        return []
    data = bytes_from_limbs(a).tobytes()
    w = a.shape[-1] * 2
    return [int.from_bytes(data[i * w : (i + 1) * w], "little") for i in range(a.shape[0])]
