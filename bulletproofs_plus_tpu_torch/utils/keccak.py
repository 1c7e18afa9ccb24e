"""Batched Keccak-f[1600] permutation in numpy.

The Fiat-Shamir layer of the framework (Merlin/STROBE-128 transcripts, see
``merlin.py``/``strobe.py``) is host-side and *batched*: one array of B
sponge states advances in lockstep, so a batch of B proofs replays B
transcripts for the cost of ~one (numpy-vectorised) permutation stream.
This is the batch-axis reframing of the reference's per-proof sequential
transcript (reference src/transcripts.rs:59-201): batch is an array
axis even on the host.

Correctness is pinned by implementing SHA3-256 on top of this permutation
and comparing against hashlib (see tests/test_keccak.py).
"""

from __future__ import annotations

import numpy as np

# The 24 Keccak round constants, generated from the standard LFSR
# (regenerated programmatically below to guard against typos).


def _round_constants() -> np.ndarray:
    rcs = []
    lfsr = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if lfsr & 1:
                rc ^= 1 << ((1 << j) - 1)
            lfsr <<= 1
            if lfsr & 0x100:
                lfsr ^= 0x171
        rcs.append(rc)
    return np.array(rcs, dtype=np.uint64)


_RC = _round_constants()

# Rho rotation offsets and pi permutation, flat lane index i = x + 5*y.


def _rho_pi_tables():
    rot = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rot[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    # pi: B[y, 2x+3y] = A[x, y]  =>  dst index for src (x,y)
    dst_of_src = [0] * 25
    for xx in range(5):
        for yy in range(5):
            dst_of_src[xx + 5 * yy] = yy + 5 * ((2 * xx + 3 * yy) % 5)
    # We want, for each dst j, the src index and its rotation.
    src = [0] * 25
    amt = [0] * 25
    for s, d in enumerate(dst_of_src):
        src[d] = s
        amt[d] = rot[s]
    return np.array(src), np.array(amt, dtype=np.uint64)


_PI_SRC, _PI_ROT = _rho_pi_tables()
_PI_ROT_INV = np.uint64(64) - _PI_ROT
# Chi index tables (flat i = x + 5y):
_CHI_A = np.array([((i % 5) + 1) % 5 + 5 * (i // 5) for i in range(25)])
_CHI_B = np.array([((i % 5) + 2) % 5 + 5 * (i // 5) for i in range(25)])

_THETA_C_IDX = np.array([[x + 5 * y for y in range(5)] for x in range(5)])  # (5,5)


def keccak_f1600(state: np.ndarray) -> np.ndarray:
    """Apply Keccak-f[1600] to a batch of states.

    Uses the native C kernel (bulletproofs_plus_tpu_torch.native) when a system
    compiler is available; the numpy path below is the portable fallback and
    the correctness oracle.

    Args:
      state: (..., 25) uint64 array, lane i = x + 5*y, little-endian lanes.
    Returns:
      new (..., 25) uint64 array.
    """
    from ..native import keccak_lib

    lib = keccak_lib()
    if lib is not None:
        out = np.ascontiguousarray(state, dtype=np.uint64).copy()
        batch = int(np.prod(out.shape[:-1])) if out.ndim > 1 else 1
        lib.keccak_f1600_batch(out.ctypes.data, batch)
        return out

    a = state.astype(np.uint64, copy=True)
    one = np.uint64(1)
    s63 = np.uint64(63)
    x_of_lane = np.arange(25) % 5
    for rnd in range(24):
        # theta
        c = (
            a[..., _THETA_C_IDX[:, 0]]
            ^ a[..., _THETA_C_IDX[:, 1]]
            ^ a[..., _THETA_C_IDX[:, 2]]
            ^ a[..., _THETA_C_IDX[:, 3]]
            ^ a[..., _THETA_C_IDX[:, 4]]
        )  # (..., 5) indexed by x
        d = c[..., [4, 0, 1, 2, 3]] ^ ((c[..., [1, 2, 3, 4, 0]] << one) | (c[..., [1, 2, 3, 4, 0]] >> s63))
        a = a ^ d[..., x_of_lane]
        # rho + pi
        g = a[..., _PI_SRC]
        rot = _PI_ROT
        b = np.where(rot == 0, g, (g << rot) | (g >> _PI_ROT_INV))
        # chi
        a = b ^ (~b[..., _CHI_A] & b[..., _CHI_B])
        # iota
        a[..., 0] ^= _RC[rnd]
    return a


def states_as_bytes(state_u64: np.ndarray) -> np.ndarray:
    """View (..., 25) uint64 states as (..., 200) uint8 (little-endian)."""
    assert state_u64.dtype == np.uint64
    state_u64 = np.ascontiguousarray(state_u64)
    return state_u64.view(np.uint8).reshape(*state_u64.shape[:-1], 200)


def bytes_as_states(state_u8: np.ndarray) -> np.ndarray:
    assert state_u8.dtype == np.uint8 and state_u8.shape[-1] == 200
    return state_u8.view(np.uint64).reshape(*state_u8.shape[:-1], 25)
