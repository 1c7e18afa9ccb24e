"""Keccak-f[1600] on torch tensors: the device-side sponge's plain version.

Counterpart of bulletproofs_plus_tpu/utils/jkeccak.py.  The host layer
(utils/keccak.py + native/keccak.c) serves numpy transcripts; this module
runs the permutation on a batch of states wherever the tensors live, as the
plain version of the replay kernel's permutation (csrc/replay.cu) and the
core of utils/jstrobe.py.

Representation: a batch of sponge states is (B, 25, 2) int64 -- 25 lanes of
(lo, hi) 32-bit halves, little-endian within the lane, the JAX package's
layout.  The permutation joins each lane's halves into one int64 (its bits
those of the unsigned lane) and splits them again at the end.  Torch has no
unsigned 64-bit integer and its `>>` on int64 is arithmetic, so a right
shift is masked to the bits it brings down.  A round is some twenty
whole-batch tensor operations (rotations by a per-lane shift tensor), not
one per lane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_RC64 = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, by lane index x + 5y
RHO = np.zeros(25, dtype=np.int64)
_x, _y = 1, 0
for _t in range(24):
    RHO[_x + 5 * _y] = ((_t + 1) * (_t + 2) // 2) % 64
    _x, _y = _y, (2 * _x + 3 * _y) % 5

# pi: output lane y + 5 ((2x + 3y) % 5) takes input lane x + 5y
PI_SRC = np.zeros(25, dtype=np.int64)
for _xx in range(5):
    for _yy in range(5):
        PI_SRC[_yy + 5 * ((2 * _xx + 3 * _yy) % 5)] = _xx + 5 * _yy

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    """Round constants as int64 (24,), the rho-pi source lanes, each output
    lane's left rotation, the right shift that brings its wrapped bits down
    (63 where it rotates by 0) and their mask (0 there)."""
    rc = torch.tensor([v - (1 << 64) if v >> 63 else v for v in _RC64], dtype=torch.int64, device=device)
    rot = torch.as_tensor(RHO[PI_SRC], device=device)
    right = torch.where(rot == 0, 63, 64 - rot)
    mask = torch.where(rot == 0, 0, (1 << rot) - 1)
    return rc, torch.as_tensor(PI_SRC, device=device), rot, right, mask


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """Apply the 24-round permutation to (B, 25, 2) int64 states."""
    rc, pi_src, rot, right, mask = _tables(str(state.device))
    batch = state.shape[0]
    a = state[..., 0] | (state[..., 1] << 32)
    for r in range(24):
        # theta: column parities c[x], then d[x] = c[x - 1] ^ rotl(c[x + 1], 1) on every lane of column x
        a5 = a.view(batch, 5, 5)
        c = a5[:, 0] ^ a5[:, 1] ^ a5[:, 2] ^ a5[:, 3] ^ a5[:, 4]
        c1 = c.roll(-1, 1)
        d = c.roll(1, 1) ^ ((c1 << 1) | ((c1 >> 63) & 1))
        # rho + pi: gather each output lane's source and rotate it
        a = (a5 ^ d[:, None]).reshape(batch, 25)[:, pi_src]
        b = ((a << rot) | ((a >> right) & mask)).view(batch, 5, 5)
        # chi: a[x] = b[x] ^ (~b[x + 1] & b[x + 2]) within each row; iota
        a = (b ^ (~b.roll(-1, 2) & b.roll(-2, 2))).reshape(batch, 25)
        a[:, 0] ^= rc[r]
    return torch.stack([a & _M32, (a >> 32) & _M32], dim=-1)


def bytes_to_state(data: torch.Tensor) -> torch.Tensor:
    """(B, 200) uint8 -> (B, 25, 2) int64 (little-endian lanes)."""
    b = data.reshape(data.shape[0], 25, 2, 4).long()
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def state_to_bytes(state: torch.Tensor) -> torch.Tensor:
    """(B, 25, 2) int64 -> (B, 200) uint8."""
    shifts = torch.arange(0, 32, 8, device=state.device)
    return ((state[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(state.shape[0], 200)
