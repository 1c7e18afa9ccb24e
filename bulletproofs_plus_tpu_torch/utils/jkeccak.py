"""Keccak-f[1600] on torch tensors: the device-side sponge's plain version.

Counterpart of bulletproofs_plus_tpu/utils/jkeccak.py.  The host layer
(utils/keccak.py + native/keccak.c) serves numpy transcripts; this module
runs the permutation on a batch of states wherever the tensors live, as the
plain version of the replay kernel's permutation (csrc/replay.cu) and the
core of utils/jstrobe.py.

Representation: a batch of sponge states is (B, 25, 2) int64 -- 25 lanes of
(lo, hi) 32-bit halves, little-endian within the lane, the JAX package's
layout.  Torch has no unsigned 64-bit integer and its `>>` on int64 is
arithmetic, so every half stays in [0, 2^32) and every operation keeps it
there: shifts are masked, and a NOT is only ever ANDed with a half.  A
round is some twenty whole-batch tensor operations (rotations by a per-lane
shift tensor), not one per lane.
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
    """Round constants (24, 2), the rho-pi source lanes, and the per-output-
    lane rotation split into (swap halves, shift within a half)."""
    rc = torch.tensor([[v & _M32, v >> 32] for v in _RC64], dtype=torch.int64, device=device)
    rot = RHO[PI_SRC]
    swap = torch.as_tensor(rot >= 32, device=device)
    shift = torch.as_tensor(rot % 32, device=device)
    return rc, torch.as_tensor(PI_SRC, device=device), swap, shift


def _rotl(lo: torch.Tensor, hi: torch.Tensor, n):
    """Rotate (lo, hi) halves left by n < 32 (an int or a broadcastable tensor)."""
    return (((lo << n) & _M32) | (hi >> (32 - n)), ((hi << n) & _M32) | (lo >> (32 - n)))


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """Apply the 24-round permutation to (B, 25, 2) int64 states."""
    rc, pi_src, swap, shift = _tables(str(state.device))
    lo, hi = state[..., 0], state[..., 1]
    batch = state.shape[0]
    for r in range(24):
        # theta: column parities c[x], then d[x] = c[x - 1] ^ rotl(c[x + 1], 1) on every lane of column x
        lo5, hi5 = lo.view(batch, 5, 5), hi.view(batch, 5, 5)
        c_lo = lo5[:, 0] ^ lo5[:, 1] ^ lo5[:, 2] ^ lo5[:, 3] ^ lo5[:, 4]
        c_hi = hi5[:, 0] ^ hi5[:, 1] ^ hi5[:, 2] ^ hi5[:, 3] ^ hi5[:, 4]
        r_lo, r_hi = _rotl(c_lo.roll(-1, 1), c_hi.roll(-1, 1), 1)
        lo = (lo5 ^ (c_lo.roll(1, 1) ^ r_lo)[:, None]).reshape(batch, 25)
        hi = (hi5 ^ (c_hi.roll(1, 1) ^ r_hi)[:, None]).reshape(batch, 25)
        # rho + pi: gather each output lane's source, swap halves for shifts >= 32, rotate the rest
        g_lo, g_hi = lo[:, pi_src], hi[:, pi_src]
        g_lo, g_hi = torch.where(swap, g_hi, g_lo), torch.where(swap, g_lo, g_hi)
        b_lo, b_hi = _rotl(g_lo, g_hi, shift)
        # chi: a[x] = b[x] ^ (~b[x + 1] & b[x + 2]) within each row
        b_lo, b_hi = b_lo.view(batch, 5, 5), b_hi.view(batch, 5, 5)
        lo = (b_lo ^ (~b_lo.roll(-1, 2) & b_lo.roll(-2, 2))).reshape(batch, 25)
        hi = (b_hi ^ (~b_hi.roll(-1, 2) & b_hi.roll(-2, 2))).reshape(batch, 25)
        # iota
        lo = torch.cat([lo[:, :1] ^ rc[r, 0], lo[:, 1:]], dim=1)
        hi = torch.cat([hi[:, :1] ^ rc[r, 1], hi[:, 1:]], dim=1)
    return torch.stack([lo, hi], dim=-1)


def bytes_to_state(data: torch.Tensor) -> torch.Tensor:
    """(B, 200) uint8 -> (B, 25, 2) int64 (little-endian lanes)."""
    b = data.reshape(data.shape[0], 25, 2, 4).long()
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def state_to_bytes(state: torch.Tensor) -> torch.Tensor:
    """(B, 25, 2) int64 -> (B, 200) uint8."""
    shifts = torch.arange(0, 32, 8, device=state.device)
    return ((state[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(state.shape[0], 200)
