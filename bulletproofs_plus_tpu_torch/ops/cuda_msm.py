"""K1-K3 and K7 wrappers: the dynamic MSM through hand-written CUDA kernels.

Counterpart of bulletproofs_plus_tpu/ops/pallas_msm.py (its dynamic half;
the fixed-base kernels K5/K6 are in ops/cuda_fixed.py).
The MSM sum_i s_i * P_i runs in three stages, each a kernel on CUDA tensors
(csrc/msm.cu) and a plain torch function of the same arithmetic on CPU
tensors:

  K1 `dyn_acc`    per tile of TILE lanes: tables T[d] = d*P, then for each
                  4-bit window w the sum over the tile of T[digit_w]
                  -> (4, 16, 64, tiles) partial points
  K7 `dyn_acc_signed`  K1 with the scalars recoded to signed digits in
                  [-8, 7]: tables of 8 multiples, x and t negated where the
                  digit is negative; same output as K1
  K2 `lane_fold`  sum of the partials over tiles -> (4, 16, 64) window sums
  K3 `horner`     sum_j 16^j W_j -> (4, 16), the result point

Points cross the kernel boundary limb-major as (4 coords, 16 limbs, ...)
int64 tensors.  Different tilings give different projective coordinates of
the same point, so results compare with ristretto point equality.
"""

from __future__ import annotations

import torch

import torch.nn.functional as tnf

from ..native import cuda
from . import pfield as pf
from .edwards import PointArray
from .limbs import NLIMBS
from . import field as F
from .msm import digits4, signed_digits4

TILE = 16  # lanes per K1 block (csrc/msm.cu)
N_WINDOWS = 64
N_DIGITS = 16
_PLAIN_CHUNK_TILES = 16  # tiles per step of dyn_acc_plain: bounds its memory
HORNER_GROUPS = 8  # K3's groups of four lanes, eight windows each (csrc/msm.cu): one warp


def coords_t(points: PointArray) -> torch.Tensor:
    """PointArray with (n, 16) coords -> (4, 16, n) limb-major tensor."""
    return torch.stack([c.t() for c in points]).contiguous()


# ---------------------------------------------------------------------------
# Plain torch versions, written in the limb-major twin of the kernels' device
# functions (ops/pfield.py).  CPU tensors take these; on CUDA they are the
# reference the kernels are held against.
# ---------------------------------------------------------------------------


def _cat(parts, dim: int) -> pf.PointS:
    return pf.PointS(*(torch.cat([getattr(p, f) for p in parts], dim=dim) for f in pf.PointS._fields))


def _dyn_acc_plain(scalars_t: torch.Tensor, pts_t: torch.Tensor, signed: bool) -> torch.Tensor:
    """K1's and K7's function: per tile the tables T[d] = d*P (16 entries, or
    9 for signed digits), then per window the sum of the selected entries."""
    n = scalars_t.shape[1]
    dev = scalars_t.device
    tiles = -(-n // TILE)
    parts = []
    for t0 in range(0, tiles, _PLAIN_CHUNK_TILES):
        lo, hi = t0 * TILE, min((t0 + _PLAIN_CHUNK_TILES) * TILE, n)
        m = -(-(hi - lo) // TILE) * TILE
        sc = tnf.pad(scalars_t[:, lo:hi], (0, m - (hi - lo)))  # zero scalars on padding lanes
        pts = _cat([pf.from_coords(pts_t[:, :, lo:hi]), pf.identity((m - (hi - lo),), device=dev)], dim=1)
        table = [pf.identity((m,), device=dev), pts]
        for _ in range((9 if signed else N_DIGITS) - 2):
            table.append(pf.padd(table[-1], pts))
        dig = signed_digits4(sc.t()) if signed else digits4(sc.t())  # (64, m)
        lanes = torch.arange(m, device=dev)
        # sel[limb, w, i] = T_i[|dig[w, i]|][limb]
        sel = pf.PointS(
            *(
                torch.stack([getattr(t, f) for t in table]).permute(0, 2, 1)[dig.abs(), lanes].movedim(-1, 0)
                for f in pf.PointS._fields
            )
        )
        if signed:
            negative = dig < 0
            sel = pf.PointS(
                torch.where(negative, F.neg25519(sel.x.movedim(0, -1)).movedim(-1, 0), sel.x),
                sel.y,
                sel.z,
                torch.where(negative, F.neg25519(sel.t.movedim(0, -1)).movedim(-1, 0), sel.t),
            )
        sel = pf.PointS(*(c.reshape(NLIMBS, N_WINDOWS, m // TILE, TILE) for c in sel))  # lanes split into tiles
        parts.append(pf.lane_halve_sum(sel, axis=3, width=TILE))
    return pf.to_coords(_cat(parts, dim=2))[..., 0]


def dyn_acc_plain(scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """K1's function: (16, n) scalars, (4, 16, n) points -> (4, 16, 64, tiles),
    entry [., ., w, b] = sum over the lanes l of tile b of T_l[digit_w(s_l)]."""
    return _dyn_acc_plain(scalars_t, pts_t, signed=False)


def dyn_acc_signed_plain(scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """K7's function: as `dyn_acc_plain` with signed digits d in [-8, 7]
    (ops/msm.signed_digits4): entry = sum over the tile of sign(d) * T_l[|d|].
    Scalars must be canonical (below 2^253)."""
    return _dyn_acc_plain(scalars_t, pts_t, signed=True)


def lane_fold_plain(parts: torch.Tensor) -> torch.Tensor:
    """K2's function: (4, 16, 64, tiles) -> (4, 16, 64) window sums."""
    p = pf.from_coords(parts)
    tiles = parts.shape[-1]
    width = 1 << max(tiles - 1, 0).bit_length()
    if width != tiles:
        p = _cat([p, pf.identity((N_WINDOWS, width - tiles), device=parts.device)], dim=2)
    return pf.to_coords(pf.lane_halve_sum(p, axis=2, width=width))[..., 0]


def horner_plain(wsum: torch.Tensor) -> torch.Tensor:
    """K3's function: (4, 16, 64) window sums W_j (LSB first) -> (4, 16) point
    sum_j 16^j W_j, by Horner from the top window."""
    w = pf.from_coords(wsum)
    acc = pf.PointS(*(c[:, N_WINDOWS - 1] for c in w))
    for j in range(N_WINDOWS - 2, -1, -1):
        for _ in range(4):
            acc = pf.pdbl(acc)
        acc = pf.padd(acc, pf.PointS(*(c[:, j] for c in w)))
    return pf.to_coords(acc)


def dyn_msm_plain(scalars: torch.Tensor, points: PointArray) -> PointArray:
    """The whole K1 -> K2 -> K3 chain in plain torch: (n, 16) canonical
    scalars and points -> sum_i s_i P_i."""
    out = horner_plain(lane_fold_plain(dyn_acc_plain(scalars.t().contiguous(), coords_t(points))))
    return PointArray(*out)


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _dyn_acc_launch(name: str, scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    n = scalars_t.shape[-1]
    cuda.require(scalars_t, f"{name} scalars", (NLIMBS, n))
    cuda.require(pts_t, f"{name} points", (4, NLIMBS, n))
    if n == 0:
        raise ValueError(f"{name}: empty MSM")
    tiles = -(-n // TILE)
    out = torch.empty((4, NLIMBS, N_WINDOWS, tiles), dtype=torch.int64, device=scalars_t.device)
    with torch.cuda.device(scalars_t.device):
        status = getattr(cuda.lib("msm"), f"bppt_{name}")(
            scalars_t.data_ptr(), pts_t.data_ptr(), out.data_ptr(), n, tiles, _stream()
        )
    cuda.check("msm", status, name)
    cuda.launches[name] += 1
    return out


def dyn_acc(scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """K1: (16, n) scalar limbs, (4, 16, n) points -> (4, 16, 64, tiles)."""
    if scalars_t.device.type == "cpu":
        return dyn_acc_plain(scalars_t, pts_t)
    return _dyn_acc_launch("dyn_acc", scalars_t, pts_t)


def dyn_acc_signed(scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """K7: K1's arguments and output through signed digits in [-8, 7].  The
    scalars must be canonical (below 2^253): the kernel recodes them by
    adding 0x88..8, which must not carry out of 256 bits."""
    if scalars_t.device.type == "cpu":
        return dyn_acc_signed_plain(scalars_t, pts_t)
    return _dyn_acc_launch("dyn_acc_signed", scalars_t, pts_t)


def lane_fold(parts: torch.Tensor) -> torch.Tensor:
    """K2: (4, 16, 64, tiles) -> (4, 16, 64) window sums."""
    if parts.device.type == "cpu":
        return lane_fold_plain(parts)
    tiles = parts.shape[-1]
    cuda.require(parts, "lane_fold parts", (4, NLIMBS, N_WINDOWS, tiles))
    out = torch.empty((4, NLIMBS, N_WINDOWS), dtype=torch.int64, device=parts.device)
    with torch.cuda.device(parts.device):
        status = cuda.lib("msm").bppt_lane_fold(parts.data_ptr(), out.data_ptr(), tiles, _stream())
    cuda.check("msm", status, "lane_fold")
    cuda.launches["lane_fold"] += 1
    return out


def horner(wsum: torch.Tensor) -> torch.Tensor:
    """K3: (4, 16, 64) window sums -> (4, 16) point sum_j 16^j W_j."""
    if wsum.device.type == "cpu":
        return horner_plain(wsum)
    cuda.require(wsum, "horner window sums", (4, NLIMBS, N_WINDOWS))
    out = torch.empty((4, NLIMBS), dtype=torch.int64, device=wsum.device)
    with torch.cuda.device(wsum.device):
        status = cuda.lib("msm").bppt_horner(wsum.data_ptr(), out.data_ptr(), _stream())
    cuda.check("msm", status, "horner")
    cuda.launches["horner"] += 1
    return out
