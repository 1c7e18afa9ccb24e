"""K1-K3 and K7 wrappers: the dynamic MSM through hand-written CUDA kernels.

Counterpart of bulletproofs_plus_tpu/ops/pallas_msm.py (its dynamic half;
the fixed-base kernels K5/K6 are in ops/cuda_fixed.py).
The MSM sum_i s_i * P_i runs in three stages, each a kernel on CUDA tensors
(csrc/msm.cu) and a plain torch function of the same arithmetic on CPU
tensors:

  K1 `dyn_acc`    per tile of `tile` lanes: tables T[d] = d*P, then for each
                  4-bit window w the sum over the tile of T[digit_w]
                  -> (64, tiles, 32) partial points, packed words
  K7 `dyn_acc_signed`  K1 with the scalars recoded to signed digits in
                  [-8, 7]: tables of the identity and 8 multiples, -P
                  where the digit is negative; same tiling, same layout
  K2 `lane_fold`  sum of the partials over tiles -> (4, 16, 64) window sums
  K3 `horner`     sum_j 16^j W_j -> (4, 16), the result point

K1's and K7's tile width is a launch parameter that `pick_tile` takes from
the lane count and from what the card holds at once (its SMs times the
kernel's blocks an SM holds, which the CUDA runtime's occupancy calculator
gives), so that the grid is one wave of resident blocks.  Partials cross from
K1 (or K7) to K2 as 32 packed 32-bit words a point (ops/cuda_fixed.py's
`limbs_to_words`), window major: K2 is K6's fold with a window a row.  Window
sums and the result cross as limb-major (4 coords, 16 limbs, ...) int64
tensors.  Different tilings give different projective coordinates of the
same point, so results compare with ristretto point equality.
"""

from __future__ import annotations

import ctypes
import functools

import torch

import torch.nn.functional as tnf

from ..native import cuda
from . import cuda_fixed as cf
from . import pfield as pf
from .edwards import PointArray
from .limbs import NLIMBS
from . import field as F
from .msm import digits4, signed_digits4

N_WINDOWS = 64
N_DIGITS = 16
POINT_WORDS = 32  # packed 32-bit words a partial point: x, y, z, t
# K1's and K7's tile widths: at most a warp of lanes (each table doubling takes one warp); at least 16, as
# narrower tiles cost K2 what they save K1 (csrc/msm.cu)
MIN_TILE, MAX_TILE = 16, 32
K1_THREADS = 256  # threads a K1 or K7 block (csrc/msm.cu)
# K1 or K7 blocks an H100 holds at once (132 SMs, two blocks each): what a
# CPU tensor's plain version tiles for, so that it cuts lanes as that card does
CPU_RESIDENT_TILES = 132 * 2
OCCUPANCY_KERNELS = ("dyn_acc", "lane_fold", "dyn_acc_signed")  # bppt_msm_occupancy's kernel index
_PLAIN_CHUNK_TILES = 16  # tiles per step of dyn_acc_plain: bounds its memory
HORNER_GROUPS = 8  # K3's groups of four lanes, eight windows each (csrc/msm.cu): one warp


def pick_tile(n: int, resident) -> int:
    """K1's tile width for n lanes: the narrowest from MIN_TILE whose
    ceil(n / tile) blocks are all resident at once (one wave), MAX_TILE where
    none is.  `resident(tile)` is the number of K1 blocks of that width the
    card holds at once (`resident_tiles`)."""
    return next((t for t in range(MIN_TILE, MAX_TILE) if -(-n // t) <= resident(t)), MAX_TILE)


@functools.lru_cache(maxsize=None)
def occupancy(kernel: str, device: int, threads: int = K1_THREADS, tile: int = 1) -> int:
    """Blocks of `kernel` ("dyn_acc" or "dyn_acc_signed" at a tile of `tile`
    lanes, or "lane_fold" at `threads` threads a block) that one SM of CUDA
    device `device` holds at once, by the CUDA runtime's occupancy
    calculator."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = cuda.lib("msm").bppt_msm_occupancy(OCCUPANCY_KERNELS.index(kernel), threads, tile,
                                                    ctypes.byref(blocks))
    cuda.check("msm", status, f"{kernel} occupancy")
    return blocks.value


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_tiles(device: torch.device, kernel: str = "dyn_acc"):
    """tile -> blocks of `kernel` (K1 "dyn_acc" or K7 "dyn_acc_signed") of
    that width that `device` holds at once: its SMs times `occupancy`, on a
    CUDA device; CPU_RESIDENT_TILES on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return lambda tile: CPU_RESIDENT_TILES
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = sm_count(device)
    return lambda tile: sms * occupancy(kernel, index, tile=tile)


def _check_tile(tile: int, name: str = "dyn_acc") -> None:
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"{name}: tile of {tile} lanes, expected 1 to {MAX_TILE}")


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


def _dyn_acc_plain(scalars_t: torch.Tensor, pts_t: torch.Tensor, signed: bool, tile: int) -> torch.Tensor:
    """K1's and K7's function: per tile the tables T[d] = d*P (16 entries, or
    9 for signed digits), then per window the sum of the selected entries."""
    n = scalars_t.shape[1]
    dev = scalars_t.device
    tiles = -(-n // tile)
    width = 1 << (tile - 1).bit_length()  # the tile axis padded with identities to a power of two
    parts = []
    for t0 in range(0, tiles, _PLAIN_CHUNK_TILES):
        lo, hi = t0 * tile, min((t0 + _PLAIN_CHUNK_TILES) * tile, n)
        m = -(-(hi - lo) // tile) * tile
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
        sel = pf.PointS(*(c.reshape(NLIMBS, N_WINDOWS, m // tile, tile) for c in sel))  # lanes split into tiles
        if width != tile:
            sel = _cat([sel, pf.identity((N_WINDOWS, m // tile, width - tile), device=dev)], dim=3)
        parts.append(pf.lane_halve_sum(sel, axis=3, width=width))
    coords = pf.to_coords(_cat(parts, dim=2))[..., 0]  # (4, 16, 64, tiles)
    return cf.limbs_to_words(coords.permute(2, 3, 0, 1))


def dyn_acc_plain(scalars_t: torch.Tensor, pts_t: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """K1's function: (16, n) scalars, (4, 16, n) points -> (64, tiles, 32)
    words, point [w, b] = sum over the lanes l of tile b (`tile` lanes; by
    default the width `dyn_acc` picks on the tensors' device) of
    T_l[digit_w(s_l)]."""
    tile = pick_tile(scalars_t.shape[1], resident_tiles(scalars_t.device)) if tile is None else tile
    _check_tile(tile)
    return _dyn_acc_plain(scalars_t, pts_t, signed=False, tile=tile)


def dyn_acc_signed_plain(scalars_t: torch.Tensor, pts_t: torch.Tensor, tile: int | None = None) -> torch.Tensor:
    """K7's function: as `dyn_acc_plain` with signed digits d in [-8, 7]
    (ops/msm.signed_digits4), tiled as `dyn_acc_signed` tiles on the
    tensors' device unless `tile` is given: point = sum over the tile of
    sign(d) * T_l[|d|].  Scalars must be canonical (below 2^253)."""
    if tile is None:
        tile = pick_tile(scalars_t.shape[1], resident_tiles(scalars_t.device, "dyn_acc_signed"))
    _check_tile(tile, "dyn_acc_signed")
    return _dyn_acc_plain(scalars_t, pts_t, signed=True, tile=tile)


def lane_fold_plain(parts: torch.Tensor) -> torch.Tensor:
    """K2's function: (64, tiles, 32) words -> (4, 16, 64) window sums."""
    return cf.fixed_fold_plain(parts, 1, 1)[..., 0]


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


def horner_identity_plain(wsum: torch.Tensor):
    """K3 with its tail: `horner_plain`, then I1's plain twin on its point
    -> (point, () bool)."""
    from .ristretto import is_identity_plain

    out = horner_plain(wsum)
    return out, is_identity_plain(PointArray(*out))


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


def _check_dyn_args(name: str, scalars_t: torch.Tensor, pts_t: torch.Tensor) -> int:
    n = scalars_t.shape[-1]
    cuda.require(scalars_t, f"{name} scalars", (NLIMBS, n))
    cuda.require(pts_t, f"{name} points", (4, NLIMBS, n))
    if n == 0:
        raise ValueError(f"{name}: empty MSM")
    return n


def dyn_acc(scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """K1: (16, n) scalar limbs, (4, 16, n) points -> (64, tiles, 32) int32
    words, tiles = ceil(n / tile) at the tile width `pick_tile` takes for
    the tensors' device."""
    if scalars_t.device.type == "cpu":
        return dyn_acc_plain(scalars_t, pts_t)
    n = _check_dyn_args("dyn_acc", scalars_t, pts_t)
    return _launch_dyn_acc(scalars_t, pts_t, pick_tile(n, resident_tiles(scalars_t.device)))


def _launch_dyn_acc(scalars_t: torch.Tensor, pts_t: torch.Tensor, tile: int) -> torch.Tensor:
    """K1's launch at a given tile width: `dyn_acc`'s, and the card tests'
    and chip_smoke.py's way to hold other widths against the plain version."""
    _check_tile(tile)
    n = _check_dyn_args("dyn_acc", scalars_t, pts_t)
    tiles = -(-n // tile)
    out = torch.empty((N_WINDOWS, tiles, POINT_WORDS), dtype=torch.int32, device=scalars_t.device)
    with torch.cuda.device(scalars_t.device):
        status = cuda.lib("msm").bppt_dyn_acc(
            scalars_t.data_ptr(), pts_t.data_ptr(), out.data_ptr(), n, tile, tiles, _stream()
        )
    cuda.check("msm", status, "dyn_acc")
    cuda.launches["dyn_acc"] += 1
    return out


def dyn_acc_signed(scalars_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """K7: K1's arguments and output layout through signed digits in [-8, 7],
    at the tile width `pick_tile` takes from K7's own occupancy.  The scalars
    must be canonical (below 2^253): the kernel recodes them by adding
    0x88..8, which must not carry out of 256 bits."""
    if scalars_t.device.type == "cpu":
        return dyn_acc_signed_plain(scalars_t, pts_t)
    n = _check_dyn_args("dyn_acc_signed", scalars_t, pts_t)
    return _launch_dyn_acc_signed(scalars_t, pts_t, pick_tile(n, resident_tiles(scalars_t.device, "dyn_acc_signed")))


def _launch_dyn_acc_signed(scalars_t: torch.Tensor, pts_t: torch.Tensor, tile: int) -> torch.Tensor:
    """K7's launch at a given tile width, as `_launch_dyn_acc` is K1's."""
    _check_tile(tile, "dyn_acc_signed")
    n = _check_dyn_args("dyn_acc_signed", scalars_t, pts_t)
    tiles = -(-n // tile)
    out = torch.empty((N_WINDOWS, tiles, POINT_WORDS), dtype=torch.int32, device=scalars_t.device)
    with torch.cuda.device(scalars_t.device):
        status = cuda.lib("msm").bppt_dyn_acc_signed(
            scalars_t.data_ptr(), pts_t.data_ptr(), out.data_ptr(), n, tile, tiles, _stream()
        )
    cuda.check("msm", status, "dyn_acc_signed")
    cuda.launches["dyn_acc_signed"] += 1
    return out


def _check_parts(parts: torch.Tensor) -> None:
    if parts.dim() != 3 or parts.shape[0] != N_WINDOWS or parts.shape[2] != POINT_WORDS or parts.shape[1] == 0:
        raise ValueError(f"lane_fold: expected (64, tiles, {POINT_WORDS}) partial words, got {tuple(parts.shape)}")


def lane_fold(parts: torch.Tensor) -> torch.Tensor:
    """K2: (64, tiles, 32) partial words -> (4, 16, 64) window sums, at the
    block size `cuda_fixed.pick_fold_threads` takes from the tile count."""
    _check_parts(parts)
    if parts.device.type == "cpu":
        return lane_fold_plain(parts)
    return _launch_lane_fold(parts, cf.pick_fold_threads(parts.shape[1], N_WINDOWS))


def _launch_lane_fold(parts: torch.Tensor, threads: int) -> torch.Tensor:
    """K2's launch at a given block size (one of cuda_fixed.FOLD_THREADS):
    `lane_fold`'s, and the card tests' and chip_smoke.py's way to hold the
    other sizes against the plain version."""
    if threads not in cf.FOLD_THREADS:
        raise ValueError(f"lane_fold: expected one of {cf.FOLD_THREADS} threads a block, got {threads!r}")
    _check_parts(parts)
    tiles = parts.shape[1]
    cuda.require(parts, "lane_fold parts", (N_WINDOWS, tiles, POINT_WORDS), dtype="torch.int32")
    out = torch.empty((4, NLIMBS, N_WINDOWS), dtype=torch.int64, device=parts.device)
    with torch.cuda.device(parts.device):
        status = cuda.lib("msm").bppt_lane_fold(
            parts.data_ptr(), out.data_ptr(), tiles, threads, _stream()
        )
    cuda.check("msm", status, "lane_fold")
    cuda.launches["lane_fold"] += 1
    return out


def horner(wsum: torch.Tensor, identity: bool = False):
    """K3: (4, 16, 64) window sums -> (4, 16) point sum_j 16^j W_j; with
    `identity`, (point, () bool: the point is the identity) from the same
    launch, I1's verdict from K3's tail (`horner_identity_plain` on the CPU)."""
    if wsum.device.type == "cpu":
        return horner_identity_plain(wsum) if identity else horner_plain(wsum)
    cuda.require(wsum, "horner window sums", (4, NLIMBS, N_WINDOWS))
    out = torch.empty((4, NLIMBS), dtype=torch.int64, device=wsum.device)
    flag = torch.empty((), dtype=torch.bool, device=wsum.device) if identity else None
    with torch.cuda.device(wsum.device):
        status = cuda.lib("msm").bppt_horner(wsum.data_ptr(), out.data_ptr(),
                                             flag.data_ptr() if identity else None, _stream())
    cuda.check("msm", status, "horner")
    cuda.launches["horner"] += 1
    return (out, flag) if identity else out
