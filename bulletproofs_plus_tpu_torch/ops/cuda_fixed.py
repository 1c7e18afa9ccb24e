"""K5-K6 wrappers: the batched fixed-base MSM through hand-written CUDA kernels.

Counterpart of the fixed-base half of bulletproofs_plus_tpu/ops/pallas_msm.py
(`fixed_msm_partials`).  For F batch rows of S scalars over a precomputed
digit table the MSM runs in two stages, each a kernel on CUDA tensors
(csrc/fixed.cu) and a plain torch function of the same arithmetic on CPU
tensors:

  K5 `fixed_acc`   per (row, scalar position, window range): the sum over
                   64 / wsplit windows of the table entry the digit selects
                   -> (F, wsplit * S, 32) partial points, packed words
  K6 `fixed_fold`  per (row, lane group): the sum of the group's partials
                   -> (4, 16, F, groups) int64 limbs

The table holds T[w, d, lane] = d * 16^w * P_lane as the affine point
precomputed for the mixed addition, (y + x, y - x, 2d x y), canonical, 24
packed 32-bit words per entry (ops/fixed_base.pack_tables), int32
(64, 16, S_tab, 24).  `lane_idx` maps scalar position -> table lane, so a
permuted MSM reads the table in place.  `wsplit`, the number of window
ranges a (row, position) is split into, is picked from the shape
(`pick_wsplit`): few rows x lanes take more and shorter ranges.  Points
leave K6 limb-major as (4 coords, 16 limbs, ...) int64 tensors, like K1-K3's.
"""

from __future__ import annotations

import torch

from ..native import cuda
from . import pfield as pf
from .limbs import NLIMBS
from .msm import digits4_nd

N_WINDOWS = 64
N_DIGITS = 16
ENTRY_WORDS = 24  # packed 32-bit words per table entry: y + x, y - x, 2d x y
POINT_WORDS = 32  # packed 32-bit words per partial point: x, y, z, t
WSPLITS = (4, 8, 16)  # window splits the wrapper picks from; the kernels take any power of two up to 64
FOLD_THREADS = (128, 256, 512)  # K6's block sizes: a quarter as many four-lane adders
N_SMS = 132  # streaming multiprocessors of an H100
# Threads K5 keeps resident: 4 blocks of 128 threads an SM (csrc/fixed.cu).
RESIDENT_THREADS = N_SMS * 4 * 128


def pick_wsplit(rows: int, lanes: int) -> int:
    """The window split for a (rows, lanes) MSM: the finest of `WSPLITS`
    whose threads are all resident at once, so that a small shape gets many
    short chains and a wide one exactly one wave; the coarsest where even
    that does not fit."""
    fitting = [w for w in WSPLITS if rows * lanes * w <= RESIDENT_THREADS]
    return max(fitting) if fitting else min(WSPLITS)


def pick_fold_threads(count: int, blocks: int) -> int:
    """K6's block size for `blocks` blocks of `count` partials each: a
    quarter as many four-lane adders.  Few partials take a small block (a
    shallow tree, no idle warps); many take the largest where every block
    has an SM of its own, since more blocks than SMs queue for the
    multipliers and gain nothing from wider blocks."""
    if count <= 32:
        return 128
    return 512 if count > 256 and blocks <= N_SMS else 256


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(..., 8k) packed int32 words -> (..., k, 16) int64 limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(words.shape[:-1] + (words.shape[-1] // 8, NLIMBS))


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., k, 16) int64 limbs below 2^16 -> (..., 8k) packed int32 words."""
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)  # (..., k, 8), each below 2^32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)  # the same bits as int32
    return words.reshape(words.shape[:-2] + (-1,)).to(torch.int32).contiguous()


def words_to_coords(words: torch.Tensor) -> torch.Tensor:
    """(..., 32) packed point words -> (4, 16, ...) int64 limb-major coordinates."""
    return words_to_limbs(words).movedim(-1, 0).movedim(-1, 0).contiguous()


# ---------------------------------------------------------------------------
# Plain torch versions (ops/pfield.py): CPU tensors take these; on CUDA they
# are the reference the kernels are held against.
# ---------------------------------------------------------------------------


def fixed_acc_plain(table: torch.Tensor, lane_idx: torch.Tensor, scalars_t: torch.Tensor, wsplit: int) -> torch.Tensor:
    """K5's function: table (64, 16, S_tab, 24), lane_idx (S,), scalars
    (16, F, S) -> (F, wsplit * S, 32) words; point [f, q * S + s] is the sum
    over windows q * 64 / wsplit .. (q + 1) * 64 / wsplit - 1 of
    T[w, digit_w(scalar[f, s]), lane_idx[s]]."""
    f, s = scalars_t.shape[1:]
    wpt = N_WINDOWS // wsplit
    dig = digits4_nd(scalars_t.movedim(0, -1))  # (64, F, S)
    windows = torch.arange(N_WINDOWS, device=table.device)[:, None, None]
    sel = words_to_limbs(table[windows, dig, lane_idx[None, None, :]])  # (64, F, S, 3, 16): a gather
    sel = sel.movedim(-1, 0).movedim(-1, 0).reshape(3, NLIMBS, wsplit, wpt, f, s)
    acc = pf.from_niels(pf.NielsS(*sel[:, :, :, 0]))
    for j in range(1, wpt):
        acc = pf.madd(acc, pf.NielsS(*sel[:, :, :, j]))
    coords = pf.to_coords(acc)  # (4, 16, wsplit, F, S)
    return limbs_to_words(coords.permute(3, 2, 4, 0, 1)).reshape(f, wsplit * s, POINT_WORDS)


def fixed_fold_plain(parts: torch.Tensor, groups: int, wsplit: int) -> torch.Tensor:
    """K6's function: (F, wsplit * S, 32) words -> (4, 16, F, groups), the sum
    of each contiguous lane group's partials over all window ranges."""
    f = parts.shape[0]
    s = parts.shape[1] // wsplit
    per = s // groups
    coords = words_to_coords(parts)  # (4, 16, F, wsplit * S)
    grouped = coords.reshape(4, NLIMBS, f, wsplit, groups, per).movedim(3, 4).reshape(4, NLIMBS, f, groups, wsplit * per)
    p = pf.from_coords(grouped)
    count = wsplit * per
    width = 1 << (count - 1).bit_length()
    if width != count:
        pad = pf.identity((f, groups, width - count), device=parts.device)
        p = pf.PointS(*(torch.cat([a, b], dim=3) for a, b in zip(p, pad)))
    return pf.to_coords(pf.lane_halve_sum(p, axis=3, width=width))[..., 0]


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _check_wsplit(wsplit: int) -> None:
    if wsplit < 1 or wsplit > N_WINDOWS or wsplit & (wsplit - 1):
        raise ValueError(f"window split {wsplit}: expected a power of two from 1 to {N_WINDOWS}")


def _check_shapes(table, lane_idx, scalars_t):
    if table.dim() != 4 or tuple(table.shape[:2]) != (N_WINDOWS, N_DIGITS) or table.shape[3] != ENTRY_WORDS:
        raise ValueError(f"fixed_acc table: expected (64, 16, lanes, {ENTRY_WORDS}) words, got {tuple(table.shape)}")
    if scalars_t.dim() != 3 or scalars_t.shape[0] != NLIMBS or 0 in scalars_t.shape:
        raise ValueError(f"fixed_acc scalars: expected non-empty (16, rows, lanes) limbs, got {tuple(scalars_t.shape)}")
    if tuple(lane_idx.shape) != (scalars_t.shape[2],):
        raise ValueError("fixed_acc lane_idx: one table lane per scalar position")


def fixed_acc(table: torch.Tensor, lane_idx: torch.Tensor, scalars_t: torch.Tensor, wsplit: int | None = None) -> torch.Tensor:
    """K5: table (64, 16, S_tab, 24) int32, lane_idx (S,) int64 with values
    below S_tab, scalars (16, F, S) int64 limbs -> (F, wsplit * S, 32) int32
    words.  `wsplit` defaults to `pick_wsplit(F, S)`."""
    _check_shapes(table, lane_idx, scalars_t)
    _, f, s = scalars_t.shape
    wsplit = pick_wsplit(f, s) if wsplit is None else wsplit
    _check_wsplit(wsplit)
    if scalars_t.device.type == "cpu":
        return fixed_acc_plain(table, lane_idx, scalars_t, wsplit)
    s_tab = table.shape[2]
    cuda.require(table, "fixed_acc table", (N_WINDOWS, N_DIGITS, s_tab, ENTRY_WORDS), dtype="torch.int32")
    cuda.require(lane_idx, "fixed_acc lane_idx", (s,))
    cuda.require(scalars_t, "fixed_acc scalars", (NLIMBS, f, s))
    out = torch.empty((f, wsplit * s, POINT_WORDS), dtype=torch.int32, device=scalars_t.device)
    with torch.cuda.device(scalars_t.device):
        status = cuda.lib("fixed").bppt_fixed_acc(
            table.data_ptr(), lane_idx.data_ptr(), scalars_t.data_ptr(), out.data_ptr(), f, s, s_tab, wsplit,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("fixed", status, "fixed_acc")
    cuda.launches["fixed_acc"] += 1
    return out


def fixed_fold(parts: torch.Tensor, groups: int, wsplit: int, threads: int | None = None) -> torch.Tensor:
    """K6: (F, wsplit * S, 32) partial words -> (4, 16, F, groups) points; S
    must split into `groups` equal contiguous lane groups.  `threads` forces
    the kernel's block size (one of `FOLD_THREADS`); by default
    `pick_fold_threads` takes it from the shape."""
    _check_wsplit(wsplit)
    if threads is not None and threads not in FOLD_THREADS:
        raise ValueError(f"fixed_fold: expected one of {FOLD_THREADS} threads a block, got {threads!r}")
    if (groups < 1 or parts.dim() != 3 or parts.shape[2] != POINT_WORDS or parts.shape[1] % (wsplit * groups)
            or 0 in parts.shape):
        raise ValueError(f"fixed_fold: partials {tuple(parts.shape)} do not split into {wsplit} ranges of {groups} groups")
    if parts.device.type == "cpu":
        return fixed_fold_plain(parts, groups, wsplit)
    f = parts.shape[0]
    s = parts.shape[1] // wsplit
    cuda.require(parts, "fixed_fold parts", (f, wsplit * s, POINT_WORDS), dtype="torch.int32")
    out = torch.empty((4, NLIMBS, f, groups), dtype=torch.int64, device=parts.device)
    with torch.cuda.device(parts.device):
        status = cuda.lib("fixed").bppt_fixed_fold(
            parts.data_ptr(), out.data_ptr(), f, s, groups, wsplit,
            threads or pick_fold_threads(wsplit * s // groups, f * groups),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("fixed", status, "fixed_fold")
    cuda.launches["fixed_fold"] += 1
    return out
