"""K5-K6 wrappers: the batched fixed-base MSM through hand-written CUDA kernels.

Counterpart of the fixed-base half of bulletproofs_plus_tpu/ops/pallas_msm.py
(`fixed_msm_partials`).  For F batch rows of S scalars over a precomputed
digit table the MSM runs in two stages, each a kernel on CUDA tensors
(csrc/fixed.cu) and a plain torch function of the same arithmetic on CPU
tensors:

  K5 `fixed_acc`   per (row, scalar position, window range): the sum over
                   16 windows of the table entry the digit selects
                   -> (4, 16, F, WSPLIT * S) partial points
  K6 `fixed_fold`  per (row, lane group): the sum of the group's partials
                   -> (4, 16, F, groups)

The table holds T[w, d, lane] = d * 16^w * P_lane as 32 packed 32-bit words
per entry (x, y, z, t; ops/fixed_base.pack_tables), int32 (64, 16, S_tab, 32):
a quarter of the int64-limb form.  `lane_idx` maps scalar position -> table
lane, so a permuted MSM reads the table in place.  Points leave the kernels
limb-major as (4 coords, 16 limbs, ...) int64 tensors, like K1-K3's.
"""

from __future__ import annotations

import torch

from ..native import cuda
from . import pfield as pf
from .limbs import NLIMBS
from .msm import digits4

N_WINDOWS = 64
N_DIGITS = 16
WSPLIT = 4  # window ranges per (row, position): csrc/fixed.cu
WORDS = 32  # packed 32-bit words per table entry


def words_to_coords(words: torch.Tensor) -> torch.Tensor:
    """(..., 32) packed int32 words -> (4, 16, ...) int64 limb-major coordinates."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(words.shape[:-1] + (4, NLIMBS))
    return limbs.movedim(-1, 0).movedim(-1, 0).contiguous()


# ---------------------------------------------------------------------------
# Plain torch versions (ops/pfield.py): CPU tensors take these; on CUDA they
# are the reference the kernels are held against.
# ---------------------------------------------------------------------------


def fixed_acc_plain(table: torch.Tensor, lane_idx: torch.Tensor, scalars_t: torch.Tensor) -> torch.Tensor:
    """K5's function: table (64, 16, S_tab, 32), lane_idx (S,), scalars
    (16, F, S) -> (4, 16, F, WSPLIT * S); entry [., ., f, q * S + s] is the
    sum over windows 16q..16q+15 of T[w, digit_w(scalar[f, s]), lane_idx[s]]."""
    f, s = scalars_t.shape[1:]
    dig = digits4(scalars_t.movedim(0, -1))  # (64, F, S)
    windows = torch.arange(N_WINDOWS, device=table.device)[:, None, None]
    sel = words_to_coords(table[windows, dig, lane_idx[None, None, :]])  # (4, 16, 64, F, S): a gather
    sel = sel.reshape(4, NLIMBS, WSPLIT, N_WINDOWS // WSPLIT, f, s)
    acc = pf.from_coords(sel[:, :, :, 0])
    for j in range(1, N_WINDOWS // WSPLIT):
        acc = pf.padd(acc, pf.from_coords(sel[:, :, :, j]))
    # (4, 16, WSPLIT, F, S) -> (4, 16, F, WSPLIT * S)
    return pf.to_coords(acc).movedim(2, 3).reshape(4, NLIMBS, f, WSPLIT * s).contiguous()


def fixed_fold_plain(parts: torch.Tensor, groups: int) -> torch.Tensor:
    """K6's function: (4, 16, F, WSPLIT * S) -> (4, 16, F, groups), the sum of
    each contiguous lane group's partials over all window ranges."""
    f = parts.shape[2]
    s = parts.shape[3] // WSPLIT
    per = s // groups
    grouped = parts.reshape(4, NLIMBS, f, WSPLIT, groups, per).movedim(3, 4).reshape(4, NLIMBS, f, groups, WSPLIT * per)
    p = pf.from_coords(grouped)
    count = WSPLIT * per
    width = 1 << (count - 1).bit_length()
    if width != count:
        pad = pf.identity((f, groups, width - count), device=parts.device)
        p = pf.PointS(*(torch.cat([a, b], dim=3) for a, b in zip(p, pad)))
    return pf.to_coords(pf.lane_halve_sum(p, axis=3, width=width))[..., 0]


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _check_shapes(table, lane_idx, scalars_t):
    if table.dim() != 4 or tuple(table.shape[:2]) != (N_WINDOWS, N_DIGITS) or table.shape[3] != WORDS:
        raise ValueError(f"fixed_acc table: expected (64, 16, lanes, 32) words, got {tuple(table.shape)}")
    if scalars_t.dim() != 3 or scalars_t.shape[0] != NLIMBS or 0 in scalars_t.shape:
        raise ValueError(f"fixed_acc scalars: expected non-empty (16, rows, lanes) limbs, got {tuple(scalars_t.shape)}")
    if tuple(lane_idx.shape) != (scalars_t.shape[2],):
        raise ValueError("fixed_acc lane_idx: one table lane per scalar position")


def fixed_acc(table: torch.Tensor, lane_idx: torch.Tensor, scalars_t: torch.Tensor) -> torch.Tensor:
    """K5: table (64, 16, S_tab, 32) int32, lane_idx (S,) int64 with values
    below S_tab, scalars (16, F, S) int64 limbs -> (4, 16, F, WSPLIT * S)."""
    _check_shapes(table, lane_idx, scalars_t)
    if scalars_t.device.type == "cpu":
        return fixed_acc_plain(table, lane_idx, scalars_t)
    _, f, s = scalars_t.shape
    s_tab = table.shape[2]
    cuda.require(table, "fixed_acc table", (N_WINDOWS, N_DIGITS, s_tab, WORDS), dtype="torch.int32")
    cuda.require(lane_idx, "fixed_acc lane_idx", (s,))
    cuda.require(scalars_t, "fixed_acc scalars", (NLIMBS, f, s))
    out = torch.empty((4, NLIMBS, f, WSPLIT * s), dtype=torch.int64, device=scalars_t.device)
    with torch.cuda.device(scalars_t.device):
        status = cuda.lib("fixed").bppt_fixed_acc(
            table.data_ptr(), lane_idx.data_ptr(), scalars_t.data_ptr(), out.data_ptr(), f, s, s_tab,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("fixed", status, "fixed_acc")
    cuda.launches["fixed_acc"] += 1
    return out


def fixed_fold(parts: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """K6: (4, 16, F, WSPLIT * S) partials -> (4, 16, F, groups) points; S
    must split into `groups` equal contiguous lane groups."""
    if groups < 1 or parts.dim() != 4 or parts.shape[3] % (WSPLIT * groups) or 0 in parts.shape:
        raise ValueError(f"fixed_fold: partials {tuple(parts.shape)} do not split into {groups} groups")
    if parts.device.type == "cpu":
        return fixed_fold_plain(parts, groups)
    f = parts.shape[2]
    s = parts.shape[3] // WSPLIT
    cuda.require(parts, "fixed_fold parts", (4, NLIMBS, f, WSPLIT * s))
    out = torch.empty((4, NLIMBS, f, groups), dtype=torch.int64, device=parts.device)
    with torch.cuda.device(parts.device):
        status = cuda.lib("fixed").bppt_fixed_fold(
            parts.data_ptr(), out.data_ptr(), f, s, groups, torch.cuda.current_stream().cuda_stream
        )
    cuda.check("fixed", status, "fixed_fold")
    cuda.launches["fixed_fold"] += 1
    return out
