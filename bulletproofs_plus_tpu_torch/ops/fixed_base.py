"""Fixed-base MSMs over precomputed 4-bit digit tables, and the verifier's
mixed static + dynamic MSM.

Counterpart of bulletproofs_plus_tpu/ops/fixed_base.py.  For fixed points
(the interleaved G_i/H_i generator vectors, the Pedersen bases) the tables

    T[j, d, i] = d * 16^j * P_i      j in 0..64, d in 0..16

are built once per generator set and stored affine, precomputed for the
mixed addition (y + x, y - x, 2d x y), so an MSM over S fixed points is 64
table reads and 64 * S mixed additions with no doublings at all.  Every
fixed-base MSM runs K5 then K6 (ops/cuda_fixed.py): the CUDA kernels on CUDA
tensors whatever the width, their plain torch versions on CPU tensors.  The
table lookup is a gather; the JAX package's one-hot matrix product and its
width thresholds were the TPU's way to the same entries.

`mixed_msm` is the verifier's: there the static generator lanes simply join
the dynamic MSM (one kernel chain beats two, and the MSM kernel builds its
digit tables on chip anyway).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import edwards as ed
from . import field as F
from .cuda_fixed import N_DIGITS, N_WINDOWS, fixed_acc, fixed_fold, limbs_to_words, pick_wsplit
from .edwards import PointArray
from .host_ristretto import L
from .limbs import NLIMBS
from .msm import msm_kernel

WINDOW_BITS = 4


class NielsArray(NamedTuple):
    """Affine points precomputed for the mixed addition: y + x, y - x and
    2d * x * y as (..., 16) canonical limb tensors.  (1, 1, 0) is the
    identity."""

    yp: torch.Tensor
    ym: torch.Tensor
    t2d: torch.Tensor


def _batch_inverse(z: torch.Tensor) -> torch.Tensor:
    """1 / z for (K, ..., 16) nonzero field elements with one Fermat
    inversion over the trailing batch: Montgomery's trick along axis 0 (3K
    multiplications of a K-th of the elements besides)."""
    prefix = [z[0]]
    for k in range(1, z.shape[0]):
        prefix.append(F.mul25519(prefix[-1], z[k]))
    running = F.inv25519(prefix[-1])
    out = [None] * z.shape[0]
    for k in range(z.shape[0] - 1, 0, -1):
        out[k] = F.mul25519(running, prefix[k - 1])
        running = F.mul25519(running, z[k])
    out[0] = running
    return torch.stack(out)


def to_niels(points: PointArray) -> NielsArray:
    """Extended points of batch shape (K, ...) -> their affine precomputed
    form, canonical: the inversion of Z is batched along the first axis."""
    zinv = _batch_inverse(points.z)
    x = F.mul25519(points.x, zinv)
    y = F.mul25519(points.y, zinv)
    t2d = F.mul25519(F.mul25519(x, y), F.limbs_const(ed.D2, x))
    return NielsArray(F.canon25519(F.add25519(y, x)), F.canon25519(F.sub25519(y, x)), F.canon25519(t2d))


def build_tables(points: PointArray) -> NielsArray:
    """(S,) points -> (64, 16, S) table of d * 16^j * P_i in the form the
    kernels' mixed addition consumes, a NielsArray with coords
    (64, 16, S, 16): the JAX package's `build_tables`, made affine.

    The 64 window bases 16^j * P come from one chain of 252 doublings over
    the S lanes; the 16 multiples of all 64 windows are then built together
    by 15 additions, so the build is 267 batched point operations and not
    64 * 20; one batched inversion of Z (along the digit axis) then makes
    every entry affine."""
    bases = [points]
    for _ in range(N_WINDOWS - 1):
        nxt = bases[-1]
        for _ in range(WINDOW_BITS):
            nxt = ed.double(nxt)
        bases.append(nxt)
    base = PointArray(*(torch.stack([b[c] for b in bases]) for c in range(4)))  # (64, S)
    multiples = [ed.identity(base.x.shape[:-1], device=base.x.device), base]
    for _ in range(N_DIGITS - 2):
        multiples.append(ed.add(multiples[-1], base))
    extended = PointArray(*(torch.stack([m[c] for m in multiples]) for c in range(4)))  # (16, 64, S)
    return NielsArray(*(c.transpose(0, 1) for c in to_niels(extended)))


HALF = (L + 1) // 2  # 2 HALF = l + 1


def halve(points: PointArray) -> PointArray:
    """HALF * P for each point: its double is P + l P, and l P lies in E[4],
    so 2 (HALF * P) and P are the same ristretto point.  A double-and-add
    over HALF's 252 bits (251 doublings, 72 additions) batched over the
    points, with the plain point operations: about one `build_tables` more."""
    acc = points
    for bit in bin(HALF)[3:]:
        acc = ed.double(acc)
        if bit == "1":
            acc = ed.add(acc, points)
    return acc


def pack_tables(tables: NielsArray) -> torch.Tensor:
    """`build_tables` coords (64, 16, S, 16 limbs) x 3 -> the kernels' table:
    int32 (64, 16, S, 24), entry = the 8 32-bit words of y + x, y - x, 2d x y."""
    return limbs_to_words(torch.stack(list(tables), dim=-2))  # (64, 16, S, 3, 16) -> words


def _fixed_msm(flat: torch.Tensor, tables: torch.Tensor, groups: int, lanes) -> torch.Tensor:
    """(F, S, 16) scalars -> (4, 16, F, groups) points by K5 then K6."""
    f, s = flat.shape[:2]
    if s == 0 or s % groups:
        raise ValueError(f"{s} scalar lanes do not split into {groups} groups")
    lanes = np.arange(s) if lanes is None else np.asarray(lanes, dtype=np.int64)
    if lanes.shape != (s,) or lanes.min() < 0 or lanes.max() >= tables.shape[2]:
        raise ValueError(f"{s} scalar lanes need {s} table lanes below {tables.shape[2]}")
    lane_idx = torch.as_tensor(lanes, dtype=torch.int64, device=flat.device)
    wsplit = pick_wsplit(f, s)
    parts = fixed_acc(tables, lane_idx, flat.movedim(-1, 0).contiguous(), wsplit)
    return fixed_fold(parts, groups, wsplit)


def fixed_msm(scalars: torch.Tensor, tables: torch.Tensor) -> PointArray:
    """sum_i scalars[i] * P_i over fixed points, one row: the JAX package's
    `fixed_msm`.  scalars: (S, 16) canonical limbs; tables: `pack_tables`
    words with at least S lanes (the JAX package takes `build_tables`' points;
    the port's kernels read the packed form).  K5 then K6, as
    `fixed_msm_batched` runs them, on a batch of one."""
    return PointArray(*(c[0] for c in fixed_msm_batched(scalars[None], tables)))


def fixed_msm_batched(scalars: torch.Tensor, tables: torch.Tensor, lanes=None) -> PointArray:
    """sum_s scalars[..., s, :] * P_s over fixed points, batched over any
    leading axes: the workhorse of the batched prover.

    scalars: (..., S, 16) canonical limbs; tables: `pack_tables` words with at
    least S lanes.  `lanes`, S host integers (a sequence or numpy array),
    names the table lane of each scalar position (default: position s reads
    lane s); it is checked against the table here, since the kernel reads
    where it is told.  Returns (...,) points."""
    lead = scalars.shape[:-2]
    out = _fixed_msm(scalars.reshape((-1,) + scalars.shape[-2:]), tables, 1, lanes)
    return PointArray(*(c[..., 0].t().reshape(lead + (NLIMBS,)) for c in out))


def fixed_msm_grouped(scalars: torch.Tensor, tables: torch.Tensor, groups: int, lanes=None) -> PointArray:
    """Like `fixed_msm_batched`, but the S scalar positions split into
    `groups` contiguous equal chunks that sum to separate points: scalars
    (B, S, 16) -> (B, groups) points, output g summing positions
    [g * S / groups, (g + 1) * S / groups).

    The prover's round MSMs use it: L and R each touch a known disjoint half
    of the interleaved generator lanes, so one call of width 2mn, with
    `lanes` carrying the round's permutation, computes both."""
    out = _fixed_msm(scalars, tables, groups, lanes)
    return PointArray(*(c.permute(1, 2, 0).contiguous() for c in out))


def mixed_msm(
    static_scalars: torch.Tensor,
    static_points: PointArray,
    dynamic_scalars: torch.Tensor,
    dynamic_points: PointArray,
    identity: bool = False,
):
    """sum static_scalars * static_points + sum dynamic_scalars * dynamic_points,
    the analog of `vartime_mixed_multiscalar_mul` (range_proof.rs:1050).
    Dynamic lanes come first, as in the JAX package.  identity=True returns
    (point, whether it is the identity), as `msm_kernel` does."""
    scalars = torch.cat([dynamic_scalars, static_scalars])
    return msm_kernel(scalars, ed.cat([dynamic_points, static_points]), identity=identity)
