"""Device batch verification: scalar pass, batched decompression, one MSM.

Counterpart of bulletproofs_plus_tpu/models/verifier_kernels.py, single
shape group only.  Implements the verifier's pass-2 scalar accumulation and
final folded MSM (reference src/range_proof.rs:856-1062) on torch tensors:

  * `scalar_pass`: every per-proof scalar — challenge inversions (one
    Montgomery batch inversion per proof), the s-vector by its bit-product
    closed form, inverse-power ladders by binary decomposition, the gi/hi
    generator accumulators, and the dynamic MSM scalars;
  * one batched ristretto decompression of every proof point (K4 inside);
  * one MSM against the identity (K1-K3 inside).

All scalars are (..., 16) int64 limb tensors mod l (ops/field.py).  Fiat-
Shamir replay stays on the host (models/range_proof.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import field as F
from ..ops import host_ristretto as hr
from ..ops import ristretto as rist
from ..ops.edwards import cat
from ..ops.limbs import NLIMBS, limbs_from_bytes, pack_ints

L = hr.L


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    return F.limbs_const(value % L, like)


def _batch_invert(x: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion over axis 1: (B, k, 16) -> (B, k, 16).

    k-1 prefix products, ONE Fermat inversion of the total, then back-
    substitution (the `Scalar::batch_invert` analog, range_proof.rs:897-905).
    Inputs must be nonzero (the transcript rejects zero challenges)."""
    k = x.shape[1]
    if k == 1:
        return F.inv_l(x)
    prefix = [x[:, 0]]
    for j in range(1, k):
        prefix.append(F.mul_l(prefix[-1], x[:, j]))
    acc = F.inv_l(prefix[-1])
    outs: list = [None] * k
    for j in range(k - 1, 0, -1):
        outs[j] = F.mul_l(acc, prefix[j - 1])
        acc = F.mul_l(acc, x[:, j])
    outs[0] = acc
    return torch.stack(outs, dim=1)


def _pow_static(x: torch.Tensor, exp: int) -> torch.Tensor:
    if exp == 0:
        return _const(1, x).expand(x.shape)
    return x if exp == 1 else F.pow_l(x, exp)


def _index_bit_products(base_prod: torch.Tensor, factors: torch.Tensor, mn: int) -> torch.Tensor:
    """s[i] = base_prod * prod_{bit b set in i} factors[:, rounds-1-b].
    base_prod: (B, 16); factors: (B, rounds, 16) -> (B, mn, 16)."""
    rounds = factors.shape[1]
    if mn != 1 << rounds:
        raise ValueError("mn must be 2^rounds")
    out = base_prod[:, None, :].expand(base_prod.shape[0], mn, NLIMBS)
    idx = np.arange(mn)
    for b in range(rounds):
        mask = torch.as_tensor((idx >> b) & 1 == 1, device=out.device)
        mult = F.mul_l(out, factors[:, rounds - 1 - b][:, None, :])
        out = F.select(mask.expand(out.shape[:-1]), mult, out)
    return out


def _power_ladder(base: torch.Tensor, start: torch.Tensor, mn: int) -> torch.Tensor:
    """out[:, i] = start * base^i for i in 0..mn, by binary decomposition.
    base, start: (B, 16) -> (B, mn, 16)."""
    nbits = max(1, (mn - 1).bit_length())
    out = start[:, None, :].expand(start.shape[0], mn, NLIMBS)
    idx = np.arange(mn)
    pow2 = base
    for b in range(nbits):
        mask = torch.as_tensor((idx >> b) & 1 == 1, device=out.device)
        mult = F.mul_l(out, pow2[:, None, :])
        out = F.select(mask.expand(out.shape[:-1]), mult, out)
        pow2 = F.sqr_l(pow2)
    return out


def _batch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (B, k, 16) canonical scalars over the batch mod l -> (k, 16).
    Limb-wise int64 sums are exact (B * 2^16 << 2^63), so one carry chain
    and one Barrett reduction replace B modular adds."""
    raw = x.sum(dim=0)  # limbs < B * 2^16
    return F.barrett_reduce(F.carry_prop(raw, 32, bits=16 + x.shape[0].bit_length()))


def scalar_pass(y, z, round_es, e, weight, r1, s1, d1, min_values, *, m: int, bit_length: int, max_mn: int):
    """Pass-2 scalar accumulation for one shape group of B proofs.

    Inputs (B, 16) scalars, round_es (B, rounds, 16), d1 (B, deg, 16),
    min_values (B, m, 16).  Returns (gi_scalars (max_mn,16), hi_scalars
    (max_mn,16), g_base_scalars (deg,16), h_base_scalar (16,),
    commit_scalars (B,m,16), a1_s (B,16), b_s (B,16), a_s (B,16),
    li_s (B,rounds,16), ri_s (B,rounds,16))."""
    B = y.shape[0]
    mn = m * bit_length
    rounds = round_es.shape[1]
    one = _const(1, y).expand(y.shape)

    # Montgomery batch inversion over [es..., y, y-1] (range_proof.rs:897-905)
    y_minus_1 = F.sub_l(y, one)
    inv_out = _batch_invert(torch.cat([round_es, y[:, None], y_minus_1[:, None]], dim=1))
    es_inv = inv_out[:, :rounds]
    y_inverse = inv_out[:, rounds]
    y_1_inverse = inv_out[:, rounds + 1]

    ch_inv_prod = one
    for j in range(rounds):
        ch_inv_prod = F.mul_l(ch_inv_prod, es_inv[:, j])

    z_square = F.sqr_l(z)
    e_square = F.sqr_l(e)
    ch_sq = F.sqr_l(round_es)
    ch_sq_inv = F.sqr_l(es_inv)
    y_nm = _pow_static(y, mn)
    y_nm_1 = F.mul_l(y_nm, y)
    y_sum = F.mul_l(F.mul_l(y, F.sub_l(y_nm, one)), y_1_inverse)

    # d vector: d[j*n + i] = z^{2(j+1)} * 2^i  -> (B, mn, 16)
    two_pows = torch.as_tensor(
        pack_ints([pow(2, i, L) for i in range(bit_length)]).astype(np.int64), device=y.device
    )
    z2_pows = _power_ladder(z_square, z_square, m)  # (B, m, 16): z^{2(j+1)}
    d = F.mul_l(z2_pows[:, :, None, :], two_pows[None, None, :, :]).reshape(B, mn, NLIMBS)

    # d_sum = (sum_j z^{2(j+1)}) * (2^n - 1)
    d_sum = z2_pows[:, 0]
    for j in range(1, m):
        d_sum = F.add_l(d_sum, z2_pows[:, j])
    d_sum = F.mul_l(d_sum, _const(pow(2, bit_length, L) - 1, y).expand(d_sum.shape))

    s_vec = _index_bit_products(ch_inv_prod, ch_sq, mn)  # (B, mn, 16)
    s_rev = s_vec.flip(1)

    # y^{-i}, and y^{mn-i} = y^mn * y^{-i}
    y_inv_i = _power_ladder(y_inverse, one, mn)
    y_nm_i = F.mul_l(y_nm[:, None], y_inv_i)

    r1_e = F.mul_l(r1, e)
    s1_e = F.mul_l(s1, e)
    e_square_z = F.mul_l(e_square, z)

    g_term = F.add_l(F.mul_l(F.mul_l(r1_e[:, None], y_inv_i), s_vec), e_square_z[:, None].expand(B, mn, NLIMBS))
    h_term = F.sub_l(
        F.mul_l(s1_e[:, None], s_rev),
        F.mul_l(e_square[:, None], F.add_l(F.mul_l(d, y_nm_i), z[:, None].expand(B, mn, NLIMBS))),
    )
    gi_scalars = _batch_sum(F.mul_l(weight[:, None], g_term))
    hi_scalars = _batch_sum(F.mul_l(weight[:, None], h_term))
    if mn < max_mn:
        pad = gi_scalars.new_zeros((max_mn - mn, NLIMBS))
        gi_scalars = torch.cat([gi_scalars, pad])
        hi_scalars = torch.cat([hi_scalars, pad])

    # Commitment scalars: -e^2 z^{2(j+1)} y^{mn+1} * weight  -> (B, m, 16)
    weighted = F.neg_l(F.mul_l(F.mul_l(e_square, y_nm_1)[:, None], F.mul_l(z2_pows, weight[:, None])))

    # h_base: weight*(r1 y s1 + e^2(y_nm_1 z d_sum + (z^2-z) y_sum)) - sum_j weighted_j*min_j
    h_contrib = F.mul_l(
        weight,
        F.add_l(
            F.mul_l(F.mul_l(r1, y), s1),
            F.mul_l(
                e_square,
                F.add_l(F.mul_l(F.mul_l(y_nm_1, z), d_sum), F.mul_l(F.sub_l(z_square, z), y_sum)),
            ),
        ),
    )
    min_terms = F.mul_l(weighted, min_values)
    for j in range(m):
        h_contrib = F.sub_l(h_contrib, min_terms[:, j])
    h_base_scalar = _batch_sum(h_contrib[:, None, :])[0]
    g_base_scalars = _batch_sum(F.mul_l(weight[:, None], d1))

    # Per-proof dynamic scalars
    a1_s = F.neg_l(F.mul_l(weight, e))
    b_s = F.neg_l(weight)
    a_s = F.neg_l(F.mul_l(weight, e_square))
    li_s = F.mul_l(a_s[:, None], ch_sq)
    ri_s = F.mul_l(a_s[:, None], ch_sq_inv)
    return gi_scalars, hi_scalars, g_base_scalars, h_base_scalar, weighted, a1_s, b_s, a_s, li_s, ri_s


def decompress_batch(compressed_limbs: torch.Tensor):
    """(N, 16) compressed limbs -> (PointArray, valid mask)."""
    return rist.decompress(compressed_limbs)


def verify_group_full(
    y, z, round_es, e, weight, r1, s1, d1, min_values,
    comp_limbs,  # (B*K, 16): [commitments, a1, b, a, li, ri] per proof
    static_points,  # interleaved G_i/H_i generators, 2*max_mn lanes
    g_base_pts,  # (deg,) points
    h_base_pt,  # (1,) point
    *, m, bit_length, max_mn,
):
    """Single-group device verification: scalar pass, batched
    decompression, dynamic scalar assembly, and the mixed static+dynamic
    MSM against the identity.  Returns (ok: bool tensor, valid: (B*K,)
    decompression mask)."""
    from ..ops.fixed_base import mixed_msm
    from ..ops.msm import pad_msm_inputs

    B = y.shape[0]
    K = m + 3 + 2 * round_es.shape[1]
    (gi, hi, gb, hb, commit_s, a1_s, b_s, a_s, li_s, ri_s) = scalar_pass(
        y, z, round_es, e, weight, r1, s1, d1, min_values, m=m, bit_length=bit_length, max_mn=max_mn,
    )
    points, valid = rist.decompress(comp_limbs)

    dyn_scalars = torch.cat(
        [commit_s, a1_s[:, None], b_s[:, None], a_s[:, None], li_s, ri_s], dim=1
    ).reshape(B * K, NLIMBS)
    dyn_scalars = torch.cat([dyn_scalars, gb, hb[None]])
    dyn_points = cat([points, g_base_pts, h_base_pt])
    dyn_scalars, dyn_points = pad_msm_inputs(dyn_scalars, dyn_points)

    static_scalars = torch.stack([gi, hi], dim=1).reshape(2 * max_mn, NLIMBS)
    ok = rist.is_identity(mixed_msm(static_scalars, static_points, dyn_scalars, dyn_points))
    return ok, valid


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------


def _points_bytes_to_limbs(blobs: Sequence[bytes]) -> np.ndarray:
    arr = np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(len(blobs), 32)
    return limbs_from_bytes(arr)


def _on(arr: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr, dtype=np.int64), device=device)


class DeviceVerifier:
    """Packing and error reporting for one same-shape group of proofs."""

    @staticmethod
    def pack(statements, proofs, challenges, weights, device="cuda"):
        """A same-shape group's scalars and compressed points as int64 limb
        tensors on `device`: (y, z, round_es, e, w, r1, s1, d1, min_values,
        comp_limbs)."""
        m = len(statements[0].commitments)
        rounds = len(proofs[0].li)
        B = len(proofs)
        deg = len(proofs[0].d1)
        y = pack_ints([c[0] % L for c in challenges])
        z = pack_ints([c[1] % L for c in challenges])
        round_es = pack_ints([e for c in challenges for e in c[2]]).reshape(B, rounds, 16)
        e = pack_ints([c[3] % L for c in challenges])
        w = pack_ints([v % L for v in weights])
        r1 = pack_ints([p.r1 for p in proofs])
        s1 = pack_ints([p.s1 for p in proofs])
        d1 = pack_ints([v for p in proofs for v in p.d1]).reshape(B, deg, 16)
        min_values = pack_ints([v or 0 for s in statements for v in s.minimum_value_promises]).reshape(B, m, 16)
        blobs: List[bytes] = []
        for statement, proof in zip(statements, proofs):
            blobs.extend(statement.commitments_compressed)
            blobs.append(proof.a1)
            blobs.append(proof.b)
            blobs.append(proof.a)
            blobs.extend(proof.li)
            blobs.extend(proof.ri)
        comp = _points_bytes_to_limbs(blobs)
        return tuple(_on(a, device) for a in (y, z, round_es, e, w, r1, s1, d1, min_values, comp))

    @staticmethod
    def raise_canonicality(valid_np: np.ndarray, m: int, rounds: int) -> None:
        """Reference-parity decompression errors, in the reference's member
        order per proof (range_proof.rs:859-866: a, a1, b, then li/ri) even
        though the packed layout is [commitments, a1, b, a, li, ri]."""
        if valid_np.all():
            return
        per_proof = valid_np.reshape(-1, m + 3 + 2 * rounds)
        DeviceVerifier.raise_canonicality_row(per_proof[~per_proof.all(axis=1)][0], m, rounds)

    @staticmethod
    def raise_canonicality_row(row: np.ndarray, m: int, rounds: int) -> None:
        """One proof's decompression flags -> the reference's error, checked
        in member order a, a1, b, li/ri, commitments."""
        if row.all():
            return
        from ..errors import InvalidArgument

        for j, name in ((m + 2, "a"), (m, "a1"), (m + 1, "b")):
            if not row[j]:
                raise InvalidArgument(f"Member '{name}' was not the canonical encoding of a point")
        if not row[m + 3 :].all():
            raise InvalidArgument("An item in member 'L' was not the canonical encoding of a point")
        raise InvalidArgument("A commitment was not the canonical encoding of a point")
