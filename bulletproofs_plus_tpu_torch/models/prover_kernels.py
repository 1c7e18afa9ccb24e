"""The batched prover's scalar protocol and the A commitment's masked sum:
P1-P4 on a card, their plain twins on the CPU.

Counterpart of the JAX package's fused prover program `_prover_fn_core`
(bulletproofs_plus_tpu/models/prover_device.py:90) minus its transcript and
its fixed-base MSMs: the vector prep (:186-221), the round body (:226-340),
the final masks and responses (:342-405) and the A commitment's masked sums
(:163-181).  Each function here runs its hand-written kernel
(csrc/prover.cu, through ops/cuda_prover.py) on CUDA tensors and its plain
twin (`*_plain`) on CPU tensors; any other device raises.  Scalars are
(..., 16) int64 limb tensors mod l (ops/field.py), every output canonical,
so kernel and twin agree limb for limb.

Vectors are compact: a and b hold the 2n values of round r's folded
vectors (the JAX program spreads them over all mn lanes), while the
generator coefficients g and h, one a lane, stay mn wide.  A round's MSM
scalars come in `round_lanes` order: group L, then group R, each the round's
generator lanes as the JAX program's permutation `perm` orders them, then
the Pedersen lanes [d_1..d_deg, c] over the tables that
`BulletproofGens.fixed_tables_joined` appends to the generators'.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cuda_prover
from ..ops import edwards as ed
from ..ops import field as F
from ..ops import host_ristretto as hr
from ..ops.cuda_fixed import words_to_limbs
from ..ops.edwards import PointArray
from ..ops.limbs import NLIMBS, pack_ints
from ..ops.msm import tree_reduce
from .verifier_kernels import _on, _power_ladder

L = hr.L


def _batch_sum_l(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Modular sum of canonical scalars along `dim`: one exact limb-wise
    int64 sum, one carry chain, one Barrett reduction."""
    raw = x.sum(dim=dim)
    return F.barrett_reduce(F.carry_prop(raw, 32, bits=16 + x.shape[dim].bit_length()))


@functools.lru_cache(maxsize=None)
def round_perm(mn: int, r: int) -> np.ndarray:
    """The JAX program's lane order of round r over the interleaved
    generators [g_0 h_0 g_1 h_1 ...]: L's g lanes, L's h lanes, R's g lanes,
    R's h lanes (g_i feeds L where i mod 2n >= n, h_i where it is below)."""
    n = mn >> (r + 1)
    lanes = np.arange(mn)
    hi = lanes % (2 * n) >= n
    return np.concatenate([2 * lanes[hi], 2 * lanes[~hi] + 1, 2 * lanes[~hi], 2 * lanes[hi] + 1])


@functools.lru_cache(maxsize=None)
def round_lanes(mn: int, deg: int, r: int) -> np.ndarray:
    """The joined table's lane of each of round r's MSM scalars: group L's
    generator lanes then the Pedersen lanes [G_1..G_deg, H] (2mn..2mn+deg),
    then group R's."""
    perm, pedersen = round_perm(mn, r), 2 * mn + np.arange(deg + 1)
    return np.concatenate([perm[:mn], pedersen, perm[mn:], pedersen])


def _plain(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ---------------------------------------------------------------------------
# Dispatch: the kernel on CUDA tensors, the twin on CPU tensors
# ---------------------------------------------------------------------------


def prove_prep(y, z, y_inv, bits, r_blind, alpha0, *, bit_length: int):
    """P1: the vectors a, b (B, mn, 16), y^1..y^(mn+1) (B, mn + 1, 16), y^-n
    for each round's n = mn >> (r + 1) (B, rounds, 16), and alpha plus its
    z-term (B, deg, 16), from y, z, y^-1 (B, 16), the bits (B, mn),
    the blindings (B, m, deg, 16) and the alpha masks (B, deg, 16)."""
    fn = prove_prep_plain if _plain(y) else cuda_prover.prove_prep
    return fn(y, z, y_inv, bits, r_blind, alpha0, bit_length=bit_length)


def prove_round(a, b, g, h, alpha, fold, y_pows, y_inv_n, d_l, d_r, *, r: int):
    """P2, round r: the fold by `fold`, the previous round's (e, e^-1, d_L,
    d_R), None in round 0; then (a, b (B, 2n, 16), g, h (B, mn, 16), alpha,
    the round's MSM scalars (B, 2 (mn + deg + 1), 16) in `round_lanes` order)."""
    fn = prove_round_plain if _plain(y_pows) else cuda_prover.prove_round
    return fn(a, b, g, h, alpha, fold, y_pows, y_inv_n, d_l, d_r, r=r)


def prove_final(a, b, g, h, alpha, fold, y_pows, y_inv_n, r_s, s_s, d_mask, eta):
    """P3's first entry: the last round's fold, then (the A1 MSM's scalars
    (B, 2 mn + deg + 1, 16) over the joined table's first lanes, the B MSM's
    [eta, r y s] (B, deg + 1, 16) over its Pedersen lanes, a0, b0 (B, 16),
    alpha (B, deg, 16))."""
    fn = prove_final_plain if _plain(y_pows) else cuda_prover.prove_final
    return fn(a, b, g, h, alpha, fold, y_pows, y_inv_n, r_s, s_s, d_mask, eta)


def prove_responses(r_s, s_s, a0, b0, eta, d_mask, alpha, e):
    """P3's second entry: r1 = r + a0 e, s1 = s + b0 e (B, 16) and d1 = eta +
    d_mask e + alpha e^2 (B, deg, 16)."""
    fn = prove_responses_plain if _plain(r_s) else cuda_prover.prove_responses
    return fn(r_s, s_s, a0, b0, eta, d_mask, alpha, e)


def bit_sum(start: PointArray, bits: torch.Tensor, table: torch.Tensor) -> PointArray:
    """P4: start + sum_i (bits[:, i] ? g_i : -h_i), (B,) points, with g_i and
    h_i the table's lanes 2i and 2i + 1."""
    fn = bit_sum_plain if _plain(bits) else cuda_prover.bit_sum
    return fn(start, bits, table)


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------


def prove_prep_plain(y, z, y_inv, bits, r_blind, alpha0, *, bit_length: int):
    """P1's twin (range_proof.rs:350-373)."""
    B, mn = bits.shape
    m = r_blind.shape[1]
    rounds = mn.bit_length() - 1
    one = F.limbs_const(1, y).expand(y.shape)
    y_powers = _power_ladder(y, one, mn + 2)  # (B, mn + 2, 16): y^0..y^(mn+1)
    y_inv_n, t = [None] * rounds, y_inv
    for r in range(rounds - 1, -1, -1):  # y^-1, y^-2, y^-4, ..: the last round's first
        y_inv_n[r] = t
        t = F.sqr_l(t)
    z_square = F.sqr_l(z)
    two_pows = _on(pack_ints([pow(2, i, L) for i in range(bit_length)]), y.device)
    z2_pows = _power_ladder(z_square, z_square, m)  # (B, m): z^(2(j+1))
    d = F.mul_l(z2_pows[:, :, None, :], two_pows[None, None]).reshape(B, mn, NLIMBS)
    bits_limb = torch.zeros((B, mn, NLIMBS), dtype=torch.int64, device=y.device)
    bits_limb[:, :, 0] = bits
    minus_one = F.limbs_const(L - 1, y).expand(B, mn, NLIMBS)
    a_ri0 = F.select(bits == 1, torch.zeros_like(bits_limb), minus_one)
    y_rev = y_powers[:, 1 : mn + 1].flip(1)  # y^(mn - i)
    z_b = z[:, None].expand(B, mn, NLIMBS)
    a = F.sub_l(bits_limb, z_b)
    b = F.add_l(a_ri0, F.add_l(F.mul_l(d, y_rev), z_b))
    alpha_terms = F.mul_l(F.mul_l(z2_pows, y_powers[:, mn + 1][:, None])[:, :, None], r_blind)  # (B, m, deg, 16)
    alpha = F.add_l(alpha0, _batch_sum_l(alpha_terms, 1))
    y_inv_n = torch.stack(y_inv_n, dim=1) if rounds else y.new_zeros((B, 0, NLIMBS))
    return a, b, y_powers[:, 1:].contiguous(), y_inv_n, alpha


def _fold_plain(a, b, g, h, alpha, fold, y_pows, y_inv_n, r: int):
    """The fold of round r - 1 (range_proof.rs:510-537): a and b from 2 len to
    len = mn >> r values, g and h lane by lane, alpha by the round's masks;
    ones for g and h without a fold (round 0)."""
    B, mn = y_pows.shape[0], y_pows.shape[1] - 1
    if fold is None:
        ones = F.limbs_const(1, y_pows).expand(B, mn, NLIMBS)
        return a, b, ones, ones, alpha
    e, e_inv, d_l, d_r = fold
    ln = mn >> r
    y_len, y_len_inv = y_pows[:, ln - 1], y_inv_n[:, r - 1]  # y^len, y^-len: round r - 1's n
    a = F.add_l(F.mul_l(a[:, :ln], e[:, None]), F.mul_l(a[:, ln:], F.mul_l(e_inv, y_len)[:, None]))
    b = F.add_l(F.mul_l(b[:, :ln], e_inv[:, None]), F.mul_l(b[:, ln:], e[:, None]))
    hi = torch.as_tensor(np.arange(mn) % (2 * ln) >= ln, device=a.device)[None].expand(B, mn)
    e_b, e_inv_b = e[:, None].expand(B, mn, NLIMBS), e_inv[:, None].expand(B, mn, NLIMBS)
    g = F.mul_l(g, F.select(hi, F.mul_l(e, y_len_inv)[:, None].expand(B, mn, NLIMBS), e_inv_b))
    h = F.mul_l(h, F.select(hi, e_inv_b, e_b))
    alpha = F.add_l(alpha, F.add_l(F.mul_l(d_l, F.sqr_l(e)[:, None]), F.mul_l(d_r, F.sqr_l(e_inv)[:, None])))
    return a, b, g, h, alpha


def prove_round_plain(a, b, g, h, alpha, fold, y_pows, y_inv_n, d_l, d_r, *, r: int):
    """P2's twin (range_proof.rs:430-458 after the fold): c_L, c_R, and each
    generator lane's L or R scalar gathered by `round_perm`."""
    B, mn = y_pows.shape[0], y_pows.shape[1] - 1
    a, b, g, h, alpha = _fold_plain(a, b, g, h, alpha, fold, y_pows, y_inv_n, r)
    n = mn >> (r + 1)
    # c_L = sum_j a_j y^(1+j) b_(j+n), c_R = sum_j a_(n+j) y^(n+1+j) b_j
    c_l = _batch_sum_l(F.mul_l(F.mul_l(a[:, :n], y_pows[:, :n]), b[:, n : 2 * n]), 1)
    c_r = _batch_sum_l(F.mul_l(F.mul_l(a[:, n : 2 * n], y_pows[:, n : 2 * n]), b[:, :n]), 1)
    # lane i, p = i mod n: a hi lane (i mod 2n >= n) takes g_i a_p y^-n and h_i b_p, a lo lane g_i a_(p+n) y^n
    # and h_i b_(p+n)
    lanes = np.arange(mn)
    hi_np = lanes % (2 * n) >= n
    at = torch.as_tensor(np.where(hi_np, lanes % n, lanes % n + n), device=a.device)
    hi = torch.as_tensor(hi_np, device=a.device)[None].expand(B, mn)
    y_n = F.select(hi, y_inv_n[:, r][:, None].expand(B, mn, NLIMBS), y_pows[:, n - 1][:, None].expand(B, mn, NLIMBS))
    g_lane = F.mul_l(F.mul_l(g, a[:, at]), y_n)
    h_lane = F.mul_l(h, b[:, at])
    combined = torch.stack([g_lane, h_lane], dim=2).reshape(B, 2 * mn, NLIMBS)  # interleaved [g_0 h_0 ...]
    perm = torch.as_tensor(round_perm(mn, r), device=a.device)
    scalars = torch.cat([combined[:, perm[:mn]], d_l, c_l[:, None], combined[:, perm[mn:]], d_r, c_r[:, None]], dim=1)
    return a, b, g, h, alpha, scalars


def prove_final_plain(a, b, g, h, alpha, fold, y_pows, y_inv_n, r_s, s_s, d_mask, eta):
    """P3's first twin (range_proof.rs:540-584): A1 = r gi'[0] + s hi'[0] +
    ry_ar H + sum d_mask G, B = rys H + sum eta G."""
    B, mn = y_pows.shape[0], y_pows.shape[1] - 1
    rounds = y_inv_n.shape[1]
    a, b, g, h, alpha = _fold_plain(a, b, g, h, alpha, fold, y_pows, y_inv_n, rounds)
    a0, b0, y1 = a[:, 0], b[:, 0], y_pows[:, 0]
    ry = F.mul_l(r_s, y1)
    ry_ar = F.add_l(F.mul_l(ry, b0), F.mul_l(F.mul_l(s_s, y1), a0))
    rys = F.mul_l(ry, s_s)
    static = torch.stack([F.mul_l(g, r_s[:, None]), F.mul_l(h, s_s[:, None])], dim=2).reshape(B, 2 * mn, NLIMBS)
    a1 = torch.cat([static, d_mask, ry_ar[:, None]], dim=1)
    brow = torch.cat([eta, rys[:, None]], dim=1)
    return a1, brow, a0.contiguous(), b0.contiguous(), alpha


def prove_responses_plain(r_s, s_s, a0, b0, eta, d_mask, alpha, e):
    """P3's second twin (range_proof.rs:586-598)."""
    r1 = F.add_l(r_s, F.mul_l(a0, e))
    s1 = F.add_l(s_s, F.mul_l(b0, e))
    d1 = F.add_l(eta, F.add_l(F.mul_l(d_mask, e[:, None]), F.mul_l(alpha, F.sqr_l(e)[:, None])))
    return r1, s1, d1


def bit_sum_plain(start: PointArray, bits: torch.Tensor, table: torch.Tensor) -> PointArray:
    """P4's twin (range_proof.rs:299-345): the A commitment's static scalars
    are the bits (a_L in {0, 1}, a_R in {0, -1}), so each lane adds g_i or
    -h_i, taken from the table's window 0, digit 1 entry (y + x, y - x, 2d x
    y) as 4 (x, y, 1, x y); then a halving tree and alpha's point."""
    B, mn = bits.shape
    entries = words_to_limbs(table[0, 1, : 2 * mn])  # (2mn, 3, 16)
    ones = bits == 1
    g_yp, g_ym, h_yp, h_ym = (entries[k::2, c][None].expand(B, mn, NLIMBS) for k in (0, 1) for c in (0, 1))
    yp = F.select(ones, g_yp, h_ym)  # -h: y + x and y - x swap
    ym = F.select(ones, g_ym, h_yp)
    e, h = F.sub25519(yp, ym), F.add25519(yp, ym)
    four = F.limbs_const(4, e).expand(e.shape)
    points = PointArray(F.add25519(e, e), F.add25519(h, h), four, F.mul25519(e, h))
    return ed.add(tree_reduce(points), start)
