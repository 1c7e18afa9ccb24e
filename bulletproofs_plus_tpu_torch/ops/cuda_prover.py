"""P1-P4 wrappers: the batched prover's scalar protocol and the A
commitment's masked sum through csrc/prover.cu.

Each wrapper takes CUDA tensors of int64 radix-2^16 limbs (ops/field.py's
layout, each limb below 2^16), checks them (`cuda.require`), allocates its
outputs, launches its kernel on the current stream and counts the launch in
`cuda.launches`:

  `prove_prep`      P1, "prove_prep", once a prove
  `prove_round`     P2, "prove_round", once a round
  `prove_final`     P3's first entry, "prove_final", after the last round
  `prove_responses` P3's second entry, "prove_responses", after the final challenge
  `bit_sum`         P4, "bit_sum", the A commitment's masked sum

Their signatures and outputs are those of the plain versions in
models/prover_kernels.py (`*_plain`), which `prover_kernels` takes for CPU
tensors; every scalar output is canonical, so the two agree limb for limb.
`bit_sum` returns a point in projective coordinates, equal to the plain
version's as a point.  There are no fallbacks.
"""

from __future__ import annotations

import functools

import torch

from ..native import cuda
from .edwards import PointArray
from .limbs import NLIMBS

PREP_MAX_THREADS = 512  # P1's block: a proof, its ladder threads and the alpha warp (csrc/prover.cu P1_MAX_THREADS)
MAX_SMEM = 232448  # shared memory a block may use: 227 KB; P1's and P2's scratch past it lies in device memory
RESPONSE_THREADS = 32  # P3's second entry: a thread an output, a warp a block (csrc/prover.cu PR_RESP_THREADS)


def prep_levels(mn: int, m: int) -> list:
    """P1's ladder levels 1, 2, .. (csrc/prover.cu `prove_prep_body`), each
    a tuple of its items' counts, one product each: y's ladder (y^(h+1+j) =
    y^h y^(1+j), h = 2^(t-1), up to y^mn), the y^-n squaring, z's (z^2 at
    level 1, then its ladder over m) and the lanes' factors d_i (at level
    log2(m) + 2)."""
    lm, lmn = m.bit_length() - 1, mn.bit_length() - 1
    levels = []
    for t in range(1, max(lmn, lm + 2) + 1):
        h = 1 << (t - 1)
        levels.append((h if t <= lmn else 0, int(t < lmn), 1 if t == 1 else h >> 1 if t <= lm + 1 else 0,
                       mn if t == lm + 2 else 0))
    return levels


def prep_threads(mn: int, m: int) -> int:
    """P1's threads a block: ladder threads enough for the widest level's
    items, a multiple of 32, and the alpha warp; at most PREP_MAX_THREADS."""
    widest = max(sum(level) for level in prep_levels(mn, m))
    return min(PREP_MAX_THREADS, 32 * -(-widest // 32) + 32)


def prep_words(mn: int, m: int, deg: int) -> int:
    """32-bit words of one proof's P1 scratch (csrc/prover.cu `p1_words`):
    y^1..y^mn, the lanes' factors d_i, z^2..z^(2m), alpha's S_k and the y^-n
    chain, 8 words each."""
    return 8 * (2 * mn + m + deg + 1)


def round_threads(mn: int) -> int:
    """P2's and P3's first entry's threads a block: a g and an h thread for
    each lane, 2 mn from 32 to 512 lane threads, and one warp more (P2:
    alpha's fold and the Pedersen lanes; P3: the last fold of a and b,
    alpha's and the closing terms)."""
    return min(512, max(32, 2 * mn)) + 32


def response_blocks(batch: int, deg: int) -> int:
    """P3's second entry's blocks of RESPONSE_THREADS: a thread for each of a
    proof's 2 + deg outputs (r1, s1, d1_1..d1_deg)."""
    return -(-batch * (2 + deg) // RESPONSE_THREADS)


def round_words(mn: int, r: int, threads: int) -> int:
    """32-bit words of one proof's P2 scratch in round r (csrc/prover.cu
    `p2_words`): a', b' and a'_j y^(1+j), g y^(-+n) and h, the warps'
    partial sums, 8 words each."""
    return 8 * (3 * (mn >> r) + 2 * mn + 2 * (threads // 32))


def bit_sum_threads(mn: int) -> int:
    """P4's threads a block, four a four-lane adder: 2 mn, from 32 to 256
    (128 at mn 64: two lanes an adder, then a tree of five levels)."""
    return min(256, max(32, 2 * mn))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(named: dict) -> torch.device:
    """Every (tensor, shape) of `named` a contiguous int64 CUDA tensor of that shape, all on one card."""
    dev = None
    for what, (t, shape) in named.items():
        cuda.require(t, what, shape)
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{what}: expected every input on {dev}, got {t.device}")
    return dev


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(named: dict) -> None:
    """P1-P3 move each value as 16-byte accesses: every tensor of `named` 16-byte aligned."""
    for what, (t, _) in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: expected a 16-byte aligned tensor")


def _fold_args(fold, batch: int, deg: int, what: str) -> dict:
    if fold is None:
        return {}
    e, e_inv, d_l, d_r = fold
    return {f"{what} e": (e, (batch, NLIMBS)), f"{what} e_inv": (e_inv, (batch, NLIMBS)),
            f"{what} previous d_L": (d_l, (batch, deg, NLIMBS)), f"{what} previous d_R": (d_r, (batch, deg, NLIMBS))}


def prove_prep(y, z, y_inv, bits, r_blind, alpha0, *, bit_length: int):
    """P1: (a, b (B, mn, 16), y^1..y^(mn+1) (B, mn + 1, 16), y^-(mn >> (r + 1))
    for each round r (B, rounds, 16), alpha (B, deg, 16)), in one launch."""
    B, mn = bits.shape
    m, deg = r_blind.shape[1], alpha0.shape[1]
    rounds = mn.bit_length() - 1
    if m * bit_length != mn:
        raise ValueError(f"prove_prep: {m} commitments of {bit_length} bits are not {mn} lanes")
    named = {"prove_prep y": (y, (B, NLIMBS)), "prove_prep z": (z, (B, NLIMBS)),
             "prove_prep y_inv": (y_inv, (B, NLIMBS)), "prove_prep bits": (bits, (B, mn)),
             "prove_prep r_blind": (r_blind, (B, m, deg, NLIMBS)), "prove_prep alpha": (alpha0, (B, deg, NLIMBS))}
    dev = _check(named)
    _aligned(named)
    new = functools.partial(torch.empty, dtype=torch.int64, device=dev)
    a, b, y_pows = new((B, mn, NLIMBS)), new((B, mn, NLIMBS)), new((B, mn + 1, NLIMBS))
    y_inv_n, alpha = new((B, rounds, NLIMBS)), new((B, deg, NLIMBS))
    words = prep_words(mn, m, deg)
    scratch = None if 4 * words <= MAX_SMEM else torch.empty((B, words), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = cuda.lib("prover").bppt_prove_prep(
            y.data_ptr(), z.data_ptr(), y_inv.data_ptr(), bits.data_ptr(), r_blind.data_ptr(), alpha0.data_ptr(),
            B, m, bit_length, deg, prep_threads(mn, m), a.data_ptr(), b.data_ptr(), y_pows.data_ptr(),
            y_inv_n.data_ptr(), alpha.data_ptr(), _ptr(scratch), _stream(),
        )
    cuda.check("prover", status, "prove_prep")
    cuda.launches["prove_prep"] += 1
    return a, b, y_pows, y_inv_n, alpha


def prove_round(a, b, g, h, alpha, fold, y_pows, y_inv_n, d_l, d_r, *, r: int):
    """P2, round r: `fold` is None in round 0, else the previous round's (e,
    e^-1, d_L, d_R), by which a, b (B, 4n, 16), g, h (B, mn, 16) and alpha
    fold first.  Returns (a, b (B, 2n, 16), g, h (B, mn, 16), alpha, the
    round's MSM scalars (B, 2 (mn + deg + 1), 16)), in one launch."""
    B, mn = y_pows.shape[0], y_pows.shape[1] - 1
    rounds, deg = y_inv_n.shape[1], alpha.shape[1]
    if not 0 <= r < rounds or (fold is None) != (r == 0):
        raise ValueError(f"prove_round: round {r} of {rounds} needs a fold exactly after round 0")
    n = mn >> (r + 1)
    width = 4 * n if fold is not None else 2 * n
    named = {"prove_round a": (a, (B, width, NLIMBS)), "prove_round b": (b, (B, width, NLIMBS)),
             "prove_round alpha": (alpha, (B, deg, NLIMBS)), "prove_round y_pows": (y_pows, (B, mn + 1, NLIMBS)),
             "prove_round y_inv_n": (y_inv_n, (B, rounds, NLIMBS)), "prove_round d_L": (d_l, (B, deg, NLIMBS)),
             "prove_round d_R": (d_r, (B, deg, NLIMBS)), **_fold_args(fold, B, deg, "prove_round")}
    if fold is not None:
        named.update({"prove_round g": (g, (B, mn, NLIMBS)), "prove_round h": (h, (B, mn, NLIMBS))})
    dev = _check(named)
    _aligned(named)
    e, e_inv, dl_prev, dr_prev, g, h = (*fold, g, h) if fold is not None else (None,) * 6
    new = functools.partial(torch.empty, dtype=torch.int64, device=dev)
    a_out, b_out = new((B, 2 * n, NLIMBS)), new((B, 2 * n, NLIMBS))
    g_out, h_out = new((B, mn, NLIMBS)), new((B, mn, NLIMBS))
    alpha_out, scalars = new((B, deg, NLIMBS)), new((B, 2 * (mn + deg + 1), NLIMBS))
    threads = round_threads(mn)
    words = round_words(mn, r, threads)
    scratch = None if 4 * words <= MAX_SMEM else torch.empty((B, words), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = cuda.lib("prover").bppt_prove_round(
            a.data_ptr(), b.data_ptr(), _ptr(g), _ptr(h), alpha.data_ptr(), _ptr(e), _ptr(e_inv), _ptr(dl_prev),
            _ptr(dr_prev), y_pows.data_ptr(), y_inv_n.data_ptr(), d_l.data_ptr(), d_r.data_ptr(), B, mn, rounds, r,
            deg, threads, a_out.data_ptr(), b_out.data_ptr(), g_out.data_ptr(), h_out.data_ptr(),
            alpha_out.data_ptr(), scalars.data_ptr(), _ptr(scratch), _stream(),
        )
    cuda.check("prover", status, "prove_round")
    cuda.launches["prove_round"] += 1
    return a_out, b_out, g_out, h_out, alpha_out, scalars


def prove_final(a, b, g, h, alpha, fold, y_pows, y_inv_n, r_s, s_s, d_mask, eta):
    """P3's first entry: the last round's fold (`fold` None where there are
    no rounds), then (the A1 MSM's scalars (B, 2 mn + deg + 1, 16), the B
    MSM's (B, deg + 1, 16), a0, b0 (B, 16), alpha (B, deg, 16)), in one launch."""
    B, mn = y_pows.shape[0], y_pows.shape[1] - 1
    rounds, deg = y_inv_n.shape[1], alpha.shape[1]
    if (fold is None) != (rounds == 0):
        raise ValueError(f"prove_final: {rounds} rounds need a fold exactly where there are rounds")
    width = 2 if fold is not None else 1
    named = {"prove_final a": (a, (B, width, NLIMBS)), "prove_final b": (b, (B, width, NLIMBS)),
             "prove_final alpha": (alpha, (B, deg, NLIMBS)), "prove_final y_pows": (y_pows, (B, mn + 1, NLIMBS)),
             "prove_final y_inv_n": (y_inv_n, (B, rounds, NLIMBS)), "prove_final r": (r_s, (B, NLIMBS)),
             "prove_final s": (s_s, (B, NLIMBS)), "prove_final d_mask": (d_mask, (B, deg, NLIMBS)),
             "prove_final eta": (eta, (B, deg, NLIMBS)), **_fold_args(fold, B, deg, "prove_final")}
    if fold is not None:
        named.update({"prove_final g": (g, (B, mn, NLIMBS)), "prove_final h": (h, (B, mn, NLIMBS))})
    dev = _check(named)
    _aligned(named)
    e, e_inv, dl_prev, dr_prev, g, h = (*fold, g, h) if fold is not None else (None,) * 6
    new = functools.partial(torch.empty, dtype=torch.int64, device=dev)
    a1, brow = new((B, 2 * mn + deg + 1, NLIMBS)), new((B, deg + 1, NLIMBS))
    a0, b0, alpha_out = new((B, NLIMBS)), new((B, NLIMBS)), new((B, deg, NLIMBS))
    with torch.cuda.device(dev):
        status = cuda.lib("prover").bppt_prove_final(
            a.data_ptr(), b.data_ptr(), _ptr(g), _ptr(h), alpha.data_ptr(), _ptr(e), _ptr(e_inv), _ptr(dl_prev),
            _ptr(dr_prev), y_pows.data_ptr(), y_inv_n.data_ptr(), r_s.data_ptr(), s_s.data_ptr(), d_mask.data_ptr(),
            eta.data_ptr(), B, mn, rounds, deg, round_threads(mn), a1.data_ptr(), brow.data_ptr(), a0.data_ptr(),
            b0.data_ptr(), alpha_out.data_ptr(), _stream(),
        )
    cuda.check("prover", status, "prove_final")
    cuda.launches["prove_final"] += 1
    return a1, brow, a0, b0, alpha_out


def prove_responses(r_s, s_s, a0, b0, eta, d_mask, alpha, e):
    """P3's second entry: (r1, s1 (B, 16), d1 (B, deg, 16)), in one launch."""
    B, deg = alpha.shape[0], alpha.shape[1]
    named = {"prove_responses r": (r_s, (B, NLIMBS)), "prove_responses s": (s_s, (B, NLIMBS)),
             "prove_responses a0": (a0, (B, NLIMBS)), "prove_responses b0": (b0, (B, NLIMBS)),
             "prove_responses eta": (eta, (B, deg, NLIMBS)), "prove_responses d_mask": (d_mask, (B, deg, NLIMBS)),
             "prove_responses alpha": (alpha, (B, deg, NLIMBS)), "prove_responses e": (e, (B, NLIMBS))}
    dev = _check(named)
    _aligned(named)
    new = functools.partial(torch.empty, dtype=torch.int64, device=dev)
    r1, s1, d1 = new((B, NLIMBS)), new((B, NLIMBS)), new((B, deg, NLIMBS))
    with torch.cuda.device(dev):
        status = cuda.lib("prover").bppt_prove_responses(
            r_s.data_ptr(), s_s.data_ptr(), a0.data_ptr(), b0.data_ptr(), eta.data_ptr(), d_mask.data_ptr(),
            alpha.data_ptr(), e.data_ptr(), B, deg, r1.data_ptr(), s1.data_ptr(), d1.data_ptr(), _stream(),
        )
    cuda.check("prover", status, "prove_responses")
    cuda.launches["prove_responses"] += 1
    return r1, s1, d1


def bit_sum(start: PointArray, bits: torch.Tensor, table: torch.Tensor) -> PointArray:
    """P4: start + sum_i (bits[:, i] ? g_i : -h_i) per proof, g_i and h_i
    read from `table` (`pack_tables` words (64, 16, S, 24), lanes 2i and 2i +
    1); start: (B,) points whose four (B, 16) coordinates share their strides
    (K6's output is read in place).  Returns (B,) points, one launch."""
    B, mn = bits.shape
    cuda.require(bits, "bit_sum bits", (B, mn))
    if table.dim() != 4 or table.shape[2] < 2 * mn:
        raise ValueError(f"bit_sum: a table of {tuple(table.shape)} lacks the {2 * mn} generator lanes")
    cuda.require(table, "bit_sum table", tuple(table.shape), dtype="torch.int32")
    if table.device != bits.device:
        raise ValueError(f"bit_sum table: expected it on {bits.device}, got {table.device}")
    coords = list(start)
    for name, c in zip("xyzt", coords):
        if c.device != bits.device or c.dtype != torch.int64 or tuple(c.shape) != (B, NLIMBS):
            raise ValueError(f"bit_sum start {name}: expected ({B}, {NLIMBS}) int64 limbs on {bits.device}")
        if c.stride() != coords[0].stride():
            raise ValueError("bit_sum start: the coordinates' strides differ")
    row_stride, limb_stride = coords[0].stride()
    out = torch.empty((4, B, NLIMBS), dtype=torch.int64, device=bits.device)
    with torch.cuda.device(bits.device):
        status = cuda.lib("prover").bppt_bit_sum(
            table.data_ptr(), table.shape[2], bits.data_ptr(), *(c.data_ptr() for c in coords), row_stride,
            limb_stride, B, mn, bit_sum_threads(mn), out.data_ptr(), _stream(),
        )
    cuda.check("prover", status, "bit_sum")
    cuda.launches["bit_sum"] += 1
    return PointArray(*out.unbind(0))
