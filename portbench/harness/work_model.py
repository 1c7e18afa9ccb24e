"""The least time the cells' work needs on one H100: the yardstick of the
`kernels_roofline.*` metrics.

It counts the work of the cell's shapes, never of a kernel's design, so a
redesign can neither make it stale nor push a share past 100%:

  * an MSM of n points with 253-bit scalars: the point additions of
    Pippenger's method at the window c that needs the fewest,
    ceil(253 / c) * (n + 2^(c+1)), plus its 253 doublings;
  * a point decoded or encoded: one exponentiation chain, (p - 5) / 8's
    250 squarings and 11 products;
  * the scalar work mod l: its products;
  * each field product as 64 32-bit multiply-adds (8 x 8 limbs, the
    reduction left out), a squaring as 36, a mixed point addition as 7
    products, a doubling as 4 products and 4 squarings;
  * the multiply-adds at 16.7e12 a second: 132 SMs x 64 INT32
    multiply-adds a clock x 1.98 GHz, an H100 SXM's published figures at
    its 700 W limit; bytes at its 3.35 TB/s, each input byte read and each
    output byte written once.

What the model leaves out (Keccak's permutations, host work, the
reductions) only lowers the least time, so the share stays a lower bound
of the work the card did in its busy time.
"""

from __future__ import annotations

import math

IMAD_PER_S = 16.7e12
BYTES_PER_S = 3.35e12
FE_MUL, FE_SQR = 64, 36
SC_MUL = 64
POINT_ADD = 7 * FE_MUL
POINT_DBL = 4 * FE_MUL + 4 * FE_SQR
CHAIN = 250 * FE_SQR + 11 * FE_MUL
SCALAR_BITS = 253


def pippenger_adds(n: int) -> int:
    """Point additions of the cheapest Pippenger window for n points."""
    return min(math.ceil(SCALAR_BITS / c) * (n + 2 ** (c + 1)) for c in range(1, 21))


def msm_ops(n: int) -> int:
    return pippenger_adds(n) * POINT_ADD + SCALAR_BITS * POINT_DBL


def least_s(ops: int, nbytes: int) -> float:
    return max(ops / IMAD_PER_S, nbytes / BYTES_PER_S)


def verify_block_ops(config: dict, ms: list) -> tuple:
    """(multiply-adds, bytes) of batch-verifying one block whose proofs
    aggregate ms[i] commitments each: one MSM over the widest statement's
    2 mn generators, H and the degree's G's, and each proof's commitments,
    A, A1, B and L, R a round; each proof's points decoded; at least 4 mn
    + 3 (rounds + 2) products mod l a proof (its generators' scalars, its
    challenges' inverses by one shared inversion)."""
    bits, degree = config["bits"], config["extension_degree"]
    rounds = [(m * bits).bit_length() - 1 for m in ms]
    points = 2 * max(ms) * bits + 1 + degree + sum(m + 3 + 2 * r for m, r in zip(ms, rounds))
    decoded = sum(3 + 2 * r for r in rounds)
    products = sum(4 * m * bits + 3 * (r + 2) for m, r in zip(ms, rounds))
    ops = msm_ops(points) + decoded * CHAIN + products * SC_MUL
    nbytes = sum(1 + 32 * (degree + 5 + 2 * r) + 32 * m for m, r in zip(ms, rounds)) + 64 * 2 * max(ms) * bits
    return ops, nbytes


def verify_block_s(config: dict, ms: list) -> float:
    return least_s(*verify_block_ops(config, ms))


def prove_call_ops(config: dict, batch: int, m: int) -> tuple:
    """(multiply-adds, bytes) of proving `batch` statements of m
    commitments: a proof's A (mn additions for its bits, an MSM for its
    masks), its L and R a round (MSMs over 2 n_j + 1 + degree points, n_j
    = mn / 2^(j+1)), A1 and B (MSMs over 3 + degree and 1 + degree
    points), its 2 rounds + 3 points encoded, and at least 3 mn products
    mod l to prepare its vectors and 6 n_j a round to fold them."""
    bits, degree = config["bits"], config["extension_degree"]
    mn = m * bits
    rounds = mn.bit_length() - 1
    halves = [mn >> (j + 1) for j in range(rounds)]
    ops = mn * POINT_ADD + msm_ops(degree + 1)
    ops += sum(2 * msm_ops(2 * n + 1 + degree) for n in halves)
    ops += msm_ops(3 + degree) + msm_ops(1 + degree)
    ops += (2 * rounds + 3) * CHAIN
    ops += (3 * mn + sum(6 * n for n in halves)) * SC_MUL
    nbytes = 1 + 32 * (degree + 5 + 2 * rounds) + 8 * m + 32 * m * degree
    return batch * ops, batch * nbytes


def prove_call_s(config: dict, batch: int, m: int) -> float:
    return least_s(*prove_call_ops(config, batch, m))
