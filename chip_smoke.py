#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bulletproofs_plus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/, holds each kernel against
its plain torch version on the card (K1, K7 and K2 at the MSM widths of both
verify batches below, 4736 and 2048 lanes; R1, the Fiat-Shamir replay, at
both batches' shapes; S1, the scalar pass, at both batches' groups and the
mixed batch's two; D1, C1 and I1, ristretto decoding, encoding and the
identity check, at the verify's and the prover's shapes, C1 in both its
forms: the RFC 9496 encoder and the double-and-encode the prover runs, and
K3's tail, the verdict a single-host verify takes in place of I1's launch,
against I1 on the same points; T1, the prover's Fiat-Shamir, at every phase
of the 128-proof prove (seeded and unseeded) and of the 64 x m4 one; P1-P4,
the prover's scalar protocol and the A commitment's masked sum, at the
128-proof prove's shape, P2 at each of its six rounds, and each but P3's
second entry by phase (P2 at its row's round), P4 on the tables of halved
points the prove sums), replays and
verifies the golden proofs, proves and verifies golden proof 3 through the sequential prover
and the host engine with their MSMs on the card (`msm_backend="device"`),
verifies the 256 x 64-bit and 64 x m4 batches through
`RangeProof.verify_batch(engine="device")` (their replay through R1, their
MSM through K7, the default signed digits; once more through K1 with
BPPT_MSM_SIGNED=0), verifies a 256-proof batch of two shapes (`mixed`,
against `engine="host"`) and a stream of nine batches through
`verify_batches_pipelined` (`pipelined`, against per-batch calls), proves
128 x 64-bit statements with `RangeProof.prove_batch_with_rng` over tables
of halved generators, built before the clock starts, and verifies what it
proved, with launch counters proving the kernels ran (C1's
double-and-encode eight times, its sqrt form never, T1 once a phase), one
device-to-host copy a prove (torch.profiler's "Memcpy DtoH" operations)
and a counter
of plain field and point calls on CUDA tensors (`PLAIN_FUNCTIONS`) proving
that nothing else computed, then 64 x (64-bit, m=4, degree 5) statements
against the sequential prover at lanes 0 and 63, and checks
that tampered and non-canonical batches fail with the reference's errors.
Last, `sharded` runs parallel/ on the card: two gloo ranks sharing card 0
(NCCL refuses two ranks on one card), then NCCL (one rank on a one-card
machine, two ranks on two cards where there are two); each rank verifies
b64_m1_x256 and proves b64_m1_x128 with `mesh=` against the same calls
unsharded (verdicts, errors, proof bytes, its own launch counts), runs
`verify_stream_pod` and `sharded_msm_fn`, and times 5 sharded verifies
beside 5 unsharded ones and the collectives inside them.  Each phase prints
one JSON line; then come the card's name and power limit (nvidia-smi), the
per-kernel table ({"kernels": [...]}: time, bound, plain version's time)
and, last, {"ok": true, "device": {...}}.  Any failed phase exits non-zero.
Without a CUDA device, or without the package beside it, it exits non-zero
with no result.

Tolerance: exact.  The kernels do integer arithmetic, so both entries of K4
must equal their plain versions mod p, and K1-K3 and K5-K7 must give the
same points (compared as canonical affine coordinates, since tilings differ
in projective Z); D1 must give the plain twin's mask and its coordinates
canonicalised, C1 its canonical limbs, I1 its bools; `max_abs_err` is the
largest limb difference (or the count of differing flags) found, and must
be 0.  The prover must reproduce golden proof 3 byte for byte.

Bounds (`bound_ms`) are the larger of bytes moved over 3.35 TB/s and the
32-bit integer multiply-adds the work needs over the card's rate: 132 SMs x
64 IMAD/clock x 1.98 GHz = 16.7e12/s, half the FMA rate behind the 67
TFLOP/s float32 peak (H100 SXM data sheet, 700 W).  The counts follow the
cheapest arithmetic each function admits, so that no kernel can pass its
bound by doing less than the bound assumed: a field multiplication counts
128 multiply-adds (8 x 8 32-bit words, low and high halves), a squaring 72
(its 36 distinct word products), an addition of two extended points 9
multiplications, a mixed addition of a precomputed affine point 7, an
addition of a point cached as (Y + X, Y - X, 2d T, 2Z) 8 (the cached form
costs one multiplication to make), a doubling 4 multiplications and 4
squarings.  K5 does, for each (row, lane,
window range), one multiplication for the range's first window and a mixed
addition for each other, and reads the lanes' table entries, the scalars and
the lane map once; K6 the additions of its tree.  K1 does, for each lane,
its table at the cheapest schedule (each even multiple a doubling of its
half, each odd one an addition: 7 doublings and 7 additions for 2P..15P;
then P..15P cached) and, for each window, the additions of cached entries
that sum its tile's lanes (64 (n - tiles) in all), and reads the scalars
and points once and writes packed partials; K2 the 64 (tiles - 1)
additions left; K7 as K1 with a table of 4 doublings and 3 additions
(2P..8P) and 8 cached entries.  R1 reads each lane's state and row and
the program once and writes each lane's canonical limbs, seed and two
flags, and does, for each lane, one integer operation for each byte of its
program's spans, its permutations, each 4320 32-bit integer instructions
at the least (`KECCAK_INT_OPS`), and for each challenge the wide
reduction's products (`FOLD_MULADDS`), over the same integer rate.

`chain_ms` is the other floor: the field multiplications and squarings that lie
one after another on the kernel's longest path, each at the dependent
latency that the one-warp probe measured in this run (`fe_mul_ns`,
`fe_sqr_ns`).  K3 and K6 spread a point operation over four lanes
(ge_dbl4, ge_add4: a doubling is a squaring and a multiplication deep, an
addition three multiplications), and their `serial_chain_ms` is the figure
of the one-thread design they replaced (4 + 4 and 9 deep); K1's first two
table levels and its quarters' sums and all of K2 do the same, and so
does K7.  K1, K7 and K2 also give their grid (`blocks`, `threads`, `waves`: blocks over those the
card holds at once, its SM count times the kernel's blocks an SM by the
CUDA occupancy calculator, both read in this run) and ptxas's registers and
spill.  `bound_ms`
stays the rate bound.  Every row carries `graph_ms`, the launch's time
replayed from a CUDA graph: `ms` times the wrapper called back to back, and
below some 0.02 ms that is the host.  The probe also times the point
operations themselves for one warp (`ge_dbl_ns`, `ge_add_ns`, `ge_dbl4_ns`,
`ge_add4_ns`), their chains' ends checked against the host's integers,
and two one-warp chains of Keccak-f[1600] permutations, checked against
utils/jkeccak.py: R1's, a permutation spread over the warp's lanes
(`perm_ns`, behind R1's `chain_ms`: its permutations one after another,
its spans not counted), and the one-thread permutation of the design
before it (`keccak_ns`).  R1 also gives its span count, its grid (`warps`
a block, `blocks`, `waves` over the blocks the card holds at once) and
`replay_fn_ms`, the whole `replay_fn` (one launch and views) called back
to back; its epilogue alone (`reduce_wide_probe`) is held against Python
integers at the reduction's edges.

T1's row is a whole prove's phases (rounds + 2 launches back to back; each
phase's `graph_ms` beside): it reads each lane's state, points (as limbs),
witness bytes and block and writes the state, its scalars and a flag byte,
and counts R1's work (permutations, span bytes, reductions) and, for each
inversion, the cheaper of two counts for this run's value: the divsteps
batches of the constant-time form (`INV_BATCH_OPS` each) and the
operations T1's own inversion (sc_inv_l_var, a warp for one value) does by
its word model's counts of batches and carry rounds (`INV_JUMP_BATCH_OPS`,
`INV_SETTLE_ROUND_OPS`), as S1's bound takes the cheaper of its two.
`bound_ms_ct` beside it counts every inversion by the constant-time form
alone, the yardstick from before T1's variable-time inversion, so that
both designs read against one figure; `inversion_ops_var` is the second
count summed.  Its `chain_ms` is its permutations at `perm_ns` and its
inversions at `sc_inv_var_ns`, one warp's chain of dependent sc_inv_l_var
on random inputs (each the sum of the last inverse and the value), its
ends checked against the word model; the inversion is also held against
Python integers and the word model at the edges
(torch_prover_inputs.inv_edge_values), alone and inside T1 (a program that
squeezes each proof's value from its state,
`torch_prover_inputs.EpiloguePhase`: a zero challenge gives inverse 0 and
its flag).  K3's row times the main path's form, with the tail
(`graph_ms_without_tail` beside); I1's launches are the sharded verify's,
its one path.

D1 reads an encoding and writes a point and a flag, C1 reads a point and
writes an encoding, I1 reads X and Y and writes a flag, as int64 limbs; D1
and C1 count K4's chain and SQRT_RATIO_M1 as K4's row does (POW_*, RATIO_*)
and the squarings and products of the formula around them (DECODE_*,
ENCODE_*, counted from ops/ristretto.py), I1 none.  Their `chain_ms` is the
same chain and the formula's products on its longest path
(DECODE_CHAIN_*, ENCODE_CHAIN_*) at `fe_sqr_ns` and `fe_mul_ns`; D1's
`chain4_ms` the same at the four-lane form's own latencies (`fe_sqr4_ns`,
`fe_mul4_ns`: the form D1 takes at a verify's 4096 points).  C1's
double-and-encode reads a point and writes an encoding as the sqrt form
does, and counts its lane's squarings and products (DC_SQR, DC_MUL:
Montgomery's trick 3 a lane) and one inversion a block of 32 (FE_INV_OPS:
20 batches of divsteps at the multiply-add rate); its `chain_ms` is a
squaring and DC_CHAIN_MUL products at `fe_sqr_ns` and `fe_mul_ns` and one
inversion at `fe_inv_ns`, one warp's chain of dependent `fe_inv` (20
against 4, its ends checked against Python integers).  It is held at
(128,), (128, 2), (64, 2), 1 and 1025 points with E[4] lanes (e = 0) among
them, against its plain twin and, at (128,), against the sqrt form's
encoding of the doubled points.  The main
phase times, beside the scalar pass, the decompression and the identity
check as stages of a verify, and reads D1's and I1's device time there.

P1-P3 read each input once and write each output once as int64 limbs, and
count the products mod l that one proof needs at the fewest
(`_prover_products`), each `SC_MULADDS_PER_MUL`; their `chain_ms` is the
products one thread runs one after another (`_prover_chains`) at
`sc_mul_ns` (their items handed out as their threads take them,
`_p1_chain`, `_p2_chain`, `_p3_chain`); the rows of P1, P2, P3's first
entry and P4 also give their phases, clock64() stamps at the `// P1
phase:` to `// P4 phase:` markers of copies built at once by
scripts/profile_torch_p2.py, and each copy's own `stamped_graph_ms`.  P4
reads the bits, the start points and the generators' first two table
words once and writes a point a proof, and counts a mixed addition (7
products) a lane; its chain (`_p4_chain`) is an adder's four-lane mixed
additions, 2 products deep, and the tree's four-lane additions, 3 deep, at
`fe_mul_ns`.

S1 reads each input once and writes each output once as int64 limbs; its
bound counts what the scalar pass needs at the fewest (`_scalar_products`):
a proof's other products as a Montgomery batch inversion arranges them, and
3 a lane and proof, each term of a lane a ladder over the lanes, each
product `SC_MULADDS_PER_MUL` (2 x 64 multiply-adds for the 8 x 8-word
product and `FOLD_MULADDS` for its reduction; sums not counted); and one
inversion a shape group: Montgomery's trick over the proofs (3 products a
proof after the first) inverts the product of every proof's product of
values to invert, a proof whose product is 0 taking 1 in its place by a
select and its inverses zeroed, at the cheaper of two counts: Fermat's
x^(l - 2) by a 4-bit window (298 products) or the batches of 30 divsteps
that this run's value needs, each `INV_BATCH_OPS` 32-bit integer
instructions (the divsteps' masks, additions and shifts, and the matrix's
32 x 32 -> 64-bit products at two multiply-adds), counted at the
multiply-add rate.  S1's own work (S1a's program's products and k + 2
inversions a proof; S1b rebuilds y^-i and P(i) from the bits of i on every
lane) stands beside it as `products` and `inversions`.  Its `chain_ms` is
S1a's chain, its program's steps with a product at the one-warp latency of
a product mod l (`sc_mul_ns`) and its one inversion step at that of an
inversion (`sc_inv_ns`, random inputs), then the products that one S1b
thread does for one lane over its share of the proofs at `sc_mul_ns`; both
probes' chain ends are checked against Python integers.  Each shape also
gives S1a's and S1b's device time a call under torch.profiler
(`s1a_device_ms`, `s1b_device_ms`, median of 5 calls).  The main phase also
reads, for one b64_m1_x256 verify, the scalar pass as a stage (its captured call alone, synchronised) and, under
torch.profiler, the verify's device operations, busy time, idle share and
S1a's and S1b's device time, in the verify and in the captured call run back
to back and after the card has idled (`s1_device_ms_*`), to tell the
profiler's reading from the context's.
"""

from __future__ import annotations

import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
MULADDS_PER_FMUL = 128
MULADDS_PER_FSQR = 72
FMUL_PER_ADD, FMUL_PER_MIXED_ADD = 9, 7
FMUL_PER_CACHED_ADD = 8  # an addition whose second point is cached as (Y + X, Y - X, 2d T, 2Z)
FMUL_DEEP_ADD4 = 3  # an addition spread over four lanes (ge_add4): three multiplications one after another
FMUL_DEEP_MADD4 = 2  # a mixed addition of an affine entry over four lanes (P4's p4_madd4): two
DBL_FMUL, DBL_FSQR = 4, 4
POW_SQR, POW_MUL = 251, 11  # the x^((p-5)/8) addition chain
RATIO_SQR, RATIO_MUL = 3, 8  # SQRT_RATIO_M1 around the chain: v^3, v^7, u v^3, u v^7, r, v r^2, two by sqrt(-1)
# D1 and C1 beside K4's chain and SQRT_RATIO_M1 (ops/ristretto.py:67-93 and :45-64): every squaring and product
# of the formula (the rate bound), then those on its longest path (the chain)
DECODE_SQR, DECODE_MUL = 2, 9  # s^2, u2^2; d u1 u1 (2), v u2^2, den_x, invsqrt den_x, den_y, 2s den_x, y, t
ENCODE_SQR, ENCODE_MUL = 1, 13  # u2^2; u1, u2, u1 u2^2, den1, den2, z_inv (2), i x, i y, enchanted, t z_inv, x z_inv, s
DECODE_CHAIN_SQR, DECODE_CHAIN_MUL = 1, 8  # s^2, d u1 u1, v u2^2; den_x, invsqrt den_x, den_y, y, t
ENCODE_CHAIN_SQR, ENCODE_CHAIN_MUL = 1, 8  # u1 or u2, u2^2, u1 u2^2; den1, den1 den2, z_inv, t z_inv, x z_inv, s
# C1's double-and-encode (csrc/ristretto.cu double_compress_kernel): a lane's X^2, Y^2, Z^2, T^2, then d T^2, e,
# eg, fh and efgh; Montgomery's trick 3 a lane; the tail's Zinv, Tinv, eg Zinv, f sqrt(-1), h e, h e Zinv, g Tinv,
# magic g Tinv and s.  On its longest path T^2, d T^2, fh and efgh, the tree's five levels up and five down, and
# the tail's Zinv, eg Zinv, h e Zinv, g Tinv, magic g Tinv and s; one inversion a block beside them
DC_SQR, DC_MUL = 4, 5 + 3 + 9
DC_CHAIN_SQR, DC_CHAIN_MUL = 1, 3 + 5 + 5 + 6
DC_THREADS = 32  # a block: one warp, one inversion
# fe_inv (csrc/divsteps.cuh): a fixed 20 batches of 30 divsteps, each batch as INV_BATCH_OPS counts it with p's nine
# non-zero 30-bit limbs in place of l's six
FE_INV_OPS = 20 * (30 * 27 + 2 * (36 + 18 + 1 + 36))
# RFC 9496 Appendix A.2: encodings a decoder must reject (as tests/test_host_ristretto.py lists them)
RFC9496_BAD = (
    "00ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "f3ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "0100000000000000000000000000000000000000000000000000000000000000",
    "01ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "ed57ffd8c914fb201471d1c3d245ce3c746fcbe63a3679d51b6a516ebebe0e20",
    "c34c4e1826e5d403b78e246e88aa051c36ccf0aafebffe137d148a2bf9104562",
    "c940e5a4404157cfb1628b108db051a8d439e1a421394ec4ebccb9ec92a8ac78",
    "47cfc5497c53dc8e61c91d17fd626ffb1c49e2bca94eed052281b510b1117a24",
    "f1c6165d33367351b0da8f6e4511010c68174a03b6581212c71c0e1d026c3c72",
    "87260f7a2f12495118360f02c26a470f450dadf34a413d21042b43b9d93e1309",
    "26948d35ca62e643e26a83177332e6b6afeb9d08e4268b650f1f5bbd8d81d371",
    "4eac077a713c57b4f4397629a4145982c661f48044dd3f96427d40b147d9742f",
    "de6a7b00deadc788eb6b6c8d20c0ae96c2f2019078fa604fee5b87d6e989ad7b",
    "bcab477be20861e01e4a0e295284146a510150d9817763caf1a6f4b422d67042",
    "2a292df7e32cababbd9de088d1d1abec9fc0440f637ed2fba145094dc14bea08",
    "f4a9e534fc0d216c44b218fa0c42d99635a0127ee2e53c712f70609649fdff22",
    "8268436f8c4126196cf64b3c7ddbda90746a378625f9813dd9b8457077256731",
    "2810e5cbc2cc4d4eece54f61c6f69758e289aa7ab440b3cbeaa21995c2f4232b",
    "3eb858e78f5a7254d8c9731174a94f76755fd3941c0ac93735c07ba14579630e",
    "a45fdc55c76448c049a1ab33f17023edfb2be3581e9c7aade8a6125215e04220",
    "d483fe813c6ba647ebbfd3ec41adca1c6130c2beeee9d9bf065c8d151c5f396e",
    "8c2e1d70d98ceca6f7caf3c037a4130ade1fca94eb9a357b4bcc222c20d05992",
    "32888462f8b486c68ad7dd9610be5192bbeaf3b443951ac1a8118419d9fa097b",
    "227142501b9d4355ccba290404bde41575b037693cef1f438c47f8fbf35d1165",
    "5c37cc491da847cfeb9281d407efc41e15144c876e0170b499a96a22ed31e01e",
    "445425117cb8c90edcbc7c1cc0e74f747f2c1efa5630a967c64f287792a48a4b",
    "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
)
LIMB_BYTES = 8 * 16  # one field element as 16 int64 limbs
POINT_BYTES = 4 * LIMB_BYTES
ENTRY_BYTES = 96  # one table entry: 24 packed 32-bit words
PART_BYTES = 128  # one K5 partial: 32 packed 32-bit words
K4_SHAPES = (128, 256, 4100)  # elements a launch: a prove's two widths, a 256-proof verify's
K4_MANY = 32768  # beyond the launchers' switch to one lane an element (4224): where that form must win
# The b64_m4_x64 verify's MSM: 64 proofs x 23 points (4 commitments, A, A1, B, 8 L and 8 R) and the base
# points padded to 1536 dynamic lanes, then 512 static (G_i, H_i for 256 bits)
M4_LANES = 1536 + 512
PROVE_BATCH = 128
COMPRESS_SHAPES = ((PROVE_BATCH,), (PROVE_BATCH, 2))  # a prove's C1 launches: A, then L/R and A1/B a lane
# the double-and-encode: both provers' shapes (the 64 x m4 prove's (64, 2)), one lane, and past one block of 1024
DOUBLE_COMPRESS_SHAPES = ((PROVE_BATCH,), (PROVE_BATCH, 2), (64, 2), (1,), (1025,))
# R1: 32-bit integer instructions a Keccak-f[1600] permutation needs at the least, 180 a round for 25 64-bit
# lanes as 32-bit halves: theta's column parities 20 (a three-input XOR is one LOP3), its rotations 10 and their
# application 50 (c[x-1] ^ rot(c[x+1]) ^ a in one LOP3 a half), rho 48 (two funnel shifts a rotation, lane 0
# unrotated), chi 50 (one LOP3 a half), iota 2
KECCAK_INT_OPS = 24 * 180
REPLAY_SHAPES = ((3, 256), (6, 64))  # golden cell and lanes: the b64_m1_x256 and b64_m4_x64 verifies' replays
# R1, S1 and P1-P3: 32-bit multiply-adds of one reduction mod l of a 512-bit value (csrc/scalar_l.cuh): three
# folds of 2^252 = -delta, 9 x 4, 5 x 4 and 1 x 4 words at two a word pair (low and high halves); a product mod l
# adds the 8 x 8-word product at two a word pair
FOLD_MULADDS = 2 * (36 + 20 + 4)
SC_MULADDS_PER_MUL = 2 * 64 + FOLD_MULADDS
# S1: one batch of 30 divsteps of the inversion (csrc/scalar_l.cuh sc_inv_l) in 32-bit integer instructions: 27 a
# divstep (two masks, three conditional negations and additions, the swap's three, zeta, three shifts), then the
# 2 x 2 matrix's 32 x 32 -> 64-bit products at two multiply-adds each: (d, e)'s 36 and l's 12 (six non-zero limbs
# of l), one for each multiple of l, and (f, g)'s 36
INV_BATCH_OPS = 30 * 27 + 2 * (36 + 12 + 1 + 36)
# T1's own inversion (csrc/scalar_l.cuh sc_inv_l_var, a warp for one value) in 32-bit integer operations: a batch's
# steps on one lane's worth, seven jumps of four (the table index 7, the load, its fields 6, f and g 6, the matrix 8,
# zeta 2) and two single steps (27 each, as INV_BATCH_OPS counts them); the batch's products on their lanes, as
# INV_BATCH_OPS counts (d, e) and (f, g); its first carry round, 6 a limb of each of two values on 9 limbs a half; and
# each further round, 3 a limb of the same 36 limbs
INV_JUMP_BATCH_OPS = 7 * 30 + 2 * 27 + 2 * (36 + 12 + 1 + 36) + 2 * 2 * 9 * 6
INV_SETTLE_ROUND_OPS = 4 * 9 * 3
# S1's shapes (label, golden cell, lanes, max_mn): the b64_m1_x256 and b64_m4_x64 verifies' groups and the mixed
# batch's two groups (m=2 with minimum values; m=1 padded to the batch's widest, 128 lanes)
# T1's shapes (label, proofs, bits, m, extension degree, seeded): the 128-proof prove (the main path's: seeded)
# unseeded too, and the 64 x m4 prove's
TRANSCRIPT_SHAPES = (("b64_m1_x128", PROVE_BATCH, 64, 1, 1, True), ("b64_m1_x128_unseeded", PROVE_BATCH, 64, 1, 1, False),
                     ("b64_m4_x64", 64, 64, 4, 5, False))
T1_ZERO_LANE = 3  # its first point in phase 1 all zeroes: flagged on that lane alone
SCALAR_SHAPES = (("b64_m1_x256", 3, 256, 64), ("b64_m4_x64", 6, 64, 256), ("mixed_m2", 4, 128, 128),
                 ("mixed_m1", 3, 128, 128))
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "golden_vectors.json")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, muladds: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muladds / IMAD_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def median_ms(fn, runs: int) -> float:
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_ms(fn, reps: int = 50) -> float:
    """Device time of one launch: CUDA events around `reps` back-to-back
    launches after a warm-up, divided by `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one launch with the host out of the way: `reps` calls
    captured into a CUDA graph, CUDA events around `replays` replays.  Where a
    kernel takes less than its wrapper's host time (some 0.02 ms), `kernel_ms`
    measures the host; this does not."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def ptxas_report(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc -Xptxas -v output."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )_Z(\d+)(\w+)", line)
        if m:
            current = m.group(2)[: int(m.group(1))]  # the mangled name's length-prefixed identifier
            out.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
    return out


def sass_histogram(cuda, library: str, kernels) -> dict:
    """{kernel: {opcode: count}} from `cuobjdump -sass` of a built library, or
    {"unavailable": reason}.  Opcodes keep their first two dotted parts
    (IMAD.WIDE, IADD3.X), which tells multiplies from the rest."""
    tool = os.path.join(os.path.dirname(cuda.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {"unavailable": "no cuobjdump beside nvcc"}
    res = subprocess.run([tool, "-sass", cuda.so_path(library)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        return {"unavailable": res.stderr.strip()[-200:]}
    out, current = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = next((k for k in kernels if k in m.group(1)), None)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)?)", line)
        if m and current:
            counts = out.setdefault(current, {})
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in out.items()}


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unavailable"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build(torch, cuda, ptxas: dict) -> dict:
    """Builds every library; `ptxas` gets each kernel's registers and spill bytes."""
    t0 = time.perf_counter()
    per_lib = cuda.build(force=True)
    seconds = time.perf_counter() - t0
    regs = {}
    for name in cuda.LIBRARIES:
        with open(cuda.log_path(name)) as f:
            regs.update(ptxas_report(f.read()))
    ptxas.update(regs)
    for name in cuda.LIBRARIES:
        cuda.lib(name)
    sass = sass_histogram(cuda, "pow", ("field_mul_latency_kernel", "field_sqr_latency_kernel",
                                        "field4_latency_kernelILb0E", "field4_latency_kernelILb1E"))
    sass.update(sass_histogram(cuda, "replay", ("perm_latency_kernel", "keccak_latency_kernel", "replay_kernel",
                                                "reduce_wide_kernel")))
    sass.update(sass_histogram(cuda, "scalar", ("scalar_latency_kernel", "scalar_inv_latency_kernel",
                                                "scalar_proof_kernel", "scalar_lane_kernel")))
    sass.update(sass_histogram(cuda, "ristretto", ("fe_inv_latency_kernel", "double_compress_kernel")))
    sass.update(sass_histogram(cuda, "transcript", ("prove_transcript_kernel", "transcript_inv_latency_kernel")))
    return {"seconds": seconds, "per_library": per_lib, "device": torch.cuda.get_device_name(0),
            "power": nvidia_smi(), "ptxas": regs, "sass": sass}


def _rand_points(torch, ed, hr, n: int, rs: random.Random, dev):
    """n distinct-looking points: sums of two of 64 host multiples of the base point."""
    base = ed.from_host([hr.point_mul(rs.randrange(1, hr.L), hr.BASEPOINT) for _ in range(64)], device=dev)
    i = torch.as_tensor([rs.randrange(64) for _ in range(n)], device=dev)
    j = torch.as_tensor([rs.randrange(64) for _ in range(n)], device=dev)
    return ed.add(ed.PointArray(*(c[i] for c in base)), ed.PointArray(*(c[j] for c in base)))


def _affine(F, torch, coords):
    """(4, 16, ...) points -> canonical affine (x, y) limbs, for exact comparison."""
    zinv = F.inv25519(coords[2].movedim(0, -1))
    x = F.canon25519(F.mul25519(coords[0].movedim(0, -1), zinv))
    y = F.canon25519(F.mul25519(coords[1].movedim(0, -1), zinv))
    return torch.stack([x, y])


def _point_err(F, torch, got, want) -> float:
    return float((_affine(F, torch, got) - _affine(F, torch, want)).abs().max())


def _fixed_rows(torch, cf, F, tables, lane_idx, scalars, groups: int, probe: dict) -> dict:
    """K5 and K6 on one shape against their plain versions, at the window
    split the wrapper picks (K6 at every block size there, and once at
    another split), then both timed at every split: {kernel: row}."""
    sc_t = scalars.movedim(-1, 0).contiguous()  # (16, f, s)
    _, f, s = sc_t.shape
    wsplit = cf.pick_wsplit(f, s)
    parts = cf.fixed_acc(tables, lane_idx, sc_t)
    if tuple(parts.shape) != (f, wsplit * s, cf.POINT_WORDS):
        raise AssertionError(f"fixed_acc did not split {wsplit} ways: {tuple(parts.shape)}")
    want = cf.fixed_acc_plain(tables, lane_idx, sc_t, wsplit)
    err5 = _point_err(F, torch, cf.words_to_coords(parts), cf.words_to_coords(want))
    want6 = cf.fixed_fold_plain(parts, groups, wsplit)
    other = next(w for w in cf.WSPLITS if w != wsplit)  # a split the wrapper does not pick here
    parts_other = cf.fixed_acc(tables, lane_idx, sc_t, other)
    err6 = max(
        _point_err(F, torch, torch.stack([cf.fixed_fold(parts, groups, wsplit)]
                                         + [cf.fixed_fold(parts, groups, wsplit, threads=t) for t in cf.FOLD_THREADS],
                                         dim=-1), want6[..., None]),
        _point_err(F, torch, cf.fixed_fold(parts_other, groups, other), cf.fixed_fold_plain(parts_other, groups, other)))
    for name, err in (("fixed_acc", err5), ("fixed_fold", err6)):
        if err != 0:
            raise AssertionError(f"{name} (rows {f}, lanes {s}, groups {groups}; fixed_fold at {cf.FOLD_THREADS} threads "
                                 f"and at split {other} too) disagrees with its plain version (max_abs_err {err})")
    wpt = cf.N_WINDOWS // wsplit
    n_parts = f * wsplit * s
    b5 = bound_ms(cf.N_WINDOWS * cf.N_DIGITS * s * ENTRY_BYTES + f * s * LIMB_BYTES + 8 * s + n_parts * PART_BYTES,
                  n_parts * (1 + (wpt - 1) * FMUL_PER_MIXED_ADD) * MULADDS_PER_FMUL)
    b6 = bound_ms(n_parts * PART_BYTES + f * groups * POINT_BYTES,
                  (n_parts - f * groups) * FMUL_PER_ADD * MULADDS_PER_FMUL)
    by_split = {}
    for w in cf.WSPLITS:  # the settings tried: K5 alone, K6 on its partials
        p_w = cf.fixed_acc(tables, lane_idx, sc_t, w)
        by_split[w] = {"fixed_acc_ms": kernel_ms(lambda: cf.fixed_acc(tables, lane_idx, sc_t, w)),
                       "fixed_fold_ms": kernel_ms(lambda: cf.fixed_fold(p_w, groups, w)),
                       "fixed_acc_graph_ms": graph_ms(lambda: cf.fixed_acc(tables, lane_idx, sc_t, w)),
                       "fixed_fold_graph_ms": graph_ms(lambda: cf.fixed_fold(p_w, groups, w)),
                       "fixed_fold_threads": cf.pick_fold_threads(w * s // groups, f * groups)}
        if w == wsplit:  # every block size timed at the split the wrapper picks
            by_split[w]["fixed_fold_graph_ms_by_threads"] = {
                t: graph_ms(lambda: cf.fixed_fold(p_w, groups, w, threads=t)) for t in cf.FOLD_THREADS}
    # the longest chain: K5 a multiplication and wpt - 1 mixed additions in a thread; K6 an adder's loop
    # additions, then the tree's levels, each 3 multiplications deep over four lanes (9 in one thread, as
    # `serial_chain_ms` counts them for the one-thread design of 128 adders that this one replaced)
    count = wsplit * s // groups
    adders = cf.pick_fold_threads(count, f * groups) // 4
    fold_adds = -(-count // adders) - 1 + (min(count, adders) - 1).bit_length()
    serial_adds = -(-count // 128) + (min(count, 128) - 1).bit_length()
    shape = {"rows": f, "lanes": s, "groups": groups, "wsplit": wsplit, "by_wsplit": by_split}
    return {
        "fixed_acc": {"max_abs_err": err5, "ms": by_split[wsplit]["fixed_acc_ms"],
                      "graph_ms": by_split[wsplit]["fixed_acc_graph_ms"],
                      "plain_ms": median_ms(lambda: cf.fixed_acc_plain(tables, lane_idx, sc_t, wsplit), 3),
                      "bound_ms": b5[0], "bound_by": b5[1],
                      "chain_ms": (1 + (wpt - 1) * FMUL_PER_MIXED_ADD) * probe["fe_mul_ns"] * 1e-6, **shape},
        "fixed_fold": {"max_abs_err": err6, "ms": by_split[wsplit]["fixed_fold_ms"],
                       "graph_ms": by_split[wsplit]["fixed_fold_graph_ms"],
                       "plain_ms": median_ms(lambda: cf.fixed_fold_plain(parts, groups, wsplit), 3),
                       "bound_ms": b6[0], "bound_by": b6[1],
                       "chain_ms": fold_adds * FMUL_DEEP_ADD4 * probe["fe_mul_ns"] * 1e-6,
                       "serial_chain_ms": serial_adds * FMUL_PER_ADD * probe["fe_mul_ns"] * 1e-6,
                       "threads": 4 * adders, **shape},
    }


def _latency_probe(torch, cp, F, pack_ints, int_from_limbs, rs) -> dict:
    """Dependent latency of one fe_mul and one fe_sqr (`fe_*_ns`), and of the
    four-lane product and squaring of D1's chain (`fe_mul4_ns`,
    `fe_sqr4_ns`, sqrt_ratio.cuh `FourLanes`): a one-warp chain of 1280
    against one of 256, the difference over 1024; the ends checked.
    `fe_*_busy_ns` is the same with 32 warps, over the eight that share a
    scheduler: what one operation takes where the SM is kept busy."""
    v = rs.randrange(2**256)
    x = torch.as_tensor(pack_ints([v]).astype("int64")[0], device="cuda")
    out = {}
    for op in ("mul", "sqr", "mul4", "sqr4"):
        got = int_from_limbs(cp.field_latency_probe(x, op, 40).cpu().numpy()) % F.P
        if got != (pow(v, 41, F.P) if op.startswith("mul") else pow(v, 2**40, F.P)):
            raise AssertionError(f"latency probe: a chain of 40 fe_{op} is wrong")
        for key, warps in ((f"fe_{op}_ns", 1), (f"fe_{op}_busy_ns", 32)):
            short = kernel_ms(lambda: cp.field_latency_probe(x, op, 256, warps))
            long = kernel_ms(lambda: cp.field_latency_probe(x, op, 1280, warps))
            # 32 warps are eight on each of the SM's four schedulers: an eighth of a step is one operation
            out[key] = (long - short) * 1e6 / 1024 / (warps // 4 or 1)
    return out


POINT_PROBE_KEYS = {"dbl": "ge_dbl_ns", "add": "ge_add_ns", "dbl4": "ge_dbl4_ns", "add4": "ge_add4_ns"}


def _point_latency_probe(torch, cp, ed, hr, rs) -> dict:
    """Dependent latency of one point operation for one warp: ge_dbl and
    ge_add (a thread a point) beside ge_dbl4 and ge_add4 (four lanes a
    point).  A chain of 320
    against one of 64, the difference over 256; the ends of a chain of 40
    checked against the host's integers (2^40 P and 41 P)."""
    point = hr.point_mul(rs.randrange(1, hr.L), hr.BASEPOINT)
    p = torch.stack(list(ed.from_host(point, device="cuda"))).contiguous()  # (4, 16)
    out = {}
    for op, key in POINT_PROBE_KEYS.items():
        got = ed.to_host(ed.PointArray(*cp.point_latency_probe(p, op, 40)))
        want = hr.point_mul(2**40 if op.startswith("dbl") else 41, point)
        if not hr.point_equal(got, want):
            raise AssertionError(f"latency probe: a chain of 40 {op} is wrong")
        short = kernel_ms(lambda: cp.point_latency_probe(p, op, 64))
        long = kernel_ms(lambda: cp.point_latency_probe(p, op, 320))
        out[key] = (long - short) * 1e6 / 256
    return out


def _horner_edges(torch, F, wsum, int_from_limbs, pack_ints) -> dict:
    """K3's edge inputs from the window sums of the main shape, (4, 16, 64)
    each: every window the identity; only W_63, only W_0 not the identity; and
    coordinates that are not canonical: windows 0 to 31 with p added to every
    coordinate (values in [p, 2p)), windows 32 to 63 the identity written as
    (2p : p + 1 : p + 1 : 2p), 2p = 2^256 - 38 being the largest value a
    coordinate can hold that is 0 mod p."""
    identity = torch.zeros_like(wsum)
    identity[1:3, 0] = 1
    only_top, only_low = identity.clone(), identity.clone()
    only_top[..., 63], only_low[..., 0] = wsum[..., 63], wsum[..., 0]
    host = wsum.cpu().numpy()
    ints = [[int_from_limbs(host[c, :, w]) % F.P + F.P if w < 32 else (2 * F.P, F.P + 1, F.P + 1, 2 * F.P)[c]
             for w in range(64)] for c in range(4)]
    above_p = torch.as_tensor(pack_ints([v for row in ints for v in row]).astype("int64"), device=wsum.device)
    above_p = above_p.reshape(4, 64, 16).transpose(1, 2).contiguous()
    return {"all_identity": identity, "only_w63": only_top, "only_w0": only_low, "not_canonical": above_p}


def _replay_inputs(torch, bp, hr, cell, batch: int, rs: random.Random):
    """R1's inputs at a verify's shape on the card: the replay of golden
    `cell`'s shape for `batch` lanes, lane 0 the golden proof from its
    transcript, every other lane's state and row random bytes (the replay is
    a function of any bytes, and no lane can stand in for another), and lane
    batch // 2 + 1's A all zeroes.  -> (replay fn, state, rows, A's lane)."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.models.replay_device import pack_replay_inputs, replay_fn, row_layout

    statement = _golden_statement(bp, hr, cell)
    proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    gens, m, rounds = statement.generators, len(cell["values"]), len(proof.li)
    stacked = bp.Transcript(b"golden", batch=batch)
    fn = replay_fn(gens.h_base_compressed(), tuple(gens.g_bases_compressed()), gens.bit_length(),
                   int(gens.extension_degree()), m, rounds, stacked.strobe.pos, stacked.strobe.pos_begin,
                   stacked.strobe.cur_flags)
    state = stacked.strobe.state.copy()
    buf = pack_replay_inputs([statement] * batch, [proof] * batch).copy()
    state[1:] = np.frombuffer(rs.randbytes(state[1:].size), dtype=np.uint8).reshape(state[1:].shape)
    buf[1:] = np.frombuffer(rs.randbytes(buf[1:].size), dtype=np.uint8).reshape(buf[1:].shape)
    zero_lane = batch // 2 + 1
    lo = row_layout(m, rounds, len(proof.d1))[0]["a"][0]
    buf[zero_lane, lo : lo + 32] = 0
    return fn, torch.as_tensor(state, device="cuda"), torch.as_tensor(buf, device="cuda"), zero_lane


def _probe_ns(probe, words) -> float:
    """One dependent permutation of a one-warp probe, ns: the chain of 320
    less the chain of 64, over 256."""
    short = kernel_ms(lambda: probe(words, 64))
    long = kernel_ms(lambda: probe(words, 320))
    return (long - short) * 1e6 / 256


def _replay_rows(torch, bp, hr, cells, rs: random.Random, rows: dict, out: dict, ptxas: dict) -> None:
    """R1 against the plain whole `replay_fn` (the replay sequence on
    utils/jstrobe.py's tensors, then `reduce_wide_l` and `is_zero_l`) on the
    card at both verify shapes, exact on the canonical limbs, the seeds and
    both flags, with lane 0 the golden proof (its challenges and the host
    replay's seed checked) and a zeroed A flagged on its lane only; at 8
    lanes of every golden shape; its epilogue alone at the reduction's
    edges.  Timed at both shapes, beside the one-warp permutation chains
    (`perm_ns`, `keccak_ns`)."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs
    from bulletproofs_plus_tpu_torch.utils import jkeccak

    words = torch.as_tensor(np.frombuffer(rs.randbytes(200), dtype=np.int64).copy(), device="cuda")
    want = words.view(torch.uint8).reshape(1, 200)
    for _ in range(3):
        want = jkeccak.state_to_bytes(jkeccak.keccak_f1600(jkeccak.bytes_to_state(want)))
    for name, probe in (("perm", cr.perm_latency_probe), ("keccak", cr.keccak_latency_probe)):
        if not torch.equal(probe(words, 3).view(torch.uint8).reshape(1, 200), want):
            raise AssertionError(f"{name} latency probe: three permutations disagree with utils/jkeccak.py")
    perm_ns = _probe_ns(cr.perm_latency_probe, words)
    out["perm_ns"] = perm_ns
    out["keccak_ns"] = _probe_ns(cr.keccak_latency_probe, words)

    L = hr.L  # the epilogue alone: 0, 1, l - 1, l, l + 1, 2^252, 2^256 - 1, 2^512 - 1, multiples of l
    edges = [0, 1, L - 1, L, L + 1, 2**252, 2**256 - 1, 2**512 - 1, L * ((2**512 - 1) // L)]
    edges += [L * (2**259 + k) for k in (-3, -1, 0, 1, 5)] + [rs.randrange(2**512) for _ in range(4082)]
    wide = torch.as_tensor(np.frombuffer(b"".join(v.to_bytes(64, "little") for v in edges), dtype=np.uint8)
                           .reshape(-1, 64).copy(), device="cuda")
    limbs, zero = cr.reduce_wide_probe(wide)
    got = [int_from_limbs(r) for r in limbs.cpu().numpy()]
    if got != [v % L for v in edges] or zero.cpu().tolist() != [v % L == 0 for v in edges]:
        raise AssertionError("R1's epilogue disagrees with Python integers at the reduction's edges")
    out["reduce_wide_probe"] = {"inputs": len(edges), "zeroes": int(zero.sum())}

    def check(fn, state, buf, what):
        got = cr.replay_cuda(fn.program, state, buf)
        want = cr.replay_fn_plain(fn.program, state, buf)
        err = max(float((got[0] - want[0]).abs().max()), float((got[1].long() - want[1].long()).abs().max()))
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got[2:], want[2:])):
            raise AssertionError(f"replay ({what}) disagrees with the plain replay_fn: max_abs_err {err}, identity "
                                 f"flags on {got[2].nonzero().flatten().tolist()}, zero flags on "
                                 f"{got[3].nonzero().flatten().tolist()}")
        return got, err

    for cell in cells:  # every golden shape, 8 lanes
        fn, state, buf, _ = _replay_inputs(torch, bp, hr, cell, 8, rs)
        check(fn, state, buf, f"8 lanes, seed {cell['seed']}")

    by_shape = {}
    for seed, batch in REPLAY_SHAPES:
        cell = next(c for c in cells if c["seed"] == seed)
        fn, state, buf, zero_lane = _replay_inputs(torch, bp, hr, cell, batch, rs)
        program = fn.program
        (scalars, seeds, bad_id, bad_zero), err = check(fn, state, buf, f"{batch} lanes, seed {seed}")
        flags = bad_id.nonzero().flatten().tolist()
        statement = _golden_statement(bp, hr, cell)
        proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
        _, host_seeds = bp.RangeProof._replay_challenges([bp.Transcript(b"golden")], [statement], [proof])
        y, z, es, e, fn_seeds, _, _ = fn(state, buf)
        lane0 = (format(int_from_limbs(y[0].cpu().numpy()), "064x"), format(int_from_limbs(z[0].cpu().numpy()), "064x"),
                 [format(int_from_limbs(v), "064x") for v in es[0].cpu().numpy()],
                 format(int_from_limbs(e[0].cpu().numpy()), "064x"))
        if (flags != [zero_lane] or bool(bad_zero.any()) or lane0 != (cell["y"], cell["z"], cell["round_es"], cell["e"])
                or seeds[0].cpu().numpy().tobytes() != host_seeds[0] or not torch.equal(fn_seeds, seeds)):
            raise AssertionError(f"replay_fn ({batch} lanes, seed {seed}): challenges, seeds or flags are wrong "
                                 f"(identity flags on {flags}, want [{zero_lane}])")
        stride = buf.shape[1]
        grid = cr.launch_shape(program, batch, stride, "cuda")
        n_ch = program.n_challenges
        b_ms, b_by = bound_ms(batch * (200 + stride + 128 * n_ch + program.n_seed + 2) + 8 * len(program.blob),
                              batch * (program.n_permutations * KECCAK_INT_OPS + program.span_bytes
                                       + n_ch * FOLD_MULADDS))
        by_shape[batch] = {
            "seed": seed, "lanes": batch, "stride": stride, "challenges": n_ch, "max_abs_err": err,
            "permutations": program.n_permutations, "spans": program.n_spans, "span_bytes": program.span_bytes,
            "pool_bytes": len(program.pool), **grid, "waves": grid["blocks"] / grid["resident_blocks"],
            "ms": kernel_ms(lambda: cr.replay_cuda(program, state, buf)),
            "graph_ms": graph_ms(lambda: cr.replay_cuda(program, state, buf)),
            "replay_fn_ms": kernel_ms(lambda: fn(state, buf)),  # one launch and views
            "replay_fn_graph_ms": graph_ms(lambda: fn(state, buf)),
            "plain_ms": median_ms(lambda: cr.replay_fn_plain(program, state, buf), 3),
            "bound_ms": b_ms, "bound_by": b_by, "chain_ms": program.n_permutations * perm_ns * 1e-6,
        }
    out["replay_by_shape"] = by_shape
    first = by_shape[REPLAY_SHAPES[0][1]]
    rows["replay"] = {**first, "threads": 32 * first["warps"], "perm_ns": perm_ns,
                      "by_shape": {b: {k: v[k] for k in ("graph_ms", "bound_ms", "chain_ms", "spans", "permutations",
                                                          "warps", "blocks", "waves", "replay_fn_ms", "plain_ms")}
                                   for b, v in by_shape.items()},
                      **ptxas.get("replay_kernel", {})}


def _transcript_inputs(torch, bp, batch: int, bits: int, m: int, deg: int, seeded: bool, rs: random.Random):
    """T1's inputs at a prove's shape: the host transcript of `batch` lanes
    after a statement of this shape (random commitments and bases: the
    phases' programs depend on the shape and the sponge position alone),
    its phases, random witness bytes, external blocks and points (canonical
    limbs below 2^16), lane T1_ZERO_LANE's first point of phase 1 zeroed."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.models.transcripts import RangeProofTranscript
    from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct

    def rand(*shape, high=256, dtype=np.uint8):
        return np.asarray([rs.randrange(high) for _ in range(int(np.prod(shape)))], dtype=dtype).reshape(shape)

    rounds, width = (bits * m).bit_length() - 1, m * (8 + 32 * deg)
    stacked = bp.Transcript.stack([bp.Transcript(b"t1") for _ in range(batch)])
    rpt = RangeProofTranscript(stacked, rs.randbytes(32), [rs.randbytes(32) for _ in range(deg)], bits, deg, m,
                               [rand(batch, 32) | 1 for _ in range(m)], [[None] * batch for _ in range(m)],
                               rand(batch, width), bp.NullRng())
    st = rpt.transcript.strobe
    phases, _ = ct.prover_phases(rounds, deg, seeded, width, st.pos, st.pos_begin, st.cur_flags)
    state = torch.as_tensor(np.ascontiguousarray(st.state), device="cuda")
    witness = torch.as_tensor(rand(batch, width), device="cuda")
    blocks = torch.as_tensor(rand(rounds + 2, batch, 32), device="cuda")
    points = [torch.as_tensor(rand(batch, ph.n_points, 16, high=1 << 16, dtype=np.int64), device="cuda")
              for ph in phases]
    points[1][T1_ZERO_LANE, 0] = 0
    return phases, state, witness, blocks, points


def _inv_var_rows(torch, hr, rs: random.Random, out: dict) -> dict:
    """T1's inversion, sc_inv_l_var, on the card: against Python integers
    and its word model at the edges and on random values, alone
    (`inv_latency_probe`) and inside T1's epilogue (`EpiloguePhase`, proof 0
    a zero challenge: inverse 0 and the zero-challenge flag on that proof
    alone); its one-warp latency `sc_inv_var_ns` (a chain of dependent
    inversions, one value, 40 against 8) beside `sc_inv_ns`."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, pack_ints

    tpi = _prover_inputs()

    def limbs(vals):
        return torch.as_tensor(pack_ints(vals).astype(np.int64), device="cuda")

    edges = tpi.inv_edge_values()
    vals = edges + [rs.randrange(hr.L) for _ in range(64)]
    got = [int_from_limbs(r) for r in ct.inv_latency_probe(limbs(vals), 1).cpu().numpy()]
    if got != [pow(v, -1, hr.L) if v else 0 for v in vals] or got != tpi.inv_latency_model(vals, 1):
        raise AssertionError("sc_inv_l_var disagrees with Python integers or its word model")
    chain = [int_from_limbs(r) for r in ct.inv_latency_probe(limbs(vals[-8:]), 5).cpu().numpy()]
    if chain != tpi.inv_latency_model(vals[-8:], 5):
        raise AssertionError("sc_inv_l_var's chain disagrees with its word model")
    x1 = limbs(vals[-1:])
    short = kernel_ms(lambda: ct.inv_latency_probe(x1, 8))
    long = kernel_ms(lambda: ct.inv_latency_probe(x1, 40))
    sc_inv_var_ns = (long - short) * 1e6 / 32
    out["sc_inv_var_ns"] = sc_inv_var_ns

    # inside T1: proof i's state squeezes edges[i] (proof 0 a zero challenge)
    batch = len(edges)
    state = torch.zeros((batch, 200), dtype=torch.uint8)
    state[:, :64] = torch.as_tensor(np.frombuffer(b"".join(v.to_bytes(64, "little") for v in edges),
                                                  dtype=np.uint8).reshape(batch, 64).copy())
    state = state.to("cuda")
    phase = tpi.EpiloguePhase(1, (0,))
    points = torch.zeros((batch, 0, 16), dtype=torch.int64, device="cuda")
    witness = torch.zeros((batch, 0), dtype=torch.uint8, device="cuda")
    outs = torch.full((2, batch, 16), -1, dtype=torch.int64, device="cuda")
    flags = torch.full((batch,), 255, dtype=torch.uint8, device="cuda")
    plain_state = state.clone()
    ct.transcript_cuda(phase, state, points, witness, None, list(outs), flags)
    want_state, scalars, inverses, want_flags = ct.transcript_plain(phase, plain_state, points, witness, None)
    got = outs.cpu().numpy()
    if (not torch.equal(state, want_state) or not torch.equal(flags, want_flags)
            or not torch.equal(outs, torch.cat([scalars, inverses], dim=1).transpose(0, 1))
            or [int_from_limbs(r) for r in got[1]] != [pow(v, -1, hr.L) if v else 0 for v in edges]
            or flags.nonzero().flatten().tolist() != [0] or int(flags[0]) != ct.ZERO_CHALLENGE):
        raise AssertionError("T1's epilogue at the inversion's edges disagrees with its twin or Python integers")
    return {"sc_inv_var_ns": sc_inv_var_ns, "edge_values": len(edges), "epilogue_lanes": batch}


def _transcript_rows(torch, bp, hr, rs: random.Random, rows: dict, out: dict, ptxas: dict) -> None:
    """T1 against its plain twin (`transcript_plain`: the phase on
    utils/jstrobe.py's tensors, then reduce_wide_l, is_zero_l, inv_l) on the
    card, at every phase of a prove of each TRANSCRIPT_SHAPES shape, exact on
    the states, every draw, challenge and inverse, and the flags (lane
    T1_ZERO_LANE's zeroed point flagged in phase 1 alone), after its
    inversion alone (`_inv_var_rows`).  A row is a whole
    prove's phases, rounds + 2 launches run back to back: `ms`, `graph_ms`,
    each phase's `graph_ms`, the plain version's time; its bound the bytes
    each launch reads and writes once (the state both ways, the points as
    limbs, the witness bytes and block, the scalars and flag, the program)
    against R1's count of a permutation, a span byte and a reduction, and
    for each inversion of this run's values the cheaper of the
    constant-time divsteps batches it needs and T1's own inversion's count
    (`bound_ms_ct` beside: the constant-time count alone);
    its chain the phases' permutations at `perm_ns` and their inversions at
    `sc_inv_var_ns`, both measured in this run."""
    from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct
    from bulletproofs_plus_tpu_torch.ops import scalar_model as SM
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs

    inv_var = _inv_var_rows(torch, hr, rs, out)
    by_shape = {}
    for label, batch, bits, m, deg, seeded in TRANSCRIPT_SHAPES:
        phases, state, witness, blocks, points = _transcript_inputs(torch, bp, batch, bits, m, deg, seeded, rs)
        outs = [torch.full((ph.n_wide + len(ph.invert), batch, 16), -1, dtype=torch.int64, device="cuda")
                for ph in phases]
        flags = torch.full((batch, len(phases)), 255, dtype=torch.uint8, device="cuda")
        block = [blocks[p] if ph.n_draws else None for p, ph in enumerate(phases)]
        plain_state, err, bytes_moved, ops, ops_ct, plain_s = state.clone(), 0.0, 0, 0, 0, 0.0
        var_counts = {"batches": 0, "rounds": 0}
        for p, ph in enumerate(phases):
            ct.transcript_cuda(ph, state, points[p], witness, block[p], list(outs[p]), flags[:, p])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_state, scalars, inverses, want_flags = ct.transcript_plain(ph, plain_state, points[p], witness,
                                                                            block[p])
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            plain_state = want_state
            want = torch.cat([scalars, inverses], dim=1).transpose(0, 1)
            err = max(err, float((outs[p] - want).abs().max()), float((state.long() - want_state.long()).abs().max()),
                      float((flags[:, p] != want_flags).sum()))
            flagged = flags[:, p].nonzero().flatten().tolist()
            if flagged != ([T1_ZERO_LANE] if p == 1 else []) or (p == 1 and int(flags[T1_ZERO_LANE, 1]) != ct.IDENTITY):
                raise AssertionError(f"prove_transcript ({label}, phase {p}): flags on lanes {flagged}")
            bytes_moved += (batch * (2 * 200 + 128 * ph.n_points + ph.witness_len + 32 * (block[p] is not None)
                                     + 128 * (ph.n_wide + len(ph.invert)) + 1) + 8 * len(ph.blob))
            inverted = [int_from_limbs(v) for c in ph.invert for v in scalars[:, c].cpu().numpy()]
            sponge_ops = batch * (ph.n_permutations * KECCAK_INT_OPS + ph.span_bytes + ph.n_wide * FOLD_MULADDS)
            ops_ct += sponge_ops
            ops += sponge_ops
            for v in inverted:
                SM.inv_l_var(SM.to_words(v, 8), counts := {})
                for key in var_counts:
                    var_counts[key] += counts[key]
                ct_ops = _divstep_batches(v) * INV_BATCH_OPS
                ops_ct += ct_ops
                ops += min(ct_ops, counts["batches"] * INV_JUMP_BATCH_OPS + counts["rounds"] * INV_SETTLE_ROUND_OPS)
        if err != 0:
            raise AssertionError(f"prove_transcript ({label}) disagrees with its plain twin: max_abs_err {err}")

        def run():
            for p, ph in enumerate(phases):
                ct.transcript_cuda(ph, state, points[p], witness, block[p], list(outs[p]), flags[:, p])

        # the same phases without their inversions: what T1's inversions add to its chain (taking them in P1
        # and P2 instead would put the same divsteps on the prove's path there)
        bare = [ct.Phase(ph.spec._replace(invert=()), ph.witness_len, ph.position) for ph in phases]

        def run_bare():
            for p, ph in enumerate(bare):
                ct.transcript_cuda(ph, state, points[p], witness, block[p], list(outs[p][: ph.n_wide]), flags[:, p])

        b_ms, b_by = bound_ms(bytes_moved, ops)
        b_ms_ct, _ = bound_ms(bytes_moved, ops_ct)
        grid = ct.launch_shape(phases[0], batch, "cuda")
        permutations = sum(ph.n_permutations for ph in phases)
        inversions = sum(len(ph.invert) for ph in phases)
        by_shape[label] = {
            "lanes": batch, "rounds": len(phases) - 2, "launches_per_prove": len(phases), "max_abs_err": err,
            "permutations": permutations, "inversions": inversions, "spans": sum(ph.n_spans for ph in phases),
            "draws": sum(ph.n_draws for ph in phases), **grid, "waves": grid["blocks"] / grid["resident_blocks"],
            "ms": kernel_ms(run, 20), "graph_ms": graph_ms(run, 5),
            "phase_graph_ms": [graph_ms(lambda p=p, ph=ph: ct.transcript_cuda(ph, state, points[p], witness, block[p],
                                                                            list(outs[p]), flags[:, p]))
                               for p, ph in enumerate(phases)],
            "without_inversions_graph_ms": graph_ms(run_bare, 5),
            "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by,  # the checked run's phases
            "bound_ms_ct": b_ms_ct, "operations": ops, "operations_ct": ops_ct,
            "inversion_ops_var": (var_counts["batches"] * INV_JUMP_BATCH_OPS
                                  + var_counts["rounds"] * INV_SETTLE_ROUND_OPS),
            "inversion_counts_var": var_counts,
            "chain_ms": (permutations * out["perm_ns"] + inversions * out["sc_inv_var_ns"]) * 1e-6,
        }
    out["transcript_by_shape"] = by_shape
    first = by_shape[TRANSCRIPT_SHAPES[0][0]]
    rows["prove_transcript"] = {
        **first, "threads": 32 * first["warps"], "perm_ns": out["perm_ns"], "sc_inv_ns": out["sc_inv_ns"],
        **inv_var,
        "by_shape": {k: {kk: v[kk] for kk in ("graph_ms", "without_inversions_graph_ms", "bound_ms", "chain_ms",
                                              "permutations", "inversions", "draws", "launches_per_prove", "warps",
                                              "blocks", "plain_ms", "phase_graph_ms", "inversion_ops_var", "bound_ms_ct",
                                              "inversion_counts_var")}
                     for k, v in by_shape.items()},
        **ptxas.get("prove_transcript_kernel", {}),
    }


def _scalar_inputs(torch, bp, hr, cell, batch: int, rs: random.Random):
    """S1's inputs as a verify hands them over: R1's replay of golden `cell`'s
    shape for `batch` lanes (lane 0 the golden proof, the others random bytes)
    gives y, z, the round challenges and e as views of its limb tensor; r1,
    s1, d1 and the minimum values are unpacked from the same rows as
    `verify_group_bytes` unpacks them (random bytes: values below 2^256,
    minimum values below 2^64); the weights are random scalars.  Lane 5's
    last round challenge is set to zero, poisoning its inversions."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.models.replay_device import unpack_row_buffer
    from bulletproofs_plus_tpu_torch.models.verifier_kernels import _u8_to_limbs
    from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints

    fn, state, buf, _ = _replay_inputs(torch, bp, hr, cell, batch, rs)
    y, z, es, e, _, _, _ = fn(state, buf)
    es[5, -1] = 0  # in place: the views stay views of the replay's tensor
    y[7] = 0
    y[7, 0] = 1
    m, rounds, deg = len(cell["values"]), es.shape[1], cell["extension_degree"]
    f = unpack_row_buffer(buf, m, rounds, deg)
    mv = _u8_to_limbs(f["min_vals"])
    weight = torch.as_tensor(pack_ints([rs.randrange(hr.L) for _ in range(batch)]).astype(np.int64), device="cuda")
    return {"y": y, "z": z, "round_es": es, "e": e, "weight": weight, "r1": _u8_to_limbs(f["r1"]),
            "s1": _u8_to_limbs(f["s1"]), "d1": _u8_to_limbs(f["d1"]),
            "min_values": torch.cat([mv, mv.new_zeros((batch, m, 16 - mv.shape[-1]))], dim=-1)}, m, cell["bits"]


def _divstep_batches(x: int) -> int:
    """Batches of 30 divsteps (csrc/scalar_l.cuh's, zeta = -(delta + 1/2))
    until g = 0 from f = l, g = x."""
    from bulletproofs_plus_tpu_torch.ops.scalar_model import L

    zeta, f, g, n = -1, L, x, 0
    while g:
        for _ in range(30):
            if g & 1 and zeta < 0:
                zeta, f, g = -zeta - 2, g, (g - f) >> 1
            else:
                zeta, g = zeta - 1, (g + f * (g & 1)) >> 1
        n += 1
    return n


def _scalar_products(args: dict, rounds: int, m: int, n: int, deg: int):
    """S1's work and the fewest 32-bit operations the scalar pass needs on
    these inputs: (S1a's program, S1b's most products for one proof of one
    lane, S1's products, its inversions, the function's operations).  S1a: the
    program's products and rounds + 2 inversions a proof; S1b for lane i with
    p bits set: rounds + p + 2 products (rounds + 1 at i = 0).  The function:
    27 + 9 rounds + 4 m + deg products a proof (one more at rounds 0), as a
    Montgomery batch inversion of the proof's values [e_1..e_k, y, y - 1]
    arranges them, and 3 a proof and lane, each of g's A y^-i P(i), h's
    D P(mn-1-i) and G_j 2^(i mod n) y^-i a ladder over the lanes,
    t_i = t_(i') f, that starts without a product; then Montgomery's trick
    over the proofs, 3 products a proof after the first, and one inversion
    of the product of the proofs' products (a zero one taken as 1) at the
    cheaper of Fermat's chain and the divsteps it needs."""
    from bulletproofs_plus_tpu_torch.ops import cuda_scalar as cs
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs
    from bulletproofs_plus_tpu_torch.ops.scalar_model import L

    batch, mn = args["y"].shape[0], m * n
    prog = cs.proof_program(rounds, m, deg)
    other = 27 + 9 * rounds + 4 * m + deg + (rounds == 0)
    lanes = [rounds + bin(i).count("1") + 2 if i else rounds + 1 for i in range(mn)]
    ys, es = args["y"].cpu().numpy(), args["round_es"].cpu().numpy()
    # Fermat's x^(l - 2) by a 4-bit window: x^2..x^15, 252 squarings, one product a further non-zero digit
    fermat = (14 + 252 + sum(1 for k in range(0, 253, 4) if (L - 2) >> k & 15) - 1) * SC_MULADDS_PER_MUL
    group = 1
    for b in range(batch):
        y = int_from_limbs(ys[b])
        prod = y * (y - 1) % L
        for v in es[b]:
            prod = prod * int_from_limbs(v) % L
        group = group * (prod or 1) % L
    inversion_ops = min(fermat, _divstep_batches(group) * INV_BATCH_OPS)
    needed = (batch * (other + 3 * mn - 3) + 3 * (batch - 1)) * SC_MULADDS_PER_MUL + inversion_ops
    return prog, max(lanes), batch * (prog.products + sum(lanes)), batch * (rounds + 2), needed


def _s1_device_ms(torch, call, runs: int = 5) -> dict:
    """S1a's and S1b's device time a call under torch.profiler, the median of
    `runs` calls each, or "not measured" where the profiler saw neither."""
    from torch.profiler import ProfilerActivity, profile

    parts = {"s1a_device_ms": [], "s1b_device_ms": []}
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
        for key, name in (("s1a_device_ms", "scalar_proof_kernel"), ("s1b_device_ms", "scalar_lane_kernel")):
            parts[key].append(sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e3)
    return {k: statistics.median(v) if any(v) else "not measured" for k, v in parts.items()}


def _scalar_rows(torch, bp, hr, cells, rs: random.Random, rows: dict, out: dict, ptxas: dict) -> None:
    """S1 against the plain scalar pass on the card at SCALAR_SHAPES: every
    output exact, limb for limb (lane 5 a zero challenge, lane 7 y = 1);
    timed beside its plain version, with the one-warp latencies of a product
    mod l (`sc_mul_ns`) and of an inversion (`sc_inv_ns`), each probe's
    chain end checked against Python integers."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.models.verifier_kernels import scalar_pass_plain
    from bulletproofs_plus_tpu_torch.native import cuda
    from bulletproofs_plus_tpu_torch.ops import cuda_scalar as cs
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, pack_ints

    vals = [rs.randrange(hr.L) for _ in range(32)]
    x = torch.as_tensor(pack_ints(vals).astype(np.int64), device="cuda")
    if [int_from_limbs(r) for r in cs.mul_latency_probe(x, 40).cpu().numpy()] != [pow(v, 41, hr.L) for v in vals]:
        raise AssertionError("S1's latency probe: a chain of 40 products mod l is wrong")
    short = kernel_ms(lambda: cs.mul_latency_probe(x, 256))
    long = kernel_ms(lambda: cs.mul_latency_probe(x, 1280))
    sc_mul_ns = (long - short) * 1e6 / 1024
    out["sc_mul_ns"] = sc_mul_ns
    edges = [0, 1, 2, hr.L - 1, hr.L - 2, (hr.L + 1) // 2, 2**252] + vals[7:]
    xe = torch.as_tensor(pack_ints(edges).astype(np.int64), device="cuda")
    if ([int_from_limbs(r) for r in cs.inv_latency_probe(xe, 1).cpu().numpy()]
            != [pow(v, -1, hr.L) if v else 0 for v in edges] or not torch.equal(cs.inv_latency_probe(xe, 6), xe)):
        raise AssertionError("S1's inversion probe disagrees with Python integers")
    short = kernel_ms(lambda: cs.inv_latency_probe(x, 4))
    long = kernel_ms(lambda: cs.inv_latency_probe(x, 20))
    sc_inv_ns = (long - short) * 1e6 / 16
    out["sc_inv_ns"] = sc_inv_ns

    by_shape = {}
    for label, seed, batch, max_mn in SCALAR_SHAPES:
        cell = next(c for c in cells if c["seed"] == seed)
        args, m, n = _scalar_inputs(torch, bp, hr, cell, batch, rs)
        kw = {"m": m, "bit_length": n, "max_mn": max_mn}
        rounds, deg = args["round_es"].shape[1], args["d1"].shape[1]
        cuda.reset_launches()
        got = cs.scalar_pass(**args, **kw)
        launches = dict(cuda.launches)
        want = scalar_pass_plain(**args, **kw)
        err = max(float((g - w).abs().max()) if g.numel() else 0.0 for g, w in zip(got, want))
        if err != 0 or launches != {"scalar_pass": 1} or any(g.shape != w.shape for g, w in zip(got, want)):
            raise AssertionError(f"S1 ({label}) disagrees with the plain scalar pass: max_abs_err {err}, "
                                 f"launches {launches}")
        if got[9][5].any() or got[9][7].any() or not got[9][4].any():
            raise AssertionError(f"S1 ({label}): the zero challenge and y = 1 did not poison lanes 5 and 7 alone")
        prog, per_lane, products, inversions, needed = _scalar_products(args, rounds, m, n, deg)
        threads = cs.lane_threads(batch)
        n_in = 6 + rounds + deg + m
        n_out = batch * (m + 3 + 2 * rounds) + 2 * max_mn + deg + 1
        b_ms, b_by = bound_ms((batch * n_in + n_out) * LIMB_BYTES, needed)
        by_shape[label] = {
            "lanes": batch, "m": m, "bits": n, "rounds": rounds, "deg": deg, "max_mn": max_mn, "max_abs_err": err,
            "launches": launches["scalar_pass"], "products": products, "inversions": inversions,
            "operations_needed": needed,
            "ms": kernel_ms(lambda: cs.scalar_pass(**args, **kw)),
            "graph_ms": graph_ms(lambda: cs.scalar_pass(**args, **kw)),
            **_s1_device_ms(torch, lambda: cs.scalar_pass(**args, **kw)),
            "plain_ms": median_ms(lambda: scalar_pass_plain(**args, **kw), 1),
            "bound_ms": b_ms, "bound_by": b_by,
            # S1a's program (its product steps, then its inversion step), then S1b's threads' proofs one after
            # another (sums and the trees' sums not counted)
            "chain_ms": ((prog.mul_steps + -(-batch // threads) * per_lane) * sc_mul_ns + sc_inv_ns) * 1e-6,
            "lanes_per_proof": prog.lanes, "program_steps": len(prog.words), "mul_steps": prog.mul_steps,
            "slots": prog.slots, "s1a_blocks": -(-batch * prog.lanes // cs.WARP), "s1b_blocks": max_mn + deg + 1,
            "s1b_threads": threads,
        }
    out["scalar_by_shape"] = by_shape
    first = by_shape[SCALAR_SHAPES[0][0]]
    rows["scalar_pass"] = {
        **first, "sc_mul_ns": sc_mul_ns, "sc_inv_ns": sc_inv_ns, "threads": cs.WARP,
        "ptxas": {k: ptxas.get(k, {})
                  for k in ("scalar_proof_kernel", "scalar_proof_global_kernel", "scalar_lane_kernel")},
        **ptxas.get("scalar_proof_kernel", {}),
        "by_shape": {k: {kk: v[kk] for kk in ("graph_ms", "ms", "s1a_device_ms", "s1b_device_ms", "plain_ms",
                                               "bound_ms", "chain_ms", "launches",
                                               "max_abs_err", "products", "inversions", "operations_needed",
                                               "mul_steps", "lanes_per_proof", "s1a_blocks", "s1b_blocks")}
                     for k, v in by_shape.items()},
    }


def _decode_inputs(bp, hr, cells):
    """D1's inputs: the b64_m1_x256 batch's own points in the order a verify
    decompresses them ([commitments, a1, b, a, li, ri] a proof), after the
    decode edges: RFC 9496 Appendix A.2's bad encodings, s >= p (p, p + 1,
    2p = 2^256 - 38, 2p - s for a valid s), odd s (1, p - s), p - 1 (y = 0),
    the largest raw inputs (2^256 - 1, 2^255 - 2) and 0 (the identity).
    -> (edges as ints, batch limbs (4096, 16) numpy)."""
    from bulletproofs_plus_tpu_torch.models.verifier_kernels import _points_bytes_to_limbs

    statements, proofs = _tiled(bp, hr, next(c for c in cells if c["seed"] == 3), 256)
    blobs = []
    for statement, proof in zip(statements, proofs):
        blobs += list(statement.commitments_compressed) + [proof.a1, proof.b, proof.a] + list(proof.li) + list(proof.ri)
    valid = int.from_bytes(proofs[0].a, "little")
    p = hr.P
    edges = [int.from_bytes(bytes.fromhex(h), "little") for h in RFC9496_BAD]
    edges += [p, p + 1, 2 * p, 2 * p - valid, 1, p - valid, p - 1, 2**256 - 1, 2**255 - 2, 0]
    return edges, _points_bytes_to_limbs(blobs)


def _forms_ms(call) -> dict:
    """Both forms of a D1 or C1 launch by graph time, in turns: one lane an
    element, four, four, one."""
    turns = [graph_ms(lambda: call(form)) for form in (1, 4, 4, 1)]
    return {"one_lane_graph_ms": statistics.mean((turns[0], turns[3])), "four_lanes_graph_ms": statistics.mean(turns[1:3])}


def _fe_inv_probe(torch, rc, pack_ints, rs: random.Random) -> float:
    """`fe_inv_ns`: one warp, dependent inversions mod p (fe_inv, a fixed 20
    batches of divsteps), a chain of 20 against one of 4, the difference over
    16; one inversion of edge values and random ones against Python
    integers, and two in a row give x back (canonical)."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs

    p = 2**255 - 19
    edges = [0, 1, 2, p - 1, p, p + 1, 2**255 - 20, 2**256 - 1, 2**200, 3 << 128]
    vals = edges + [rs.randrange(2**256) for _ in range(32 - len(edges))]
    x = torch.as_tensor(pack_ints(vals).astype(np.int64), device="cuda")
    got = [int_from_limbs(r) for r in rc.fe_inv_probe(x, 1).cpu().numpy()]
    twice = [int_from_limbs(r) for r in rc.fe_inv_probe(x, 2).cpu().numpy()]
    if got != [pow(v, p - 2, p) for v in vals] or twice != [v % p for v in vals]:
        raise AssertionError("fe_inv disagrees with Python integers")
    short = kernel_ms(lambda: rc.fe_inv_probe(x, 4))
    long = kernel_ms(lambda: rc.fe_inv_probe(x, 20))
    return (long - short) * 1e6 / 16


def _ristretto_rows(torch, bp, hr, cells, rs: random.Random, rows: dict, out: dict, ptxas: dict, probe: dict) -> None:
    """D1, C1 and I1 against their plain twins on the card, exact (D1's mask
    and canonical coordinates, C1's canonical limbs, I1's bool), each form
    of D1 and C1 against the launcher's pick; then timed beside the plain
    twins, with K4's chain and each kernel's own products as `chain_ms`.
    D1 at the b64_m1_x256 batch's 4096 points after the decode edges; C1 at
    the prover's (128,) and (128, 2) on random points, the identity and its
    coset among them; I1 on the identity, its coset forms, random points and
    K3's own (4, 16) output, read in place, from a verify of the golden batch
    and of a tampered one."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.models import verifier_kernels as vk
    from bulletproofs_plus_tpu_torch.ops import cuda_ristretto as rc
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import field as F
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist
    from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints

    mul_ns, sqr_ns = probe["fe_mul_ns"], probe["fe_sqr_ns"]
    k4_sqr, k4_mul = POW_SQR + RATIO_SQR, POW_MUL + RATIO_MUL  # K4's chain and SQRT_RATIO_M1, counted as its row

    # D1
    edges, batch = _decode_inputs(bp, hr, cells)
    s = torch.as_tensor(np.concatenate([pack_ints(edges), batch]).astype(np.int64), device="cuda")
    pts, ok = rc.decompress_cuda(s)
    want_pts, want_ok = rist.decompress_plain(s)
    err_d = max([float((c - F.canon25519(w)).abs().max()) for c, w in zip(pts, want_pts)]
                + [float((ok != want_ok).sum())])
    if err_d != 0 or ok[: len(edges) - 1].any() or not ok[len(edges) - 1 :].all():
        raise AssertionError(f"decompress disagrees with its plain version (max_abs_err {err_d}), or a bad "
                             f"encoding decoded, or a batch point did not ({int(ok.sum())} of {len(ok)} valid)")
    for lanes in (1, 4):
        pts_l, ok_l = rc.decompress_cuda(s, lanes=lanes)
        if not (torch.equal(ok_l, ok) and all(torch.equal(a, b) for a, b in zip(pts_l, pts))):
            raise AssertionError(f"decompress with {lanes} lanes an element disagrees with the launcher's pick")
    sb = s[len(edges) :].contiguous()  # the main path's launch: the batch's own points
    n = sb.shape[0]
    b_ms, b_by = bound_ms(n * (LIMB_BYTES + 4 * LIMB_BYTES + 1),
                          n * ((k4_sqr + DECODE_SQR) * MULADDS_PER_FSQR + (k4_mul + DECODE_MUL) * MULADDS_PER_FMUL))
    forms = _forms_ms(lambda form: rc.decompress_cuda(sb, lanes=form))
    rows["decompress"] = {
        "max_abs_err": err_d, "lanes": n, "checked": s.shape[0], "edges": len(edges),
        "ms": kernel_ms(lambda: rc.decompress_cuda(sb)), "graph_ms": graph_ms(lambda: rc.decompress_cuda(sb)),
        **forms, "plain_ms": median_ms(lambda: rist.decompress_plain(sb), 3), "bound_ms": b_ms, "bound_by": b_by,
        "chain_ms": ((k4_sqr + DECODE_CHAIN_SQR) * sqr_ns + (k4_mul + DECODE_CHAIN_MUL) * mul_ns) * 1e-6,
        "chain4_ms": ((k4_sqr + DECODE_CHAIN_SQR) * probe["fe_sqr4_ns"]
                      + (k4_mul + DECODE_CHAIN_MUL) * probe["fe_mul4_ns"]) * 1e-6,
        "fe_mul4_ns": probe["fe_mul4_ns"], "fe_sqr4_ns": probe["fe_sqr4_ns"],
        "ptxas": {k: ptxas.get(k, {}) for k in ("decompress_kernel", "decompress_coop_kernel")},
        **ptxas.get("decompress_coop_kernel", {}),
    }

    # C1
    flat = _rand_points(torch, ed, hr, 2 * PROVE_BATCH, rs, "cuda")  # sums of two points: Z is not 1
    coset = ed.from_host([hr.IDENTITY, (0, hr.P - 1, 1, 0), (hr.SQRT_M1, 0, 1, 0), (hr.P - hr.SQRT_M1, 0, 1, 0)],
                         device="cuda")
    flat = ed.cat([coset, ed.PointArray(*(c[len(coset.x) :] for c in flat))])
    by_shape, err_c = {}, 0.0
    for shape in COMPRESS_SHAPES:
        k = int(np.prod(shape))
        p = ed.PointArray(*(c[:k].reshape(shape + (16,)) for c in flat))
        got, want = rc.compress_cuda(p), rist.compress_plain(p)
        err_c = max(err_c, float((got - want).abs().max()))
        if err_c != 0 or any(got.reshape(-1, 16)[:4].any(dim=-1).tolist()):
            raise AssertionError(f"compress {shape} disagrees with its plain version (max_abs_err {err_c}), or the "
                                 f"identity's coset did not encode as zero")
        for lanes in (1, 4):
            if not torch.equal(rc.compress_cuda(p, lanes=lanes), got):
                raise AssertionError(f"compress with {lanes} lanes an element disagrees with the launcher's pick")
        bc = bound_ms(k * 5 * LIMB_BYTES,
                      k * ((k4_sqr + ENCODE_SQR) * MULADDS_PER_FSQR + (k4_mul + ENCODE_MUL) * MULADDS_PER_FMUL))
        by_shape[str(shape)] = {"elements": k, "ms": kernel_ms(lambda: rc.compress_cuda(p)),
                                "graph_ms": graph_ms(lambda: rc.compress_cuda(p)),
                                **_forms_ms(lambda form: rc.compress_cuda(p, lanes=form)),
                                "plain_ms": median_ms(lambda: rist.compress_plain(p), 3),
                                "bound_ms": bc[0], "bound_by": bc[1]}
    main_shape = by_shape[str(COMPRESS_SHAPES[1])]  # the shape of seven of a prove's eight launches
    rows["compress"] = {
        "max_abs_err": err_c, "lanes": main_shape["elements"], **main_shape,
        "chain_ms": ((k4_sqr + ENCODE_CHAIN_SQR) * sqr_ns + (k4_mul + ENCODE_CHAIN_MUL) * mul_ns) * 1e-6,
        "by_shape": by_shape, "ptxas": {k: ptxas.get(k, {}) for k in ("compress_kernel", "compress_coop_kernel")},
        **ptxas.get("compress_coop_kernel", {}),
    }

    # C1's double-and-encode, the prover's: against its plain twin at each shape, the identity's coset (e = 0)
    # among ordinary lanes, and at (128,) against the sqrt form's encoding of the doubled points too
    fe_inv_ns = _fe_inv_probe(torch, rc, pack_ints, rs)
    flat = _rand_points(torch, ed, hr, 1025, rs, "cuda")
    at = [0, 5, 33, 64, 100, 1024]  # e = 0 lanes: in the first block, others, the last lane past 1024
    for k, pos in enumerate(at):
        for c, v in zip(flat, coset):
            c[pos] = v[k % len(coset.x)]
    by_shape, err_dc = {}, 0.0
    for shape in DOUBLE_COMPRESS_SHAPES:
        k = int(np.prod(shape))
        p = ed.PointArray(*(c[:k].reshape(shape + (16,)) for c in flat))
        cuda_launches = dict(rc.cuda.launches)
        got = rc.double_compress_cuda(p)
        if rc.cuda.launches["double_compress"] != cuda_launches.get("double_compress", 0) + 1:
            raise AssertionError("double_compress: not one launch a call")
        want = rist.double_and_compress_plain(p)
        err_dc = max(err_dc, float((got - want).abs().max()))
        zero_lanes = [pos for pos in at if pos < k]
        if err_dc != 0 or got.reshape(-1, 16)[zero_lanes].any():
            raise AssertionError(f"double_compress {shape} disagrees with its plain version (max_abs_err {err_dc}), "
                                 f"or an e = 0 lane did not encode as zero")
        if shape == COMPRESS_SHAPES[0] and not torch.equal(got, rist.compress_plain(ed.double(p))):
            raise AssertionError("double_compress disagrees with the encoding of the doubled points")
        if k < 128:
            continue
        blocks = -(-k // DC_THREADS)
        bd = bound_ms(k * 5 * LIMB_BYTES,
                      k * (DC_SQR * MULADDS_PER_FSQR + DC_MUL * MULADDS_PER_FMUL) + blocks * FE_INV_OPS)
        by_shape[str(shape)] = {"elements": k, "blocks": blocks, "ms": kernel_ms(lambda: rc.double_compress_cuda(p)),
                                "graph_ms": graph_ms(lambda: rc.double_compress_cuda(p)),
                                "plain_ms": median_ms(lambda: rist.double_and_compress_plain(p), 3),
                                "bound_ms": bd[0], "bound_by": bd[1]}
    main_shape = by_shape[str(COMPRESS_SHAPES[1])]
    rows["double_compress"] = {
        "max_abs_err": err_dc, "lanes": main_shape["elements"], **main_shape, "threads": DC_THREADS,
        "checked": [list(s) for s in DOUBLE_COMPRESS_SHAPES], "e_zero_lanes": at,
        "chain_ms": (DC_CHAIN_SQR * sqr_ns + DC_CHAIN_MUL * mul_ns + fe_inv_ns) * 1e-6, "fe_inv_ns": fe_inv_ns,
        "by_shape": by_shape, **ptxas.get("double_compress_kernel", {}),
        "ptxas": {k: ptxas.get(k, {}) for k in ("double_compress_kernel", "fe_inv_latency_kernel")},
    }
    out["fe_inv_ns"] = fe_inv_ns

    # I1: K3's output from a verify of the golden batch and of the same with one r1 tampered; the verdict K3's
    # tail wrote there against I1's on the same point
    statements, proofs = _tiled(bp, hr, next(c for c in cells if c["seed"] == 3), 256)
    tampered = list(proofs)
    tampered[17] = bp.RangeProof.from_bytes(proofs[17].to_bytes())
    tampered[17].r1 = (tampered[17].r1 + 1) % hr.L
    results, inner = [], vk.combine_groups_point

    def recording(*args, **kwargs):
        results.append(inner(*args, **kwargs))
        return results[-1]

    vk.combine_groups_point = recording
    try:
        _verify(bp, statements, proofs)
        try:
            _verify(bp, statements, tampered)
        except bp.VerificationFailed:
            pass
    finally:
        vk.combine_groups_point = inner
    i = hr.SQRT_M1
    forms = [(0, 1, 1, 0), (0, hr.P - 1, 1, 0), (i, 0, 1, 0), (hr.P - i, 0, 1, 0), (0, 5, 5, 0), (hr.P, 7, 7, 0),
             (2 * hr.P, 3, 3, 0)]
    many = ed.cat([ed.PointArray(*(torch.as_tensor(pack_ints([f[c] for f in forms]).astype(np.int64), device="cuda")
                                   for c in range(4))),
                   ed.PointArray(*(c[:64] for c in _rand_points(torch, ed, hr, 64, rs, "cuda")))])
    got = rc.is_identity_cuda(many)
    err_i = float((got != rist.is_identity_plain(many)).sum())
    points, fused = [r[0] for r in results], [bool(r[1]) for r in results]
    k3 = [bool(rc.is_identity_cuda(r)) for r in points]
    if err_i != 0 or got.tolist() != [True] * len(forms) + [False] * 64 or k3 != [True, False]:
        raise AssertionError(f"is_identity disagrees with its plain version ({err_i} lanes) or on K3's output {k3}")
    if [bool(rist.is_identity_plain(r)) for r in points] != k3 or points[0].y.data_ptr() - points[0].x.data_ptr() != 128:
        raise AssertionError("is_identity: K3's output is not the (4, 16) tensor read in place, or the plain twin differs")
    if fused != k3:
        raise AssertionError(f"K3's tail gave the verdicts {fused}, I1 on the same points {k3}")
    out["k3_tail_verdicts"] = {"tail": fused, "is_identity": k3}
    res = points[0]
    bi = bound_ms(2 * LIMB_BYTES + 1, 0)
    rows["is_identity"] = {
        "max_abs_err": err_i, "lanes": 1, "checked": many.x.shape[0] + 2,
        "ms": kernel_ms(lambda: rc.is_identity_cuda(res)), "graph_ms": graph_ms(lambda: rc.is_identity_cuda(res)),
        "plain_ms": median_ms(lambda: rist.is_identity_plain(res), 3), "bound_ms": bi[0], "bound_by": bi[1],
        "chain_ms": 0.0,  # no product: two canonical forms
        **ptxas.get("is_identity_kernel", {}),
    }
    out["ristretto"] = {k: rows[k] for k in ("decompress", "compress", "double_compress", "is_identity")}


PROVER_KERNELS = ("prove_prep", "prove_round", "prove_final", "prove_responses", "bit_sum")
PROVER_SHAPE = (PROVE_BATCH, 1, 64, 1)  # the main path's prove: proofs, m, bit length, extension degree
PROVER_ROW_ROUND = 1  # P2's row: round 1, the first that folds (the others are in `by_round`)


def _prover_products(mn: int, m: int, deg: int, rounds: int, r: int | None = None) -> dict:
    """The products mod l that one proof needs at the fewest in each of
    P1-P3's launches (sums and doublings not counted): P1 y^2..y^(mn+1) as a
    ladder, y^-n by rounds - 1 squarings, z^2 and its ladder over m, one a
    lane (z^(2(j+1)) y^(mn-i), then 2^k as doublings) and the alpha terms;
    P2 at round r, n = mn >> (r + 1), with a fold two factors, two products
    a folded value of a and of b (4n each), e^2, e^-2 and two a mask, one
    for each of g and h a lane; then a_p y^(+-n) once a position (2n), one
    for each of g and h a lane after a fold (none in round 0, where both are
    one) and two a term of c_L and of c_R; P3's first entry the same fold to
    one value, four factors (g's two and h's two, each by r or s), one for
    each of g and h a lane and five for ry_ar and rys (only those five
    without rounds); its second 2 + 2 deg (r1 and s1 one each, d1_k
    (d_mask_k + alpha_k e) e two)."""
    n = mn >> ((r or 0) + 1)
    fold = 2 + 8 * n + 2 + 2 * deg + 2 * mn
    last = 2 + 4 + 2 + 2 * deg + 4 + 2 * mn if rounds else 0
    return {"prove_prep": mn + max(rounds - 1, 0) + m + mn + m + m * deg,
            "prove_round": (fold + 2 * mn if r else 0) + 2 * n + 4 * n,
            "prove_final": last + 5,
            "prove_responses": 2 + 2 * deg}


def _prover_bytes(mn: int, m: int, deg: int, rounds: int, r: int | None = None) -> dict:
    """The bytes one proof's share of each of P1-P3's launches must move:
    each value the function reads read once, each output written once, as
    int64 limbs (LIMB_BYTES a scalar, 8 a bit).  P1 reads all of its inputs;
    P2 at round r reads a and b (4n each after a fold, else 2n), alpha and
    the round's masks, y^1..y^2n and y^-n, and after a fold also e, e^-1,
    the previous masks, g, h and y^-2n; P3's first entry reads the last
    fold's (a and b two each, g, h, e, e^-1, masks, y^-1), alpha, y^1, r, s,
    d_mask and eta; its second all of its inputs."""
    n = mn >> ((r or 0) + 1)
    fold_in = 2 + 2 * deg + 2 * mn + 1
    scalars = {
        "prove_prep": (3 + m * deg + deg) + (2 * mn + mn + 1 + rounds + deg),
        "prove_round": ((2 * (4 * n if r else 2 * n) + deg + 2 * deg + 2 * n + 1 + (fold_in if r else 0))
                        + (4 * n + 2 * mn + deg + 2 * (mn + deg + 1))),
        "prove_final": (((4 + fold_in) if rounds else 2) + deg + 1 + 2 + 2 * deg
                        + (2 * mn + deg + 1) + (deg + 1) + 2 + deg),
        "prove_responses": (4 + 3 * deg + 1) + (2 + deg),
    }
    out = {k: v * LIMB_BYTES for k, v in scalars.items()}
    out["prove_prep"] += 8 * mn
    return out


def _prover_chains(mn: int, m: int, deg: int, rounds: int, r: int) -> dict:
    """Products one thread of P1-P3 runs one after another at its longest:
    P1 as `_p1_chain`; P2 as `_p2_chain`; P3's first entry as `_p3_chain`;
    its second two, a d1 thread's."""
    return {"prove_prep": _p1_chain(mn, m, deg),
            "prove_round": _p2_chain(mn, rounds, r, deg) if r < rounds else 0,
            "prove_final": _p3_chain(mn, rounds, deg),
            "prove_responses": 2}


def _p1_chain(mn: int, m: int, deg: int) -> int:
    """P1's longest path in products mod l, its items handed out as
    csrc/prover.cu's prove_prep_body hands them: the ladder threads' levels
    (`cuda_prover.prep_levels`, each level's items strided over T - 32
    threads, `prep_threads`) beside the alpha warp's z^2, its group's ladder
    over G = min(m, 32) lanes, the product by y, and for each pass of 32 / G
    values of k a lane's m / G terms and the m / G - 1 steps of z^(2G)
    between them; then the last step's items strided over all T threads."""
    from bulletproofs_plus_tpu_torch.ops.cuda_prover import prep_levels, prep_threads

    threads = prep_threads(mn, m)
    ladder = sum(-(-sum(level) // (threads - 32)) for level in prep_levels(mn, m))
    g = min(m, 32)
    alpha = 2 + (g.bit_length() - 1) + -(-deg // (32 // g)) * (2 * (m // g) - 1)
    return max(ladder, alpha) + -(-(mn + 1 + deg) // threads)


def _p4_chain(mn: int, threads: int) -> int:
    """P4's longest path in products mod p: an adder's four-lane mixed
    additions, one a lane it takes (mn / (threads / 4)), then the tree's
    four-lane additions over the adders that hold a point."""
    adders = threads // 4
    return (-(-mn // adders) * FMUL_DEEP_MADD4 + (min(mn, adders).bit_length() - 1) * FMUL_DEEP_ADD4)


def _p3_chain(mn: int, rounds: int, deg: int) -> int:
    """P3's first entry's longest path in products mod l, its items handed
    out as csrc/prover.cu's prove_final_kernel hands them: a lane thread's
    items one after another (a g item on a hi lane three products, e y^-1
    first, every other two; one without a fold, the product by r or s), and
    the closing warp's three steps, two products an item of the first and
    one of the second, its items strided over 32 lanes."""
    from bulletproofs_plus_tpu_torch.ops.cuda_prover import round_threads

    lanes = round_threads(mn) - 32
    per = [0] * lanes
    for q in range(2 * mn):
        i = q % mn
        per[q % lanes] += (3 if q < mn and i & 1 else 2) if rounds else 1
    closing = 2 * -(-(6 + 2 * deg) // 32) + -(-(5 + deg) // 32)
    return max(max(per), closing)


def _p2_chain(mn: int, rounds: int, r: int, deg: int) -> int:
    """P2's longest path in products mod l, its items handed to threads as
    csrc/prover.cu's prove_round_body hands them out: the most that one
    thread runs before the barrier, then the most after it, an item's
    independent products side by side.  Before: a g item its fold (e y^-len
    first on a hi lane) and y^(-+n), an h item its fold, an a fold item e^-1
    y^len, its fold and a' y^(1+j), a b fold item its fold, alpha's warp two a
    term; after: a lane item's product and a c term's; the sums' additions
    are not counted."""
    from bulletproofs_plus_tpu_torch.ops.cuda_prover import round_threads

    lanes = round_threads(mn) - 32
    hb = rounds - 1 - r
    length, fold = 2 << hb, r > 0
    pre, post = [0] * lanes, [0] * lanes
    for q in range(2 * mn):
        i = q % mn
        if q < mn:  # g: its fold (e y^-len first on a hi lane of round r - 1), then y^(-+n)
            pre[q % lanes] += (1 + ((i >> (hb + 1)) & 1) if fold else 0) + 1
        else:  # h: its fold
            pre[q % lanes] += int(fold)
        post[q % lanes] += 1
    for j in range(2 * length):
        pre[lanes - 1 - j % lanes] += (3 if fold else 1) if j < length else int(fold)
    for j in range(length // 2):
        post[j % lanes] += 1
        post[(j + lanes // 2) % lanes] += 1
    return max(max(pre), 2 * -(-deg // 32) if fold else 0) + max(post)


def _prover_inputs():
    """tests/torch_prover_inputs.py (numpy and the port only): the kernels'
    seeded inputs and `LaneRng`, one lane of a batched SeededRng."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_prover_inputs

    return torch_prover_inputs


def _p2_profiler():
    """scripts/profile_torch_p2.py, the prover kernels' phase stamps."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import profile_torch_p2

    return profile_torch_p2


def _prover_rows(torch, rows: dict, out: dict, ptxas: dict, probe: dict) -> None:
    """P1-P4 against their plain twins on the card at the 128-proof prove's
    shape, every output exact (P2 at every round; P4 as canonical affine
    points, its start read as K6 leaves it), each timed beside its twin, with
    its bound (the products mod l of `_prover_products` at
    `SC_MULADDS_PER_MUL`, or for P4 a mixed addition a lane; the bytes of
    `_prover_bytes`, or for P4 its bits, start and result as int64 limbs and
    its generators as their first two table words) and its chain (`_prover_chains` at `sc_mul_ns`;
    P4 `_p4_chain` at `fe_mul_ns`), P4 on the tables the prove sums
    (`halved_tables_joined`); each kernel but P3's second entry also by
    phase, clock64() stamps at its markers in a copy built for this (the four
    copies built at once, scripts/profile_torch_p2.py `build_all`)."""
    pin = _prover_inputs()

    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.native import BUILD_DIR, cuda
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from bulletproofs_plus_tpu_torch.ops import field as F

    batch, m, n, deg = PROVER_SHAPE
    mn = m * n
    rounds = mn.bit_length() - 1
    sc_ns = out["sc_mul_ns"]

    def err(got, want):
        return max(float((g - w).abs().max()) if g.numel() else 0.0 for g, w in zip(got, want))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def row(name, call, plain, args, outs, r=None, extra=None):
        e = err(outs, plain(*args[0], **args[1]))
        if e != 0:
            raise AssertionError(f"{name} disagrees with its plain twin (max_abs_err {e})")
        products = _prover_products(mn, m, deg, rounds, r)[name]
        moved = batch * _prover_bytes(mn, m, deg, rounds, r)[name]
        ins = [t for t in args[0] if isinstance(t, torch.Tensor)]
        ins += [t for f in args[0] if isinstance(f, tuple) for t in f]
        if moved > nbytes(*ins, *outs):
            raise AssertionError(f"{name}: {moved} bytes counted, more than its tensors hold")
        b_ms, b_by = bound_ms(moved, batch * products * SC_MULADDS_PER_MUL)
        chain = _prover_chains(mn, m, deg, rounds, rounds if r is None else r)[name]
        return {"max_abs_err": e, "ms": kernel_ms(lambda: call(*args[0], **args[1])),
                "graph_ms": graph_ms(lambda: call(*args[0], **args[1])),
                "plain_ms": median_ms(lambda: plain(*args[0], **args[1]), 3), "bound_ms": b_ms, "bound_by": b_by,
                "chain_ms": chain * sc_ns * 1e-6, "products": products, "bytes": moved,
                "threads": cpr.prep_threads(mn, m) if name == "prove_prep" else cpr.round_threads(mn), "blocks": batch,
                **ptxas.get(f"{name}_kernel", {}), **(extra or {})}

    # the stamped copies of P1-P4, one nvcc each, started together
    p2p = _p2_profiler()
    stamped = {tag: (p2p.load_stamped(so, cuda), names) for tag, (so, names, _) in
               p2p.build_all(os.path.join(cuda.CSRC, "prover.cu"), BUILD_DIR, cuda, ("P1", "P2", "P3", "P4")).items()}

    def phases(tag, call, threads):
        lib, names = stamped[tag]
        split = p2p.split(call, lib, names, cuda, batch, threads // 32, graph_ms)
        return {"phases": split["phases"], "stamped_graph_ms": split["stamped_graph_ms"]}

    cuda.reset_launches()
    prep = pin.to_device(pin.prep_inputs(batch, m, n, deg, seed=1), torch, "cuda")
    keys = ("y", "z", "y_inv", "bits", "r_blind", "alpha0")
    args = ([prep[k] for k in keys], {"bit_length": n})
    rows["prove_prep"] = row("prove_prep", cpr.prove_prep, PK.prove_prep_plain, args,
                             cpr.prove_prep(*args[0], **args[1]), r=0)
    # P1 by phase: its `// P1 phase:` markers
    rows["prove_prep"].update(phases("P1", lambda: cpr.prove_prep(*args[0], **args[1]), cpr.prep_threads(mn, m)))

    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")
    by_round = {}
    for r in range(rounds):
        inp = pin.to_device(pin.round_inputs(batch, m, n, deg, r, seed=10 + r), torch, "cuda")
        args = ([inp[k] for k in keys], {"r": r})
        by_round[r] = row("prove_round", cpr.prove_round, PK.prove_round_plain, args,
                          cpr.prove_round(*args[0], **args[1]), r=r)
    rows["prove_round"] = {**by_round[PROVER_ROW_ROUND], "round": PROVER_ROW_ROUND,
                           "by_round": {r: {k: v[k] for k in ("graph_ms", "ms", "bound_ms", "chain_ms", "products",
                                                              "bytes")}
                                        for r, v in by_round.items()}}
    # P2's row round by phase: its `// P2 phase:` markers
    inp = pin.to_device(pin.round_inputs(batch, m, n, deg, PROVER_ROW_ROUND, seed=10 + PROVER_ROW_ROUND), torch,
                        "cuda")
    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")
    rows["prove_round"].update(phases("P2", lambda: cpr.prove_round(*(inp[k] for k in keys), r=PROVER_ROW_ROUND),
                                      cpr.round_threads(mn)))

    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s", "s_s", "d_mask", "eta")
    inp = pin.to_device(pin.final_inputs(batch, m, n, deg, seed=2), torch, "cuda")
    args = ([inp[k] for k in keys], {})
    rows["prove_final"] = row("prove_final", cpr.prove_final, PK.prove_final_plain, args, cpr.prove_final(*args[0]))
    # P3's first entry by phase: its `// P3 phase:` markers
    rows["prove_final"].update(phases("P3", lambda: cpr.prove_final(*args[0]), cpr.round_threads(mn)))
    keys = ("r_s", "s_s", "a0", "b0", "eta", "d_mask", "alpha", "e")
    inp = pin.to_device(pin.responses_inputs(batch, deg, seed=3), torch, "cuda")
    args = ([inp[k] for k in keys], {})
    rows["prove_responses"] = row("prove_responses", cpr.prove_responses, PK.prove_responses_plain, args,
                                  cpr.prove_responses(*args[0]),
                                  extra={"threads": cpr.RESPONSE_THREADS, "blocks": cpr.response_blocks(batch, deg)})

    # P4 on the tables the prove sums, from alpha's point as K6 leaves it; lane 0 all ones, lane 1 all zeros
    table, bits, _, start = pin.bit_sum_inputs(batch, m, n, deg, "cuda", seed=4)
    got, want = cpr.bit_sum(start, bits, table), PK.bit_sum_plain(start, bits, table)
    e4 = _point_err(F, torch, torch.stack(list(got)).movedim(-1, 1), torch.stack(list(want)).movedim(-1, 1))
    if e4 != 0:
        raise AssertionError(f"bit_sum disagrees with its plain twin (max_abs_err {e4})")
    threads = cpr.bit_sum_threads(mn)
    b4 = bound_ms(nbytes(bits, *start) + 2 * mn * 64 + batch * POINT_BYTES,
                  batch * mn * FMUL_PER_MIXED_ADD * MULADDS_PER_FMUL)
    rows["bit_sum"] = {"max_abs_err": e4, "ms": kernel_ms(lambda: cpr.bit_sum(start, bits, table)),
                       "graph_ms": graph_ms(lambda: cpr.bit_sum(start, bits, table)),
                       "plain_ms": median_ms(lambda: PK.bit_sum_plain(start, bits, table), 3),
                       "bound_ms": b4[0], "bound_by": b4[1],
                       "chain_ms": _p4_chain(mn, threads) * probe["fe_mul_ns"] * 1e-6, "threads": threads,
                       "blocks": batch, **ptxas.get("bit_sum_kernel", {}),
                       **phases("P4", lambda: cpr.bit_sum(start, bits, table), threads)}
    out["prover"] = {k: rows[k] for k in PROVER_KERNELS}
    out["prover_shape"] = {"proofs": batch, "m": m, "bits": n, "deg": deg, "rounds": rounds}


def phase_kernels(torch, bp, params, cells, rows: dict, ptxas: dict) -> dict:
    from bulletproofs_plus_tpu_torch.ops import cuda_fixed as cf
    from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
    from bulletproofs_plus_tpu_torch.ops import cuda_pow as cp
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import field as F
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist
    from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, pack_ints
    from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel

    dev = "cuda"
    rs = random.Random(20260416)
    out = {"section_s": {}}
    clock = [time.perf_counter()]

    def section_done(name: str) -> None:  # where the phase's seconds go
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["section_s"][name], clock[0] = now - clock[0], now

    probe = _latency_probe(torch, cp, F, pack_ints, int_from_limbs, rs)
    out.update(probe)
    out.update(_point_latency_probe(torch, cp, ed, hr, rs))
    section_done("probes")
    dbl_ns = DBL_FMUL * probe["fe_mul_ns"] + DBL_FSQR * probe["fe_sqr_ns"]
    add_ns = FMUL_PER_ADD * probe["fe_mul_ns"]

    # K4, both entries, on 4087 random lanes plus edge values (4100, a 256-proof verify's count), compared
    # mod p (and with python pow on the edges); then timed at a prove's widths too
    edges = [0, 1, F.P - 1, F.P, F.P + 1, 2**255 - 1, 2**256 - 1, 2**256 - 38, 2**256 - 30]
    vals = [rs.randrange(2**256) for _ in range(K4_SHAPES[-1] - 4 - len(edges))] + [4, 2, 0, 9] + edges
    x = torch.as_tensor(pack_ints(vals).astype("int64"), device=dev)
    got, want = cp.pow_p58_cuda(x), cp.pow_p58_plain(x)
    err = float((F.canon25519(got) - F.canon25519(want)).abs().max())
    tail = [int_from_limbs(r) % F.P for r in got[-len(edges):].cpu().numpy()]
    if err != 0 or tail != [pow(v, (F.P - 5) // 8, F.P) for v in edges]:
        raise AssertionError(f"K4 pow_p58 disagrees with its plain version (max_abs_err {err})")
    # the fused entry: u = 1 broadcast, as the ristretto formulas call it, then u a tensor of its own
    one = F.limbs_const(1, x).expand(x.shape)
    u_own = torch.as_tensor(pack_ints(vals[::-1]).astype("int64"), device=dev)
    err_ratio = 0.0
    for u in (one, u_own):
        (sq, r), (sq_want, r_want) = cp.sqrt_ratio_m1_cuda(u, x), rist.sqrt_ratio_m1_plain(u, x)
        err_ratio = max(err_ratio, float((r - F.canon25519(r_want)).abs().max()), float((sq != sq_want).sum()))
    if err_ratio != 0 or not bool(sq_want.any()) or bool(sq_want.all()):
        raise AssertionError(f"K4 sqrt_ratio_m1 disagrees with its plain version (max_abs_err {err_ratio})")
    n = x.shape[0]
    ratio_muladds = (POW_SQR + RATIO_SQR) * MULADDS_PER_FSQR + (POW_MUL + RATIO_MUL) * MULADDS_PER_FMUL
    b_ms, b_by = bound_ms(n * (3 * LIMB_BYTES + 1), n * ratio_muladds)
    bp_ms, _ = bound_ms(2 * n * LIMB_BYTES, n * (POW_SQR * MULADDS_PER_FSQR + POW_MUL * MULADDS_PER_FMUL))
    by_lanes = {}
    for k in K4_SHAPES:  # both forms of both entries in turns: one lane an element, four, four, one
        xk, onek = x[-k:].contiguous(), one[-k:]
        for entry, call in (("pow_p58", lambda form: cp.pow_p58_cuda(xk, lanes=form)),
                            ("sqrt_ratio_m1", lambda form: cp.sqrt_ratio_m1_cuda(onek, xk, lanes=form))):
            turns = [kernel_ms(lambda: call(form)) for form in (1, 4, 4, 1)]
            by_lanes.setdefault(k, {}).update({
                f"{entry}_one_lane_ms": statistics.mean((turns[0], turns[3])),
                f"{entry}_four_lanes_ms": statistics.mean(turns[1:3]),
                f"{entry}_ms": kernel_ms(lambda: call(None)),  # the launcher's own pick
                f"{entry}_one_lane_graph_ms": graph_ms(lambda: call(1)),
                f"{entry}_four_lanes_graph_ms": graph_ms(lambda: call(4)),
            })
    many = x.repeat(-(-K4_MANY // n), 1)[:K4_MANY].contiguous()
    by_lanes[K4_MANY] = {f"pow_p58_{name}_graph_ms": graph_ms(lambda: cp.pow_p58_cuda(many, lanes=form), reps=5)
                         for name, form in (("one_lane", 1), ("four_lanes", 4))}
    for lanes_form in (1, 4):  # each form forced, against the launcher's pick checked above
        sq_f, r_f = cp.sqrt_ratio_m1_cuda(u_own, x, lanes=lanes_form)
        if not (torch.equal(sq_f, sq) and torch.equal(r_f, r)
                and torch.equal(F.canon25519(cp.pow_p58_cuda(x, lanes=lanes_form)), F.canon25519(got))):
            raise AssertionError(f"K4 with {lanes_form} lanes an element disagrees with the launcher's pick")
    pow_chain_ms = (POW_SQR * probe["fe_sqr_ns"] + POW_MUL * probe["fe_mul_ns"]) * 1e-6
    rows["pow_p58"] = {
        # on every path K4's chain runs inline in D1 and C1; its own entries are held and timed here
        "max_abs_err": max(err, err_ratio), "entry": "inline in D1/C1", "ms": by_lanes[n]["sqrt_ratio_m1_ms"],
        "graph_ms": by_lanes[n]["sqrt_ratio_m1_four_lanes_graph_ms"],
        "plain_ms": median_ms(lambda: rist.sqrt_ratio_m1_plain(one, x), 3), "bound_ms": b_ms, "bound_by": b_by,
        "chain_ms": pow_chain_ms + (RATIO_SQR * probe["fe_sqr_ns"] + RATIO_MUL * probe["fe_mul_ns"]) * 1e-6,
        "lanes": n, "pow_p58_ms": by_lanes[n]["pow_p58_ms"],
        "pow_p58_plain_ms": median_ms(lambda: cp.pow_p58_plain(x), 3), "pow_p58_bound_ms": bp_ms,
        "pow_p58_chain_ms": pow_chain_ms, "by_lanes": by_lanes,
    }

    section_done("k4")

    _ristretto_rows(torch, bp, hr, cells, rs, rows, out, ptxas, probe)
    section_done("d1_c1_i1")

    _replay_rows(torch, bp, hr, cells, rs, rows, out, ptxas)
    section_done("r1")

    _scalar_rows(torch, bp, hr, cells, rs, rows, out, ptxas)
    section_done("s1")

    _transcript_rows(torch, bp, hr, rs, rows, out, ptxas)
    section_done("t1")

    # the prover's tables, built and timed here, the first use of each: the joined generators' and Pedersen bases'
    # (P4's and K5's rows below), the halved ones (the batched prover's)
    t0 = time.perf_counter()
    joined = params.bp_gens.fixed_tables_joined(2 * 64, params.pc_gens, dev)
    torch.cuda.synchronize()
    out["table_build_s"] = time.perf_counter() - t0
    out["table_bytes"] = {"generators": joined[:, :, : 2 * 64].numel() * 4, "joined": joined.numel() * 4}
    t0 = time.perf_counter()  # the batched prover's: halved generators and Pedersen bases, built once
    halved = params.bp_gens.halved_tables_joined(2 * 64, params.pc_gens, dev)
    torch.cuda.synchronize()
    out["halved_tables_build_s"] = time.perf_counter() - t0
    out["table_bytes"]["halved_joined"] = halved.numel() * 4
    section_done("tables")

    _prover_rows(torch, rows, out, ptxas, probe)
    section_done("p1_p4")

    # K1-K3 on the main path's MSM shape: 4098 dynamic lanes padded to 4608
    # (zero scalar, identity) plus 128 static lanes.
    n_dyn, n_pad, n_static = 4098, 510, 128
    pts = _rand_points(torch, ed, hr, n_dyn + n_static, rs, dev)
    pts = ed.cat([ed.PointArray(*(c[:n_dyn] for c in pts)), ed.identity((n_pad,), device=dev),
                  ed.PointArray(*(c[n_dyn:] for c in pts))])
    scal = [rs.randrange(hr.L) for _ in range(n_dyn)] + [0] * n_pad + [rs.randrange(hr.L) for _ in range(n_static)]
    sc_t = torch.as_tensor(pack_ints(scal).astype("int64"), device=dev).t().contiguous()
    pts_t = cm.coords_t(pts)
    n = sc_t.shape[1]
    resident = cm.resident_tiles(dev)  # tile -> K1 blocks this card holds at once
    tile = cm.pick_tile(n, resident)
    tiles = -(-n // tile)
    parts = cm.dyn_acc(sc_t, pts_t)
    if tuple(parts.shape) != (64, tiles, cm.POINT_WORDS):
        raise AssertionError(f"dyn_acc did not take {tiles} tiles of {tile} lanes: {tuple(parts.shape)}")
    err1 = _point_err(F, torch, cf.words_to_coords(parts), cf.words_to_coords(cm.dyn_acc_plain(sc_t, pts_t)))
    wsum = cm.lane_fold(parts)
    want2 = cm.lane_fold_plain(parts)
    err2 = max(_point_err(F, torch, w, want2)
               for w in [wsum] + [cm._launch_lane_fold(parts, t) for t in cf.FOLD_THREADS])
    # K3 on the main path's window sums and on its edge inputs, against one batched run of its plain version
    edges = _horner_edges(torch, F, wsum, int_from_limbs, pack_ints)
    horner_inputs = [wsum] + list(edges.values())
    horner_want = cm.horner_plain(torch.stack(horner_inputs, dim=-1))  # (4, 16, 5)
    res = cm.horner(wsum)
    err3 = _point_err(F, torch, torch.stack([res] + [cm.horner(w) for w in edges.values()], dim=-1), horner_want)
    for name, err in (("dyn_acc", err1), ("lane_fold", err2), ("horner", err3)):
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version (max_abs_err {err})")

    # K1 and K2 at the b64_m4_x64 verify's MSM too, and at each shape once more at the tile width the wrapper
    # turns down, K2 on each K1's partials: at 4736 lanes 16 (296 blocks, a second wave), at 2048 lanes 8 (256
    # blocks, two an SM, where the picked 16 makes 128, one an SM)
    pts4 = _rand_points(torch, ed, hr, M4_LANES, rs, dev)
    sc4 = torch.as_tensor(pack_ints([rs.randrange(hr.L) for _ in range(M4_LANES)]).astype("int64"), device=dev)
    shapes = {n: (sc_t, pts_t, parts, wsum), M4_LANES: (sc4.t().contiguous(), cm.coords_t(pts4), None, None)}
    other_tile = {n: 16, M4_LANES: 8}
    by_shape, by_shape_wsum = {}, {}
    for lanes, (sc_s, pts_s, parts_s, wsum_s) in shapes.items():
        if parts_s is None:
            parts_s = cm.dyn_acc(sc_s, pts_s)
            err1 = max(err1, _point_err(F, torch, cf.words_to_coords(parts_s),
                                        cf.words_to_coords(cm.dyn_acc_plain(sc_s, pts_s))))
            wsum_s = cm.lane_fold(parts_s)
            err2 = max(err2, _point_err(F, torch, wsum_s, cm.lane_fold_plain(parts_s)))
        by_shape_wsum[lanes] = wsum_s
        t_o = other_tile[lanes]
        p_o = cm._launch_dyn_acc(sc_s, pts_s, t_o)
        if _point_err(F, torch, cm.lane_fold(p_o)[..., None], wsum_s[..., None]) != 0:
            raise AssertionError(f"dyn_acc at {t_o} lanes a tile and lane_fold disagree with the picked tile ({lanes} lanes)")
        t_s = cm.pick_tile(lanes, resident)
        by_shape[lanes] = {"tile": t_s, "tiles": parts_s.shape[1], "waves": parts_s.shape[1] / resident(t_s),
                           "dyn_acc_graph_ms": graph_ms(lambda: cm.dyn_acc(sc_s, pts_s)),
                           "lane_fold_graph_ms": graph_ms(lambda: cm.lane_fold(parts_s)),
                           "other_tile": {"tile": t_o, "tiles": p_o.shape[1], "waves": p_o.shape[1] / resident(t_o),
                                          "dyn_acc_graph_ms": graph_ms(lambda: cm._launch_dyn_acc(sc_s, pts_s, t_o)),
                                          "lane_fold_graph_ms": graph_ms(lambda: cm.lane_fold(p_o))}}
    out["k1_k2_by_shape"] = by_shape
    for name, err in (("dyn_acc", err1), ("lane_fold", err2)):
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version at {M4_LANES} lanes (max_abs_err {err})")
    fold_threads = cf.pick_fold_threads(tiles, 64)

    # K1 per tile: tables (7 additions and 7 doublings a lane, then a product an entry for the cached form
    # of P..15P), then 64 window sums of its lanes, each addition of a cached entry 8 products; K2 the rest of
    # the 64 (n - 1) additions, of extended points; packed 128-byte partials between them.  K7 the same with
    # a table of 3 additions and 4 doublings (2P..8P) and 8 cached entries
    dbl_muladds = DBL_FMUL * MULADDS_PER_FMUL + DBL_FSQR * MULADDS_PER_FSQR
    k1_table = 7 * FMUL_PER_ADD * MULADDS_PER_FMUL + 7 * dbl_muladds + 15 * MULADDS_PER_FMUL
    k7_table = 3 * FMUL_PER_ADD * MULADDS_PER_FMUL + 4 * dbl_muladds + 8 * MULADDS_PER_FMUL
    b1 = bound_ms(n * (LIMB_BYTES + POINT_BYTES) + tiles * 64 * PART_BYTES,
                  n * k1_table + 64 * (n - tiles) * FMUL_PER_CACHED_ADD * MULADDS_PER_FMUL)
    b2 = bound_ms(tiles * 64 * PART_BYTES + 64 * POINT_BYTES, 64 * (tiles - 1) * FMUL_PER_ADD * MULADDS_PER_FMUL)
    b3 = bound_ms(65 * POINT_BYTES, 252 * (DBL_FMUL * MULADDS_PER_FMUL + DBL_FSQR * MULADDS_PER_FSQR)
                  + 63 * FMUL_PER_ADD * MULADDS_PER_FMUL)
    # the longest chains: K1 a doubling and an addition over four lanes for the table's first levels, one
    # thread a point two additions for the others and the quarter's window additions, then two additions
    # over four lanes for the quarters' sums ((Q0 + Q1) beside (Q2 + Q3), then their sum); K2 an adder's
    # loop additions and the tree's levels, each 3 multiplications deep over four lanes
    k1_adds = 2 + (-(-tile // 4) - 1)
    adders = fold_threads // 4
    k2_adds = -(-tiles // adders) - 1 + (min(tiles, adders) - 1).bit_length()
    regs = ptxas.get("dyn_acc_kernel", {}), ptxas.get("lane_fold_kernel", {})
    dev_index = torch.cuda.current_device()
    # the plain versions of K1, K3 and K7 take one to two seconds a call: timed once, already warm
    rows["dyn_acc"] = {"max_abs_err": err1, "ms": kernel_ms(lambda: cm.dyn_acc(sc_t, pts_t)),
                       "graph_ms": by_shape[n]["dyn_acc_graph_ms"],
                       "plain_ms": median_ms(lambda: cm.dyn_acc_plain(sc_t, pts_t), 1),
                       "bound_ms": b1[0], "bound_by": b1[1],
                       "chain_ms": ((k1_adds * FMUL_PER_ADD + 1 + 3 * FMUL_DEEP_ADD4) * probe["fe_mul_ns"]
                                    + probe["fe_sqr_ns"]) * 1e-6,
                       "lanes": n, "tile": tile, "blocks": tiles, "threads": cm.K1_THREADS,
                       "waves": by_shape[n]["waves"], "sms": cm.sm_count(dev),
                       "blocks_per_sm": cm.occupancy("dyn_acc", dev_index, tile=tile), **regs[0]}
    k2_per_sm = cm.occupancy("lane_fold", dev_index, threads=fold_threads)
    rows["lane_fold"] = {"max_abs_err": err2, "ms": kernel_ms(lambda: cm.lane_fold(parts)),
                         "graph_ms": by_shape[n]["lane_fold_graph_ms"],
                         "graph_ms_by_threads": {t: graph_ms(lambda: cm._launch_lane_fold(parts, t))
                                                 for t in cf.FOLD_THREADS},
                         "plain_ms": median_ms(lambda: cm.lane_fold_plain(parts), 3),
                         "bound_ms": b2[0], "bound_by": b2[1],
                         "chain_ms": k2_adds * FMUL_DEEP_ADD4 * probe["fe_mul_ns"] * 1e-6,
                         "tiles": tiles, "blocks": 64, "threads": fold_threads,
                         "waves": 64 / (cm.sm_count(dev) * k2_per_sm), "blocks_per_sm": k2_per_sm, **regs[1]}

    # the longest chain: 252 doublings, each a squaring and a multiplication deep over four lanes, then the
    # addition of a group's own pair of windows and those of the tree's levels, each 3 multiplications deep
    horner_adds = 64 // cm.HORNER_GROUPS - 1 + (cm.HORNER_GROUPS - 1).bit_length()
    # the main path's K3 writes the verdict too (its tail, I1's test): held against the plain twin and I1
    tail_pt, tail_flag = cm.horner(wsum, identity=True)
    plain_pt, plain_flag = cm.horner_identity_plain(wsum)
    err3 = max(err3, _point_err(F, torch, tail_pt[..., None], plain_pt[..., None]),
               float(bool(tail_flag) != bool(plain_flag)),
               float(bool(tail_flag) != bool(rist.is_identity(ed.PointArray(*tail_pt)))))
    for w in edges.values():  # the identity among them
        edge_flag = cm.horner(w, identity=True)[1]
        err3 = max(err3, float(bool(edge_flag) != bool(cm.horner_identity_plain(w)[1])))
    if err3 != 0:
        raise AssertionError(f"horner with its tail disagrees with its plain twin or with I1 (max_abs_err {err3})")
    rows["horner"] = {"max_abs_err": err3, "ms": kernel_ms(lambda: cm.horner(wsum, identity=True)),
                      "graph_ms": graph_ms(lambda: cm.horner(wsum, identity=True)),
                      "graph_ms_without_tail": graph_ms(lambda: cm.horner(wsum)),
                      "plain_ms": median_ms(lambda: cm.horner_identity_plain(wsum), 1),
                      "bound_ms": b3[0], "bound_by": b3[1],
                      "chain_ms": (252 * (probe["fe_sqr_ns"] + probe["fe_mul_ns"])
                                   + horner_adds * FMUL_DEEP_ADD4 * probe["fe_mul_ns"]) * 1e-6,
                      # one thread's 252 doublings and 6 tree levels: the design this one replaced
                      "serial_chain_ms": (252 * dbl_ns + 6 * add_ns) * 1e-6,
                      "groups": cm.HORNER_GROUPS, "edge_inputs": list(edges)}

    # K7 at both verify widths, held exactly against its plain version at the tile it picks and at 16 and 32
    # lanes, its MSM against K1's; then the A/B of the two digit recodings, K1 + K2 against K7 + K2 by graph
    # time in the order K1, K7, K7, K1
    resident7 = cm.resident_tiles(dev, "dyn_acc_signed")
    err7, by_shape7 = 0.0, {}
    for lanes, (sc_s, pts_s, _, _) in shapes.items():
        res_s = res if lanes == n else cm.horner(by_shape_wsum[lanes])
        t7 = cm.pick_tile(lanes, resident7)
        for t in sorted({t7, 16, 32}):
            p7 = cm.dyn_acc_signed(sc_s, pts_s) if t == t7 else cm._launch_dyn_acc_signed(sc_s, pts_s, t)
            err7 = max(err7, _point_err(F, torch, cf.words_to_coords(p7),
                                        cf.words_to_coords(cm.dyn_acc_signed_plain(sc_s, pts_s, t))))
            if _point_err(F, torch, cm.horner(cm.lane_fold(p7))[..., None], res_s[..., None]) != 0:
                raise AssertionError(f"dyn_acc_signed at {t} lanes a tile: its MSM is not K1's ({lanes} lanes)")
        if err7 != 0:
            raise AssertionError(f"dyn_acc_signed disagrees with its plain version ({lanes} lanes, max_abs_err {err7})")
        parts7 = cm.dyn_acc_signed(sc_s, pts_s)
        chains = {"k1": lambda: cm.lane_fold(cm.dyn_acc(sc_s, pts_s)),
                  "k7": lambda: cm.lane_fold(cm.dyn_acc_signed(sc_s, pts_s))}
        by_shape7[lanes] = {"tile": t7, "tiles": parts7.shape[1], "waves": parts7.shape[1] / resident7(t7),
                            "dyn_acc_signed_graph_ms": graph_ms(lambda: cm.dyn_acc_signed(sc_s, pts_s)),
                            "lane_fold_graph_ms": graph_ms(lambda: cm.lane_fold(parts7)),
                            "k1_k7_k7_k1_graph_ms": [graph_ms(chains[k]) for k in ("k1", "k7", "k7", "k1")]}
    out["k7_by_shape"] = by_shape7
    t7 = by_shape7[n]["tile"]
    tiles7 = by_shape7[n]["tiles"]
    b7 = bound_ms(n * (LIMB_BYTES + POINT_BYTES) + tiles7 * 64 * PART_BYTES,
                  n * k7_table + 64 * (n - tiles7) * FMUL_PER_CACHED_ADD * MULADDS_PER_FMUL)
    # the longest chain: K1's, with one table level of one-thread additions, not two, the cached form's
    # product before the windows and the first entry's, and the window additions at 8 products
    k7_chain = ((FMUL_PER_ADD + 2 + (-(-t7 // 4) - 1) * FMUL_PER_CACHED_ADD + 1 + 3 * FMUL_DEEP_ADD4)
                * probe["fe_mul_ns"] + probe["fe_sqr_ns"]) * 1e-6
    rows["dyn_acc_signed"] = {"max_abs_err": err7, "ms": kernel_ms(lambda: cm.dyn_acc_signed(sc_t, pts_t)),
                              "graph_ms": by_shape7[n]["dyn_acc_signed_graph_ms"],
                              "plain_ms": median_ms(lambda: cm.dyn_acc_signed_plain(sc_t, pts_t), 1),
                              "bound_ms": b7[0], "bound_by": b7[1], "chain_ms": k7_chain,
                              "lanes": n, "tile": t7, "blocks": tiles7, "threads": cm.K1_THREADS,
                              "waves": by_shape7[n]["waves"], "sms": cm.sm_count(dev),
                              "blocks_per_sm": cm.occupancy("dyn_acc_signed", dev_index, tile=t7),
                              "tiles_checked": sorted({t7, 16, 32}),
                              **ptxas.get("dyn_acc_signed_kernel", {})}
    section_done("k1_k2_k3_k7")

    # K5 and K6 at the prover's shapes, over the generators' tables joined with the Pedersen bases' (128 + 2
    # lanes): the round MSM (128 proofs x 132 lanes in round 1's order, L and R as two groups, each ending with
    # its Pedersen lanes [d, c]), the A1 MSM (130 lanes in place, one group) and the Pedersen MSMs of alpha and
    # B (128 rows x 1 and 2 lanes; B's timed).
    from bulletproofs_plus_tpu_torch.models.prover_kernels import round_lanes


    def rand_scalars(f, s):
        vals = [[rs.randrange(hr.L) for _ in range(s)] for _ in range(f)]
        vals[0] = [0] * s  # a chain of identity additions
        vals[1] = [0] * (s - 1) + [11 << (4 * 50)]  # one non-zero digit
        return torch.as_tensor(pack_ints([v for row in vals for v in row]).astype("int64"), device=dev).reshape(f, s, 16)

    on_dev = lambda lanes: torch.as_tensor(lanes, device=dev)  # noqa: E731
    shapes = (
        ("round", joined, on_dev(round_lanes(64, 1, PROVER_ROW_ROUND)), rand_scalars(PROVE_BATCH, 132), 2),
        ("a1", joined, torch.arange(130, device=dev), rand_scalars(PROVE_BATCH, 130), 1),
        ("pedersen", joined, on_dev([128, 129]), rand_scalars(PROVE_BATCH, 2), 1),
    )
    out["fixed_shapes"] = {}
    for label, tab, lane_idx, scal, groups in shapes:
        got = _fixed_rows(torch, cf, F, tab, lane_idx, scal, groups, probe)
        out["fixed_shapes"][label] = got
        if label == "round":  # the shape the prover launches most: the kernels table's row
            rows.update(got)
        section_done(f"k5_k6_{label}")

    # The whole chain against the host Pippenger on 16 lanes
    small = [hr.point_mul(rs.randrange(1, hr.L), hr.BASEPOINT) for _ in range(16)]
    small_sc = [rs.randrange(hr.L) for _ in range(16)]
    got16 = msm_kernel(torch.as_tensor(pack_ints(small_sc).astype("int64"), device=dev), ed.from_host(small, device=dev))
    if not hr.point_equal(ed.to_host(got16), host_msm(small_sc, small)):
        raise AssertionError("16-lane MSM disagrees with the host Pippenger")
    out["kernels"] = {k: {kk: v[kk] for kk in ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms", "chain_ms",
                                               "serial_chain_ms", "graph_ms_by_threads", "tile", "blocks", "threads",
                                               "waves", "blocks_per_sm", "registers", "spill_stores", "spill_loads",
                                               "ptxas", "sc_mul_ns")
                          if kk in v}
                      for k, v in rows.items()}
    out["k4"] = rows["pow_p58"]
    out["k3"] = rows["horner"]
    out["host_pippenger_16"] = "equal"
    return out


def _golden_statement(bp, hr, cell, params=None):
    if params is None:
        pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(cell["extension_degree"]))
        params = bp.RangeParameters.init(cell["bits"], len(cell["values"]), pc)
    commitments = [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    return bp.RangeStatement.init(params, commitments, mv, seed_nonce=cell["seed_nonce"])


def phase_golden(bp, hr, cells) -> dict:
    results = []
    for cell in cells:
        statement = _golden_statement(bp, hr, cell)
        proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
        if proof.to_bytes().hex() != cell["proof"]:
            raise AssertionError(f"golden seed {cell['seed']}: proof bytes do not round-trip")
        challenges, _ = bp.RangeProof._replay_challenges([bp.Transcript(b"golden")], [statement], [proof])
        y, z, es, e = challenges[0]
        if (format(y, "064x"), format(z, "064x"), [format(v, "064x") for v in es], format(e, "064x")) != (
            cell["y"], cell["z"], cell["round_es"], cell["e"]
        ):
            raise AssertionError(f"golden seed {cell['seed']}: challenges differ")
        masks = bp.RangeProof.verify_batch(
            [bp.Transcript(b"golden")], [statement], [proof], bp.VerifyAction.RECOVER_AND_VERIFY, device="cuda"
        )
        got = None if masks[0] is None else [format(b, "064x") for b in masks[0].blindings()]
        if got != cell["mask"]:
            raise AssertionError(f"golden seed {cell['seed']}: mask {got} != {cell['mask']}")
        results.append({"seed": cell["seed"], "bits": cell["bits"], "m": len(cell["values"]), "valid": True})
    return {"cells": results}


def phase_host_engine(torch, bp, hr, cells) -> dict:
    """Golden proof 3 (64 bits, one commitment) through the sequential prover
    and the host engine with their MSMs on the card (`msm_backend="device"`):
    the proof must be the golden bytes, the verify must recover the golden
    mask and refuse a tampered copy, and the launch counters must show that
    each MSM went through K1 or K7, K2 and K3."""
    from bulletproofs_plus_tpu_torch.native import cuda

    cell = next(c for c in cells if c["seed"] == 3)
    statement = _golden_statement(bp, hr, cell)
    witness = bp.RangeWitness.init([bp.CommitmentOpening(v, bl) for v, bl in zip(cell["values"], cell["blindings"])])
    out = {}

    def counted(label, fn):
        cuda.reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        counts = {k: cuda.launches[k] for k in ("dyn_acc", "dyn_acc_signed", "lane_fold", "horner")}
        if not (counts["dyn_acc"] or counts["dyn_acc_signed"]) or not counts["lane_fold"] or not counts["horner"]:
            raise AssertionError(f"host engine, {label}: the MSM kernels did not run: {counts}")
        out[label] = {"seconds": time.perf_counter() - t0, "launches": counts}
        return result

    proof = counted("prove", lambda: bp.RangeProof.prove_with_rng(
        bp.Transcript(b"golden"), statement, witness, bp.SeededRng(cell["seed"]), msm_backend="device", device="cuda"))
    if proof.to_bytes().hex() != cell["proof"]:
        raise AssertionError("host engine: prove_with_rng with its MSMs on the card is not golden proof 3")
    masks = counted("verify", lambda: bp.RangeProof.verify_batch(
        [bp.Transcript(b"golden")], [statement], [proof], bp.VerifyAction.RECOVER_AND_VERIFY,
        msm_backend="device", engine="host", device="cuda"))
    if [format(b, "064x") for b in masks[0].blindings()] != cell["mask"]:
        raise AssertionError("host engine: the recovered mask is not golden mask 3")
    tampered = bp.RangeProof.from_bytes(proof.to_bytes())
    tampered.s1 = (tampered.s1 + 1) % hr.L
    try:
        bp.RangeProof.verify_batch([bp.Transcript(b"golden")], [statement], [tampered], bp.VerifyAction.VERIFY_ONLY,
                                   msm_backend="device", engine="host", device="cuda")
        raise AssertionError("host engine: a tampered s1 was accepted")
    except bp.VerificationFailed:
        pass
    out.update(golden_proof="equal", golden_mask="equal", tampered_s1="VerificationFailed")
    return out


def _tiled(bp, hr, cell, batch: int):
    statement = _golden_statement(bp, hr, cell)
    proof = bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    return [statement] * batch, [proof] * batch


def _verify(bp, statements, proofs):
    return bp.RangeProof.verify_batch(
        [bp.Transcript(b"golden") for _ in proofs], statements, proofs, bp.VerifyAction.VERIFY_ONLY,
        engine="device", device="cuda",
    )


# D1 decodes a verify's points once a shape group and K3 writes the MSM's verdict in its tail (I1 checks the
# all-reduced point of a sharded verify only); C1 encodes a prove's points eight times; K4's chain runs inside D1
# and C1, and K4's own entries (`pow_p58`, `sqrt_ratio_m1`) on no path.  The MSM's first stage is K7 (signed
# digits, the default) or K1 (BPPT_MSM_SIGNED=0); a single-shape verify replays its transcripts once through R1;
# S1 runs the scalar pass once a shape group
VERIFY_KERNELS = ("replay", "scalar_pass", "dyn_acc_signed", "lane_fold", "horner", "decompress")
PROVE_KERNELS = ("fixed_acc", "fixed_fold", "double_compress", "prove_transcript") + PROVER_KERNELS
# a 64-bit prove, 6 rounds: K5 and K6 once a round (L and R with their Pedersen lanes) and for alpha, A1 and B;
# C1's double-and-encode for A, each round's L/R and A1/B (its sqrt form and K4's own entries never); T1 once a
# phase (after A, each round and A1/B); P1 once, P2 once a round, P3's entries and P4 once
PROVE_LAUNCHES = {"fixed_acc": 9, "fixed_fold": 9, "double_compress": 8, "prove_transcript": 8, "prove_prep": 1,
                  "prove_round": 6, "prove_final": 1, "prove_responses": 1, "bit_sum": 1}
# the plain field and point functions that no prove on the card may call on a CUDA tensor
PLAIN_FUNCTIONS = {"ops.field": ("mul_l", "add_l", "sub_l", "sqr_l", "select"), "ops.edwards": ("add",),
                   "ops.msm": ("tree_reduce",)}
K4_ENTRIES = ("pow_p58", "sqrt_ratio_m1")
OFF_PROVE = K4_ENTRIES + ("compress",)  # entries a prove launches 0 times


def _unsigned_arm(torch, bp, cuda, statements, proofs, launches: dict) -> dict:
    """One verify with BPPT_MSM_SIGNED=0 for the call: K1 takes K7's place."""
    before = os.environ.get("BPPT_MSM_SIGNED")
    os.environ["BPPT_MSM_SIGNED"] = "0"
    try:
        cuda.reset_launches()
        t0 = time.perf_counter()
        _verify(bp, statements, proofs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        if before is None:
            del os.environ["BPPT_MSM_SIGNED"]
        else:
            os.environ["BPPT_MSM_SIGNED"] = before
    counts = {k: cuda.launches[k] for k in ("dyn_acc", "is_identity") + VERIFY_KERNELS + K4_ENTRIES}
    if (not counts["dyn_acc"] or counts["dyn_acc_signed"] or any(counts[k] for k in K4_ENTRIES) or counts["is_identity"]
            or [counts[k] for k in ("lane_fold", "horner", "replay", "decompress")] != [1] * 4):
        raise AssertionError(f"unsigned verify: wrong kernels launched: {counts}")
    launches["dyn_acc"] = counts["dyn_acc"]
    return {"proofs": len(proofs), "seconds": seconds, "launches": counts}


def _verify_stages(torch, bp, statements, proofs) -> dict:
    """Three stages of one verify, each its call's arguments captured from a
    verify, then the call alone with a synchronise on both sides (median of
    5, host clock): the scalar pass (S1), the decompression (D1) and the MSM
    with its verdict (`combine_groups_msm`: K7, K2, K3 with I1's test in its
    tail, then the verdict's and the flags' readbacks); and torch.profiler
    over one whole verify: its device operations, device busy time, idle
    share, D1's, K3's and S1's device time, S1a's and S1b's apart,
    beside theirs in the captured call run 5 times back to back and 5 times
    each after 20 ms of an idle card."""
    from torch.profiler import ProfilerActivity, profile

    from bulletproofs_plus_tpu_torch.models import verifier_kernels as vk
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist

    stages = {"scalar_pass": vk, "decompress": rist, "combine_groups_msm": vk}
    inners = {name: getattr(module, name) for name, module in stages.items()}
    captured = {name: [] for name in stages}

    def recording(name):
        def call(*args, **kwargs):
            captured[name].append((args, kwargs))
            return inners[name](*args, **kwargs)
        return call

    for name, module in stages.items():
        setattr(module, name, recording(name))
    try:
        _verify(bp, statements, proofs)
    finally:
        for name, module in stages.items():
            setattr(module, name, inners[name])
    ((args, kwargs),), ((dec_args, _),), ((id_args, _),) = (captured[name] for name in stages)
    inner, decompress, msm_verdict = (inners[name] for name in stages)
    _, valid = decompress(*dec_args)
    out = {"scalar_pass_stage_ms": median_ms(lambda: inner(*args, **kwargs), 5),
           "decompress_stage_ms": median_ms(lambda: decompress(*dec_args), 5),
           "msm_verdict_stage_ms": median_ms(lambda: bool(msm_verdict(*id_args)) and bool(valid.all()), 5),
           "decompress_points": dec_args[0].shape[0], "card": nvidia_smi()}

    def device_events(fn):
        for _ in range(2):  # a trace that saw no device work is taken again once
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = [e for e in prof.events()
                      if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
            if events:
                return events, wall_ms
        return [], wall_ms

    def s1_ms(events, calls):  # S1a's and S1b's device time a call
        return [sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e3 / calls
                for name in ("scalar_proof_kernel", "scalar_lane_kernel")]

    def after_idle():
        for _ in range(5):
            torch.cuda.synchronize()
            time.sleep(0.02)
            inner(*args, **kwargs)

    events, wall_ms = device_events(lambda: _verify(bp, statements, proofs))
    if not events:
        out["device_ops"] = "not measured: the profiler saw no device work"
        return out
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    out.update(device_ops=len(events), verify_wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
               **{f"{label}_device_ms": sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e3
                  for label, name in (("d1", "decompress"), ("k3", "horner_kernel"))},
               s1_device_ms=sum(s1_ms(events, 1)), s1_device_ms_in_verify=s1_ms(events, 1),
               s1_device_ms_back_to_back=s1_ms(device_events(lambda: [inner(*args, **kwargs) for _ in range(5)])[0], 5),
               s1_device_ms_after_idle=s1_ms(device_events(after_idle)[0], 5))
    return out


def phase_main(torch, bp, hr, cells, launches: dict) -> dict:
    from bulletproofs_plus_tpu_torch.native import cuda

    out = {}
    for label, seed, batch in (("b64_m1_x256", 3, 256), ("b64_m4_x64", 6, 64)):
        cell = next(c for c in cells if c["seed"] == seed)
        statements, proofs = _tiled(bp, hr, cell, batch)
        cuda.reset_launches()
        t0 = time.perf_counter()
        _verify(bp, statements, proofs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {k: cuda.launches[k] for k in VERIFY_KERNELS}
        if (not all(counts.values()) or [counts[k] for k in ("replay", "scalar_pass", "decompress", "horner")]
                != [1, 1, 1, 1] or any(cuda.launches[k] for k in OFF_PROVE + ("double_compress", "dyn_acc", "is_identity"))):
            raise AssertionError(f"{label}: wrong kernel launches: {dict(cuda.launches)}")
        if seed == 3:
            launches.update(counts)
            out["b64_m1_x256_unsigned"] = _unsigned_arm(torch, bp, cuda, statements, proofs, launches)
            out["b64_m1_x256_stages"] = _verify_stages(torch, bp, statements, proofs)
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            _verify(bp, statements, proofs)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        wall = statistics.median(samples)
        out[label] = {"proofs": batch, "first_s": first_s, "median_s": wall, "samples_s": samples,
                      "proofs_per_s": batch / wall, "launches": counts}
    return out


def _interleaved_mixed(bp, hr, cells, batch: int = 256):
    """The mixed batch: golden proof 3 (64-bit, m=1, 6 rounds) at the even
    positions and golden proof 4 (64-bit, m=2 with minimum values, 7
    rounds) at the odd ones, all of extension degree 1, on one generator
    set, as one deployment would hold them."""
    pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(1))
    params = bp.RangeParameters.init(64, 2, pc)
    pairs = [(_golden_statement(bp, hr, cell, params), bp.RangeProof.from_bytes(bytes.fromhex(cell["proof"])))
             for cell in (next(c for c in cells if c["seed"] == seed) for seed in (3, 4))]
    return [pairs[i % 2][0] for i in range(batch)], [pairs[i % 2][1] for i in range(batch)]


def _outcome(bp, fn):
    """(error class, message) of fn(), or its result."""
    try:
        return fn()
    except bp.ProofError as exc:
        return (type(exc).__name__, str(exc))


def phase_mixed(torch, bp, hr, cells) -> dict:
    """256 x 64-bit proofs of two shapes interleaved through the device
    engine's mixed path (host replay, one `group_contrib` a shape group, one
    `combine_groups_msm`), in VERIFY_ONLY and RECOVER_AND_VERIFY: verdicts and
    masks equal `engine="host"`'s on the same batch (its MSM on the card).
    Then a non-canonical point in a later proof of one group and an earlier
    proof of the other: the earlier proof's error is raised."""
    from bulletproofs_plus_tpu_torch.native import cuda

    statements, proofs = _interleaved_mixed(bp, hr, cells)
    out = {"proofs": len(proofs), "groups": {"m1_rounds6": len(proofs) // 2, "m2_rounds7": len(proofs) // 2}}

    def run(action, proofs=proofs, **kw):
        return bp.RangeProof.verify_batch([bp.Transcript(b"golden") for _ in proofs], statements, proofs,
                                          getattr(bp.VerifyAction, action), device="cuda", **kw)

    # decompressions: one a shape group, and one of every proof's points in the structural checks when masks
    # are recovered
    for action, decompressions in (("VERIFY_ONLY", 2), ("RECOVER_AND_VERIFY", 3)):
        cuda.reset_launches()
        t0 = time.perf_counter()
        got = run(action)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: cuda.launches[k] for k in VERIFY_KERNELS + K4_ENTRIES}
        if (counts["replay"] or counts["decompress"] != decompressions or counts["dyn_acc_signed"] != 1
                or counts["scalar_pass"] != 2 or counts["horner"] != 1 or cuda.launches["is_identity"]
                or any(counts[k] for k in K4_ENTRIES)):
            raise AssertionError(f"mixed {action}: wrong kernel launches {counts} (want no replay, "
                                 f"{decompressions} decompressions, two scalar passes, one MSM with its verdict, "
                                 f"no identity check apart)")
        want = run(action, engine="host", msm_backend="device")
        masks = [None if m is None else m.blindings() for m in got]
        if masks != [None if m is None else m.blindings() for m in want]:
            raise AssertionError(f"mixed {action}: masks differ from engine='host'")
        if action != "VERIFY_ONLY" and (masks[0] is None or masks[1] is not None):
            raise AssertionError("mixed: the m=1 lanes must recover masks, the m=2 ones none")
        out[action] = {"seconds": seconds, "launches": counts, "masks_equal_host": True}

    def noncanonical(a_at, l_at):
        bad = list(proofs)
        bad_a = bp.RangeProof.from_bytes(proofs[a_at].to_bytes())
        bad_a.a = (hr.P + 1).to_bytes(32, "little")
        bad_l = bp.RangeProof.from_bytes(proofs[l_at].to_bytes())
        bad_l.li = [bad_l.li[0], (hr.P + 1).to_bytes(32, "little")] + bad_l.li[2:]
        bad[a_at], bad[l_at] = bad_a, bad_l
        return bad

    cases = {  # (proof with a bad A in the m=1 group, proof with a bad L in the m=2 group) -> the earlier one's
        "later_a_200_earlier_l_101": (200, 101, "An item in member 'L' was not the canonical encoding of a point"),
        "earlier_a_100_later_l_201": (100, 201, "Member 'a' was not the canonical encoding of a point"),
    }
    for label, (a_at, l_at, want) in cases.items():
        got = _outcome(bp, lambda: run("VERIFY_ONLY", proofs=noncanonical(a_at, l_at)))
        if got != ("InvalidArgument", want):
            raise AssertionError(f"mixed, {label}: got {got!r}, want InvalidArgument({want!r})")
        out[label] = want
    return out


STREAM_BATCHES = 8  # 256 x m=1 batches in the pipelined stream, then one mixed batch


def phase_pipelined(torch, bp, hr, cells) -> dict:
    """`verify_batches_pipelined` over 8 batches of 256 x 64-bit m=1 proofs and
    one mixed batch: results equal per-batch `verify_batch`; a stream with
    batches 2 and 5 tampered raises batch 2's error; the stream's proofs/s
    (VERIFY_ONLY, median of 3) beside the sequential calls' on this card."""
    cell = next(c for c in cells if c["seed"] == 3)
    st, pr = _tiled(bp, hr, cell, 256)
    batches = [(st, pr)] * STREAM_BATCHES + [_interleaved_mixed(bp, hr, cells)]
    n_proofs = sum(len(p) for _, p in batches)

    def stream(action, batches=batches):
        return bp.RangeProof.verify_batches_pipelined(
            [([bp.Transcript(b"golden") for _ in p], s, p) for s, p in batches], action, device="cuda")

    def sequential(action):
        return [bp.RangeProof.verify_batch([bp.Transcript(b"golden") for _ in p], s, p, action, device="cuda")
                for s, p in batches]

    action = bp.VerifyAction.RECOVER_AND_VERIFY
    got, want = stream(action), sequential(action)
    if [[None if m is None else m.blindings() for m in b] for b in got] != [
            [None if m is None else m.blindings() for m in b] for b in want]:
        raise AssertionError("pipelined: results differ from per-batch verify_batch")

    tampered = list(batches)
    bad = bp.RangeProof.from_bytes(pr[0].to_bytes())
    bad.a = (hr.P + 1).to_bytes(32, "little")
    tampered[2] = (st, [bad] + pr[1:])  # batch 2: a non-canonical A (InvalidArgument)
    bad5 = bp.RangeProof.from_bytes(pr[0].to_bytes())
    bad5.r1 = (bad5.r1 + 1) % hr.L
    tampered[5] = (st, pr[:17] + [bad5] + pr[18:])  # batch 5: a tampered r1 (VerificationFailed)
    failure = _outcome(bp, lambda: stream(bp.VerifyAction.VERIFY_ONLY, tampered))
    want_failure = ("InvalidArgument", "Member 'a' was not the canonical encoding of a point")
    if failure != want_failure:
        raise AssertionError(f"pipelined: batches 2 and 5 tampered raised {failure!r}, want batch 2's {want_failure!r}")

    verify_only = bp.VerifyAction.VERIFY_ONLY
    stream_s = [median_ms(lambda: stream(verify_only), 1) / 1e3 for _ in range(3)]
    sequential_s = [median_ms(lambda: sequential(verify_only), 1) / 1e3 for _ in range(3)]
    wall, seq = statistics.median(stream_s), statistics.median(sequential_s)
    return {"batches": len(batches), "proofs": n_proofs, "equal_to_verify_batch": True,
            "tampered_2_and_5": f"{failure[0]}: {failure[1]} (batch 2's)", "lookahead": 2,
            "stream_samples_s": stream_s, "sequential_samples_s": sequential_s,
            "stream_proofs_per_s": n_proofs / wall, "sequential_proofs_per_s": n_proofs / seq,
            "card": nvidia_smi()}


def _prove_inputs(bp, hr, params, cell):
    """PROVE_BATCH 64-bit statements and witnesses whose lane 0 is golden cell
    3: (statements(seeded), witnesses, blindings)."""
    pc, seed = params.pc_gens, cell["seed"]
    values = [(cell["values"][0] + 7919 * lane) % 2**64 for lane in range(PROVE_BATCH)]
    blindings = [[seed * 1000 + 17 * lane] for lane in range(PROVE_BATCH)]
    commitments = [pc.commit(v, bl) for v, bl in zip(values, blindings)]
    if hr.compress(commitments[0]).hex() != cell["commitments"][0] or blindings[0] != cell["blindings"][0]:
        raise AssertionError("lane 0 is not golden cell 3")
    witnesses = [bp.RangeWitness.init([bp.CommitmentOpening(v, bl)]) for v, bl in zip(values, blindings)]

    def statements(seeded: bool):
        return [bp.RangeStatement.init(params, [c], [None], (cell["seed_nonce"] + lane) if seeded else None)
                for lane, c in enumerate(commitments)]

    return statements, witnesses, blindings


class _PlainCalls:
    """Counts the calls of PLAIN_FUNCTIONS with a CUDA tensor among their
    arguments while active: every name in the port's modules bound to one of
    them is wrapped, and put back on exit."""

    def __init__(self):
        import importlib

        self.counts = {}
        self.originals = {}
        for module, names in PLAIN_FUNCTIONS.items():
            mod = importlib.import_module(f"bulletproofs_plus_tpu_torch.{module}")
            for name in names:
                self.originals[id(getattr(mod, name))] = (f"{module}.{name}", getattr(mod, name))
        self.patched = []

    def _wrap(self, label, fn):
        import torch

        def on_cuda(v):
            return (isinstance(v, torch.Tensor) and v.is_cuda) or (isinstance(v, tuple) and any(map(on_cuda, v)))

        def call(*args, **kwargs):
            if any(on_cuda(v) for v in list(args) + list(kwargs.values())):
                self.counts[label] = self.counts.get(label, 0) + 1
            return fn(*args, **kwargs)

        return call

    def __enter__(self):
        wrappers = {key: self._wrap(label, fn) for key, (label, fn) in self.originals.items()}
        for mod in [m for name, m in list(sys.modules.items()) if name.startswith("bulletproofs_plus_tpu_torch") and m]:
            for attr, value in list(vars(mod).items()):
                if id(value) in self.originals and value is self.originals[id(value)][1]:
                    self.patched.append((mod, attr, value))
                    setattr(mod, attr, wrappers[id(value)])
        return self

    def __exit__(self, *exc):
        for mod, attr, value in self.patched:
            setattr(mod, attr, value)
        return False


def _prove_copies(torch, prove) -> dict:
    """One prove under torch.profiler: its device-to-host copies (the
    trace's "Memcpy DtoH" operations), which must be 1, and T1's device time
    and launches there."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    events = prof.events()
    copies = sum(e.name.startswith("Memcpy DtoH") for e in events)
    t1 = [e for e in events if "prove_transcript_kernel" in e.name and "CUDA" in str(getattr(e, "device_type", ""))]
    if copies != 1:
        raise AssertionError(f"prove: {copies} device-to-host copies, want 1")
    return {"device_to_host_copies": copies, "t1_device_ms": sum(e.time_range.elapsed_us() for e in t1) / 1e3,
            "t1_device_launches": len(t1)}


M4_BATCH = 64  # the aggregated prove: 64 statements of four 64-bit commitments, extension degree 5


def _prove_m4(torch, bp, hr) -> dict:
    """64 x (64-bit, m = 4, degree 5) statements proved on the card (8
    rounds, mn = 256): lanes 0 and 63 byte for byte and their final
    transcript states against the port's sequential `prove_with_rng` fed the
    same lane's RNG stream, the batch verified on the card, and the launches.
    An aggregated statement takes no seed nonce (the reference refuses mask
    recovery there), so this prove is unseeded; the seeded arm is the
    128-proof prove's."""
    import numpy as np

    from bulletproofs_plus_tpu_torch.native import cuda

    pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(5))
    params = bp.RangeParameters.init(64, 4, pc)
    rs = random.Random(464)
    openings = [[bp.CommitmentOpening(rs.randrange(2**64), [rs.randrange(1, hr.L) for _ in range(5)]) for _ in range(4)]
                for _ in range(M4_BATCH)]
    statements = [bp.RangeStatement.init(params, [pc.commit(o.v, o.r) for o in ops], [None] * 4) for ops in openings]
    witnesses = [bp.RangeWitness.init(ops) for ops in openings]
    try:
        bp.RangeStatement.init(params, statements[0].commitments, [None] * 4, seed_nonce=1)
        raise AssertionError("an aggregated statement took a seed nonce")
    except bp.InvalidArgument as exc:
        seeded = f"refused: {exc}"
    t0 = time.perf_counter()
    tables = params.bp_gens.halved_tables_joined(2 * 256, pc, "cuda")  # built before the clock starts
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ts = [bp.Transcript(b"m4") for _ in range(M4_BATCH)]
    cuda.reset_launches()
    t0 = time.perf_counter()
    proofs = bp.RangeProof.prove_batch_with_rng(ts, statements, witnesses, bp.SeededRng(11), device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: cuda.launches[k] for k in PROVE_KERNELS}
    want = {**PROVE_LAUNCHES, "prove_round": 8, "fixed_acc": 11, "fixed_fold": 11, "double_compress": 10,
            "prove_transcript": 10}
    if counts != want or any(cuda.launches[k] for k in OFF_PROVE):
        raise AssertionError(f"m4 prove: expected launches {want}, got {counts}")
    copies = _prove_copies(torch, lambda: bp.RangeProof.prove_batch_with_rng(
        [bp.Transcript(b"m4") for _ in range(M4_BATCH)], statements, witnesses, bp.SeededRng(11), device="cuda"))
    for lane in (0, M4_BATCH - 1):
        seq_t = bp.Transcript(b"m4")
        seq = bp.RangeProof.prove_with_rng(seq_t, statements[lane], witnesses[lane], _prover_inputs().LaneRng(11, lane),
                                           msm_backend="device", device="cuda")
        state = [np.asarray(t.strobe.state).tobytes() for t in (seq_t, ts[lane])]
        if seq.to_bytes() != proofs[lane].to_bytes() or state[0] != state[1]:
            raise AssertionError(f"m4 prove: lane {lane} differs from the sequential prover's proof or state")
    verdicts = bp.RangeProof.verify_batch([bp.Transcript(b"m4") for _ in range(M4_BATCH)], statements, proofs,
                                          bp.VerifyAction.VERIFY_ONLY, device="cuda")
    if verdicts != [None] * M4_BATCH:
        raise AssertionError("m4 prove: the batch did not verify")
    return {"proofs": M4_BATCH, "m": 4, "bits": 64, "deg": 5, "rounds": 8, "seconds": seconds, "launches": counts,
            "halved_tables_build_s": build_s, "halved_tables_bytes": tables.numel() * 4,
            "lanes_equal_to_sequential": [0, M4_BATCH - 1], "verified": M4_BATCH, "seeded": seeded, **copies}


def phase_prove(torch, bp, hr, params, cells, launches: dict) -> dict:
    """128 x 64-bit proofs through `prove_batch_with_rng` on the card, lane 0
    being golden cell 3, then verified on the card by the port itself; no
    plain field or point function runs on a CUDA tensor during the prove;
    then the aggregated prove (`_prove_m4`)."""
    from bulletproofs_plus_tpu_torch.native import cuda

    cell = next(c for c in cells if c["seed"] == 3)
    pc, seed = params.pc_gens, cell["seed"]
    statements, witnesses, blindings = _prove_inputs(bp, hr, params, cell)

    def transcripts():
        return [bp.Transcript(b"golden") for _ in range(PROVE_BATCH)]

    # the halved generators' tables, built and timed in the kernels phase, are cached in `params`: no prove below
    # builds them
    params.bp_gens.halved_tables_joined(2 * cell["bits"], pc, "cuda")
    out = {"proofs": PROVE_BATCH}

    seeded = statements(True)
    cuda.reset_launches()
    t0 = time.perf_counter()
    with _PlainCalls() as plain:
        proofs = bp.RangeProof.prove_batch_with_rng(transcripts(), seeded, witnesses, bp.SeededRng(seed),
                                                    device="cuda")
        torch.cuda.synchronize()
    out["first_s"] = time.perf_counter() - t0
    counts = {k: cuda.launches[k] for k in PROVE_KERNELS}
    if counts != PROVE_LAUNCHES or any(cuda.launches[k] for k in OFF_PROVE):
        raise AssertionError(f"prove: expected launches {PROVE_LAUNCHES}, got {dict(cuda.launches)}")
    if plain.counts or not plain.patched:
        raise AssertionError(f"prove: plain field or point functions ran on CUDA tensors: {plain.counts} "
                             f"({len(plain.patched)} names wrapped)")
    from bulletproofs_plus_tpu_torch.ops import field

    zero = torch.zeros((1, 16), dtype=torch.int64, device="cuda")
    with _PlainCalls() as control:  # the counter's own check: one plain call on the card, counted
        field.add_l(zero, zero)
    if control.counts != {"ops.field.add_l": 1}:
        raise AssertionError(f"prove: the plain-call counter missed a call on the card: {control.counts}")
    out["plain_calls_on_cuda"] = {"counts": plain.counts, "names_wrapped": len(plain.patched)}
    launches.update(counts, compress=cuda.launches["compress"])
    out["launches"] = dict(cuda.launches)
    out.update(_prove_copies(torch, lambda: bp.RangeProof.prove_batch_with_rng(
        transcripts(), seeded, witnesses, bp.SeededRng(seed), device="cuda")))
    if proofs[0].to_bytes().hex() != cell["proof"]:
        raise AssertionError("prove: lane 0 is not golden proof 3")
    masks = bp.RangeProof.verify_batch(transcripts(), seeded, proofs, bp.VerifyAction.RECOVER_AND_VERIFY, device="cuda")
    if [m.blindings() for m in masks] != blindings:
        raise AssertionError("prove: recovered masks differ from the blindings")
    out["golden_lane0"] = "equal"
    out["verified_seeded"] = len(masks)

    unseeded = statements(False)
    plain_proofs = bp.RangeProof.prove_batch_with_rng(transcripts(), unseeded, witnesses, bp.SeededRng(4), device="cuda")
    bp.RangeProof.verify_batch(transcripts(), unseeded, plain_proofs, bp.VerifyAction.VERIFY_ONLY, device="cuda")
    out["verified_unseeded"] = len(plain_proofs)

    samples = []
    for _ in range(5):
        ts = transcripts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bp.RangeProof.prove_batch_with_rng(ts, seeded, witnesses, bp.SeededRng(seed), device="cuda")
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    wall = statistics.median(samples)
    out.update(median_s=wall, samples_s=samples, proofs_per_s=PROVE_BATCH / wall, ms_per_proof=wall * 1e3 / PROVE_BATCH)
    out["m4_deg5"] = _prove_m4(torch, bp, hr)
    out["card"] = nvidia_smi()
    return out


# S1, D1, K7, K2, K3 and I1 on each rank's share of a sharded verify (R1 does not run: a mesh replays on the
# host); K5, K6 and C1 on its share of a sharded prove
SHARDED_VERIFY_KERNELS = ("scalar_pass", "decompress", "dyn_acc_signed", "lane_fold", "horner", "is_identity")
SHARDED_MSM_LANES = 64
COLLECTIVE_TIMEOUT_S = 300


def _sharded_rank(rank: int, world: int, backend: str, store: str, out_dir: str) -> None:
    """One rank of the `sharded` phase: joins the process group (gloo ranks
    share card 0, NCCL rank r takes card r), builds the "dp" mesh and runs
    `_sharded_checks`, with every collective timed to its end on the card;
    writes what it saw to out_dir/rank<r>.json.  Any failed check raises."""
    import datetime

    import torch
    import torch.distributed as dist

    from bulletproofs_plus_tpu_torch.parallel import global_dp_mesh

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    collectives = {"calls": 0, "seconds": 0.0}
    all_reduce = dist.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):  # the port's one collective
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = all_reduce(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        collectives["calls"] += 1
        collectives["seconds"] += time.perf_counter() - t0
        return work

    dist.all_reduce = timed_all_reduce
    try:
        out = _sharded_checks(torch, global_dp_mesh("cuda"), collectives)
    finally:
        dist.destroy_process_group()
    out.update(rank=rank, world=world, backend=backend, device=torch.cuda.current_device())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _sharded_checks(torch, mesh, collectives: dict) -> dict:
    """b64_m1_x256 verified with `mesh=` against the same batch unsharded
    (verdicts, a tampered batch, a non-canonical A in the last rank's shard),
    b64_m1_x128 proved with `mesh=` against the same lanes unsharded
    (proof bytes, final transcript states, golden proof 3 at lane 0),
    `verify_stream_pod` over two batches, `sharded_msm_fn` on 64 lanes
    against `host_msm`, and 5 sharded verifies timed beside 5 unsharded
    ones, with the time in collectives."""
    import bulletproofs_plus_tpu_torch as bp
    from bulletproofs_plus_tpu_torch.native import cuda
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints
    from bulletproofs_plus_tpu_torch.ops.msm import host_msm
    from bulletproofs_plus_tpu_torch.parallel import make_mesh, make_pod_stream, sharded_msm_fn, verify_stream_pod

    with open(GOLDEN) as f:
        cell = next(c for c in json.load(f) if c["seed"] == 3)
    statements, proofs = _tiled(bp, hr, cell, 256)
    out = {}

    def counted(fn):
        torch.cuda.synchronize()
        cuda.reset_launches()
        calls = collectives["calls"]
        result = fn()
        torch.cuda.synchronize()
        return result, dict(cuda.launches), collectives["calls"] - calls

    def verify(batch, **kw):
        return _outcome(bp, lambda: [None if m is None else m.blindings() for m in bp.RangeProof.verify_batch(
            [bp.Transcript(b"golden") for _ in batch], statements, batch, bp.VerifyAction.VERIFY_ONLY,
            device="cuda", **kw)])

    want = verify(proofs)
    got, launches, calls = counted(lambda: verify(proofs, mesh=mesh))
    if got != want or want != [None] * 256:
        raise AssertionError(f"sharded verify: {str(got)[:200]} (unsharded: {str(want)[:200]})")
    if (not all(launches.get(k) for k in SHARDED_VERIFY_KERNELS) or launches.get("replay")
            or any(launches.get(k) for k in K4_ENTRIES) or not calls):
        raise AssertionError(f"sharded verify: wrong launches {launches}, {calls} collectives")
    out["verify"] = {"proofs": 256, "equal_to_unsharded": True, "launches": launches, "collectives": calls}

    tampered = list(proofs)
    tampered[17] = bp.RangeProof.from_bytes(proofs[17].to_bytes())
    tampered[17].r1 = (tampered[17].r1 + 1) % hr.L
    bad = list(proofs)
    bad[200] = bp.RangeProof.from_bytes(proofs[200].to_bytes())
    bad[200].a = (hr.P + 1).to_bytes(32, "little")
    for label, batch, error in (("tampered_r1_17", tampered, "VerificationFailed"),
                                ("noncanonical_a_200", bad, "InvalidArgument")):
        got, want = verify(batch, mesh=mesh), verify(batch)
        if got != want or got[0] != error:
            raise AssertionError(f"sharded verify, {label}: {got} (unsharded: {want})")
        out[label] = f"{got[0]}: {got[1]}"

    params = statements[0].generators
    prove_statements, witnesses, _ = _prove_inputs(bp, hr, params, cell)
    seeded = prove_statements(True)

    def prove(**kw):
        transcripts = [bp.Transcript(b"golden") for _ in seeded]
        lanes = bp.RangeProof.prove_batch_with_rng(transcripts, seeded, witnesses, bp.SeededRng(cell["seed"]),
                                                   device="cuda", **kw)
        return [p.to_bytes().hex() for p in lanes], [bytes(t.strobe.state).hex() for t in transcripts]

    want = prove()
    got, launches, calls = counted(lambda: prove(mesh=mesh))
    if got != want or got[0][0] != cell["proof"]:
        raise AssertionError("sharded prove: proofs or transcript states differ from the unsharded prove's")
    if (not all(launches.get(k) for k in PROVE_KERNELS) or any(launches.get(k) for k in OFF_PROVE)
            or not calls):
        raise AssertionError(f"sharded prove: wrong launches {launches}, {calls} collectives")
    out["prove"] = {"lanes": PROVE_BATCH, "equal_to_unsharded": True, "golden_lane0": "equal", "launches": launches,
                    "collectives": calls}

    stream = make_pod_stream(statements * 2, proofs * 2, b"golden", batch_size=256)
    results = verify_stream_pod(stream, bp.VerifyAction.VERIFY_ONLY, mesh)
    if results != [[None] * 256] * 2:
        raise AssertionError("verify_stream_pod: a batch did not verify")
    out["stream_pod"] = {"batches": 2, "proofs": 512}

    rs = random.Random(9)
    scalars = [rs.randrange(hr.L) for _ in range(SHARDED_MSM_LANES)]
    points = [hr.point_mul(rs.randrange(1, hr.L), hr.BASEPOINT) for _ in range(SHARDED_MSM_LANES)]
    t0 = time.perf_counter()
    point = sharded_msm_fn(make_mesh("cuda"))(torch.as_tensor(pack_ints(scalars).astype("int64"), device="cuda"),
                                              ed.from_host(points, device="cuda"))
    torch.cuda.synchronize()
    msm_s = time.perf_counter() - t0
    if hr.compress(ed.to_host(point)) != hr.compress(host_msm(scalars, points)):
        raise AssertionError("sharded_msm_fn differs from host_msm")
    out["sharded_msm"] = {"lanes": SHARDED_MSM_LANES, "equal_to_host_msm": True, "seconds": msm_s}

    sharded_s, unsharded_s, collective_s = [], [], []
    for _ in range(5):
        before = collectives["seconds"]
        sharded_s.append(median_ms(lambda: verify(proofs, mesh=mesh), 1) / 1e3)
        collective_s.append(collectives["seconds"] - before)
        unsharded_s.append(median_ms(lambda: verify(proofs), 1) / 1e3)
    out["timing"] = {"sharded_median_s": statistics.median(sharded_s), "unsharded_median_s": statistics.median(unsharded_s),
                     "collectives_median_s": statistics.median(collective_s), "sharded_samples_s": sharded_s,
                     "unsharded_samples_s": unsharded_s, "collectives_samples_s": collective_s}
    return out


def phase_sharded(torch, launches: dict) -> dict:
    """parallel/ on the card: two gloo ranks sharing card 0, then NCCL (a
    world of one on a one-card machine, two ranks on two cards where there
    are two), each rank running `_sharded_checks`.  A rank that fails raises
    out of the spawn and fails the phase."""
    import tempfile

    import torch.multiprocessing as mp

    count = torch.cuda.device_count()
    runs = [("gloo", 2, "two ranks sharing cuda:0")]
    runs.append(("nccl", 2, "two ranks on two cards") if count >= 2 else
                ("nccl", 1, "one rank: NCCL takes a card a rank, and this machine has one"))
    out = {"card": nvidia_smi(), "device_count": count}
    for backend, world, what in runs:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            mp.spawn(_sharded_rank, args=(world, backend, os.path.join(tmp, "store"), tmp), nprocs=world, join=True)
            seconds = time.perf_counter() - t0
            ranks = []
            for rank in range(world):
                with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                    ranks.append(json.load(f))
        out[f"{backend}_world{world}"] = {"ran": what, "seconds": seconds, "ranks": ranks}
    # I1's path: the all-reduced point of a sharded verify (a single-host verify takes K3's verdict)
    launches["is_identity"] = out["gloo_world2"]["ranks"][0]["verify"]["launches"]["is_identity"]
    return out


def phase_reject(bp, hr, cells) -> dict:
    cell = next(c for c in cells if c["seed"] == 3)
    statements, proofs = _tiled(bp, hr, cell, 256)
    raw = bytearray(proofs[0].to_bytes())
    r1_at = 1 + 32 * len(proofs[0].d1) + 3 * 32
    raw[r1_at] ^= 1
    tampered = list(proofs)
    tampered[17] = bp.RangeProof.from_bytes(bytes(raw))
    try:
        _verify(bp, statements, tampered)
        raise AssertionError("tampered r1 was accepted")
    except bp.VerificationFailed:
        pass
    bad = bp.RangeProof.from_bytes(proofs[0].to_bytes())
    bad.a = (hr.P + 1).to_bytes(32, "little")  # s >= p: not canonical
    noncanon = list(proofs)
    noncanon[200] = bad
    want = "Member 'a' was not the canonical encoding of a point"
    try:
        _verify(bp, statements, noncanon)
        raise AssertionError("non-canonical a was accepted")
    except bp.InvalidArgument as exc:
        if str(exc) != want:
            raise AssertionError(f"non-canonical a: got {exc!r}")
    return {"tampered_r1": "VerificationFailed", "noncanonical_a": want}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import bulletproofs_plus_tpu_torch as bp
        from bulletproofs_plus_tpu_torch.native import cuda
        from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    with open(GOLDEN) as f:
        cells = json.load(f)

    # the prover's parameters: 64 bits, one commitment, extension degree 1 (golden cell 3's)
    params = bp.RangeParameters.init(64, 1, bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(1)))
    rows, launches, ptxas = {}, {}, {}
    phases = (
        ("build", lambda: phase_build(torch, cuda, ptxas)),
        ("kernels", lambda: phase_kernels(torch, bp, params, cells, rows, ptxas)),
        ("golden", lambda: phase_golden(bp, hr, cells)),
        ("host_engine", lambda: phase_host_engine(torch, bp, hr, cells)),
        ("main", lambda: phase_main(torch, bp, hr, cells, launches)),
        ("mixed", lambda: phase_mixed(torch, bp, hr, cells)),
        ("pipelined", lambda: phase_pipelined(torch, bp, hr, cells)),
        ("prove", lambda: phase_prove(torch, bp, hr, params, cells, launches)),
        ("reject", lambda: phase_reject(bp, hr, cells)),
        ("sharded", lambda: phase_sharded(torch, launches)),
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0, **result})

    # kernel -> (source under csrc/, the TPU kernel it replaces)
    kernels = {
        "dyn_acc": ("msm.cu", "bulletproofs_plus_tpu/ops/pallas_msm.py:336"),
        "lane_fold": ("msm.cu", "bulletproofs_plus_tpu/ops/pallas_msm.py:422"),
        "horner": ("msm.cu", "bulletproofs_plus_tpu/ops/pallas_msm.py:432"),
        "pow_p58": ("pow.cu", "bulletproofs_plus_tpu/ops/pallas_pow.py:78"),
        "fixed_acc": ("fixed.cu", "bulletproofs_plus_tpu/ops/pallas_msm.py:536"),
        "fixed_fold": ("fixed.cu", "bulletproofs_plus_tpu/ops/pallas_msm.py:567"),
        "dyn_acc_signed": ("msm.cu", "bulletproofs_plus_tpu/ops/pallas_msm.py:340"),
        "replay": ("replay.cu", "bulletproofs_plus_tpu/models/replay_device.py:101"),
        "scalar_pass": ("scalar_pass.cu", "bulletproofs_plus_tpu/models/verifier_kernels.py:130"),
        "decompress": ("ristretto.cu", "bulletproofs_plus_tpu/models/verifier_kernels.py:263"),
        "compress": ("ristretto.cu", "bulletproofs_plus_tpu/ops/ristretto.py:47"),
        "double_compress": ("ristretto.cu", "bulletproofs_plus_tpu/ops/ristretto.py:47"),
        "is_identity": ("ristretto.cu", "bulletproofs_plus_tpu/ops/ristretto.py:103"),
        **{k: ("prover.cu", "bulletproofs_plus_tpu/models/prover_device.py:90") for k in PROVER_KERNELS},
        "prove_transcript": ("transcript.cu", "bulletproofs_plus_tpu/models/prover_device.py:134"),
    }
    launches["pow_p58"] = launches["decompress"] + launches["compress"]  # K4's chain, inline in D1 and C1
    table = [
        {"name": k, "route": "cuda", "source": f"bulletproofs_plus_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": launches[k], "max_abs_err": rows[k]["max_abs_err"],
         "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
         "bound_by": rows[k]["bound_by"], "library_ms": None,
         **{extra: rows[k][extra] for extra in ("chain_ms", "serial_chain_ms", "graph_ms", "entry", "pow_p58_ms",
                                                "tile", "blocks", "threads", "waves", "blocks_per_sm", "registers",
                                                "spill_stores", "spill_loads", "lanes", "permutations",
                                                "spans", "warps", "perm_ns", "replay_fn_ms", "by_shape",
                                                "sc_mul_ns", "sc_inv_ns", "fe_inv_ns", "ptxas", "one_lane_graph_ms",
                                                "four_lanes_graph_ms", "products", "inversions", "round", "by_round",
                                                "phases", "stamped_graph_ms", "chain4_ms", "fe_mul4_ns", "fe_sqr4_ns",
                                                "graph_ms_without_tail", "phase_graph_ms", "launches_per_prove",
                                                "inversions", "draws", "without_inversions_graph_ms",
                                                "sc_inv_var_ns", "operations", "inversion_ops_var",
                                                "bound_ms_ct", "operations_ct")
            if extra in rows[k]}}
        for k, (source, replaces) in kernels.items()
    ]
    print(nvidia_smi())
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
