"""S1 wrapper: the batch verifier's scalar pass on GF(l), through
csrc/scalar_pass.cu.

`scalar_pass` launches S1 on CUDA tensors: S1a (`scalar_proof_kernel`, a
thread a proof) writes each proof's dynamic scalars and a scratch table of
the factors its lanes need, S1b (`scalar_lane_kernel`, a block a generator
lane, then a block for each base point) sums the lanes' terms over the
batch.  Its signature and outputs are those of the plain version,
models/verifier_kernels.py's `scalar_pass_plain`, which
`verifier_kernels.scalar_pass` takes for CPU tensors; every output is
canonical, so the two agree limb for limb.  Inputs are int64 radix-2^16
limbs, each limb below 2^16 (ops/field.py's layout).

`scalar_pass_model` runs S1's two programs in plain Python on
ops/scalar_model.py, word for word as the kernels run them (S1a's loops and
scratch columns, S1b's threads striding over the proofs and the block's tree
of sums); the CPU tests hold it against the plain version.
`mul_latency_probe` (one warp, a chain of dependent `sc_mul_l`) counts no
launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..native import cuda
from . import scalar_model as SM

MAX_ROUNDS = 30  # S1_MAX_ROUNDS: mn = 2^rounds
PROOF_THREADS = 32  # S1a's block: one warp, a proof a thread
LANE_THREAD_CHOICES = (32, 64, 128, 256)  # S1b's block sizes
COL_A, COL_D, COL_C, COL_H, COL_CHSQ = range(5)  # scratch columns, then y^-(2^b), G_j, w d1_k


def scratch_columns(rounds: int, m: int, deg: int) -> int:
    return COL_CHSQ + 2 * rounds + m + deg


def lane_threads(batch: int) -> int:
    """S1b's threads a block: the batch rounded up to a power of two, from 32 to 256."""
    return next((t for t in LANE_THREAD_CHOICES if t >= batch), LANE_THREAD_CHOICES[-1])


def check_shape(batch: int, rounds: int, m: int, bit_length: int, max_mn: int) -> None:
    """What S1 takes: mn = m * bit_length = 2^rounds, both powers of two, at most 2^MAX_ROUNDS."""
    mn = m * bit_length
    if batch < 1:
        raise ValueError("scalar_pass: expected a non-empty batch")
    if m & (m - 1) or bit_length & (bit_length - 1) or not 1 <= bit_length <= 64 or rounds > MAX_ROUNDS:
        raise ValueError(f"scalar_pass: m {m} and bit length {bit_length} must be powers of two, "
                         f"the bit length at most 64, rounds at most {MAX_ROUNDS}")
    if mn != 1 << rounds:
        raise ValueError("mn must be 2^rounds")
    if max_mn < mn:
        raise ValueError(f"scalar_pass: max_mn {max_mn} below mn {mn}")


def scalar_pass(y, z, round_es, e, weight, r1, s1, d1, min_values, *, m: int, bit_length: int, max_mn: int):
    """S1 on CUDA tensors: the plain version's inputs and outputs, two
    launches on the current stream, counted once as `scalar_pass`."""
    B = y.shape[0]
    rounds, deg = round_es.shape[1], d1.shape[1]
    check_shape(B, rounds, m, bit_length, max_mn)
    inputs = {"y": (y, ()), "z": (z, ()), "round_es": (round_es, (rounds,)), "e": (e, ()), "weight": (weight, ()),
              "r1": (r1, ()), "s1": (s1, ()), "d1": (d1, (deg,)), "min_values": (min_values, (m,))}
    # the replay hands its challenges over as views of one tensor: S1 takes each input contiguous
    ins = [t.contiguous() for t, _ in inputs.values()]
    for (name, (_, inner)), t in zip(inputs.items(), ins):
        cuda.require(t, f"scalar_pass {name}", (B,) + inner + (16,))
    dev = y.device
    if any(t.device != dev for t in ins):
        raise ValueError("scalar_pass: expected every input on one device")
    new = functools.partial(torch.empty, dtype=torch.int64, device=dev)
    commit, a1_s, b_s, a_s = new((B, m, 16)), new((B, 16)), new((B, 16)), new((B, 16))
    li_s, ri_s = new((B, rounds, 16)), new((B, rounds, 16))
    gi, hi, gb, hb = new((max_mn, 16)), new((max_mn, 16)), new((deg, 16)), new((16,))
    scratch = torch.empty((scratch_columns(rounds, m, deg), B, 8), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = cuda.lib("scalar").bppt_scalar_pass(
            *(t.data_ptr() for t in ins), B, rounds, m, bit_length, deg, max_mn,
            commit.data_ptr(), a1_s.data_ptr(), b_s.data_ptr(), a_s.data_ptr(), li_s.data_ptr(), ri_s.data_ptr(),
            gi.data_ptr(), hi.data_ptr(), gb.data_ptr(), hb.data_ptr(), scratch.data_ptr(), lane_threads(B),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("scalar", status, "scalar_pass")
    cuda.launches["scalar_pass"] += 1
    return gi, hi, gb, hb, commit, a1_s, b_s, a_s, li_s, ri_s


def mul_latency_probe(x: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, lane t a chain of `iters` dependent products acc * x[t]
    from acc = x[t] ((32, 16) int64 limbs on a CUDA device): x^(iters + 1)
    mod l.  Counts no launch."""
    cuda.require(x, "mul_latency_probe input", (32, 16))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = cuda.lib("scalar").bppt_scalar_latency(x.data_ptr(), out.data_ptr(), iters,
                                                        torch.cuda.current_stream().cuda_stream)
    cuda.check("scalar", status, "mul_latency_probe")
    return out


# ---------------------------------------------------------------------------
# The kernels' programs in Python, on ops/scalar_model.py
# ---------------------------------------------------------------------------


def _words(limbs) -> list:
    return [int(limbs[2 * k]) | int(limbs[2 * k + 1]) << 16 for k in range(8)]


def _limbs(words) -> list:
    return [v for w in words for v in (w & 0xFFFF, w >> 16)]


def _small(v: int) -> list:
    return [v] + [0] * 7


def _proof_model(y, z, es, e, w, r1, s1, d1, mins, m: int, n: int):
    """S1a for one proof, on 8-word values: (commit, a1_s, b_s, a_s, li, ri,
    {scratch column: value})."""
    rounds, deg = len(es), len(d1)
    col_yinv, col_g = COL_CHSQ + rounds, COL_CHSQ + 2 * rounds
    col_w = col_g + m
    zero, one = _small(0), _small(1)
    cols = {}
    e_sq = SM.sqr_l(e)
    a1_s = SM.sub_l(zero, SM.mul_l(w, e))
    b_s = SM.sub_l(zero, w)
    a_s = SM.sub_l(zero, SM.mul_l(w, e_sq))
    li, ri, prefix = [None] * rounds, [None] * rounds, []
    acc = None
    for j in range(rounds):
        u = SM.sqr_l(es[j])
        cols[COL_CHSQ + j] = u
        li[j] = SM.mul_l(a_s, u)
        acc = list(es[j]) if j == 0 else SM.mul_l(acc, es[j])
        prefix.append(acc)
    acc = list(y) if rounds == 0 else SM.mul_l(acc, y)
    prefix.append(acc)
    ym1 = SM.sub_l(y, one)
    acc = SM.inv_l(SM.mul_l(acc, ym1))
    y1_inv = SM.mul_l(acc, prefix[rounds])
    acc = SM.mul_l(acc, ym1)
    if rounds == 0:
        y_inv, chinv = acc, one
    else:
        y_inv = SM.mul_l(acc, prefix[rounds - 1])
        acc = SM.mul_l(acc, y)
        chinv = acc
        for j in range(rounds - 1, 0, -1):
            ri[j] = SM.mul_l(a_s, SM.sqr_l(SM.mul_l(acc, prefix[j - 1])))
            acc = SM.mul_l(acc, es[j])
        ri[0] = SM.mul_l(a_s, SM.sqr_l(acc))
    ynm, t = list(y), y_inv
    for j in range(rounds):
        cols[col_yinv + j] = t
        if j + 1 < rounds:
            t = SM.sqr_l(t)
        ynm = SM.sqr_l(ynm)
    ysum = SM.mul_l(SM.mul_l(y, SM.sub_l(ynm, one)), y1_inv)
    zsq = SM.sqr_l(z)
    q = SM.mul_l(SM.mul_l(e_sq, SM.mul_l(ynm, y)), w)
    gq = SM.mul_l(SM.mul_l(w, e_sq), ynm)
    zp, zsum, msum, commit = zsq, zero, zero, []
    for j in range(m):
        zsum = SM.add_l(zsum, zp)
        c = SM.sub_l(zero, SM.mul_l(q, zp))
        commit.append(c)
        msum = SM.add_l(msum, SM.mul_l(c, mins[j]))
        cols[col_g + j] = SM.mul_l(gq, zp)
        if j + 1 < m:
            zp = SM.mul_l(zp, zsq)
    two_n_1 = (1 << n) - 1
    zsum = SM.mul_l(zsum, [two_n_1 & SM.M32, two_n_1 >> 32] + [0] * 6)
    t = SM.mul_l(SM.mul_l(SM.mul_l(ynm, y), z), zsum)
    t = SM.mul_l(e_sq, SM.add_l(t, SM.mul_l(SM.sub_l(zsq, z), ysum)))
    t = SM.mul_l(w, SM.add_l(SM.mul_l(SM.mul_l(r1, y), s1), t))
    cols[COL_H] = SM.sub_l(t, msum)
    u = SM.mul_l(SM.mul_l(w, e), chinv)
    cols[COL_A] = SM.mul_l(u, r1)
    cols[COL_D] = SM.mul_l(u, s1)
    cols[COL_C] = SM.mul_l(SM.mul_l(w, e_sq), z)
    for k in range(deg):
        cols[col_w + k] = SM.mul_l(w, d1[k])
    return commit, a1_s, b_s, a_s, li, ri, cols


def _block_sum(per_thread: list) -> list:
    """The block's tree of modular sums over its threads' values."""
    vals = list(per_thread)
    s = len(vals) >> 1
    while s:
        for t in range(s):
            vals[t] = SM.add_l(vals[t], vals[t + s])
        s >>= 1
    return vals[0]


def _lane_model(cols: list, i: int, rounds: int, n: int, threads: int):
    """S1b's block for lane i < mn: (g_i, h_i) summed over the batch."""
    col_yinv, col_g = COL_CHSQ + rounds, COL_CHSQ + 2 * rounds
    two_k = [0] * 8
    two_k[(i % n) >> 5] = 1 << ((i % n) & 31)
    g, h = [_small(0)] * threads, [_small(0)] * threads
    for t in range(threads):
        for b in range(t, len(cols), threads):
            c = cols[b]
            yi = pi = pr = None
            for k in range(rounds):
                chsq = c[COL_CHSQ + rounds - 1 - k]
                if (i >> k) & 1:
                    yi = c[col_yinv + k] if yi is None else SM.mul_l(yi, c[col_yinv + k])
                    pi = chsq if pi is None else SM.mul_l(pi, chsq)
                else:
                    pr = chsq if pr is None else SM.mul_l(pr, chsq)
            u = c[COL_A]
            if yi is not None:
                u = SM.mul_l(u, yi)
            if pi is not None:
                u = SM.mul_l(u, pi)
            g[t] = SM.add_l(g[t], SM.add_l(u, c[COL_C]))
            h[t] = SM.sub_l(h[t], c[COL_C])
            u = c[COL_D] if pr is None else SM.mul_l(c[COL_D], pr)
            h[t] = SM.add_l(h[t], u)
            u = SM.mul_l(c[col_g + i // n], two_k)
            if yi is not None:
                u = SM.mul_l(u, yi)
            h[t] = SM.sub_l(h[t], u)
    return _block_sum(g), _block_sum(h)


def scalar_pass_model(y, z, round_es, e, weight, r1, s1, d1, min_values, *, m: int, bit_length: int, max_mn: int):
    """S1's programs on numpy int64 limb arrays (the plain version's shapes):
    S1a proof by proof, then S1b block by block at the threads the wrapper
    picks.  Returns the plain version's ten outputs as numpy int64 limbs."""
    B, rounds = y.shape[0], round_es.shape[1]
    deg = d1.shape[1]
    check_shape(B, rounds, m, bit_length, max_mn)
    mn, threads = m * bit_length, lane_threads(B)
    per_proof = [
        _proof_model(_words(y[b]), _words(z[b]), [_words(v) for v in round_es[b]], _words(e[b]),
                     _words(weight[b]), _words(r1[b]), _words(s1[b]), [_words(v) for v in d1[b]],
                     [_words(v) for v in min_values[b]], m, bit_length)
        for b in range(B)
    ]
    cols = [p[6] for p in per_proof]
    lanes = [_lane_model(cols, i, rounds, bit_length, threads) for i in range(mn)]
    zero = _small(0)
    gi = [g for g, _ in lanes] + [zero] * (max_mn - mn)
    hi = [h for _, h in lanes] + [zero] * (max_mn - mn)
    col_w = COL_CHSQ + 2 * rounds + m
    gb = [_block_sum([_column_sum(cols[t::threads], col_w + k) for t in range(threads)]) for k in range(deg)]
    hb = _block_sum([_column_sum(cols[t::threads], COL_H) for t in range(threads)])

    def arr(values, shape):
        return np.asarray([_limbs(v) for v in values], dtype=np.int64).reshape(shape + (16,))

    return (arr(gi, (max_mn,)), arr(hi, (max_mn,)), arr(gb, (deg,)), arr([hb], (1,))[0],
            arr([c for p in per_proof for c in p[0]], (B, m)), arr([p[1] for p in per_proof], (B,)),
            arr([p[2] for p in per_proof], (B,)), arr([p[3] for p in per_proof], (B,)),
            arr([v for p in per_proof for v in p[4]], (B, rounds)), arr([v for p in per_proof for v in p[5]], (B, rounds)))


def _column_sum(cols: list, col: int) -> list:
    """One thread's sum of a scratch column over its proofs."""
    acc = _small(0)
    for c in cols:
        acc = SM.add_l(acc, c[col])
    return acc
