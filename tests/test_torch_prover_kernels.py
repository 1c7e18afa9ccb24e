"""The prover's kernels P1-P4 (csrc/prover.cu) through their plain twins on
the CPU (models/prover_kernels.py `*_plain`, which the dispatchers run on
CPU tensors), against Python integers mod l and, for P4, host_ristretto's
points.

The integer references follow the JAX package's fused prover
(bulletproofs_plus_tpu/models/prover_device.py:186-405) in its own form:
vectors spread over all mn lanes and folded by rolls, each round's lane
scalars interleaved and gathered by its permutation `perm`, written out here
as that program writes it.  The twins keep the vectors compact and write the
scalars in that order directly.  Inputs are seeded (tests/torch_prover_inputs.py)
at B = 2, mn in {8, 16}, degree 1 and 6.  Tolerance: exact -- every scalar
output is canonical, and points are compared by their encodings.  The
kernels themselves run only on a card (tests/test_torch_cuda.py -k prove).
"""

import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs
from torch_prover_inputs import final_inputs, prep_inputs, responses_inputs, round_inputs, to_device

L = hr.L
B = 2
SHAPES = [(1, 8, 1), (1, 8, 6), (2, 8, 1), (2, 8, 6)]  # (m, bit length, degree): mn 8 and 16
SHAPE_IDS = ["mn8_deg1", "mn8_deg6", "mn16_deg1", "mn16_deg6"]

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def _ints(t):
    """(..., 16) limbs -> nested lists of ints (also for numpy arrays)."""
    arr = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if arr.ndim == 1:
        return int_from_limbs(arr)
    return [_ints(row) for row in arr]


def _jax_perm(mn, n):
    """The lane permutation of one round as the JAX program builds it."""
    lanes = np.arange(mn)
    hi_np = lanes % (2 * n) >= n
    return np.concatenate([2 * lanes[hi_np], 2 * lanes[~hi_np] + 1, 2 * lanes[~hi_np], 2 * lanes[hi_np] + 1])


def _spread_fold(av, bv, g, h, alpha, fold, y_pow, y_inv_n, r):
    """One proof's fold at the end of round r - 1, in the JAX program's spread
    form (rolls by that round's n), on ints."""
    mn = len(g)
    e, e_inv, dl, dr = fold
    n = mn >> r
    y_n, y_n_inv = y_pow[n - 1], y_inv_n[r - 1]
    hi = [i % (2 * n) >= n for i in range(mn)]
    up = lambda v, i: v[(i - n) % mn]  # noqa: E731  torch.roll(v, n)
    down = lambda v, i: v[(i + n) % mn]  # noqa: E731  torch.roll(v, -n)
    lo_a = [up(av, i) if hi[i] else av[i] for i in range(mn)]
    hi_a = [av[i] if hi[i] else down(av, i) for i in range(mn)]
    lo_b = [up(bv, i) if hi[i] else bv[i] for i in range(mn)]
    hi_b = [bv[i] if hi[i] else down(bv, i) for i in range(mn)]
    av = [(lo_a[i] * e + hi_a[i] * e_inv * y_n) % L for i in range(mn)]
    bv = [(lo_b[i] * e_inv + hi_b[i] * e) % L for i in range(mn)]
    g = [g[i] * (e * y_n_inv if hi[i] else e_inv) % L for i in range(mn)]
    h = [h[i] * (e_inv if hi[i] else e) % L for i in range(mn)]
    alpha = [(alpha[k] + dl[k] * e * e + dr[k] * e_inv * e_inv) % L for k in range(len(alpha))]
    return av, bv, g, h, alpha


def _spread(v, mn):
    return [v[i % len(v)] for i in range(mn)]


def _fold_ints(inp, b):
    f = inp["fold"]
    return None if f is None else tuple(_ints(x[b]) for x in f)


@pytest.mark.parametrize("m, n, deg", SHAPES, ids=SHAPE_IDS)
def test_prove_prep_plain_matches_integers(m, n, deg):
    """P1's twin: a_i = bit - z, b_i = (bit - 1) + z^(2(j+1)) 2^k y^(mn-i) + z,
    y^1..y^(mn+1), y^-n of each round, alpha + sum_j z^(2(j+1)) y^(mn+1) r_jk."""
    mn = m * n
    inp = prep_inputs(B, m, n, deg, seed=mn + deg)
    a, b, y_pows, y_inv_n, alpha = PK.prove_prep(**to_device(inp, torch, "cpu"), bit_length=n)
    for lane in range(B):
        y, z, y_inv = (_ints(inp[k][lane]) for k in ("y", "z", "y_inv"))
        bits = inp["bits"][lane].tolist()
        z2 = [pow(z, 2 * (j + 1), L) for j in range(m)]
        assert _ints(y_pows[lane]) == [pow(y, k, L) for k in range(1, mn + 2)]
        assert _ints(y_inv_n[lane]) == [pow(y_inv, mn >> (r + 1), L) for r in range(mn.bit_length() - 1)]
        assert _ints(a[lane]) == [(bit - z) % L for bit in bits]
        assert _ints(b[lane]) == [(bits[i] - 1 + z2[i // n] * 2 ** (i % n) * pow(y, mn - i, L) + z) % L
                                  for i in range(mn)]
        r_blind, alpha0 = _ints(inp["r_blind"][lane]), _ints(inp["alpha0"][lane])
        assert _ints(alpha[lane]) == [(alpha0[k] + sum(z2[j] * pow(y, mn + 1, L) * r_blind[j][k] for j in range(m))) % L
                                      for k in range(deg)]


@pytest.mark.parametrize("m, n, deg", SHAPES, ids=SHAPE_IDS)
def test_prove_round_plain_matches_integers(m, n, deg):
    """P2's twin at every round (a zero-free e in the folds): the fold, c_L
    and c_R, and the MSM scalars in the JAX program's `perm` order, then the
    Pedersen lanes [d, c] of each group; `round_lanes` names the lanes of
    the joined table."""
    mn = m * n
    for r in range(mn.bit_length() - 1):
        inp = round_inputs(B, m, n, deg, r, seed=10 * r + mn + deg, zero_free=True)
        a, b, g, h, alpha, scalars = PK.prove_round(
            *(to_device(inp, torch, "cpu")[k] for k in ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n",
                                                      "d_l", "d_r")), r=r)
        half = mn >> (r + 1)
        perm = _jax_perm(mn, half)
        assert np.array_equal(PK.round_perm(mn, r), perm)
        pedersen = list(range(2 * mn, 2 * mn + deg + 1))
        assert PK.round_lanes(mn, deg, r).tolist() == list(perm[:mn]) + pedersen + list(perm[mn:]) + pedersen
        for lane in range(B):
            y_pow, y_inv_n = _ints(inp["y_pows"][lane]), _ints(inp["y_inv_n"][lane])
            av, bv = _spread(_ints(inp["a"][lane]), mn), _spread(_ints(inp["b"][lane]), mn)
            gv = [1] * mn if r == 0 else _ints(inp["g"][lane])
            hv = [1] * mn if r == 0 else _ints(inp["h"][lane])
            al = _ints(inp["alpha"][lane])
            if r:
                av, bv, gv, hv, al = _spread_fold(av, bv, gv, hv, al, _fold_ints(inp, lane), y_pow, y_inv_n, r)
            assert all(av[i] == av[i % (2 * half)] and bv[i] == bv[i % (2 * half)] for i in range(mn))
            assert _ints(a[lane]) == av[: 2 * half] and _ints(b[lane]) == bv[: 2 * half]
            assert _ints(g[lane]) == gv and _ints(h[lane]) == hv and _ints(alpha[lane]) == al
            c_l = sum(av[j] * y_pow[j] * bv[j + half] for j in range(half)) % L
            c_r = sum(av[half + j] * y_pow[half + j] * bv[j] for j in range(half)) % L
            y_n, y_n_inv = y_pow[half - 1], y_inv_n[r]
            combined = []
            for i in range(mn):
                if i % (2 * half) >= half:
                    combined += [gv[i] * av[(i - half) % mn] * y_n_inv % L, hv[i] * bv[(i - half) % mn] % L]
                else:
                    combined += [gv[i] * av[(i + half) % mn] * y_n % L, hv[i] * bv[(i + half) % mn] % L]
            want = ([combined[p] for p in perm[:mn]] + _ints(inp["d_l"][lane]) + [c_l]
                    + [combined[p] for p in perm[mn:]] + _ints(inp["d_r"][lane]) + [c_r])
            assert _ints(scalars[lane]) == want, (r, lane)


@pytest.mark.parametrize("m, n, deg", SHAPES + [(1, 1, 2)], ids=SHAPE_IDS + ["mn1_no_rounds"])
def test_prove_final_plain_matches_integers(m, n, deg):
    """P3's first twin: the last fold (none without rounds), a0, b0, the A1
    MSM's scalars [g_i r, h_i s interleaved, d_mask, r y b0 + s y a0] and the
    B MSM's [eta, r y s]."""
    mn = m * n
    rounds = mn.bit_length() - 1
    inp = final_inputs(B, m, n, deg, seed=3 * mn + deg, zero_free=True)
    a1, brow, a0, b0, alpha = PK.prove_final(
        *(to_device(inp, torch, "cpu")[k] for k in ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s",
                                                  "s_s", "d_mask", "eta")))
    for lane in range(B):
        y_pow, y_inv_n = _ints(inp["y_pows"][lane]), _ints(inp["y_inv_n"][lane])
        av, bv = _spread(_ints(inp["a"][lane]), mn), _spread(_ints(inp["b"][lane]), mn)
        gv = _ints(inp["g"][lane]) if rounds else [1] * mn
        hv = _ints(inp["h"][lane]) if rounds else [1] * mn
        al = _ints(inp["alpha"][lane])
        if rounds:
            av, bv, gv, hv, al = _spread_fold(av, bv, gv, hv, al, _fold_ints(inp, lane), y_pow, y_inv_n, rounds)
        assert len(set(av)) == 1 and len(set(bv)) == 1  # one value left, on every lane
        r_s, s_s, y1 = _ints(inp["r_s"][lane]), _ints(inp["s_s"][lane]), y_pow[0]
        assert _ints(a0[lane]) == av[0] and _ints(b0[lane]) == bv[0] and _ints(alpha[lane]) == al
        static = [v for i in range(mn) for v in (gv[i] * r_s % L, hv[i] * s_s % L)]
        ry_ar = (r_s * y1 * bv[0] + s_s * y1 * av[0]) % L
        assert _ints(a1[lane]) == static + _ints(inp["d_mask"][lane]) + [ry_ar]
        assert _ints(brow[lane]) == _ints(inp["eta"][lane]) + [r_s * y1 * s_s % L]


@pytest.mark.parametrize("deg", [1, 6])
def test_prove_responses_plain_matches_integers(deg):
    """P3's second twin: r1 = r + a0 e, s1 = s + b0 e, d1 = eta + d e + alpha e^2."""
    inp = responses_inputs(B, deg, seed=deg)
    keys = ("r_s", "s_s", "a0", "b0", "eta", "d_mask", "alpha", "e")
    r1, s1, d1 = PK.prove_responses(*(to_device(inp, torch, "cpu")[k] for k in keys))
    for lane in range(B):
        v = {k: _ints(inp[k][lane]) for k in keys}
        e = v["e"]
        assert _ints(r1[lane]) == (v["r_s"] + v["a0"] * e) % L
        assert _ints(s1[lane]) == (v["s_s"] + v["b0"] * e) % L
        assert _ints(d1[lane]) == [(v["eta"][k] + v["d_mask"][k] * e + v["alpha"][k] * e * e) % L for k in range(deg)]


@pytest.fixture(scope="module")
def joined():
    """The joined tables over 32 generator lanes (bit length 8, two parties)
    and the Pedersen bases of degree 6, and the host generators."""
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(6))
    params = tbp.RangeParameters.init(8, 2, pc)
    table = params.bp_gens.fixed_tables_joined(32, pc, "cpu")
    assert tuple(table.shape) == (64, 16, 32 + 7, 24)
    return table, params.bp_gens.interleaved()[:32], params


def test_joined_tables_are_one_copy(joined):
    """The joined tables are cached as one tensor, with no sliced copy of
    their generator lanes kept beside them: their lanes are the sliced
    tables' followed by the Pedersen bases'."""
    table, _, params = joined
    bp_gens, pc = params.bp_gens, params.pc_gens
    assert not bp_gens._fixed_tables
    assert bp_gens.fixed_tables_joined(32, pc, "cpu") is table
    assert torch.equal(table[:, :, :8], bp_gens.fixed_tables_sliced(8, "cpu"))
    assert torch.equal(table[:, :, 32:], pc.device_base_tables("cpu"))


@pytest.mark.parametrize("mn", [8, 16])
def test_bit_sum_plain_matches_host_points(joined, mn):
    """P4's twin: start + sum_i (bit_i ? g_i : -h_i), from the tables'
    window 0, digit 1 entries, against host_ristretto; start read as K6
    leaves it (a transposed view) and contiguous."""
    table, gens, _ = joined
    rs = np.random.default_rng(mn)
    bits = rs.integers(0, 2, size=(B, mn)).astype(np.int64)
    bits[0] = 1  # every g
    bits[1, : mn // 2] = 0  # half of the h
    starts = [hr.point_mul(int(rs.integers(1, 2**62)), hr.BASEPOINT) for _ in range(B)]
    start = ed.from_host(starts, device="cpu")
    view = ed.PointArray(*(c.t().contiguous().t() for c in start))  # limb-major storage, (B, 16) view
    for pts in (start, view):
        got = PK.bit_sum(pts, torch.as_tensor(bits), table)
        for lane in range(B):
            want = starts[lane]
            for i in range(mn):
                want = hr.point_add(want, gens[2 * i] if bits[lane, i] else hr.point_neg(gens[2 * i + 1]))
            assert hr.compress(ed.to_host(ed.PointArray(*(c[lane] for c in got)))) == hr.compress(want)


def test_dispatch_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA device (here "meta") raises: no
    dispatcher falls back to the twin."""
    meta = lambda inp: to_device(inp, torch, "meta")  # noqa: E731
    p = meta(prep_inputs(B, 1, 8, 1, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        PK.prove_prep(**p, bit_length=8)
    rnd = meta(round_inputs(B, 1, 8, 1, 1, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        PK.prove_round(*(rnd[k] for k in ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")),
                       r=1)
    fin = meta(final_inputs(B, 1, 8, 1, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        PK.prove_final(*(fin[k] for k in ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s", "s_s",
                                          "d_mask", "eta")))
    res = meta(responses_inputs(B, 1, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        PK.prove_responses(*(res[k] for k in ("r_s", "s_s", "a0", "b0", "eta", "d_mask", "alpha", "e")))
    start = ed.identity((B,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        PK.bit_sum(start, torch.zeros((B, 8), dtype=torch.int64, device="meta"),
                   torch.zeros((64, 16, 16, 24), dtype=torch.int32, device="meta"))


def test_p3_launch_shapes_cover_every_output():
    """P3's host-side launch shapes (ops/cuda_prover.py) against what
    csrc/prover.cu takes, over mn 1 to 2,048, degrees 1 to 6 and batches 1
    to 1,025: the first entry's block is P2's, a multiple of 32 from 64 to
    544 (the C entry's range) whose TL = T - 32 lane threads stride over the
    2 mn lane items, each item taken by exactly one thread, and whose
    closing warp's items fit its shared slots; the second entry's blocks of
    RESPONSE_THREADS hold one thread for each of a proof's 2 + deg outputs
    and leave less than one block idle."""
    import os
    import re

    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr

    source = open(os.path.join(os.path.dirname(cpr.__file__), "..", "csrc", "prover.cu")).read()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", source).group(1))  # noqa: E731
    assert define("PR_RESP_THREADS") == cpr.RESPONSE_THREADS == 32
    assert define("P2_MAX_THREADS") == 544 and define("P3_ITEMS") == 6
    assert "#define P3_SLOTS (P3_ITEMS + 2 * 64 + 2)" in source  # deg <= 64, as the C entries check
    for mn in (1 << k for k in range(12)):
        t = cpr.round_threads(mn)
        lanes = t - 32
        assert t % 32 == 0 and 64 <= t <= 544 and lanes == min(512, max(32, 2 * mn))
        taken = sorted(q for thread in range(lanes) for q in range(thread, 2 * mn, lanes))
        assert taken == list(range(2 * mn)), mn
    for deg in range(1, 7):
        assert 6 + 2 * deg + 2 <= 6 + 2 * 64 + 2
        for batch in range(1, 1026):
            blocks = cpr.response_blocks(batch, deg)
            assert 0 <= blocks * cpr.RESPONSE_THREADS - batch * (2 + deg) < cpr.RESPONSE_THREADS, (batch, deg)


def _prep_model(y, z, y_inv, bits, r_blind, alpha0, m, n):
    """One proof through P1's schedule (csrc/prover.cu `prove_prep_body`) on
    ints: the ladder threads' levels as `cuda_prover.prep_levels` counts
    them, each item reading only slots that a level before it wrote; the
    alpha warp's groups of G = min(m, 32) lanes, their ladder and sums by
    shuffles lane by lane; then the last step."""
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr

    mn, deg = m * n, len(alpha0)
    lm, ln, rounds = m.bit_length() - 1, n.bit_length() - 1, mn.bit_length() - 1
    ys, ds, zs = [y] + [None] * (mn - 1), [None] * mn, [None] * m
    y_pows, y_inv_n, yi = [y] + [None] * mn, [None] * (rounds - 1) + [y_inv] if rounds else [], y_inv

    def known(values, i):
        assert values[i] is not None, i
        return values[i]

    for lv, (ny, ni, nz, nd) in enumerate(cpr.prep_levels(mn, m), start=1):
        h = 1 << (lv - 1)
        hz = h >> 1
        old_ys, old_zs, old_yi = list(ys), list(zs), yi
        for q in range(ny + ni + nz + nd):
            if q < ny:
                assert ys[h + q] is None
                ys[h + q] = y_pows[h + q] = known(old_ys, h - 1) * known(old_ys, q) % L
            elif q < ny + ni:
                yi = y_inv_n[rounds - 1 - lv] = old_yi * old_yi % L
            elif q < ny + ni + nz:
                j = q - ny - ni
                if lv == 1:
                    zs[0] = z * z % L
                else:
                    zs[hz + j] = known(old_zs, hz - 1) * known(old_zs, j) % L
            else:
                i = q - ny - ni - nz
                ds[i] = known(old_zs, i >> ln) * (1 << (i & (n - 1))) % L
    assert None not in ys and None not in ds and None not in y_inv_n
    # the alpha warp, lane by lane
    G = min(m, 32)
    lg = G.bit_length() - 1
    v, h = [z * z % L] * 32, 1
    while h < G:
        old = list(v)
        for lane in range(32):
            g, base = lane & (G - 1), lane - (lane & (G - 1))
            if h <= g < 2 * h:
                v[lane] = old[base + h - 1] * old[base + ((g - h) & (G - 1))] % L
        h <<= 1
    zg = [v[lane - (lane & (G - 1)) + G - 1] for lane in range(32)]
    v = [x * y % L for x in v]
    sk = [None] * deg
    for k0 in range(0, deg, 32 >> lg):
        acc = [0] * 32
        for lane in range(32):
            g, k, u = lane & (G - 1), k0 + (lane >> lg), v[lane]
            for j in range(g, m, G):
                if j > g:
                    u = u * zg[lane] % L
                if k < deg:
                    acc[lane] = (acc[lane] + u * r_blind[j][k]) % L
        off = G >> 1
        while off:
            acc = [(acc[lane] + acc[lane ^ off]) % L for lane in range(32)]
            off >>= 1
        for lane in range(0, 32, G):
            if k0 + (lane >> lg) < deg:
                sk[k0 + (lane >> lg)] = acc[lane]
    y_pows[mn] = ys[mn - 1] * ys[0] % L
    a = [(bit - z) % L for bit in bits]
    b = [(ds[i] * ys[mn - 1 - i] + z + (0 if bits[i] else L - 1)) % L for i in range(mn)]
    alpha = [(alpha0[k] + sk[k] * ys[mn - 1]) % L for k in range(deg)]
    return a, b, y_pows, y_inv_n, alpha


@pytest.mark.parametrize("m, n, deg", [(1, 1, 1), (1, 64, 1), (2, 8, 6), (4, 16, 5), (64, 1, 3), (32, 2, 2)],
                         ids=["mn1", "mn64", "mn16_deg6", "m4_mn64_deg5", "m64_n1", "m32_n2"])
def test_prove_prep_schedule_matches_plain(m, n, deg):
    """P1's schedule, its levels and the alpha warp's groups (m above 32
    among them: two terms a lane), modelled on ints, gives the plain twin's
    every output; and `prep_threads` gives every level's items and the last
    step's a thread each at the prove's shapes."""
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr

    mn = m * n
    inp = prep_inputs(B, m, n, deg, seed=7 * mn + deg)
    want = PK.prove_prep(**to_device(inp, torch, "cpu"), bit_length=n)
    for lane in range(B):
        y, z, y_inv = (_ints(inp[k][lane]) for k in ("y", "z", "y_inv"))
        got = _prep_model(y, z, y_inv, inp["bits"][lane].tolist(), _ints(inp["r_blind"][lane]),
                          _ints(inp["alpha0"][lane]), m, n)
        assert list(got) == [_ints(w[lane]) if w[lane].numel() else [] for w in want]
    for mn, m in ((64, 1), (256, 4)):
        threads = cpr.prep_threads(mn, m)
        assert all(sum(level) <= threads - 32 for level in cpr.prep_levels(mn, m)) and mn + 1 + 6 <= threads


def test_prep_launch_shapes():
    """P1's and P4's host-side launch shapes against csrc/prover.cu: P1's
    block a multiple of 32 from 64 to its 512 and its scratch `p1_words`,
    over mn 1 to 65,536 and m 1 to 1,024; P4's a power of two from 32 to its
    512 threads."""
    import os
    import re

    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr

    source = open(os.path.join(os.path.dirname(cpr.__file__), "..", "csrc", "prover.cu")).read()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", source).group(1))  # noqa: E731
    assert define("P1_MAX_THREADS") == cpr.PREP_MAX_THREADS == 512 and define("P4_MAX_THREADS") == 512
    assert "return 8 * (2 * mn + m + deg + 1);" in source
    assert define("PR_MAX_SMEM") == cpr.MAX_SMEM
    for lmn in range(17):
        for lm in range(min(lmn, 10) + 1):
            t = cpr.prep_threads(1 << lmn, 1 << lm)
            assert t % 32 == 0 and 64 <= t <= 512, (lmn, lm)
            assert len(cpr.prep_levels(1 << lmn, 1 << lm)) == max(lmn, lm + 2)
        t = cpr.bit_sum_threads(1 << lmn)
        assert t & (t - 1) == 0 and 32 <= t <= 256
    assert cpr.prep_threads(64, 1) == 128 and cpr.bit_sum_threads(64) == 128
    assert cpr.prep_words(64, 1, 1) == 8 * 131


@pytest.mark.parametrize("mn, threads", [(1, 32), (8, 32), (16, 32), (16, 128)])
def test_bit_sum_schedule_matches_host_points(joined, mn, threads):
    """P4's schedule on host points: adder a from alpha's point (a = 0) or
    the identity adds lanes a, a + T / 4, .. (the identity past the last),
    then the tree over the adders that hold a point, across warps, then the
    three levels of warp 0, gives start + sum_i (bit_i ? g_i : -h_i)."""
    _, gens, _ = joined
    rs = np.random.default_rng(mn + threads)
    bits = rs.integers(0, 2, size=mn)
    start = hr.point_mul(int(rs.integers(1, 2**62)), hr.BASEPOINT)
    adders = threads // 4
    acc = [start if a == 0 else hr.IDENTITY for a in range(adders)]
    for i0 in range(0, mn, adders):
        for a in range(adders):
            i = i0 + a
            if i < mn:
                acc[a] = hr.point_add(acc[a], gens[2 * i] if bits[i] else hr.point_neg(gens[2 * i + 1]))
    n = min(mn, adders)
    wv = n >> 4
    while wv >= 1:  # adder k of warp w + wv into adder k of warp w
        for w in range(wv):
            for k in range(8):
                acc[8 * w + k] = hr.point_add(acc[8 * w + k], acc[8 * (w + wv) + k])
        wv >>= 1
    s = 1
    while s < n and s < 8:  # warp 0: each group adds the group at xor distance s
        acc[:8] = [hr.point_add(acc[k], acc[k ^ s]) for k in range(8)]
        s <<= 1
    want = start
    for i in range(mn):
        want = hr.point_add(want, gens[2 * i] if bits[i] else hr.point_neg(gens[2 * i + 1]))
    assert hr.compress(acc[0]) == hr.compress(want)
