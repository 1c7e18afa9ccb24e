"""The port's GF(p), GF(l) and limb-major point ops against the JAX package.

Inputs come from seeded numpy; both packages get the same limbs and must
agree exactly mod p (GF(p) results are lazily reduced) or exactly (GF(l)
results and canonical forms).  The CUDA header's carry logic, which no CPU
can run, is held against Python integers through its word-exact model
(ops/field_model.py).  Tolerance: exact integer equality.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from bulletproofs_plus_tpu.ops import field as JF
from bulletproofs_plus_tpu.ops import pfield as jpf
from bulletproofs_plus_tpu.ops.limbs import int_from_limbs, pack_ints
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import field as F
from bulletproofs_plus_tpu_torch.ops import field_model as fm
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import pfield as pf
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from torch_jax_loops import jax_loops_jitted_once  # noqa: F401  (the fixture, used by pytestmark)

P, L = F.P, F.L
torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores
# the JAX package's eager references: each fori_loop compiled once, not at every call (tests/torch_jax_loops.py)
pytestmark = pytest.mark.usefixtures("jax_loops_jitted_once")
# Values below 2^256 that sit at the reduction edges, including the
# carry-out window of the 2^256 == 38 fold (2^256 - 30 squared).
EDGES_P = [0, 1, 2, 19, P - 1, P, P + 1, 2**255, 2**256 - 1, 2**256 - 30, 2**256 - 38, 2**256 - 19]
EDGES_L = [0, 1, 2, L - 2, L - 1]


def _rand_ints(rs, n, bound):
    return [int.from_bytes(rs.bytes(32), "little") % bound for _ in range(n)]


def _pair(vals):
    """Same limbs for both packages: (jax uint32 array, torch int64 tensor)."""
    arr = pack_ints(vals)
    return jnp.asarray(arr), torch.as_tensor(arr.astype(np.int64))


def _ints(x):
    arr = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return [int_from_limbs(r) for r in arr.reshape(-1, arr.shape[-1])]


def _fp_operands():
    rs = np.random.RandomState(20260416)
    a = _rand_ints(rs, 24, 2**256) + EDGES_P
    b = _rand_ints(rs, 24, 2**256) + EDGES_P[::-1]
    return a, b


@pytest.mark.parametrize(
    "op",
    ["mul25519", "sqr25519", "add25519", "sub25519", "neg25519", "mul_small25519", "pow25519"],
)
def test_fp_ops_match_jax(op):
    av, bv = _fp_operands()
    (ja, ta), (jb, tb) = _pair(av), _pair(bv)
    ref = {
        "mul25519": (lambda x, y: x * y, lambda f: f(ja, jb), lambda f: f(ta, tb)),
        "sqr25519": (lambda x, y: x * x, lambda f: f(ja), lambda f: f(ta)),
        "add25519": (lambda x, y: x + y, lambda f: f(ja, jb), lambda f: f(ta, tb)),
        "sub25519": (lambda x, y: x - y, lambda f: f(ja, jb), lambda f: f(ta, tb)),
        "neg25519": (lambda x, y: -x, lambda f: f(ja), lambda f: f(ta)),
        "mul_small25519": (lambda x, y: 2 * x, lambda f: f(ja, 2), lambda f: f(ta, 2)),
        "pow25519": (lambda x, y: pow(x, 12345, P), lambda f: f(ja, 12345), lambda f: f(ta, 12345)),
    }[op]
    want, call_jax, call_torch = ref
    got_t = call_torch(getattr(F, op))
    got_j = call_jax(getattr(JF, op))
    assert ((got_t >= 0) & (got_t < 2**16)).all()
    gt, gj = _ints(got_t), _ints(got_j)
    assert all(v < 2**256 for v in gt)
    assert [v % P for v in gt] == [v % P for v in gj] == [want(x, y) % P for x, y in zip(av, bv)]


def test_fp_predicates_match_jax():
    av, bv = _fp_operands()
    (ja, ta), (jb, tb) = _pair(av), _pair(av[:6] + bv[6:])
    assert _ints(F.canon25519(ta)) == _ints(JF.canon25519(ja)) == [v % P for v in av]
    for name in ("eq25519",):
        assert getattr(F, name)(ta, tb).tolist() == np.asarray(getattr(JF, name)(ja, jb)).tolist()
    for name in ("is_zero25519", "is_negative25519"):
        assert getattr(F, name)(ta).tolist() == np.asarray(getattr(JF, name)(ja)).tolist()
    assert [v % P for v in _ints(F.abs25519(ta))] == [v % P for v in _ints(JF.abs25519(ja))]


def test_pow_p58_matches_jax_and_python():
    av = _fp_operands()[0][:6] + EDGES_P
    ja, ta = _pair(av)
    got = _ints(F.pow_p58(ta))
    want = [pow(v, (P - 5) // 8, P) for v in av]
    assert [v % P for v in got] == want == [v % P for v in _ints(JF.pow_p58(ja))]


def test_fold_carry_out_regression():
    """(2^256 - 30)^2 lands in the fold's carry-out window [2^256, 2^256 + 38q):
    the result must still be 64, as in tests/test_pfield.py."""
    edge = torch.as_tensor(pack_ints([2**256 - 30]).astype(np.int64))
    assert _ints(F.mul25519(edge, edge))[0] % P == pow(2**256 - 30, 2, P) == 64


@pytest.mark.parametrize("op", ["mul_l", "sqr_l", "add_l", "sub_l", "neg_l", "pow_l", "barrett_reduce"])
def test_fl_ops_match_jax(op):
    rs = np.random.RandomState(7)
    av = _rand_ints(rs, 16, L) + EDGES_L
    bv = _rand_ints(rs, 16, L) + EDGES_L[::-1]
    (ja, ta), (jb, tb) = _pair(av), _pair(bv)
    if op == "barrett_reduce":
        wide = [int.from_bytes(rs.bytes(64), "little") for _ in range(16)] + [2**512 - 1, 0, L, L * L]
        arr = pack_ints(wide, 32)
        got_t = _ints(F.barrett_reduce(torch.as_tensor(arr.astype(np.int64))))
        assert got_t == _ints(JF.barrett_reduce(jnp.asarray(arr))) == [v % L for v in wide]
        return
    fn_t, fn_j = getattr(F, op), getattr(JF, op)
    if op in ("sqr_l", "neg_l"):
        got_t, got_j = fn_t(ta), fn_j(ja)
    elif op == "pow_l":
        got_t, got_j = fn_t(ta, 2**64 + 7), fn_j(ja, 2**64 + 7)
    else:
        got_t, got_j = fn_t(ta, tb), fn_j(ja, jb)
    want = {
        "mul_l": [x * y % L for x, y in zip(av, bv)],
        "sqr_l": [x * x % L for x in av],
        "add_l": [(x + y) % L for x, y in zip(av, bv)],
        "sub_l": [(x - y) % L for x, y in zip(av, bv)],
        "neg_l": [-x % L for x in av],
        "pow_l": [pow(x, 2**64 + 7, L) for x in av],
    }[op]
    assert _ints(got_t) == _ints(got_j) == want


def test_inv_l_matches_python():
    """`inv_l` by divsteps (the kernels' inversion, batched in plain torch)
    against pow(., -1, l): the edges, inv(0) = 0, random values, and values
    at and above l, reduced first; a batch of two axes."""
    rs = np.random.RandomState(17)
    vals = EDGES_L + [3, L, L + 5, 2**252, 2**256 - 1] + _rand_ints(rs, 24, L) + _rand_ints(rs, 8, 2**256)
    got = F.inv_l(torch.as_tensor(pack_ints(vals).astype(np.int64)).reshape(2, -1, 16))
    assert got.shape == (2, len(vals) // 2, 16)
    assert _ints(got.reshape(-1, 16)) == [pow(v % L, -1, L) if v % L else 0 for v in vals]


def test_wide_reduction_and_scalar_predicates_match_jax():
    """reduce_wide_l (a 64-byte challenge to its scalar), is_zero_l and eq_l
    against the JAX package's, zero and l included."""
    rs = np.random.RandomState(9)
    wide = [int.from_bytes(rs.bytes(64), "little") for _ in range(8)] + [0, L, 2 * L, 2**512 - 1]
    arr = pack_ints(wide, 32)
    got = F.reduce_wide_l(torch.as_tensor(arr.astype(np.int64)))
    assert _ints(got) == _ints(JF.reduce_wide_l(jnp.asarray(arr))) == [v % L for v in wide]
    other = torch.cat([got[:6], got[:6].flip(0)])
    for name, args_t, args_j in (("is_zero_l", (got,), (JF.reduce_wide_l(jnp.asarray(arr)),)),
                                 ("eq_l", (got, other), (jnp.asarray(got.numpy()), jnp.asarray(other.numpy())))):
        assert getattr(F, name)(*args_t).tolist() == np.asarray(getattr(JF, name)(*args_j)).tolist()
    assert F.is_zero_l(got).tolist() == [v % L == 0 for v in wide]


def test_fl_select_geq_match_jax():
    rs = np.random.RandomState(8)
    av = _rand_ints(rs, 10, L) + EDGES_L
    bv = _rand_ints(rs, 10, L) + EDGES_L
    (ja, ta), (jb, tb) = _pair(av), _pair(bv)
    assert F.geq(ta, tb).tolist() == np.asarray(JF.geq(ja, jb)).tolist() == [x >= y for x, y in zip(av, bv)]
    mask = np.arange(len(av)) % 3 == 0
    got = F.select(torch.as_tensor(mask), ta, tb)
    assert _ints(got) == _ints(JF.select(jnp.asarray(mask), ja, jb))


# ---------------------------------------------------------------------------
# Limb-major point twin (ops/pfield.py) against the JAX pfield
# ---------------------------------------------------------------------------


def _host_points(n, seed):
    rs = np.random.RandomState(seed)
    pts = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(n - 1)]
    return pts + [hr.IDENTITY]


def _both_s(pts):
    """Host points -> (jax PointS, torch PointS), limb-major (16, n)."""
    coords = [pack_ints([p[i] for p in pts]) for i in range(4)]
    j = jpf.PointS(*(jnp.asarray(c.T) for c in coords))
    t = pf.PointS(*(torch.as_tensor(c.T.astype(np.int64)).contiguous() for c in coords))
    return j, t


def _host_of(p, n):
    coords = [np.asarray(c.numpy() if isinstance(c, torch.Tensor) else c).reshape(16, -1) for c in p]
    return [tuple(int_from_limbs(c[:, i]) % P for c in coords) for i in range(n)]


@pytest.mark.parametrize("op", ["padd", "pdbl", "lane_halve_sum"])
def test_pfield_twin_matches_jax(op):
    n = 8
    jp, tp = _both_s(_host_points(n, 3))
    jq, tq = _both_s(_host_points(n, 4)[::-1])
    if op == "padd":
        got, want, k = pf.padd(tp, tq), jpf.padd(jp, jq), n
    elif op == "pdbl":
        got, want, k = pf.pdbl(tp), jpf.pdbl(jp), n
    else:
        got, want, k = pf.lane_halve_sum(tp, axis=1, width=n), jpf.lane_halve_sum(jp, axis=1, width=n), 1
    for g, w in zip(_host_of(got, k), _host_of(want, k)):
        assert hr.point_equal(g, w)


def _four_lane_cases():
    """(P, Q) pairs, limb-major: random points, the identity on either side,
    a point with itself and with its negative, and the same points with
    coordinates moved into [p, 2^256): p added to each, and the identity
    written as (2p : p + 1 : p + 1 : 2p), 2p = 2^256 - 38."""
    pts = _host_points(6, 21)
    neg = [((P - x) % P, y, z, (P - t) % P) for x, y, z, t in pts]
    left = pts + [hr.IDENTITY, pts[0], pts[1], pts[2]]
    right = pts[::-1] + [pts[3], hr.IDENTITY, pts[1], neg[2]]
    above = lambda p: tuple(v + P for v in p)  # noqa: E731
    top_identity = (2 * P, P + 1, P + 1, 2 * P)
    left += [above(p) for p in pts] + [top_identity, above(pts[4])]
    right += [above(p) for p in pts[::-1]] + [above(pts[5]), top_identity]
    to_s = lambda ps: pf.PointS(  # noqa: E731
        *(torch.as_tensor(pack_ints([p[i] for p in ps]).T.astype(np.int64)).contiguous() for i in range(4)))
    return left, right, to_s(left), to_s(right)


@pytest.mark.parametrize("op", ["pdbl4", "padd4"])
def test_four_lane_schedule_equals_one_lane_limb_for_limb(op):
    """`pdbl4` and `padd4`, the lane schedule of csrc ge_dbl4 and ge_add4,
    return the limbs of `pdbl` and `padd`, and of the JAX package's `pdbl`
    and `padd` on the same packed inputs, not only the same points; and the
    points are right by the host's integers."""
    left, right, tp, tq = _four_lane_cases()
    n = len(left)
    jp, jq = (jpf.PointS(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in pt)) for pt in (tp, tq))
    if op == "pdbl4":
        got, want, jax_want = pf.pdbl4(tp), pf.pdbl(tp), jpf.pdbl(jp)
        host = [hr.point_add(a, a) for a in left]
    else:
        got, want, jax_want = pf.padd4(tp, tq), pf.padd(tp, tq), jpf.padd(jp, jq)
        host = [hr.point_add(a, b) for a, b in zip(left, right)]
    for g, w, jw in zip(got, want, jax_want):
        assert g.shape == w.shape == (16, n) and torch.equal(g, w)
        assert np.array_equal(g.numpy(), np.asarray(jw).astype(np.int64))  # the JAX package's limbs on the same inputs
    for g, h in zip(_host_of(got, n), host):
        assert hr.point_equal(g, h)
    assert hr.is_identity(_host_of(got, n)[9]) == (op == "padd4")  # P + (-P)


def test_identity_add_chain_regression():
    """id + id + B + B == 2B: identity add chains reach the fold's carry-out
    window (tests/test_pfield.py::test_fold16_carry_out_edge)."""
    _, b = _both_s([hr.BASEPOINT])
    acc = pf.padd(pf.padd(pf.padd(pf.identity((1,), device="cpu"), pf.identity((1,), device="cpu")), b), b)
    assert hr.point_equal(_host_of(acc, 1)[0], hr.point_mul(2, hr.BASEPOINT))
    x = ed.from_host(hr.BASEPOINT, device="cpu")
    assert hr.point_equal(ed.to_host(ed.double(x)), hr.point_mul(2, hr.BASEPOINT))


# ---------------------------------------------------------------------------
# The word-exact model of csrc/field25519.cuh (ops/field_model.py) against
# Python integers.  The model asserts the bounds the CUDA code relies on (no
# dropped carry), so a pass also says those held on these operands.
# ---------------------------------------------------------------------------

MODEL_EDGES = [
    0, 1, 2, 19, 38, P - 1, P, P + 1, 2**255 - 1, 2**255, 2**255 + 18, 2**255 + 19, 2**256 - 1, 2**256 - 38,
    2**256 - 39, 2**256 - 30, 2**256 - 19, 2**256 - 2**32, 2**32 - 1, 2**32, 2**224 - 1,
    int("ffffffff00000000" * 4, 16), int("00000000ffffffff" * 4, 16), int("80000000" * 8, 16), int("7fffffff" * 8, 16),
]


def _model_operands():
    rs = np.random.RandomState(20260416)
    return MODEL_EDGES + _rand_ints(rs, 40, 2**256)


def _lands_in_carry_out_window(a, b):
    """Whether a * b, folded as fe_reduce_wide folds it, reaches 2^256 again
    after the top carry was folded: the case the last `+38` exists for."""
    t = a * b
    s = (t % 2**256) + 38 * (t >> 256)
    return (s % 2**256) + 38 * (s >> 256) >= 2**256


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg"])
def test_field_model_matches_integers(op):
    vals = _model_operands()
    W, V = fm.to_words, fm.from_words
    for a in vals:
        if op == "sqr":
            e, o = fm.wide_sqr(W(a))
            assert fm.wide_value(e, o) == a * a  # the 43-product accumulation, before any fold
            assert V(fm.fe_sqr(W(a))) % P == a * a % P
            continue
        if op == "neg":
            assert V(fm.fe_neg(W(a))) % P == -a % P
            continue
        for b in vals:
            if op == "mul":
                e, o = fm.wide_mul(W(a), W(b))
                assert fm.wide_value(e, o) == a * b
                assert V(fm.fe_mul(W(a), W(b))) % P == a * b % P
            elif op == "add":
                assert V(fm.fe_add(W(a), W(b))) % P == (a + b) % P
            else:
                assert V(fm.fe_sub(W(a), W(b))) % P == (a - b) % P


@pytest.mark.parametrize("op", ["canon", "eq", "is_negative", "abs", "select"])
def test_field_model_predicates(op):
    vals = _model_operands()
    W, V = fm.to_words, fm.from_words
    for i, a in enumerate(vals):
        if op == "canon":
            assert V(fm.fe_canon(W(a))) == a % P
        elif op == "is_negative":
            assert fm.fe_is_negative(W(a)) == bool(a % P & 1)
        elif op == "abs":
            assert V(fm.fe_abs(W(a))) == (P - a % P if a % P & 1 else a % P)
        elif op == "select":
            b = vals[-1 - i]
            assert V(fm.fe_select(True, W(a), W(b))) == a and V(fm.fe_select(False, W(a), W(b))) == b
        else:
            for b in vals:
                assert fm.fe_eq(W(a), W(b)) == ((a - b) % P == 0)


@pytest.mark.parametrize(
    "a, b",
    [(2**256 - 30, 2**256 - 30), (2**256 - 1, 2**256 - 1), (2**256 - 1, 2**256 - 36), (2**256 - 19, 2**256 - 2)],
)
def test_field_model_carry_out_window(a, b):
    """Operands whose last fold lands in [2^256, 2^256 + 38q): the product
    must still be right, by fe_mul and, for a square, by fe_sqr."""
    assert _lands_in_carry_out_window(a, b)
    W, V = fm.to_words, fm.from_words
    assert V(fm.fe_mul(W(a), W(b))) % P == a * b % P
    if a == b:
        assert V(fm.fe_sqr(W(a))) % P == a * a % P


def _words_value(words):
    return sum(w << (32 * k) for k, w in enumerate(words))


def _check_mul4_lanes(a, b):
    """FourLanes::mul's model (`fe_mul4_lanes`) on a, b: the four lanes'
    shares weighed by 2^(64 t) sum to a b, so do the first round's two sums
    and the second round's sixteen words, and the folded words are fe_mul's
    (fe_sqr's for a square), word for word."""
    W = fm.to_words
    shares, (s0, s2), w, r = fm.fe_mul4_lanes(W(a), W(b))
    assert all(len(p) == 10 for p in shares) and len(s0) == len(s2) == 12 and len(w) == 16
    assert sum(_words_value(p) << (64 * t) for t, p in enumerate(shares)) == a * b
    assert _words_value(s0) + (_words_value(s2) << 128) == _words_value(w) == a * b
    assert r == fm.fe_mul(W(a), W(b))
    if a == b:
        assert r == fm.fe_sqr(W(a))


@pytest.mark.parametrize("square", [False, True], ids=["mul4", "sqr4"])
def test_field_model_four_lanes_match_one_lane(square):
    """D1's four-lane product and squaring (csrc/sqrt_ratio.cuh, modelled
    lane by lane) against Python integers and the one-lane fe_mul and fe_sqr
    words, on the model's edge operands (0, 1, p - 1, p, 2^255 - 1, 2^256 -
    1, words of all ones, the carry-out window) and random ones."""
    vals = _model_operands()
    for a in vals:
        for b in [a] if square else vals[::3]:
            _check_mul4_lanes(a, b)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**256 - 1), st.integers(0, 2**256 - 1))
def test_field_model_four_lanes_any_operands(a, b):
    """The same on any two values below 2^256, and on the square of each."""
    _check_mul4_lanes(a, b)
    _check_mul4_lanes(a, a)


def test_field_model_pow_p58_and_sqrt_ratio():
    """The kernels' chain and the whole SQRT_RATIO_M1 on the model: the
    power against python pow, the ratio against the plain torch version, on a
    square, a non-square, v = 0 and u = 0."""
    W, V = fm.to_words, fm.from_words
    for v in (0, 1, 2, P - 1, 2**256 - 30, 2**255 + 7):
        assert V(fm.fe_pow_p58(W(v))) % P == pow(v, (P - 5) // 8, P)
    us = [1, 1, 4, 7, 0, 1, 2**256 - 1]
    vs = [4, 2, 9, 0, 5, 2**256 - 30, 3]  # 1/4 is a square, 1/2 is not (2 is a non-residue mod p)
    want_sq, want_r = rist.sqrt_ratio_m1_plain(*(torch.as_tensor(pack_ints(x).astype(np.int64)) for x in (us, vs)))
    for i, (u, v) in enumerate(zip(us, vs)):
        was_square, r = fm.sqrt_ratio_m1(W(u), W(v))
        assert was_square == bool(want_sq[i])
        assert V(r) == _ints(F.canon25519(want_r[i : i + 1]))[0]
    assert want_sq.tolist()[:2] == [True, False]
