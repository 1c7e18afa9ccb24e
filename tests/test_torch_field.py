"""The port's GF(p), GF(l) and limb-major point ops against the JAX package.

Inputs come from seeded numpy; both packages get the same limbs and must
agree exactly mod p (GF(p) results are lazily reduced) or exactly (GF(l)
results and canonical forms).  Tolerance: exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bulletproofs_plus_tpu.ops import field as JF
from bulletproofs_plus_tpu.ops import pfield as jpf
from bulletproofs_plus_tpu.ops.limbs import int_from_limbs, pack_ints
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import field as F
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import pfield as pf

P, L = F.P, F.L
torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores
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


def test_identity_add_chain_regression():
    """id + id + B + B == 2B: identity add chains reach the fold's carry-out
    window (tests/test_pfield.py::test_fold16_carry_out_edge)."""
    _, b = _both_s([hr.BASEPOINT])
    acc = pf.padd(pf.padd(pf.padd(pf.identity((1,), device="cpu"), pf.identity((1,), device="cpu")), b), b)
    assert hr.point_equal(_host_of(acc, 1)[0], hr.point_mul(2, hr.BASEPOINT))
    x = ed.from_host(hr.BASEPOINT, device="cpu")
    assert hr.point_equal(ed.to_host(ed.double(x)), hr.point_mul(2, hr.BASEPOINT))
