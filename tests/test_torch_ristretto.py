"""Ristretto255 decoding, encoding and the identity check of the port (D1, C1
and I1 in csrc/ristretto.cu) against the JAX package, and the public helpers
the port adds to match the JAX package's surface.

On the CPU `decompress`, `compress` and `is_identity` take their plain torch
twins; these tests hold the twins against the JAX package's
ops/ristretto.py (run eagerly on the CPU, as its own tests run it) and the
host oracle, and hold the kernels' word-exact models (ops/field_model.py
`decompress_words`, `compress_words`, `is_identity_words`, the CUDA code's
order of operations over the carry-flag words) against the same.  The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Every decode rejection of RFC 9496 is pinned by an input
that breaks that rule alone where one exists.  Inputs come from seeded numpy.
Tolerance: exact (masks, canonical limbs, points mod p).
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bulletproofs_plus_tpu.ops import edwards as jed
from bulletproofs_plus_tpu.ops import ristretto as jrist
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import field_model as fm
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, pack_ints
from torch_jax_loops import jax_loops_jitted_once  # noqa: F401  (the fixture, used by pytestmark)
from test_host_ristretto import INVALID_ENCODINGS

P = hr.P
torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores
# the JAX package's eager references: each fori_loop compiled once, not at every call (tests/torch_jax_loops.py)
pytestmark = pytest.mark.usefixtures("jax_loops_jitted_once")
RULES = ("canonical", "even", "square", "t_nonneg", "y_nonzero")


def _valid_encodings(seed=11, n=5):
    rs = np.random.RandomState(seed)
    ks = [1, 2] + [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n - 2)]
    return [int.from_bytes(hr.compress(hr.point_mul(k, hr.BASEPOINT)), "little") for k in ks]


def _decode_rules(s: int) -> dict:
    """Which of RFC 9496's decode rules s passes, on host integers, in the
    formula's own steps (ops/ristretto.py:67-93)."""
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-hr.D * u1 * u1 - u2_sqr) % P
    square, invsqrt = hr.sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x * v % P
    x = 2 * s * den_x % P
    x = P - x if x & 1 else x
    y = u1 * den_y % P
    return {"canonical": s < P, "even": s % 2 == 0, "square": square, "t_nonneg": x * y % P % 2 == 0,
            "y_nonzero": y != 0}


def _a2(*indices):
    return [int.from_bytes(bytes.fromhex(INVALID_ENCODINGS[i]), "little") for i in indices]


# Each decode rejection and the inputs that pin it, in the order the kernel ANDs the rules (RULES): each input
# breaks its group's rule and passes every rule before it.  Three groups break their rule alone: 2p - s1 and
# p - s1 are -s1 mod p for a valid (even, below p) s1, whose decode passes every other rule, 2p being
# 2^256 - 38, a raw input above 2^255; and y = 0 comes only from s = p - 1, the one even s with 1 - s^2 = 0.
# The others are RFC 9496 Appendix A.2's (tests/test_host_ristretto.py), where garbage past a broken rule can
# break later ones too; A.2's "negative xy" entry 23 reads above 2^255 and so stands with the non-canonical
# ones, as does p itself (odd).
EDGES = {
    "s_ge_p": [2 * P - s for s in _valid_encodings()] + [2 * P],
    "s_ge_p_a2": _a2(0, 1, 2, 3, 23) + [P],
    "odd_s": [P - s for s in _valid_encodings()],
    "odd_s_a2": _a2(*range(4, 12)) + [1],
    "non_square": _a2(*range(12, 20)),
    "negative_t": _a2(20, 21, 22, 24, 25, 26, 27),
    "y_zero": _a2(28),  # s = p - 1
}
BROKEN = {"s_ge_p": "canonical", "s_ge_p_a2": "canonical", "odd_s": "even", "odd_s_a2": "even",
          "non_square": "square", "negative_t": "t_nonneg", "y_zero": "y_nonzero"}
ALONE = ("s_ge_p", "odd_s", "y_zero")  # the rule named is the only one broken


def _all_inputs():
    """Every decode input: the valid encodings (the identity's among them),
    then each edge group in order."""
    vals = [0] + _valid_encodings()
    for group in EDGES.values():
        vals += group
    return vals


def _limbs(vals):
    return pack_ints(vals)


@functools.lru_cache(maxsize=None)
def _jax_decoded():
    """The JAX package's decompress of every input, once: (mask, [point ints])."""
    pts, ok = jrist.decompress(jnp.asarray(_limbs(_all_inputs())))
    return np.asarray(ok).tolist(), jed.to_host(pts)


@pytest.mark.parametrize("group", list(EDGES))
def test_decode_edges_break_their_rule(group):
    """Each edge input breaks the rule it stands for and passes the rules
    before it (and all others, where the group isolates it); the host oracle
    rejects it."""
    for s in EDGES[group]:
        broken = [r for r in RULES if not _decode_rules(s)[r]]
        assert broken[:1] == [BROKEN[group]], (group, hex(s), broken)
        if group in ALONE:
            assert broken == [BROKEN[group]], (group, hex(s), broken)
        assert hr.decompress(s.to_bytes(32, "little")) is None


def test_decompress_plain_matches_jax_and_host():
    """D1's plain twin against the JAX package and the host oracle on the
    valid encodings and every edge: the same mask, the same points mod p,
    and exactly the identity (0, 1, 1, 0) on every rejected lane."""
    vals = _all_inputs()
    pts, ok = rist.decompress_plain(torch.as_tensor(_limbs(vals).astype(np.int64)))
    jok, jpts = _jax_decoded()
    want = [hr.decompress(s.to_bytes(32, "little")) for s in vals]
    assert ok.tolist() == jok == [w is not None for w in want]
    assert sum(ok.tolist()) == 1 + len(_valid_encodings())
    host = ed.to_host(pts)
    for i, w in enumerate(want):
        assert hr.point_equal(host[i], w or hr.IDENTITY) and hr.point_equal(jpts[i], w or hr.IDENTITY)
        assert tuple(c % P for c in host[i]) == tuple(c % P for c in jpts[i])
    bad = ~ok
    ident = ed.identity((int(bad.sum()),), device="cpu")
    assert all(torch.equal(c[bad], i) for c, i in zip(pts, ident))


def test_decompress_model_matches_jax():
    """D1's word-exact model against the JAX package on every input: the
    mask exactly, the coordinates canonical and equal mod p to JAX's, z = 1,
    the identity on rejected lanes."""
    vals = _all_inputs()
    jok, jpts = _jax_decoded()
    for s, want_ok, want in zip(vals, jok, jpts):
        ok, coords = fm.decompress_words(fm.to_words(s))
        got = [fm.from_words(c) for c in coords]
        assert ok == want_ok, hex(s)
        assert all(c < P for c in got) and got[2] == 1
        if ok:
            assert got[0] == want[0] % P and got[1] == want[1] % P and got[3] == want[3] % P
        else:
            assert got == [0, 1, 1, 0]


def _coset_forms():
    """The identity's class in ristretto, written with X = 0 or Y = 0 in
    other ways than (0, 1, 1, 0): (0, -1), (+-sqrt(-1), 0), those scaled by
    Z = 5, and (0 : p + 1 : p + 1 : 0), limbs not canonical."""
    i = hr.SQRT_M1
    return [(0, 1, 1, 0), (0, P - 1, 1, 0), (i, 0, 1, 0), (P - i, 0, 1, 0), (0, 5, 5, 0), (5 * i % P, 0, 5, 0),
            (0, P + 1, P + 1, 0), (P, 7, 7, 0)]


def _encode_points():
    """Points to encode: the identity's coset forms, base-point multiples,
    their doubles (Z not 1), negatives, and sums with a torsion point of
    order 4 (the same ristretto element)."""
    rs = np.random.RandomState(12)
    base = [hr.point_mul(int.from_bytes(rs.bytes(32), "little") % hr.L, hr.BASEPOINT) for _ in range(4)]
    torsion = (hr.SQRT_M1, 0, 1, 0)
    pts = _coset_forms() + base + [hr.point_double(p) for p in base] + [hr.point_neg(p) for p in base]
    return pts + [hr.point_add(p, torsion) for p in base]


def _from_ints(points):
    """Host points whose coordinates may be >= p, as limb tensors (any value below 2^256)."""
    return ed.PointArray(*(torch.as_tensor(pack_ints([p[c] for p in points]).astype(np.int64)) for c in range(4)))


def _jax_points(points):
    return jed.PointArray(*(jnp.asarray(pack_ints([p[c] for p in points])) for c in range(4)))


@functools.lru_cache(maxsize=1)
def _jax_compressed():
    """The JAX package's `compress`, in one call (one eager pass of its ops,
    each compiled once): of every point of `_encode_points()`, then of 2Q
    for each of them (doubled on the host), then of the host Pippenger's MSM
    over `_msm_inputs()` -> (the first encodings, the doubled ones) as int64
    limbs."""
    from bulletproofs_plus_tpu_torch.ops.msm import host_msm

    pts = _encode_points()
    doubled = [hr.point_double(tuple(c % P for c in p)) for p in pts]
    out = np.asarray(jrist.compress(_jax_points(pts + doubled + [host_msm(*_msm_inputs())]))).astype(np.int64)
    return out[: len(pts)], out[len(pts) :]


def test_compress_plain_matches_jax():
    """C1's plain twin against the JAX package, limb for limb, and the host
    encoder: the coset forms all encode as zero."""
    pts = _encode_points()
    got = rist.compress_plain(_from_ints(pts)).numpy()
    want = _jax_compressed()[0]
    assert np.array_equal(got, want.astype(np.int64))
    assert [int_from_limbs(r) for r in got] == [int.from_bytes(hr.compress(tuple(c % P for c in p)), "little")
                                                 for p in pts]
    assert not got[: len(_coset_forms())].any()


def test_compress_model_matches_jax():
    """C1's word-exact model against the JAX package, word for word."""
    pts = _encode_points()
    want = _jax_compressed()[0]
    for p, w in zip(pts, want):
        assert fm.from_words(fm.compress_words(*(fm.to_words(c) for c in p))) == int_from_limbs(w)


def _msm_inputs():
    """Four scalars and four points for a fixed-base MSM, one point with an
    order-4 torsion part."""
    rs = np.random.RandomState(15)
    scalars = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(4)]
    points = [hr.point_mul(int.from_bytes(rs.bytes(32), "little") % hr.L, hr.BASEPOINT) for _ in range(4)]
    points[3] = hr.point_add(points[3], (hr.SQRT_M1, 0, 1, 0))
    return scalars, points


def _doubled_encodings():
    """The JAX package's `compress` of 2Q for each point Q of
    `_encode_points()`, then of the host Pippenger's MSM over
    `_msm_inputs()` (`_jax_compressed`): int64 limbs, the encodings C1's
    double-and-encode must give."""
    return _jax_compressed()[1]


# subsets of `_encode_points()`: all (the coset forms' e = 0 lanes among ordinary ones), one, an odd count, the
# identity and the three other points of E[4] alone
DOUBLE_SUBSETS = {"all": list(range(24)), "one": [9], "odd": list(range(3, 16)), "e4": [0, 1, 2, 3]}


@pytest.mark.parametrize("subset", list(DOUBLE_SUBSETS))
def test_double_and_compress_plain_matches_jax(subset):
    """C1's double-and-encode, plain twin: the encoding of 2Q against the
    JAX package's `compress` of the doubled points, limb for limb; the e = 0
    lanes (Q in E[4]) encode as zero."""
    pts = _encode_points()
    want = _doubled_encodings()
    assert len(pts) == 24 and not want[: len(_coset_forms())].any()
    idx = DOUBLE_SUBSETS[subset]
    got = rist.double_and_compress_plain(_from_ints([pts[i] for i in idx])).numpy()
    assert np.array_equal(got, want[idx])


@pytest.mark.parametrize("subset", list(DOUBLE_SUBSETS) + ["two_blocks"])
def test_double_compress_model_matches_jax(subset):
    """C1's double-and-encode, word-exact model (ops/field_model.py
    `double_compress_words`: the warp's product tree, one fe_inv a block,
    the tail) against the JAX package, word for word; "two_blocks" is 48
    points, past one block of 32 lanes."""
    pts = _encode_points()
    want = _doubled_encodings()
    idx = DOUBLE_SUBSETS.get(subset, list(range(24)) * 2)
    got = fm.double_compress_words([[fm.to_words(c) for c in pts[i]] for i in idx])
    assert [fm.from_words(w) for w in got] == [int_from_limbs(w) for w in want[idx]]


def test_fe_inv_model_matches_python():
    """fe_inv's word-exact model (csrc/divsteps.cuh, a fixed 20 batches of
    divsteps mod p) against pow(x, p - 2, p): edges (0, 1, p - 1, 2^255 - 20,
    p and above, many trailing zeros) and seeded values below 2^256."""
    rs = np.random.RandomState(16)
    vals = [0, 1, 2, P - 1, 2**255 - 20, P, P + 1, 2**256 - 1, 2**200, 3 << 128, 1 << 254]
    vals += [int.from_bytes(rs.bytes(32), "little") for _ in range(48)]
    for v in vals:
        assert fm.from_words(fm.fe_inv(fm.to_words(v))) == pow(v, P - 2, P), v


def test_divsteps_sources_match_models():
    """csrc/divsteps.cuh's p in 30-bit limbs, p^-1 mod 2^30 and batch count
    are the model's, fe_inv's batch loop has no exit, and ristretto.cu's
    double-and-encode block is the model's."""
    import os
    import re

    from bulletproofs_plus_tpu_torch.ops import scalar_model as sm

    csrc = os.path.join(os.path.dirname(rist.__file__), "..", "csrc")
    with open(os.path.join(csrc, "divsteps.cuh")) as f:
        header = f.read()
    assert int(re.search(r"#define DS_BATCHES (\d+)", header).group(1)) == sm.INV_BATCHES
    assert int(re.search(r"inv30 = (\w+)u;\n    __host__ __device__ static constexpr int32_t limb\(int i\) \{\n"
                         r"        return i == 0", header).group(1), 0) == pow(P, -1, 1 << 30)
    limbs = re.search(r"return i == 0 \? (\w+) : i == 8 \? (\w+) : (\w+);", header).groups()
    assert [int(limbs[0], 0)] + [int(limbs[2], 0)] * 7 + [int(limbs[1], 0)] == sm._s30(P)
    body = header[header.index("fe_inv(const fe &x)"):]
    assert "DS_BATCHES; ++batch)" in body and "break" not in body and "_sync" not in body
    with open(os.path.join(csrc, "ristretto.cu")) as f:
        assert int(re.search(r"#define DC_THREADS (\d+)", f.read()).group(1)) == fm.DC_THREADS


def test_halved_table_msm_double_encoded_matches_jax():
    """An MSM over tables of halved points ((l + 1) / 2) P (K5 then K6's plain
    versions here), double-encoded, against the JAX package's `compress` of
    the MSM over the original points (the host Pippenger's) and the host
    encoder; one point carries an order-4 torsion part, and a zero row's Q
    (the identity) encodes as zero."""
    from bulletproofs_plus_tpu_torch.ops.fixed_base import build_tables, fixed_msm_batched, halve, pack_tables
    from bulletproofs_plus_tpu_torch.ops.msm import host_msm

    scalars, points = _msm_inputs()
    tables = pack_tables(build_tables(halve(ed.from_host(points, device="cpu"))))
    rows = torch.as_tensor(pack_ints(scalars + [0] * 4).astype(np.int64)).reshape(2, 4, 16)
    got = rist.double_and_compress(fixed_msm_batched(rows, tables)).numpy()
    assert np.array_equal(got[0], _doubled_encodings()[-1]) and not got[1].any()
    assert int_from_limbs(got[0]) == int.from_bytes(hr.compress(host_msm(scalars, points)), "little")


def test_halved_tables_joined():
    """`BulletproofGens.halved_tables_joined`: the generators' and the
    Pedersen bases' halved points, in `fixed_tables_joined`'s layout, each
    lane's first entry (window 0, digit 1) doubled the original point as a
    ristretto point; cached under a key of its own, beside the joined tables
    it leaves alone."""
    import bulletproofs_plus_tpu_torch as tbp
    from bulletproofs_plus_tpu_torch.ops.cuda_fixed import words_to_limbs

    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(2))
    gens = tbp.BulletproofGens(2, 1)
    halved = gens.halved_tables_joined(4, pc, "cpu")
    assert halved is gens.halved_tables_joined(4, pc, "cpu") and not gens._joined_tables
    assert tuple(halved.shape) == (64, 16, 4 + 3, 24)
    entries = words_to_limbs(halved[0, 1]).numpy()  # (7 lanes, [y + x, y - x, 2d x y], 16)
    want = gens.interleaved()[:4] + list(pc.g_base_vec) + [pc.h_base]
    for lane, p in enumerate(want):
        y_plus_x, y_minus_x = int_from_limbs(entries[lane, 0]), int_from_limbs(entries[lane, 1])
        x, y = (y_plus_x - y_minus_x) * pow(2, P - 2, P) % P, (y_plus_x + y_minus_x) * pow(2, P - 2, P) % P
        assert hr.point_equal(hr.point_double((x, y, 1, x * y % P)), p)


def test_double_and_compress_dispatch(monkeypatch):
    """A CPU tensor takes the plain twin and never reaches the CUDA wrapper;
    a tensor on another device goes to the wrapper, which refuses it."""

    def no_launch(*a, **k):
        raise AssertionError("a CUDA wrapper was called for a CPU tensor")

    monkeypatch.setattr(rist, "double_compress_cuda", no_launch)
    pts = _from_ints(_encode_points()[:6])
    assert torch.equal(rist.double_and_compress(pts), rist.double_and_compress_plain(pts))
    monkeypatch.undo()
    with pytest.raises(ValueError):
        rist.double_and_compress(ed.PointArray(*(c.to("meta") for c in pts)))


def test_is_identity_plain_model_and_jax():
    """I1's plain twin and its model against the JAX package: true on every
    coset form of the identity, false on the other points."""
    pts = _encode_points()
    n_coset = len(_coset_forms())
    got = rist.is_identity_plain(_from_ints(pts)).tolist()
    want = np.asarray(jrist.is_identity(_jax_points(pts))).tolist()
    assert got == want == [True] * n_coset + [False] * (len(pts) - n_coset)
    assert [fm.is_identity_words(fm.to_words(p[0]), fm.to_words(p[1])) for p in pts] == got


def test_ristretto_dispatch(monkeypatch):
    """CPU tensors take the plain twins and never reach a CUDA wrapper; a
    tensor on another device goes to the wrapper, which refuses it."""

    def no_launch(*a, **k):
        raise AssertionError("a CUDA wrapper was called for a CPU tensor")

    for name in ("decompress_cuda", "compress_cuda", "is_identity_cuda"):
        monkeypatch.setattr(rist, name, no_launch)
    s = torch.as_tensor(_limbs(_all_inputs()[:6]).astype(np.int64))
    pts, ok = rist.decompress(s)
    want_pts, want_ok = rist.decompress_plain(s)
    assert torch.equal(ok, want_ok) and all(torch.equal(a, b) for a, b in zip(pts, want_pts))
    assert torch.equal(rist.compress(pts), rist.compress_plain(pts))
    assert torch.equal(rist.is_identity(pts), rist.is_identity_plain(pts))
    monkeypatch.undo()
    meta = ed.PointArray(*(c.to("meta") for c in pts))
    for call in (lambda: rist.decompress(s.to("meta")), lambda: rist.compress(meta), lambda: rist.is_identity(meta)):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# Public helpers the JAX package has, with its signatures
# ---------------------------------------------------------------------------


def test_compute_generator_padding_matches_jax():
    from bulletproofs_plus_tpu.errors import InvalidArgument as JInvalidArgument
    from bulletproofs_plus_tpu.gens.params import compute_generator_padding as jpad
    from bulletproofs_plus_tpu_torch.errors import InvalidArgument
    from bulletproofs_plus_tpu_torch.gens.params import compute_generator_padding

    for bits in (8, 32, 64):
        for agg, max_agg in ((1, 1), (1, 4), (2, 4), (3, 8), (8, 8)):
            assert compute_generator_padding(bits, agg, max_agg) == jpad(bits, agg, max_agg)
    with pytest.raises(InvalidArgument):
        compute_generator_padding(64, 4, 2)
    with pytest.raises(JInvalidArgument):
        jpad(64, 4, 2)


def test_point_neg_matches_jax():
    from bulletproofs_plus_tpu.ops import host_ristretto as jhr

    rs = np.random.RandomState(13)
    for _ in range(4):
        p = hr.from_uniform_bytes(rs.bytes(64))
        assert hr.point_neg(p) == jhr.point_neg(p)
        assert hr.is_identity(hr.point_add(p, hr.point_neg(p)))
        assert hr.compress(hr.point_neg(p)) == hr.compress(ed.to_host(ed.neg(ed.from_host([p], device="cpu")))[0])


def test_sha3_256_matches_jax_and_hashlib():
    from bulletproofs_plus_tpu.utils.keccak import sha3_256 as jsha3
    from bulletproofs_plus_tpu_torch.utils.keccak import sha3_256

    rs = np.random.RandomState(14)
    for n in (0, 1, 3, 135, 136, 137, 272, 1000):
        d = rs.bytes(n)
        assert sha3_256(d) == jsha3(d) == hashlib.sha3_256(d).digest()


def test_fixed_msm_matches_jax():
    """The one-row fixed-base MSM (K5 then K6; their plain versions here)
    against the JAX package's `fixed_msm` and the host Pippenger."""
    from bulletproofs_plus_tpu.ops.fixed_base import build_tables as jbuild
    from bulletproofs_plus_tpu.ops.fixed_base import fixed_msm as jfixed
    from bulletproofs_plus_tpu_torch.ops.fixed_base import build_tables, fixed_msm, pack_tables
    from bulletproofs_plus_tpu_torch.ops.msm import host_msm

    rs = np.random.RandomState(15)
    scalars = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(4)]
    points = [hr.point_mul(int.from_bytes(rs.bytes(32), "little") % hr.L, hr.BASEPOINT) for _ in range(4)]
    got = fixed_msm(torch.as_tensor(pack_ints(scalars).astype(np.int64)),
                    pack_tables(build_tables(ed.from_host(points, device="cpu"))))
    want = jfixed(jnp.asarray(pack_ints(scalars)), jbuild(jed.from_host(points)))
    assert hr.point_equal(ed.to_host(got), jed.to_host(want))
    assert hr.point_equal(ed.to_host(got), host_msm(scalars, points))


@pytest.mark.parametrize("target", [None, 8, 13])
def test_pad_msm_inputs_target_matches_jax(target):
    from bulletproofs_plus_tpu.ops.msm import pad_msm_inputs as jpad
    from bulletproofs_plus_tpu_torch.ops.msm import pad_msm_inputs

    rs = np.random.RandomState(16)
    points = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(5)]
    scalars = pack_ints([int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(5)])
    s, p = pad_msm_inputs(torch.as_tensor(scalars.astype(np.int64)), ed.from_host(points, device="cpu"), target)
    js, jp = jpad(jnp.asarray(scalars), jed.from_host(points), target)
    assert np.array_equal(s.numpy(), np.asarray(js).astype(np.int64))
    assert all(np.array_equal(c.numpy(), np.asarray(jc).astype(np.int64)) for c, jc in zip(p, jp))
    assert s.shape[0] == (target or 8)


def test_digits4_nd_matches_jax():
    from bulletproofs_plus_tpu.ops.msm import digits4_nd as jdigits
    from bulletproofs_plus_tpu_torch.ops.msm import digits4_nd

    rs = np.random.RandomState(17)
    limbs = pack_ints([int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(6)]).reshape(2, 3, 16)
    got = digits4_nd(torch.as_tensor(limbs.astype(np.int64)))
    assert got.shape == (64, 2, 3)
    assert np.array_equal(got.numpy(), np.asarray(jdigits(jnp.asarray(limbs))).astype(np.int64))


def _scalar_args(B=2, m=1, bits=4, deg=2, seed=18):
    rs = np.random.RandomState(seed)
    rounds = (m * bits).bit_length() - 1

    def sc(*shape):
        n = int(np.prod(shape))
        vals = [int.from_bytes(rs.bytes(32), "little") % (hr.L - 1) + 1 for _ in range(n)]
        return torch.as_tensor(pack_ints(vals).astype(np.int64)).reshape(shape + (16,))

    args = dict(y=sc(B), z=sc(B), round_es=sc(B, rounds), e=sc(B), weight=sc(B), r1=sc(B), s1=sc(B), d1=sc(B, deg),
                min_values=torch.zeros((B, m, 16), dtype=torch.int64))
    return args, dict(m=m, bit_length=bits, max_mn=m * bits)


@pytest.mark.parametrize("fn", ["scalar_pass", "scalar_pass_plain", "group_contrib", "verify_group_full",
                                "build_sharded_verifier"])
def test_extension_degree_keyword(fn):
    """The JAX package's `extension_degree=` keyword: the degree d1 holds is
    accepted (and changes nothing), any other raises ValueError, before any
    decompression, MSM or collective."""
    from bulletproofs_plus_tpu_torch.models import verifier_kernels as vk
    from bulletproofs_plus_tpu_torch.parallel import verify as pv

    args, kw = _scalar_args()
    deg = args["d1"].shape[1]
    if fn.startswith("scalar_pass"):
        call = functools.partial(getattr(vk, fn), **args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(call(extension_degree=deg), call()))
        with pytest.raises(ValueError):
            call(extension_degree=deg + 1)
        return

    comp = torch.as_tensor(pack_ints([_valid_encodings()[0]] * 16).astype(np.int64))  # B (m + 3 + 2 rounds) points
    rest = [comp]
    if fn == "group_contrib":
        call = lambda d: vk.group_contrib(*args.values(), *rest, **kw, extension_degree=d)  # noqa: E731
        got, want = call(deg), vk.group_contrib(*args.values(), *rest, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
    elif fn == "verify_group_full":
        call = lambda d: vk.verify_group_full(*args.values(), *rest, None, None, None, **kw,  # noqa: E731
                                              extension_degree=d)
    else:
        class NoCollectives:  # the mismatch must raise before the verifier reaches the process group
            def get_group(self, *a):
                return None

        verifier = pv.build_sharded_verifier(NoCollectives(), **kw, extension_degree=deg + 1)
        call = lambda d: verifier(*args.values(), *rest, None, None, None)  # noqa: E731
    with pytest.raises(ValueError, match="extension_degree"):
        call(deg + 1)
