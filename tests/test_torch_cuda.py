"""The port's CUDA kernels on the card, against the host oracle.

Needs a CUDA device; every test skips without one.  This file imports no
JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Tolerance: exact (ristretto point equality, equality mod p).
"""

import numpy as np
import pytest
import torch

from bulletproofs_plus_tpu_torch.native import cuda
from bulletproofs_plus_tpu_torch.ops import cuda_fixed as cf
from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
from bulletproofs_plus_tpu_torch.ops import cuda_pow as cp
from bulletproofs_plus_tpu_torch.ops import cuda_ristretto as rcu
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import field as F
from bulletproofs_plus_tpu_torch.ops import fixed_base as fb
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, pack_ints
from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel

pytestmark = pytest.mark.cuda
P = hr.P


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


def _msm_inputs(n, seed):
    rs = np.random.RandomState(seed)
    scalars = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n)]
    scalars[0] = 0
    pts = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(n - 1)] + [hr.IDENTITY]
    return scalars, pts


@pytest.mark.parametrize("n", [1, 16, 40])  # one lane, one full tile, a ragged third tile
def test_msm_kernels_match_host(card, n, monkeypatch):
    """The MSM through the default digits (K7, signed) and through K1 (BPPT_MSM_SIGNED=0)."""
    scalars, pts = _msm_inputs(n, n)
    for env, first in ((None, "dyn_acc_signed"), ("0", "dyn_acc")):
        if env is None:
            monkeypatch.delenv("BPPT_MSM_SIGNED", raising=False)
        else:
            monkeypatch.setenv("BPPT_MSM_SIGNED", env)
        cuda.reset_launches()
        got = msm_kernel(torch.as_tensor(pack_ints(scalars).astype(np.int64), device=card),
                         ed.from_host(pts, device=card))
        assert hr.point_equal(ed.to_host(got), host_msm(scalars, pts))
        assert [cuda.launches[k] for k in (first, "lane_fold", "horner")] == [1, 1, 1]
        assert cuda.launches["dyn_acc"] + cuda.launches["dyn_acc_signed"] == 1


def pa(coords):
    """(4, 16, ...) limb-major coordinates -> PointArray."""
    return ed.PointArray(*(c.movedim(0, -1) for c in coords))


def _random_scalars(card, n, seed):
    """(16, n) canonical scalar limbs on the card, lane 0 a zero scalar where n > 1."""
    rs = np.random.RandomState(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n)]
    if n > 1:
        vals[0] = 0
    return torch.as_tensor(pack_ints(vals).astype(np.int64), device=card).t().contiguous()


# (lanes, K1's tile or the wrapper's pick): one lane; one full 16-lane tile; a ragged last tile of 18; 37 tiles,
# a count no block size of K2 divides into whole rounds of adders; 100 lanes; the MSMs of a 256 x 64-bit verify
# (4736 lanes) and of a 64 x (64-bit, m=4) one (2048)
@pytest.mark.parametrize("n, tile", [(1, None), (16, 16), (40, 18), (592, 16), (100, None), (4736, None),
                                     (2048, None)])
def test_msm_kernels_match_plain(card, n, tile):
    """K1 against its plain version, K2 against its own at every block size,
    K3 after them, and K7 at the same tile width against its plain version
    and through the same K2 to the same MSM; a zero scalar and an identity
    point (lanes 0 and n - 1, where n > 1) go through all of them."""
    sc_t = _random_scalars(card, n, n)
    pts = _random_projective(card, n, n + 1)
    if n > 1:
        pts = ed.cat([ed.PointArray(*(c[: n - 1] for c in pts)), ed.identity((1,), device=card)])
    pts_t = cm.coords_t(pts)
    picked = cm.pick_tile(n, cm.resident_tiles(card))
    tile = tile or picked
    cuda.reset_launches()
    parts = cm._launch_dyn_acc(sc_t, pts_t, tile) if tile != picked else cm.dyn_acc(sc_t, pts_t)
    assert tuple(parts.shape) == (64, -(-n // tile), cm.POINT_WORDS) and cuda.launches["dyn_acc"] == 1
    want = cm.dyn_acc_plain(sc_t, pts_t, tile)
    assert bool(rist.point_equal(pa(cf.words_to_coords(parts)), pa(cf.words_to_coords(want))).all())
    wsum = cm.lane_fold(parts)
    want2 = pa(cm.lane_fold_plain(parts))
    for threads in cf.FOLD_THREADS:
        assert bool(rist.point_equal(pa(cm._launch_lane_fold(parts, threads)), want2).all())
    assert bool(rist.point_equal(pa(wsum), want2).all())
    res = cm.horner(wsum)
    assert bool(rist.point_equal(pa(res), pa(cm.horner_plain(wsum))))
    picked7 = cm.pick_tile(n, cm.resident_tiles(card, "dyn_acc_signed"))
    want7 = pa(cf.words_to_coords(cm.dyn_acc_signed_plain(sc_t, pts_t, tile)))
    cuda.reset_launches()
    parts7 = cm.dyn_acc_signed(sc_t, pts_t) if tile == picked7 else cm._launch_dyn_acc_signed(sc_t, pts_t, tile)
    assert tuple(parts7.shape) == (64, -(-n // tile), cm.POINT_WORDS) and cuda.launches["dyn_acc_signed"] == 1
    assert bool(rist.point_equal(pa(cf.words_to_coords(parts7)), want7).all())
    assert bool(rist.point_equal(pa(cm.horner(cm.lane_fold(parts7))), pa(res)))


@pytest.mark.parametrize("kernel", ["dyn_acc", "dyn_acc_signed"])
def test_k1_grid_is_one_wave_of_two_blocks_an_sm(card, kernel):
    """The card holds two K1 (or K7) blocks an SM at every tile width (the
    design's cap of 128 registers for 256 threads), and the width the
    wrapper picks for each MSM of the verify paths makes one wave of them."""
    resident = cm.resident_tiles(card, kernel)
    sms = cm.sm_count(torch.device(card))
    for tile in range(1, cm.MAX_TILE + 1):
        assert cm.occupancy(kernel, torch.cuda.current_device(), tile=tile) >= 2
        assert resident(tile) >= 2 * sms
    for n in (16, 2048, 4736):
        assert -(-n // cm.pick_tile(n, resident)) <= resident(cm.pick_tile(n, resident))
    assert cm.occupancy("lane_fold", torch.cuda.current_device(), threads=512) >= 1


# (entry, tile, tiles, threads): K1's and K7's tile outside 1-32 and a tile count that is not ceil(n / tile);
# K2's block sizes that are not a power of two from 32 to 512
@pytest.mark.parametrize("entry, tile, tiles, threads", [
    ("dyn_acc", 0, 1, None), ("dyn_acc", 33, 1, None), ("dyn_acc", 2, 1, None),
    ("dyn_acc_signed", 0, 1, None), ("dyn_acc_signed", 33, 1, None), ("dyn_acc_signed", 2, 1, None),
    ("lane_fold", None, 1, 16), ("lane_fold", None, 1, 96), ("lane_fold", None, 1, 1024)])
def test_msm_entries_refuse_bad_launch_parameters(card, entry, tile, tiles, threads):
    """The C entries themselves, below the wrappers' checks: K1 and K7 refuse
    a tile their warps cannot hold or a grid that does not cover the lanes,
    K2 a block size its tree cannot sum."""
    n = 4
    sc_t = torch.zeros((16, n), dtype=torch.int64, device=card)
    pts_t = cm.coords_t(ed.identity((n,), device=card))
    out = torch.empty((64, 1, cm.POINT_WORDS), dtype=torch.int32, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "dyn_acc":
        status = cuda.lib("msm").bppt_dyn_acc(sc_t.data_ptr(), pts_t.data_ptr(), out.data_ptr(), n, tile, tiles, stream)
    elif entry == "dyn_acc_signed":
        status = cuda.lib("msm").bppt_dyn_acc_signed(sc_t.data_ptr(), pts_t.data_ptr(), out.data_ptr(), n, tile,
                                                     tiles, stream)
    else:
        wsum = torch.empty((4, 16, 64), dtype=torch.int64, device=card)
        status = cuda.lib("msm").bppt_lane_fold(out.data_ptr(), wsum.data_ptr(), 1, threads, stream)
    with pytest.raises(RuntimeError):
        cuda.check("msm", status, "msm entry")


FIELD_EDGES = [0, 1, P - 1, P, P + 1, 2**255 - 1, 2**256 - 1, 2**256 - 38, 2**256 - 30]


def test_pow_p58_kernel_matches_python(card):
    """K4 alone, the field edge values among its lanes: 251 squarings and 11
    products of the header's carry-flag code for each."""
    rs = np.random.RandomState(4)
    vals = [int.from_bytes(rs.bytes(32), "little") for _ in range(300)] + FIELD_EDGES
    x = torch.as_tensor(pack_ints(vals).astype(np.int64), device=card)
    want = [pow(v, (P - 5) // 8, P) for v in vals]
    for lanes in (None, 1, 4):  # the launcher's pick, then each form forced
        got = cp.pow_p58_cuda(x, lanes=lanes).cpu().numpy()
        assert [int_from_limbs(r) % P for r in got] == want
    odd = cp.pow_p58_cuda(x[:37], lanes=4).cpu().numpy()  # a last warp with idle groups
    assert [int_from_limbs(r) % P for r in odd] == want[:37]
    assert cp.pow_p58_cuda(x[:0]).shape == (0, 16)


@pytest.mark.parametrize("op", ["mul", "sqr", "mul4", "sqr4"])
def test_field_probe_chains_match_python(card, op):
    """The latency probe's chains of dependent fe_mul and fe_sqr, and of the
    four-lane product and squaring of D1's chain, from each edge value: x^(n
    + 1) and x^(2^n), with one warp and with three."""
    for v in FIELD_EDGES + [2**255 + 12345]:
        x = torch.as_tensor(pack_ints([v]).astype(np.int64)[0], device=card)
        for n, warps in ((1, 1), (2, 1), (37, 1), (5, 3)):
            got = int_from_limbs(cp.field_latency_probe(x, op, n, warps).cpu().numpy()) % P
            assert got == (pow(v, n + 1, P) if op.startswith("mul") else pow(v, 2**n, P))


@pytest.mark.parametrize("op", cp.POINT_PROBE_OPS)
def test_point_probe_chains_match_python(card, op):
    """The chains of dependent point operations, one lane a point (ge_dbl,
    ge_add) and four lanes a point (ge_dbl4, ge_add4), from a random point,
    the identity and a point with
    coordinates at and above p: 2^n P and (n + 1) P by the host's integers."""
    base = hr.point_mul(0x1234567 + len(op), hr.BASEPOINT)
    for point in (base, hr.IDENTITY, tuple(v + P for v in base), (2 * P, P + 1, P + 1, 2 * P)):
        p = torch.as_tensor(pack_ints(list(point)).astype(np.int64), device=card)
        for n, warps in ((0, 1), (1, 1), (2, 1), (37, 1), (5, 3)):
            got = ed.to_host(ed.PointArray(*cp.point_latency_probe(p, op, n, warps)))
            want = hr.point_mul(2**n if op.startswith("dbl") else n + 1, tuple(v % P for v in point))
            assert hr.point_equal(got, want)


def _random_projective(card, n, seed):
    """n points on the card with Z != 1: sums of two of 64 host multiples of the base point."""
    rs = np.random.RandomState(seed)
    pool = ed.from_host([hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(64)], device=card)
    i, j = (torch.as_tensor(rs.randint(0, 64, size=n), device=card) for _ in range(2))
    return ed.add(ed.PointArray(*(c[i] for c in pool)), ed.PointArray(*(c[j] for c in pool)))


@pytest.mark.parametrize("case", ["random", "all_identity", "only_w63", "only_w0", "not_canonical"])
def test_horner_kernel_edge_inputs(card, case):
    """K3 against its plain version and, through it, the host: nothing to
    sum, only the window with the longest chain of doublings, only the window
    with none, limbs at and above p."""
    pts = _random_projective(card, 64, 7)
    wsum = cm.coords_t(pts)
    identity = cm.coords_t(ed.identity((64,), device=card))
    if case == "all_identity":
        wsum = identity
    elif case == "only_w63":
        wsum = torch.cat([identity[..., :63], wsum[..., 63:]], dim=-1)
    elif case == "only_w0":
        wsum = torch.cat([wsum[..., :1], identity[..., 1:]], dim=-1)
    elif case == "not_canonical":
        host = [tuple(v + P for v in p) for p in ed.to_host(pts)[:32]] + [(2 * P, P + 1, P + 1, 2 * P)] * 32
        coords = [pack_ints([p[i] for p in host]).astype(np.int64) for i in range(4)]
        wsum = torch.as_tensor(np.stack(coords), device=card).transpose(1, 2).contiguous()
    want = pa(cm.horner_plain(wsum))
    host_w = ed.to_host(ed.PointArray(*(c.t() for c in wsum)))
    assert hr.point_equal(ed.to_host(want), host_msm([16**j for j in range(64)], [tuple(v % P for v in p) for p in host_w]))
    cuda.reset_launches()
    assert bool(rist.point_equal(pa(cm.horner(wsum)), want))
    assert cuda.launches["horner"] == 1


@pytest.mark.parametrize("count", [1, 2, 3, 16, 32, 96, 256, 8192])
def test_fixed_fold_kernel_counts(card, count):
    """K6 alone at each count of partials a block, in 1 to 3 lane groups,
    at every window split that divides the count and every block size: a
    count below the number of adders, one that fills no tree, loops of many
    partials an adder; three rows, one of them all identities."""
    rows = 3
    for groups in (1, 2, 3):
        for wsplit in (w for w in (1, 4, 16, 64) if count % w == 0):
            s = groups * count // wsplit
            pts = _random_projective(card, rows * wsplit * s, count + groups)
            parts = cf.limbs_to_words(torch.stack(list(pts), dim=1)).reshape(rows, wsplit * s, cf.POINT_WORDS)
            parts[1] = cf.limbs_to_words(torch.stack(list(ed.identity((wsplit * s,), device=card)), dim=1))
            want = pa(cf.fixed_fold_plain(parts, groups, wsplit))
            assert bool(rist.is_identity(ed.PointArray(*(c[1] for c in want))).all())
            for threads in (None,) + cf.FOLD_THREADS:
                got = cf.fixed_fold(parts, groups, wsplit, threads=threads)
                assert tuple(got.shape) == (4, 16, rows, groups)
                assert bool(rist.point_equal(pa(got), want).all())


@pytest.mark.parametrize("threads", [0, 16, 96, 384, 1024])
def test_fixed_fold_entry_refuses_block_sizes_its_tree_cannot_sum(card, threads):
    """The C entry itself, below the wrapper's own check: a block size that
    is not a power of two from 32 to 512 is an error, not a wrong sum."""
    parts = torch.zeros((1, 4, cf.POINT_WORDS), dtype=torch.int32, device=card)
    out = torch.empty((4, 16, 1, 1), dtype=torch.int64, device=card)
    status = cuda.lib("fixed").bppt_fixed_fold(parts.data_ptr(), out.data_ptr(), 1, 4, 1, 1, threads,
                                               torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError):
        cuda.check("fixed", status, "fixed_fold")


@pytest.mark.parametrize("broadcast_u", [False, True])
def test_sqrt_ratio_m1_kernel_matches_plain(card, broadcast_u):
    """K4's fused entry against the plain version: squares, non-squares,
    v = 0, u = 0, edge values and random lanes across a block boundary."""
    rs = np.random.RandomState(12)
    rnd = [int.from_bytes(rs.bytes(32), "little") for _ in range(2 * 151)]
    us = [1, 1, 4, 7, 0, 0, 2**256 - 1, P + 1] + FIELD_EDGES + rnd[:151]
    vs = [4, 2, 9, 0, 5, 0, 3, 2**256 - 30] + FIELD_EDGES[::-1] + rnd[151:]
    v = torch.as_tensor(pack_ints(vs).astype(np.int64), device=card)
    u = torch.as_tensor(pack_ints(us).astype(np.int64), device=card)
    if broadcast_u:
        u = F.limbs_const(1, v).expand(v.shape)
    cuda.reset_launches()
    was_square, r = rist.sqrt_ratio_m1(u, v)
    assert cuda.launches["sqrt_ratio_m1"] == 1 and cuda.launches["pow_p58"] == 0
    want_sq, want_r = rist.sqrt_ratio_m1_plain(u, v)
    assert was_square.dtype == torch.bool and torch.equal(was_square, want_sq)
    assert torch.equal(r, F.canon25519(want_r))
    for lanes in (1, 4):
        sq_l, r_l = cp.sqrt_ratio_m1_cuda(u, v, lanes=lanes)
        assert torch.equal(sq_l, want_sq) and torch.equal(r_l, r)
    if not broadcast_u:
        assert was_square.tolist()[:6] == [True, False, True, False, True, True]
    shaped_sq, shaped_r = rist.sqrt_ratio_m1(u.reshape(2, -1, 16)[:, :80], v.reshape(2, -1, 16)[:, :80])
    assert shaped_sq.shape == (2, 80) and torch.equal(shaped_r, r.reshape(2, -1, 16)[:, :80])
    empty_sq, empty_r = cp.sqrt_ratio_m1_cuda(u[:0], v[:0])
    assert empty_sq.shape == (0,) and empty_r.shape == (0, 16)


@pytest.mark.parametrize("n", [1, 16, 40])
def test_signed_msm_kernel_matches_host_and_plain(card, n):
    """K7 in K1's place: the same MSM, its partials equal to the plain version's."""
    scalars, pts = _msm_inputs(n, 50 + n)
    sc = torch.as_tensor(pack_ints(scalars).astype(np.int64), device=card)
    points = ed.from_host(pts, device=card)
    cuda.reset_launches()
    assert hr.point_equal(ed.to_host(msm_kernel(sc, points, signed=True)), host_msm(scalars, pts))
    assert [cuda.launches[k] for k in ("dyn_acc_signed", "dyn_acc", "lane_fold", "horner")] == [1, 0, 1, 1]
    sc_t, pts_t = sc.t().contiguous(), cm.coords_t(points)
    got, want = cm.dyn_acc_signed(sc_t, pts_t), cm.dyn_acc_signed_plain(sc_t, pts_t)
    assert bool(rist.point_equal(pa(cf.words_to_coords(got)), pa(cf.words_to_coords(want))).all())


@pytest.fixture(scope="module")
def fixed_setup():
    """12 base points and their packed digit tables (built on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    pts = [hr.point_mul(9 * i + 4, hr.BASEPOINT) for i in range(12)]
    return pts, fb.pack_tables(fb.build_tables(ed.from_host(pts, device="cuda")))


@pytest.mark.parametrize("rows, lanes, groups", [(1, 1, 1), (3, 12, 1), (5, 12, 2), (130, 6, 3)])
def test_fixed_kernels_match_host_and_plain(card, fixed_setup, rows, lanes, groups):
    """K5 and K6 at ragged shapes, with a lane permutation, a zero row and a
    row with one non-zero digit."""
    pts, tables = fixed_setup
    rs = np.random.RandomState(rows * 100 + lanes)
    scal = [[int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(lanes)] for _ in range(rows)]
    scal[0] = [0] * lanes
    if rows > 1:
        scal[1] = [0] * (lanes - 1) + [9 << (4 * 63 - 4)]
    perm = [int(v) for v in rs.permutation(12)[:lanes]]
    lane_idx = torch.as_tensor(perm, device=card)
    sc = torch.as_tensor(pack_ints([v for row in scal for v in row]).astype(np.int64), device=card).reshape(rows, lanes, 16)
    cuda.reset_launches()
    got = fb.fixed_msm_grouped(sc, tables, groups, lanes=perm)
    assert (cuda.launches["fixed_acc"], cuda.launches["fixed_fold"]) == (1, 1)
    per = lanes // groups
    flat = ed.to_host(ed.PointArray(*(c.reshape(-1, 16) for c in got)))
    for row in range(0, rows, max(1, rows // 4)):
        for grp in range(groups):
            idx = perm[grp * per : (grp + 1) * per]
            want = host_msm(scal[row][grp * per : (grp + 1) * per], [pts[i] for i in idx])
            assert hr.point_equal(flat[row * groups + grp], want)
    sc_t = sc.movedim(-1, 0).contiguous()
    for wsplit in (1,) + cf.WSPLITS + (64,):  # every split the wrapper picks, and the kernels' two extremes
        parts = cf.fixed_acc(tables, lane_idx, sc_t, wsplit)
        assert tuple(parts.shape) == (rows, wsplit * lanes, cf.POINT_WORDS)
        want = cf.fixed_acc_plain(tables, lane_idx, sc_t, wsplit)
        assert bool(rist.point_equal(pa(cf.words_to_coords(parts)), pa(cf.words_to_coords(want))).all())
        folded = cf.fixed_fold(parts, groups, wsplit)
        assert bool(rist.point_equal(pa(folded), pa(cf.fixed_fold_plain(parts, groups, wsplit))).all())
        for row in range(0, rows, max(1, rows // 4)):
            for grp in range(groups):
                assert hr.point_equal(ed.to_host(ed.PointArray(*(c[:, row, grp] for c in folded))), flat[row * groups + grp])


def test_compress_on_card_matches_host(card):
    pts = [hr.point_mul(k, hr.BASEPOINT) for k in (1, 2, 1000, 2**200 + 7)] + [hr.IDENTITY]
    points = ed.from_host(pts, device=card)
    points = ed.cat([points, ed.double(points)])
    from bulletproofs_plus_tpu_torch.ops.limbs import bytes_from_limbs

    cuda.reset_launches()
    got = bytes_from_limbs(rist.compress(points).cpu().numpy())
    assert dict(cuda.launches) == {"compress": 1}  # C1 alone: K4's chain runs inside it
    assert [r.tobytes() for r in got] == [hr.compress(p) for p in ed.to_host(points)]


def _ristretto_inputs(card, n, seed):
    """n decode inputs on the card: every 16th a valid encoding, the rest
    random values below 2^256 (almost all rejected), the first lanes the
    decode edges (s >= p, 2p, odd, p - 1, RFC 9496's bad encodings)."""
    rs = np.random.RandomState(seed)
    valid = [int.from_bytes(hr.compress(hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT)), "little")
             for _ in range(8)]
    edges = [0, P, P + 1, 2 * P, 2**256 - 1, 2**255 - 2, 1, P - 1, P - valid[0], 2 * P - valid[0]]
    vals = [valid[i % 8] if i % 16 == 0 else int.from_bytes(rs.bytes(32), "little") for i in range(n)]
    vals[: len(edges)] = edges[:n]
    return torch.as_tensor(pack_ints(vals).astype(np.int64), device=card)


# empty, one lane, a verify's 4096 points, the four-lane form with a ragged last warp and at its cut, just past
# it (one lane an element)
@pytest.mark.parametrize("n", [0, 1, 4096, 4099, 4224, 4225])
def test_decompress_kernel_matches_plain(card, n):
    """D1 against its plain twin in both forms and the launcher's pick: the
    mask exactly, the coordinates canonical and equal mod p, the identity on
    every rejected lane; one launch a call."""
    s = _ristretto_inputs(card, n, 40 + n)
    cuda.reset_launches()
    pts, ok = rist.decompress(s)
    assert dict(cuda.launches) == ({"decompress": 1} if n else {})
    want_pts, want_ok = rist.decompress_plain(s)
    assert ok.dtype == torch.bool and torch.equal(ok, want_ok)
    for c, w in zip(pts, want_pts):
        assert torch.equal(c, F.canon25519(w))
    if n >= 16:
        assert 0 < int(ok.sum()) < n
    for lanes in (1, 4):
        pts_l, ok_l = rcu.decompress_cuda(s, lanes=lanes)
        assert torch.equal(ok_l, ok) and all(torch.equal(a, b) for a, b in zip(pts_l, pts))


def test_decompress_kernel_decode_edges(card):
    """D1 at the 39 decode edges of chip_smoke.py (RFC 9496 Appendix A.2's
    bad encodings, s >= p, odd s, p - 1, the largest raw inputs, 0) before
    one valid encoding, in both forms: every edge but 0 rejected, its lane
    the identity, equal to the plain twin."""
    from chip_smoke import RFC9496_BAD

    valid = int.from_bytes(hr.compress(hr.point_mul(12345, hr.BASEPOINT)), "little")
    edges = [int.from_bytes(bytes.fromhex(h), "little") for h in RFC9496_BAD]
    edges += [P, P + 1, 2 * P, 2 * P - valid, 1, P - valid, P - 1, 2**256 - 1, 2**255 - 2, 0]
    assert len(edges) == 39
    s = torch.as_tensor(pack_ints(edges + [valid]).astype(np.int64), device=card)
    want_pts, want_ok = rist.decompress_plain(s)
    assert want_ok.tolist() == [False] * 38 + [True, True]
    for lanes in (1, 4):
        pts, ok = rcu.decompress_cuda(s, lanes=lanes)
        assert torch.equal(ok, want_ok)
        assert all(torch.equal(c, F.canon25519(w)) for c, w in zip(pts, want_pts))


@pytest.mark.parametrize("shape", [(0,), (1,), (128,), (128, 2), (4225,)])  # the prover's shapes, and ragged
def test_compress_kernel_matches_plain(card, shape):
    """C1 against its plain twin (limb for limb: both canonical) in both
    forms; points with Z not 1, the identity, and the identity's coset."""
    n = int(np.prod(shape))
    rs = np.random.RandomState(41 + n)
    base = ed.from_host([hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(16)]
                        + [hr.IDENTITY, (0, P - 1, 1, 0), (hr.SQRT_M1, 0, 1, 0)], device=card)
    base = ed.cat([base, ed.double(base)])
    idx = torch.as_tensor(rs.randint(0, base.x.shape[0], size=n), device=card)
    pts = ed.PointArray(*(c[idx].reshape(shape + (16,)) for c in base))
    cuda.reset_launches()
    got = rist.compress(pts)
    assert dict(cuda.launches) == ({"compress": 1} if n else {})
    want = rist.compress_plain(pts)
    assert got.shape == shape + (16,) and torch.equal(got, want)
    for lanes in (1, 4):
        assert torch.equal(rcu.compress_cuda(pts, lanes=lanes), want)
    strided = ed.PointArray(*(c[..., :1, :] for c in pts)) if len(shape) == 2 else pts
    assert torch.equal(rist.compress(strided), rist.compress_plain(strided))  # rows that are views


# the provers' shapes (128 proofs, 64 x m4's (64, 2)), one lane, past one block of 32 and of 1024
@pytest.mark.parametrize("shape", [(1,), (128,), (128, 2), (64, 2), (1025,)])
def test_double_compress_kernel_matches_plain(card, shape):
    """C1's double-and-encode against its plain twin, limb for limb, and
    against the sqrt form's encoding of the doubled points; lanes whose e is
    0 (the identity and the three other points of E[4]) among ordinary ones,
    in the first block and the last, encode as zero; one launch a call."""
    n = int(np.prod(shape))
    rs = np.random.RandomState(43 + n)
    i = hr.SQRT_M1
    e4 = [hr.IDENTITY, (0, P - 1, 1, 0), (i, 0, 1, 0), (P - i, 0, 1, 0)]
    base = ed.from_host([hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(16)], device=card)
    base = ed.cat([ed.from_host(e4, device=card), base, ed.double(base)])
    idx = rs.randint(len(e4), base.x.shape[0], size=n)
    zero = sorted({0, n // 2, n - 1} | ({33} if n > 33 else set()))
    idx[zero] = np.arange(len(zero)) % len(e4)
    pts = ed.PointArray(*(c[torch.as_tensor(idx, device=card)].reshape(shape + (16,)) for c in base))
    cuda.reset_launches()
    got = rist.double_and_compress(pts)
    assert dict(cuda.launches) == {"double_compress": 1}
    assert got.shape == shape + (16,) and torch.equal(got, rist.double_and_compress_plain(pts))
    assert not got.reshape(n, 16)[zero].any()
    assert torch.equal(got, rist.compress_plain(ed.double(pts)))


def test_fe_inv_probe_matches_python(card):
    """fe_inv (csrc/divsteps.cuh, a fixed 20 batches of divsteps mod p) on the
    card against Python's pow(x, p - 2, p): 0, 1, p - 1, p and above,
    2^256 - 1, many trailing zeros, then 256 seeded values below 2^256,
    32 lanes a launch; two inversions in a row give x mod p back."""
    rs = np.random.RandomState(14)
    edges = [0, 1, 2, P - 1, P, P + 1, 2**256 - 1, 2**200, 3 << 128, 1 << 254]
    vals = edges + [int.from_bytes(rs.bytes(32), "little") for _ in range(256 - len(edges))]
    for lo in range(0, len(vals), 32):
        chunk = vals[lo:lo + 32]
        x = torch.as_tensor(pack_ints(chunk).astype(np.int64), device=card)
        assert [int_from_limbs(r) for r in rcu.fe_inv_probe(x, 1).cpu().numpy()] == [pow(v, P - 2, P) for v in chunk]
        assert [int_from_limbs(r) for r in rcu.fe_inv_probe(x, 2).cpu().numpy()] == [v % P for v in chunk]


def test_is_identity_kernel_matches_plain(card):
    """I1 against its plain twin: the identity, its coset with X = 0 or
    Y = 0, coordinates not canonical (p, 2p), random points; and K3's (4, 16)
    output read in place after a valid and a tampered MSM."""
    i = hr.SQRT_M1
    forms = [(0, 1, 1, 0), (0, P - 1, 1, 0), (i, 0, 1, 0), (P - i, 0, 1, 0), (0, 5, 5, 0), (P, 7, 7, 0),
             (2 * P, 3, 3, 0), (5, 2 * P, 9, 0)]
    rs = np.random.RandomState(42)
    forms += [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(130)]
    pts = ed.PointArray(*(torch.as_tensor(pack_ints([f[c] for f in forms]).astype(np.int64), device=card)
                          for c in range(4)))
    cuda.reset_launches()
    got = rist.is_identity(pts)
    assert dict(cuda.launches) == {"is_identity": 1}
    assert torch.equal(got, rist.is_identity_plain(pts)) and got.tolist() == [True] * 8 + [False] * 130
    scalars, points = _msm_inputs(16, 43)
    sc = torch.as_tensor(pack_ints(scalars).astype(np.int64), device=card)
    p_dev = ed.from_host(points, device=card)
    neg = torch.as_tensor(pack_ints([(hr.L - v) % hr.L for v in scalars]).astype(np.int64), device=card)
    for scal, want in ((torch.cat([sc, neg]), True), (torch.cat([sc, sc]), False)):
        res = msm_kernel(scal, ed.cat([p_dev, p_dev]))  # views of K3's one (4, 16) output
        ptrs = [c.data_ptr() for c in res]
        assert ptrs[1] - ptrs[0] == 16 * 8
        cuda.reset_launches()
        assert bool(rist.is_identity(res)) is want
        assert cuda.launches["is_identity"] == 1


@pytest.mark.parametrize("case", ["valid", "tampered", "all_identity", "random"])
def test_horner_identity_tail_matches_is_identity(card, case):
    """K3 with its tail: the point is K3's alone and the verdict is I1's on
    it and the plain twin's, from one launch of K3 and none of I1: the sum
    of a valid and a tampered MSM, window sums all the identity, random
    projective window sums."""
    if case in ("valid", "tampered"):
        scalars, points = _msm_inputs(16, 47)
        sc = torch.as_tensor(pack_ints(scalars).astype(np.int64), device=card)
        other = [(hr.L - v) % hr.L for v in scalars] if case == "valid" else scalars
        sc = torch.cat([sc, torch.as_tensor(pack_ints(other).astype(np.int64), device=card)])
        p_dev = ed.from_host(points, device=card)
        wsum = cm.lane_fold(cm.dyn_acc_signed(sc.t().contiguous(), cm.coords_t(ed.cat([p_dev, p_dev]))))
    elif case == "all_identity":
        wsum = torch.zeros((4, 16, 64), dtype=torch.int64, device=card)
        wsum[1, 0] = 1
        wsum[2, 0] = 1
    else:
        wsum = cm.coords_t(_random_projective(card, 64, 9))
    cuda.reset_launches()
    point, flag = cm.horner(wsum, identity=True)
    assert dict(cuda.launches) == {"horner": 1}
    assert torch.equal(point, cm.horner(wsum))
    plain_point, plain_flag = cm.horner_identity_plain(wsum)
    assert bool(rist.point_equal(ed.PointArray(*point), ed.PointArray(*plain_point)))
    assert flag.shape == () and bool(flag) == bool(plain_flag) == bool(rcu.is_identity_cuda(ed.PointArray(*point)))
    assert bool(flag) == (case in ("valid", "all_identity"))


def _transcript_inputs(batch, bits, m, deg, seeded, device, seed):
    """A prove's T1 phases from a fresh stacked transcript that has absorbed
    nothing, random points, witness bytes and blocks on `device`, lane 3's
    first point of phase 1 all zeroes."""
    from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct
    from bulletproofs_plus_tpu_torch.utils.merlin import Transcript

    rs = np.random.RandomState(seed)
    rounds = (bits * m).bit_length() - 1
    stacked = Transcript.stack([Transcript(b"t1") for _ in range(batch)])
    st = stacked.strobe
    width = m * (8 + 32 * deg)
    phases, _ = ct.prover_phases(rounds, deg, seeded, width, st.pos, st.pos_begin, st.cur_flags)
    state = torch.as_tensor(rs.randint(0, 256, (batch, 200), dtype=np.uint8), device=device)
    witness = torch.as_tensor(rs.randint(0, 256, (batch, width), dtype=np.uint8), device=device)
    blocks = torch.as_tensor(rs.randint(0, 256, (rounds + 2, batch, 32), dtype=np.uint8), device=device)
    points = [torch.as_tensor(rs.randint(0, 1 << 16, (batch, ph.n_points, 16)), device=device) for ph in phases]
    points[1][3, 0] = 0
    return phases, state, witness, blocks, points


@pytest.mark.parametrize("batch, bits, m, deg, seeded", [(128, 64, 1, 1, True), (128, 64, 1, 1, False),
                                                         (64, 64, 4, 5, False), (5, 1, 1, 2, False)],
                         ids=["b64_m1_x128_seeded", "b64_m1_x128", "b64_m4_x64_deg5", "one_bit_x5"])
def test_prove_transcript_kernel_matches_plain(card, batch, bits, m, deg, seeded):
    """T1 against its plain twin on the card at every phase of a prove:
    states, every draw, challenge and inverse, and the flags, exactly, one
    launch a phase; lane 3's zeroed point flags lane 3 alone."""
    from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct

    phases, state, witness, blocks, points = _transcript_inputs(batch, bits, m, deg, seeded, card, batch + deg)
    plain_state = state.clone()
    for p, phase in enumerate(phases):
        block = blocks[p] if phase.n_draws else None
        n = phase.n_wide + len(phase.invert)
        outs = torch.full((n, batch, 16), -1, dtype=torch.int64, device=card)
        flags = torch.full((batch,), 255, dtype=torch.uint8, device=card)
        cuda.reset_launches()
        ct.prove_transcript(phase, state, points[p], witness, block, list(outs), flags)
        assert dict(cuda.launches) == {"prove_transcript": 1}
        want_state, scalars, inverses, want_flags = ct.transcript_plain(phase, plain_state, points[p], witness, block)
        plain_state = want_state
        assert torch.equal(state, want_state), p
        assert torch.equal(outs, torch.cat([scalars, inverses], dim=1).transpose(0, 1)), p
        assert torch.equal(flags, want_flags), p
        assert flags.nonzero().flatten().tolist() == ([3] if p == 1 else []), p


def _golden_cells():
    import json
    import os

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_vectors.json")) as f:
        return json.load(f)


def _golden_replay(cell, batch, device):
    """replay_fn of a golden cell's shape, with its state and rows tiled to `batch` lanes on `device`."""
    import bulletproofs_plus_tpu_torch as tbp
    from bulletproofs_plus_tpu_torch.models.replay_device import pack_replay_inputs, replay_fn

    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(cell["extension_degree"]))
    params = tbp.RangeParameters.init(cell["bits"], len(cell["values"]), pc)
    commitments = [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    statement = tbp.RangeStatement.init(params, commitments, mv, seed_nonce=cell["seed_nonce"])
    proof = tbp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    stacked = tbp.Transcript.stack([tbp.Transcript(b"golden") for _ in range(batch)])
    fn = replay_fn(params.h_base_compressed(), tuple(params.g_bases_compressed()), cell["bits"],
                   cell["extension_degree"], len(commitments), len(proof.li),
                   stacked.strobe.pos, stacked.strobe.pos_begin, stacked.strobe.cur_flags)
    state = torch.as_tensor(stacked.strobe.state, device=device).clone()
    buf = torch.as_tensor(pack_replay_inputs([statement] * batch, [proof] * batch).copy(), device=device)
    return fn, state, buf, (statement, proof)


def _random_lanes(state, buf, seed):
    """Every lane but lane 0 random state and row bytes (the replay is a function of any bytes)."""
    rs = np.random.RandomState(seed)
    state[1:] = torch.as_tensor(rs.randint(0, 256, size=tuple(state[1:].shape), dtype=np.uint8))
    buf[1:] = torch.as_tensor(rs.randint(0, 256, size=tuple(buf[1:].shape), dtype=np.uint8))


def _assert_replay_equal(got, want):
    names = ("scalars", "seeds", "bad_identity", "bad_zero")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and torch.equal(g, w.to(g.dtype)), name


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_replay_kernel_matches_plain(card, seed):
    """R1 on every golden shape, 40 lanes (random bytes on lanes 1-39): its
    whole output -- canonical limbs, seeds, both flags -- equals the plain
    replay_fn (the sequence, then reduce_wide_l and is_zero_l) on the card;
    lane 33's zeroed A raises bad_identity there only; lane 0's challenges
    are the golden ones."""
    from bulletproofs_plus_tpu_torch.models.replay_device import row_layout
    from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr

    cell = next(c for c in _golden_cells() if c["seed"] == seed)
    fn, state, buf, (_, proof) = _golden_replay(cell, 40, card)
    _random_lanes(state, buf, seed)
    lo = row_layout(len(cell["values"]), len(proof.li), len(proof.d1))[0]["a"][0]
    buf[33, lo : lo + 32] = 0
    cuda.reset_launches()
    got = cr.replay(fn.program, state, buf)
    assert dict(cuda.launches) == {"replay": 1}
    _assert_replay_equal(got, cr.replay_fn_plain(fn.program, state, buf))
    assert got[2].nonzero().flatten().tolist() == [33]
    y, z, es, e, seeds, bad_identity, bad_zero = fn(state, buf)
    assert format(int_from_limbs(y[0].cpu().numpy()), "064x") == cell["y"]
    assert format(int_from_limbs(z[0].cpu().numpy()), "064x") == cell["z"]
    assert [format(int_from_limbs(v), "064x") for v in es[0].cpu().numpy()] == cell["round_es"]
    assert format(int_from_limbs(e[0].cpu().numpy()), "064x") == cell["e"]
    assert not bool(bad_zero.any()) and bool(bad_identity[33]) and seeds.shape == (40, 32)


@pytest.mark.parametrize("warps", [3, 8])
def test_replay_ragged_last_block(card, warps):
    """Blocks of several warps over 37 proofs: the last block's spare warps
    neither write nor hold the others back; every lane equals the plain
    version."""
    from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr

    cell = next(c for c in _golden_cells() if c["seed"] == 6)
    fn, state, buf, _ = _golden_replay(cell, 37, card)
    _random_lanes(state, buf, warps)
    cuda.reset_launches()
    got = cr.replay_cuda(fn.program, state, buf, warps=warps)
    assert cuda.launches["replay"] == 1
    _assert_replay_equal(got, cr.replay_fn_plain(fn.program, state, buf))


def _wide_edges(seed):
    """64-byte values at the reduction's edges, then random ones -> (ints, (n, 64) uint8)."""
    L = hr.L
    rs = np.random.RandomState(seed)
    vals = [0, 1, L - 1, L, L + 1, 2**252, 2**256 - 1, 2**512 - 1, L * ((2**512 - 1) // L)]
    vals += [L * (2**259 + k) for k in (-3, -1, 0, 1, 5)]
    vals += [int.from_bytes(rs.bytes(64), "little") for _ in range(50)]
    return vals, np.frombuffer(b"".join(v.to_bytes(64, "little") for v in vals), dtype=np.uint8).reshape(-1, 64)


def test_reduce_wide_probe_edges(card):
    """R1's epilogue alone on edge values near 0, l, 2^256, multiples of l and
    2^512: exact against Python integers; zero exactly on the multiples of l."""
    from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr

    vals, arr = _wide_edges(11)
    limbs, zero = cr.reduce_wide_probe(torch.as_tensor(arr.copy(), device=card))
    assert [int_from_limbs(r) for r in limbs.cpu().numpy()] == [v % hr.L for v in vals]
    assert zero.cpu().tolist() == [v % hr.L == 0 for v in vals]


def test_replay_fn_is_one_launch(card):
    """replay_fn on CUDA tensors is one R1 launch and no other device work."""
    from torch.profiler import ProfilerActivity, profile

    cell = next(c for c in _golden_cells() if c["seed"] == 3)
    fn, state, buf, _ = _golden_replay(cell, 256, card)
    fn(state, buf)  # the program's upload
    torch.cuda.synchronize()
    cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(state, buf)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))]
    assert dict(cuda.launches) == {"replay": 1}
    assert len(kernels) == 1 and "replay_kernel" in kernels[0], kernels


def test_perm_probe_matches_plain(card):
    """The warp's permutation chain against utils/jkeccak.py."""
    from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr
    from bulletproofs_plus_tpu_torch.utils import jkeccak

    rs = np.random.RandomState(9)
    st = torch.as_tensor(rs.randint(0, 256, size=(1, 200), dtype=np.uint8), device=card)
    want = st
    for _ in range(3):
        want = jkeccak.state_to_bytes(jkeccak.keccak_f1600(jkeccak.bytes_to_state(want)))
    got = cr.perm_latency_probe(st.view(torch.int64).reshape(25), 3)
    assert torch.equal(got.view(torch.uint8).reshape(1, 200), want)


def test_keccak_probe_matches_plain(card):
    """The latency probe's permutation chain against utils/jkeccak.py."""
    from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr
    from bulletproofs_plus_tpu_torch.utils import jkeccak

    rs = np.random.RandomState(5)
    st = torch.as_tensor(rs.randint(0, 256, size=(1, 200), dtype=np.uint8), device=card)
    want = st
    for _ in range(3):
        want = jkeccak.state_to_bytes(jkeccak.keccak_f1600(jkeccak.bytes_to_state(want)))
    got = cr.keccak_latency_probe(st.view(torch.int64).reshape(25), 3)
    assert torch.equal(got.view(torch.uint8).reshape(1, 200), want)


def test_device_replay_verify_on_card(card):
    """A single-shape batch verifies through R1 once, the golden mask comes back.
    Mask recovery decompresses every proof's points for the structural checks
    before the verification's own decompression: D1 twice, K3 once with the
    verdict in its tail and no I1, and no launch of K4's own entries."""
    import bulletproofs_plus_tpu_torch as tbp

    cell = next(c for c in _golden_cells() if c["seed"] == 3)
    _, _, _, (statement, proof) = _golden_replay(cell, 1, card)
    cuda.reset_launches()
    masks = tbp.RangeProof.verify_batch([tbp.Transcript(b"golden") for _ in range(4)], [statement] * 4,
                                        [proof] * 4, tbp.VerifyAction.RECOVER_AND_VERIFY, device=card)
    assert [cuda.launches[k] for k in ("replay", "decompress", "horner", "is_identity")] == [1, 2, 1, 0]
    assert cuda.launches["sqrt_ratio_m1"] == 0 and cuda.launches["pow_p58"] == 0
    assert all([format(b, "064x") for b in m.blindings()] == cell["mask"] for m in masks)


@pytest.mark.parametrize("backend, world", [("gloo", 2), ("nccl", 1)], ids=["gloo_two_ranks_one_card", "nccl"])
def test_sharded_prove_and_verify_on_card(card, backend, world):
    """Ranks of one process group on the card (gloo: two ranks share card 0;
    NCCL, which takes one card a rank: one rank): each rank's sharded prove
    equals its unsharded prove byte for byte, its sharded verify the
    unsharded masks, a tampered batch fails on every rank, and each rank
    launched the prover's (K5, K6, C1's double-and-encode) and the
    verifier's (K7, K2, K3, D1, I1) kernels itself, with no device replay
    under a mesh and no launch of K4's own entries or C1's sqrt form."""
    import torch_ranks

    cuda.build()  # in the parent, so that the ranks do not compile at once
    ranks = torch_ranks.Ranks(torch_ranks.card_checks, world, backend, "cuda")
    try:
        results = ranks.results()
    finally:
        ranks.close()
    for rank in results:
        assert rank["prove_equal"] and rank["verify_equal"]
        assert all(m is not None for m in rank["masks"])
        assert rank["tampered"] == ["VerificationFailed", "Range proof batch not valid"]
        prove, verify = rank["prove_launches"], rank["verify_launches"]
        assert all(prove.get(k) for k in ("fixed_acc", "fixed_fold", "double_compress", "prove_prep", "prove_round",
                                          "prove_final", "prove_responses", "bit_sum")), prove
        assert not prove.get("compress"), prove
        assert all(verify.get(k) for k in ("dyn_acc_signed", "lane_fold", "horner", "decompress", "is_identity")), verify
        assert not verify.get("replay") and not verify.get("sqrt_ratio_m1") and not prove.get("sqrt_ratio_m1"), verify


def test_world_of_one_mesh_on_card(card):
    """Without a process group, `global_dp_mesh()` makes this process a world
    of one over NCCL: a verify and a prove with `mesh=` equal the unsharded
    ones on the card."""
    import torch_ranks

    from bulletproofs_plus_tpu_torch.parallel import global_dp_mesh

    statements, witnesses = torch_ranks.shape(torch_ranks.tbp, "b4_m1")
    proofs, states = torch_ranks.prove(statements, witnesses, "b4_m1", None, card)
    mesh = global_dp_mesh()
    try:
        assert mesh.size() == 1 and torch.distributed.get_backend() == "nccl"
        sharded, sharded_states = torch_ranks.prove(statements, witnesses, "b4_m1", mesh, card)
        assert [p.to_bytes() for p in sharded] == [p.to_bytes() for p in proofs] and sharded_states == states
        want = torch_ranks.verify(statements, proofs, "RECOVER_AND_VERIFY", device=card)
        assert torch_ranks.verify(statements, proofs, "RECOVER_AND_VERIFY", device=card, mesh=mesh) == want
        assert all(m is not None for m in want)
    finally:
        torch.distributed.destroy_process_group()


def _scalar_inputs(batch, m, n, deg, seed, card, mins=False, zero_lane=None, one_y=None):
    """tests/torch_scalar_inputs.py's inputs on the card, y, z, the round
    challenges and e as views of one (batch, rounds + 3, 16) tensor, as the
    replay hands them over."""
    from torch_scalar_inputs import scalar_inputs

    rounds = (m * n).bit_length() - 1
    out = {k: torch.as_tensor(v, device=card)
           for k, v in scalar_inputs(batch, m, n, deg, seed, mins, zero_lane, one_y).items()}
    ch = torch.cat([out["y"][:, None], out["z"][:, None], out["round_es"], out["e"][:, None]], dim=1)
    out.update(y=ch[:, 0], z=ch[:, 1], round_es=ch[:, 2 : 2 + rounds], e=ch[:, 2 + rounds])
    return out


# (batch, m, bit length, extension degree, max_mn, minimum values, zero-challenge lane, lane with y = 1): one
# proof; a 256 x 64-bit verify's group; a 64 x m4 one of degree 5; the mixed batch's m=2 group (minimum values)
# and its m=1 group padded to the batch's widest; a zero challenge and a y of 1 poisoning their lanes; one-bit
# proofs (no rounds) with a y of 1; m = 512, whose program needs 1,318 slots and 142 KB of shared memory a block;
# m = 1024, one proof a block at 32 lanes; m = 2048, whose slots lie in global memory; m = 32768, slot indices past
# 16 bits
@pytest.mark.parametrize("batch, m, n, deg, max_mn, mins, zero_lane, one_y", [
    (1, 1, 64, 1, 64, False, None, None), (256, 1, 64, 1, 64, False, None, None),
    (64, 4, 64, 5, 256, False, None, None), (128, 2, 64, 1, 128, True, None, None),
    (128, 1, 64, 1, 128, False, None, None), (40, 1, 64, 1, 64, True, 3, 7), (9, 1, 1, 2, 2, True, None, 4),
    (3, 512, 2, 1, 1024, True, None, 1), (2, 1024, 1, 1, 1024, True, None, None),
    (3, 2048, 1, 1, 2048, True, None, None), (1, 32768, 1, 1, 32768, True, None, None),
], ids=["b1", "b256_m1", "b64_m4_deg5", "mixed_m2", "mixed_m1_padded", "zero_challenge", "rounds0_y_one",
        "m512_wide_program", "m1024_one_proof_a_block", "m2048_global_slots", "m32768_wide_slot_indices"])
def test_scalar_pass_kernel_matches_plain(card, batch, m, n, deg, max_mn, mins, zero_lane, one_y):
    """S1 on the card equals the plain scalar pass limb for limb, every output."""
    from bulletproofs_plus_tpu_torch.models.verifier_kernels import scalar_pass, scalar_pass_plain

    args = _scalar_inputs(batch, m, n, deg, batch + m, card, mins, zero_lane, one_y)
    cuda.reset_launches()
    got = scalar_pass(**args, m=m, bit_length=n, max_mn=max_mn)
    assert dict(cuda.launches) == {"scalar_pass": 1}
    want = scalar_pass_plain(**args, m=m, bit_length=n, max_mn=max_mn)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), k
    if zero_lane is not None:  # the poisoned lanes' inverses are 0: their R scalars vanish
        assert not got[9][zero_lane].any() and not got[9][one_y].any() and got[9][0].any()


def test_scalar_inv_probe_matches_python(card):
    """sc_inv_l, Bernstein and Yang's divsteps, on the card against Python's
    pow(x, -1, l): 0 (gives 0), 1, 2, l - 1, l - 2, (l + 1) / 2, 2^252 and
    small values, then 1,024 seeded values, 32 lanes a launch; two
    inversions in a row give x back."""
    from bulletproofs_plus_tpu_torch.ops import cuda_scalar as cs

    L = hr.L
    rs = np.random.RandomState(13)
    edges = [0, 1, 2, L - 1, L - 2, (L + 1) // 2, 2**252] + list(range(3, 28))
    vals = edges + [int.from_bytes(rs.bytes(32), "little") % L for _ in range(1024)]
    for lo in range(0, len(vals), 32):
        chunk = vals[lo:lo + 32]
        x = torch.as_tensor(pack_ints(chunk).astype(np.int64), device=card)
        got = [int_from_limbs(r) for r in cs.inv_latency_probe(x, 1).cpu().numpy()]
        assert got == [pow(v, -1, L) if v else 0 for v in chunk], lo
        assert torch.equal(cs.inv_latency_probe(x, 2), x)


@pytest.mark.parametrize("action", ["VERIFY_ONLY", "RECOVER_AND_VERIFY", "RECOVER_ONLY"])
def test_one_bit_verify_on_card(card, action):
    """One-bit proofs (n = 1, m = 1, degrees 1 and 2: no rounds) through
    verify_batch(engine="device") on the card give the host engine's
    verdicts and masks, through R1 (no round challenges) and S1 (y and
    y - 1 inverted alone)."""
    import bulletproofs_plus_tpu_torch as tbp

    for deg in (1, 2):
        pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(deg))
        params = tbp.RangeParameters.init(1, 1, pc)
        openings = [tbp.CommitmentOpening(v, [17 + 5 * v + k for k in range(deg)]) for v in (1, 0, 1)]
        statements = [tbp.RangeStatement.init(params, [pc.commit(o.v, o.r)], [None], 40 + i)
                      for i, o in enumerate(openings)]
        proofs = tbp.RangeProof.prove_batch_with_rng(
            [tbp.Transcript(b"one") for _ in openings], statements, [tbp.RangeWitness.init([o]) for o in openings],
            tbp.SeededRng(9), device="cpu")
        assert not proofs[0].li

        def verify(**kw):
            masks = tbp.RangeProof.verify_batch([tbp.Transcript(b"one") for _ in proofs], statements, proofs,
                                                getattr(tbp.VerifyAction, action), **kw)
            return [None if m is None else m.blindings() for m in masks]

        want = verify(engine="host")
        cuda.reset_launches()
        assert verify(engine="device", device=card) == want
        assert cuda.launches["replay"] == 1
        assert cuda.launches["scalar_pass"] == (0 if action == "RECOVER_ONLY" else 1)
        assert (want[0] is None) == (action == "VERIFY_ONLY")


def test_scalar_latency_probe_matches_python(card):
    """The probe's chains: x^(iters + 1) mod l on each lane."""
    from bulletproofs_plus_tpu_torch.ops import cuda_scalar as cs

    rs = np.random.RandomState(12)
    vals = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(30)] + [0, hr.L - 1]
    got = cs.mul_latency_probe(torch.as_tensor(pack_ints(vals).astype(np.int64), device=card), 5)
    assert [int_from_limbs(r) for r in got.cpu().numpy()] == [pow(v, 6, hr.L) for v in vals]


def test_scalar_pass_once_a_shape_group(card):
    """verify_batch(engine="device") launches S1 once for a single-shape
    batch and once a shape group for a mixed one (golden proofs 3 and 4)."""
    import bulletproofs_plus_tpu_torch as tbp

    cells = {c["seed"]: c for c in _golden_cells()}
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1))
    params = tbp.RangeParameters.init(64, 2, pc)

    def pair(cell):
        mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(cell["commitments"])
        statement = tbp.RangeStatement.init(params, [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]],
                                            mv, seed_nonce=cell["seed_nonce"])
        return statement, tbp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))

    for pairs, groups in (([pair(cells[3])] * 4, 1), ([pair(cells[3]), pair(cells[4])] * 2, 2)):
        statements, proofs = [p[0] for p in pairs], [p[1] for p in pairs]
        cuda.reset_launches()
        got = tbp.RangeProof.verify_batch([tbp.Transcript(b"golden") for _ in proofs], statements, proofs,
                                          tbp.VerifyAction.VERIFY_ONLY, device=card)
        assert len(got) == len(proofs) and cuda.launches["scalar_pass"] == groups, dict(cuda.launches)


# (batch, m, bit length, extension degree): the 128 x 64-bit prove's shape and a 64 x (64-bit, m=4) one of degree 5
PROVER_SHAPES = [(128, 1, 64, 1), (64, 4, 64, 5)]
PROVER_IDS = ["b128_mn64_deg1", "b64_mn256_deg5"]


def _equal(got, want):
    """Kernel outputs on the card against the plain twin's on the CPU, limb for limb."""
    return all(g.shape == w.shape and torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("batch, m, n, deg", PROVER_SHAPES, ids=PROVER_IDS)
def test_prove_scalar_kernels_match_plain(card, batch, m, n, deg):
    """P1, P2 (round 0, round 1, the last round), P3's two entries on the card
    against their plain twins on the CPU, every output limb for limb, one
    launch each."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import final_inputs, prep_inputs, responses_inputs, round_inputs, to_device

    mn = m * n
    rounds = mn.bit_length() - 1
    inp = prep_inputs(batch, m, n, deg, seed=batch + deg)
    cuda.reset_launches()
    got = cpr.prove_prep(**to_device(inp, torch, card), bit_length=n)
    assert _equal(got, PK.prove_prep_plain(**to_device(inp, torch, "cpu"), bit_length=n))
    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")
    for r in sorted({0, 1, rounds - 1}):
        inp = round_inputs(batch, m, n, deg, r, seed=r + deg)
        got = cpr.prove_round(*(to_device(inp, torch, card)[k] for k in keys), r=r)
        assert _equal(got, PK.prove_round_plain(*(to_device(inp, torch, "cpu")[k] for k in keys), r=r)), r
    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s", "s_s", "d_mask", "eta")
    inp = final_inputs(batch, m, n, deg, seed=deg)
    got = cpr.prove_final(*(to_device(inp, torch, card)[k] for k in keys))
    assert _equal(got, PK.prove_final_plain(*(to_device(inp, torch, "cpu")[k] for k in keys)))
    keys = ("r_s", "s_s", "a0", "b0", "eta", "d_mask", "alpha", "e")
    inp = responses_inputs(batch, deg, seed=deg)
    got = cpr.prove_responses(*(to_device(inp, torch, card)[k] for k in keys))
    assert _equal(got, PK.prove_responses_plain(*(to_device(inp, torch, "cpu")[k] for k in keys)))
    assert dict(cuda.launches) == {"prove_prep": 1, "prove_round": len({0, 1, rounds - 1}), "prove_final": 1,
                                   "prove_responses": 1}


# (batch, m, bit length, extension degree): mn 1 (no rounds, no fold) to 2,048 (lane items strided), degrees 1, 5
# and 6, batches of one proof, 128, 129 and 1,025
FINAL_SHAPES = [(1, 1, 1, 1), (1025, 1, 1, 6), (128, 1, 64, 1), (129, 1, 64, 5), (1025, 1, 64, 6), (128, 4, 64, 5),
                (1, 4, 64, 6), (129, 4, 64, 1), (2, 32, 64, 1), (1, 32, 64, 6)]


@pytest.mark.parametrize("batch, m, n, deg", FINAL_SHAPES,
                         ids=[f"b{b}_mn{m * n}_deg{d}" for b, m, n, d in FINAL_SHAPES])
def test_prove_final_kernel_matches_plain(card, batch, m, n, deg):
    """P3's first entry on the card against its plain twin on the CPU, every
    output limb for limb, one launch; the fold's challenge zero-free at odd
    degrees."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import final_inputs, to_device

    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "r_s", "s_s", "d_mask", "eta")
    inp = final_inputs(batch, m, n, deg, seed=batch + m * n + deg, zero_free=deg % 2 == 1)
    cuda.reset_launches()
    got = cpr.prove_final(*(to_device(inp, torch, card)[k] for k in keys))
    assert _equal(got, PK.prove_final_plain(*(to_device(inp, torch, "cpu")[k] for k in keys)))
    assert dict(cuda.launches) == {"prove_final": 1}


def test_prove_responses_kernel_matches_plain(card):
    """P3's second entry on the card against its plain twin on the CPU at
    batches 1, 128, 129 and 1,025 and degrees 1, 5 and 6 (a ragged last
    block), every output limb for limb, one launch a call."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import responses_inputs, to_device

    keys = ("r_s", "s_s", "a0", "b0", "eta", "d_mask", "alpha", "e")
    cuda.reset_launches()
    cases = [(batch, deg) for batch in (1, 128, 129, 1025) for deg in (1, 5, 6)]
    for batch, deg in cases:
        inp = responses_inputs(batch, deg, seed=batch + deg)
        got = cpr.prove_responses(*(to_device(inp, torch, card)[k] for k in keys))
        assert _equal(got, PK.prove_responses_plain(*(to_device(inp, torch, "cpu")[k] for k in keys))), (batch, deg)
    assert dict(cuda.launches) == {"prove_responses": len(cases)}


# both prove shapes, and mn = 2048, whose items the threads stride over and whose scratch lies in device memory
@pytest.mark.parametrize("batch, m, n, deg", PROVER_SHAPES + [(2, 32, 64, 1)], ids=PROVER_IDS + ["b2_mn2048"])
def test_prove_round_kernel_every_round(card, batch, m, n, deg):
    """P2 on the card against its plain twin on the CPU at every round,
    every output limb for limb, one launch a round; the folds' challenges
    zero-free and not."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import round_inputs, to_device

    mn = m * n
    rounds = mn.bit_length() - 1
    keys = ("a", "b", "g", "h", "alpha", "fold", "y_pows", "y_inv_n", "d_l", "d_r")
    cuda.reset_launches()
    for r in range(rounds):
        inp = round_inputs(batch, m, n, deg, r, seed=100 + r, zero_free=r % 2 == 1)
        got = cpr.prove_round(*(to_device(inp, torch, card)[k] for k in keys), r=r)
        assert _equal(got, PK.prove_round_plain(*(to_device(inp, torch, "cpu")[k] for k in keys), r=r)), r
    assert dict(cuda.launches) == {"prove_round": rounds}


# (batch, m, bit length, extension degree): P1 at mn 1 (no rounds) to 2,048 (m 32), m 1,024 with n 1 (the C entry's
# most), and mn 4,096, whose slots lie in device memory (prove_prep_global_kernel); degrees 1, 5 and 6, batches 1,
# 129 and 1,025
PREP_SHAPES = [(1, 1, 1, 1), (1025, 1, 1, 6), (129, 1, 64, 5), (1025, 1, 64, 6), (1, 1, 64, 1), (128, 4, 64, 5),
               (129, 4, 64, 1), (1, 4, 64, 6), (2, 32, 64, 1), (129, 32, 64, 6), (1, 1024, 1, 5), (2, 64, 64, 1)]


@pytest.mark.parametrize("batch, m, n, deg", PREP_SHAPES, ids=[f"b{b}_m{m}_mn{m * n}_deg{d}" for b, m, n, d in PREP_SHAPES])
def test_prove_prep_kernel_matches_plain(card, batch, m, n, deg):
    """P1 on the card against its plain twin on the CPU, every output limb
    for limb, one launch; y = 1 in lane 0 where the batch has two proofs or
    more."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import prep_inputs, to_device

    inp = prep_inputs(batch, m, n, deg, seed=batch + m * n + deg)
    cuda.reset_launches()
    got = cpr.prove_prep(**to_device(inp, torch, card), bit_length=n)
    assert dict(cuda.launches) == {"prove_prep": 1}
    assert _equal(got, PK.prove_prep_plain(**to_device(inp, torch, "cpu"), bit_length=n))


def _bit_sum_equal(got, want):
    """Two (B,) point arrays as canonical affine coordinates."""
    return all(torch.equal(F.canon25519(F.mul25519(got[c], F.inv25519(got.z))),
                           F.canon25519(F.mul25519(want[c], F.inv25519(want.z)))) for c in range(2))


@pytest.mark.parametrize("batch, m, n, deg", PROVER_SHAPES, ids=PROVER_IDS)
def test_bit_sum_kernel_matches_plain(card, batch, m, n, deg):
    """P4 on the card against its plain twin on the card, as points
    (canonical affine coordinates): the start points as K6 leaves them (a
    (B, 16) view of limb-major storage) and contiguous, on the tables the
    prove sums (the halved generators' and Pedersen bases'); lane 0 all bits
    set, lane 1 none."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import bit_sum_inputs

    table, bits, start, view = bit_sum_inputs(batch, m, n, deg, card, seed=m * n)
    want = PK.bit_sum_plain(start, bits, table)
    for pts in (start, view):
        cuda.reset_launches()
        got = cpr.bit_sum(pts, bits, table)
        assert dict(cuda.launches) == {"bit_sum": 1}
        assert _bit_sum_equal(got, want)


# (batch, m, bit length, extension degree): P4 at mn 1 (more adders than lanes) to 2,048, batches 1, 129 and 1,025
BIT_SUM_SHAPES = [(1, 1, 1, 1), (129, 1, 1, 1), (1025, 1, 64, 1), (129, 1, 64, 1), (1, 4, 64, 5), (129, 4, 64, 5),
                  (2, 32, 64, 1), (129, 32, 64, 1)]


@pytest.mark.parametrize("batch, m, n, deg", BIT_SUM_SHAPES,
                         ids=[f"b{b}_mn{m * n}_deg{d}" for b, m, n, d in BIT_SUM_SHAPES])
def test_bit_sum_kernel_shapes(card, batch, m, n, deg):
    """P4 on the card against its plain twin at every shape of
    BIT_SUM_SHAPES, as points, one launch, on the halved tables; a lane of
    all ones and (where the batch has two) one of all zeros; the start as K6
    leaves it."""
    from bulletproofs_plus_tpu_torch.models import prover_kernels as PK
    from bulletproofs_plus_tpu_torch.ops import cuda_prover as cpr
    from torch_prover_inputs import bit_sum_inputs

    table, bits, start, view = bit_sum_inputs(batch, m, n, deg, card, seed=batch + m * n)
    cuda.reset_launches()
    got = cpr.bit_sum(view, bits, table)
    assert dict(cuda.launches) == {"bit_sum": 1}
    assert _bit_sum_equal(got, PK.bit_sum_plain(start, bits, table))


@pytest.mark.parametrize("seeded, n, m, deg", [(True, 8, 1, 1), (False, 8, 2, 2), (False, 4, 4, 6), (True, 1, 1, 2)],
                         ids=["seeded", "aggregated", "m4_degree6", "one_bit_no_rounds"])
def test_prove_batch_on_card_matches_cpu(card, seeded, n, m, deg):
    """prove_batch_with_rng on the card equals the same call on the CPU (the
    plain twins) byte for byte, proofs and final transcript states, and
    launches P1 once, P2 once a round, each entry of P3 and P4 once, K5 and
    K6 once a round and three times besides (alpha, A1, B), C1's
    double-and-encode once a round and twice besides, T1 once a phase
    (rounds + 2) and C1's sqrt form never, with one device-to-host copy."""
    import bulletproofs_plus_tpu_torch as tbp

    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(deg))
    params = tbp.RangeParameters.init(n, m, pc)
    rs = np.random.RandomState(n * m + deg)
    batch, rounds = 4, (m * n).bit_length() - 1
    statements, witnesses = [], []
    for lane in range(batch):
        openings = [tbp.CommitmentOpening(int(rs.randint(0, 1 << n)), [int(rs.randint(1, 2**62)) for _ in range(deg)])
                    for _ in range(m)]
        statements.append(tbp.RangeStatement.init(params, [pc.commit(o.v, o.r) for o in openings], [None] * m,
                                                  (lane + 17) if seeded else None))
        witnesses.append(tbp.RangeWitness.init(openings))

    def prove(device):
        ts = [tbp.Transcript(b"card") for _ in range(batch)]
        proofs = tbp.RangeProof.prove_batch_with_rng(ts, statements, witnesses, tbp.SeededRng(5), device=device)
        return [p.to_bytes() for p in proofs], [bytes(np.asarray(t.strobe.state).tobytes()) for t in ts]

    want = prove("cpu")
    prove(card)  # the tables and the programs, once
    torch.cuda.synchronize()
    cuda.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = prove(card)
        torch.cuda.synchronize()
    assert got == want
    assert {k: cuda.launches[k] for k in ("prove_prep", "prove_round", "prove_final", "prove_responses", "bit_sum",
                                          "fixed_acc", "fixed_fold", "double_compress", "compress",
                                          "prove_transcript")} == {
        "prove_prep": 1, "prove_round": rounds, "prove_final": 1, "prove_responses": 1, "bit_sum": 1,
        "fixed_acc": rounds + 3, "fixed_fold": rounds + 3, "double_compress": rounds + 2, "compress": 0,
        "prove_transcript": rounds + 2}
    assert sum(e.name.startswith("Memcpy DtoH") for e in prof.events()) == 1
