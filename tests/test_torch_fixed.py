"""The port's fixed-base MSM (K5 -> K6), signed-digit MSM (K7) and `compress`
against the JAX package and the host oracle.

On the CPU the wrappers take their kernels' plain versions; these tests hold
those against the JAX package on the same numpy-seeded inputs: its Pallas
fixed-base kernels once, run as its own tests run them (interpret mode), and
its plain references for the rest, plus the host Pippenger.  Points compare
with ristretto equality (the two packages may hold different projective
coordinates of one point), digits and encodings exactly.  The CUDA kernels
themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bulletproofs_plus_tpu.ops import edwards as jed
from bulletproofs_plus_tpu.ops import fixed_base as jfb
from bulletproofs_plus_tpu.ops import pallas_msm as pm
from bulletproofs_plus_tpu.ops import pfield as jpf
from bulletproofs_plus_tpu.ops import ristretto as jrist
from bulletproofs_plus_tpu.ops.limbs import limbs_from_bytes, pack_ints
from bulletproofs_plus_tpu_torch.convert import tables_from_jax_numpy
from bulletproofs_plus_tpu_torch.ops import cuda_fixed as cf
from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import fixed_base as fb
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from bulletproofs_plus_tpu_torch.ops.limbs import bytes_from_limbs
from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel, signed_digits4, tree_reduce
from torch_jax_loops import jax_loops_jitted_once  # noqa: F401  (the fixture, used by pytestmark)

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores
# the JAX package's eager references: each fori_loop compiled once, not at every call (tests/torch_jax_loops.py)
pytestmark = pytest.mark.usefixtures("jax_loops_jitted_once")

S_TAB = 8
BASE_PTS = [hr.point_mul(9 * i + 4, hr.BASEPOINT) for i in range(S_TAB)]


def _t(arr) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr).astype(np.int64))


def _scalars(rows, lanes, seed):
    rs = np.random.RandomState(seed)
    return [[int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(lanes)] for _ in range(rows)]


def _pack(scal):
    return pack_ints([v for row in scal for v in row]).reshape(len(scal), len(scal[0]), 16)


def _host(points: ed.PointArray):
    """PointArray of any batch shape -> flat list of host points."""
    return ed.to_host(ed.PointArray(*(c.reshape(-1, 16) for c in points)))


@pytest.fixture(scope="module")
def jax_tables():
    return jfb.build_tables(jed.from_host(BASE_PTS))


@pytest.fixture(scope="module")
def tables():
    return fb.pack_tables(fb.build_tables(ed.from_host(BASE_PTS, device="cpu")))


@pytest.fixture(params=cf.WSPLITS)
def wsplit(request, monkeypatch):
    """Every window split the wrapper can pick, forced for the test."""
    monkeypatch.setattr(fb, "pick_wsplit", lambda rows, lanes: request.param)
    return request.param


def _niels_ints(point):
    """A host point -> its table entry (y + x, y - x, 2d x y) as canonical integers."""
    zinv = pow(point[2], hr.P - 2, hr.P)
    x, y = point[0] * zinv % hr.P, point[1] * zinv % hr.P
    return [(y + x) % hr.P, (y - x) % hr.P, 2 * hr.D * x * y % hr.P]


def test_build_tables_matches_jax(jax_tables, tables):
    """Entry for entry the words of the JAX package's tables carried across
    with convert.tables_from_jax_numpy (exact: both are canonical affine,
    precomputed for the mixed addition), digit 0 the identity (1, 1, 0), and
    T[j, d, i] = d * 16^j * P_i."""
    carried = tables_from_jax_numpy(*(np.asarray(c) for c in jax_tables), device="cpu")
    assert tables.dtype == carried.dtype == torch.int32
    assert tuple(tables.shape) == tuple(carried.shape) == (64, 16, S_TAB, cf.ENTRY_WORDS)
    assert torch.equal(tables, carried)
    limbs = cf.words_to_limbs(tables).numpy()  # (64, 16, S, 3, 16)
    identity = pack_ints([1, 1, 0])
    assert (limbs[:, 0] == identity).all()
    for j, d, i in ((0, 1, 0), (1, 15, 3), (37, 8, 5), (63, 15, 7)):
        want = _niels_ints(hr.point_mul(d * 16**j, BASE_PTS[i]))
        assert np.array_equal(limbs[j, d, i], pack_ints(want))


@pytest.mark.parametrize("rows, lanes, want", [(128, 128, 4), (256, 2, 16), (128, 2, 16), (1, 1, 16), (4096, 128, 4)])
def test_pick_wsplit(rows, lanes, want):
    """The prover's wide shape takes 4 ranges (one wave of resident
    threads), its Pedersen shapes the finest split; nothing leaves WSPLITS."""
    assert cf.pick_wsplit(rows, lanes) == want and want in cf.WSPLITS


def test_tables_from_jax_numpy_checks_layout(jax_tables):
    coords = [np.asarray(c) for c in jax_tables]
    with pytest.raises(ValueError):
        tables_from_jax_numpy(*(c[:, :8] for c in coords), device="cpu")  # 8 digits
    with pytest.raises(ValueError):
        tables_from_jax_numpy(coords[0], coords[1], coords[2], coords[3][:, :, :4], device="cpu")
    with pytest.raises(ValueError):
        tables_from_jax_numpy(*(c[..., :8] for c in coords), device="cpu")  # 8 limbs
    with pytest.raises(ValueError):
        tables_from_jax_numpy(coords[0] + np.uint32(1 << 16), *coords[1:], device="cpu")


def test_generator_tables_are_cached_per_size_and_device():
    import bulletproofs_plus_tpu_torch as tbp

    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(2))
    gens = tbp.BulletproofGens(2, 2)
    full = gens.fixed_tables("cpu")
    assert tuple(full.shape) == (64, 16, 8, 24) and gens.fixed_tables_sliced(8, "cpu") is full
    half = gens.fixed_tables_sliced(4, "cpu")
    assert half is gens.fixed_tables_sliced(4, "cpu") and torch.equal(half, full[:, :, :4])
    bases = pc.device_base_tables("cpu")
    assert tuple(bases.shape) == (64, 16, 3, 24) and bases is pc.device_base_tables("cpu")
    # [G_1, G_2, H]: a scalar on the last lane multiplies the value base H
    got = fb.fixed_msm_batched(_t(pack_ints([0, 0, 5])), bases)
    assert hr.point_equal(ed.to_host(got), hr.point_mul(5, pc.h_base))


@pytest.fixture(scope="module")
def pallas_batched(jax_tables):
    """S = 6, B = 3 (tests/test_pallas_msm.py's shape) over an 8-lane table:
    the one interpret-mode run of the TPU kernels K5 and K6, as host points."""
    scal = _scalars(3, 6, 11)
    before = pm._INTERPRET
    pm._INTERPRET = True
    try:
        jgot = pm.fixed_msm_batched_pallas(jnp.asarray(_pack(scal)), jfb.transpose_tables(jax_tables))
        return scal, [jed.to_host(jed.PointArray(*(c[row] for c in jgot))) for row in range(3)]
    finally:
        pm._INTERPRET = before


def test_fixed_msm_batched_matches_pallas_and_host(pallas_batched, tables, wsplit):
    """The port at each window split, the TPU kernels in interpret mode and
    the host oracle give the same points."""
    scal, jgot = pallas_batched
    got = _host(fb.fixed_msm_batched(_t(_pack(scal)), tables))
    for row in range(len(scal)):
        want = host_msm(scal[row], BASE_PTS[: len(scal[row])])
        assert hr.point_equal(got[row], want)
        assert hr.point_equal(jgot[row], want)


@pytest.fixture(scope="module")
def jax_grouped(jax_tables):
    """S = 8, B = 2, G = 2 through the JAX package's plain reference, as host points."""
    scal = _scalars(2, 8, 5)
    jgot = jfb.fixed_msm_grouped(jnp.asarray(_pack(scal)), jax_tables, 2, allow_pallas=False)
    return scal, [[jed.to_host(jed.PointArray(*(c[row, grp] for c in jgot))) for grp in range(2)] for row in range(2)]


def test_fixed_msm_grouped_matches_jax_and_host(jax_grouped, tables, wsplit):
    s, b, g = 8, 2, 2
    scal, jgot = jax_grouped
    got = fb.fixed_msm_grouped(_t(_pack(scal)), tables, g)
    assert tuple(got.x.shape) == (b, g, 16)
    half = s // g
    for row in range(b):
        for grp in range(g):
            want = host_msm(scal[row][grp * half : (grp + 1) * half], BASE_PTS[grp * half : (grp + 1) * half])
            assert hr.point_equal(ed.to_host(ed.PointArray(*(c[row, grp] for c in got))), want)
            assert hr.point_equal(jgot[row][grp], want)


def test_fixed_msm_lane_permutation(tables):
    """`lanes` reads the table in place: position j multiplies P_lanes[j]."""
    perm = [5, 0, 7, 2, 6, 1]
    scal = _scalars(2, len(perm), 3)
    got = fb.fixed_msm_grouped(_t(_pack(scal)), tables, 3, lanes=perm)
    for row in range(2):
        for grp in range(3):
            want = host_msm(scal[row][2 * grp : 2 * grp + 2], [BASE_PTS[i] for i in perm[2 * grp : 2 * grp + 2]])
            assert hr.point_equal(ed.to_host(ed.PointArray(*(c[row, grp] for c in got))), want)


@pytest.mark.parametrize("lead, s", [((1,), 5), ((3,), 7), ((2, 2), 3), ((), 1)])
def test_fixed_msm_ragged_shapes(tables, lead, s, wsplit):
    """Widths and batches that fill no tile, and leading axes of any rank,
    at each window split."""
    rows = int(np.prod(lead)) if lead else 1
    scal = _scalars(rows, s, 100 + s)
    got = fb.fixed_msm_batched(_t(_pack(scal)).reshape(lead + (s, 16)), tables)
    assert tuple(got.x.shape) == lead + (16,)
    for row, pt in enumerate(_host(got)):
        assert hr.point_equal(pt, host_msm(scal[row], BASE_PTS[:s]))


def test_fixed_msm_zero_and_single_digit_rows(tables, wsplit):
    """A row of zero scalars is a chain of identity additions through K5 and
    K6 (the field fold's carry-out window), and must give the identity; a row
    with one non-zero digit gives that one table entry."""
    s = 8
    scal = [[0] * s, [0] * 3 + [7 << (4 * 41)] + [0] * 4, _scalars(1, s, 9)[0]]
    parts = cf.fixed_acc(tables, torch.arange(s), _t(_pack(scal)).movedim(-1, 0).contiguous(), wsplit)
    assert tuple(parts.shape) == (3, wsplit * s, cf.POINT_WORDS) and parts.dtype == torch.int32
    got = _host(fb.fixed_msm_batched(_t(_pack(scal)), tables))
    assert hr.is_identity(got[0])
    assert hr.point_equal(got[1], hr.point_mul(7 * 16**41, BASE_PTS[3]))
    assert hr.point_equal(got[2], host_msm(scal[2], BASE_PTS))


class _Ref:
    """What a Pallas kernel body reads and writes, for running it eagerly."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, key):
        return self.value[key]

    def __setitem__(self, key, value):
        self.value = value


FOLD_COUNTS, FOLD_GROUPS = [1, 3, 32, 96], [1, 3]
FOLD_WIDTH = 128  # lanes the JAX package pads a fold to


def _fold_case(count, groups):
    """Two rows of partials for `groups` lane groups of `count` partials each
    (count = wsplit * lanes a group), the second row with the identity among
    them: (parts words, wsplit, the pool of host points, indices into it)."""
    wsplit = 1 if count < 32 else 16
    s = groups * count // wsplit
    rs = np.random.RandomState(count * 10 + groups)
    pool = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(7)] + [hr.IDENTITY]
    pick = rs.randint(0, 7, size=(2, wsplit * s))
    pick[1, ::3] = 7
    pa = ed.from_host([pool[i] for i in pick.reshape(-1)], device="cpu")
    parts = cf.limbs_to_words(torch.stack(list(pa), dim=1)).reshape(2, wsplit * s, cf.POINT_WORDS)
    return parts, wsplit, pool, pick


@pytest.fixture(scope="module")
def jax_folds():
    """The TPU kernel's body, `pm._fixed_fold_kernel`, run eagerly once on
    the partials of every case: each (row, group)'s partials along its lane
    axis, filled up to 128 lanes with the identity as the JAX package pads
    them -> {(count, groups): host points, row-major over (row, group)}."""
    blocks, index = [], {}
    for count in FOLD_COUNTS:
        for groups in FOLD_GROUPS:
            parts, wsplit, _, _ = _fold_case(count, groups)
            f, s = parts.shape[0], parts.shape[1] // wsplit
            coords = cf.words_to_coords(parts).reshape(4, 16, f, wsplit, groups, s // groups)
            coords = coords.movedim(3, 4).reshape(4, 16, f * groups, count).numpy().astype(np.uint32)
            padded = np.zeros((4, 16, f * groups, FOLD_WIDTH), np.uint32)
            padded[1:3, 0] = 1  # the identity (0 : 1 : 1 : 0)
            padded[..., :count] = coords
            index[count, groups] = (sum(b.shape[2] for b in blocks), f * groups)
            blocks.append(padded)
    outs = [_Ref() for _ in range(4)]
    pm._fixed_fold_kernel(*(_Ref(jnp.asarray(c)[None]) for c in np.concatenate(blocks, axis=2)), *outs)
    host = jed.to_host(jed.PointArray(*(jnp.transpose(o.value, (1, 0)) for o in outs)))
    return {key: host[at : at + n] for key, (at, n) in index.items()}


@pytest.mark.parametrize("groups", FOLD_GROUPS)
@pytest.mark.parametrize("count", FOLD_COUNTS)
def test_fixed_fold_plain_counts(jax_folds, count, groups):
    """K6's plain version at counts of partials a block that fill no tree (1,
    3), one exactly (32) and one and a half (96), in one and three lane
    groups: against the JAX package's `_fixed_fold_kernel` body on the same
    partials and the host's sums of the same points."""
    parts, wsplit, pool, pick = _fold_case(count, groups)
    s = parts.shape[1] // wsplit
    got = cf.fixed_fold(parts, groups, wsplit)  # CPU tensor: the plain version
    assert tuple(got.shape) == (4, 16, 2, groups)
    assert torch.equal(got, cf.fixed_fold(parts, groups, wsplit, threads=512))  # the block size is the kernel's own
    per = s // groups
    for row in range(2):
        for grp in range(groups):
            mine = [pool[pick[row, q * s + grp * per + i]] for q in range(wsplit) for i in range(per)]
            assert len(mine) == count
            have = ed.to_host(ed.PointArray(*(c[:, row, grp] for c in got)))
            assert hr.point_equal(have, host_msm([1] * count, mine))
            assert hr.point_equal(have, jax_folds[count, groups][row * groups + grp])
    with pytest.raises(ValueError):
        cf.fixed_fold(parts, groups, wsplit, threads=64)


@pytest.mark.parametrize(
    "count, blocks, want", [(1, 256, 128), (32, 256, 128), (33, 8, 256), (256, 256, 256), (512, 128, 512), (512, 256, 256)]
)
def test_pick_fold_threads(count, blocks, want):
    """The prover's shapes: Pedersen (32 partials a block), round (256 in 256
    blocks), A1 (512 in 128 blocks, a block an SM); and the round shape at a
    split of 8, where 256 blocks of 512 partials keep 256 threads."""
    assert cf.pick_fold_threads(count, blocks) == want and want in cf.FOLD_THREADS


def test_fixed_msm_refuses_bad_shapes(tables):
    with pytest.raises(ValueError):
        fb.fixed_msm_batched(torch.zeros((2, S_TAB + 1, 16), dtype=torch.int64), tables)  # more lanes than the table
    with pytest.raises(ValueError):
        fb.fixed_msm_grouped(torch.zeros((2, 6, 16), dtype=torch.int64), tables, 4)  # 6 lanes, 4 groups
    with pytest.raises(ValueError):
        fb.fixed_msm_batched(torch.zeros((2, 2, 16), dtype=torch.int64), tables, lanes=[0, S_TAB])  # past the table
    with pytest.raises(ValueError):
        fb.fixed_msm_batched(torch.zeros((2, 2, 16), dtype=torch.int64), tables, lanes=[0, 1, 2])  # 3 lanes, 2 scalars
    with pytest.raises(ValueError):
        cf.fixed_acc(tables[:, :8], torch.arange(2), torch.zeros((16, 1, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        cf.fixed_acc(tables, torch.arange(2), torch.zeros((16, 1, 2), dtype=torch.int64), 3)  # not a power of two
    with pytest.raises(ValueError):
        cf.fixed_fold(torch.zeros((1, 12, 32), dtype=torch.int32), 1, 8)  # 12 partials, 8 ranges


def test_signed_digits4_reconstructs_and_matches_jax():
    rs = np.random.RandomState(31)
    vals = [0, 1, hr.L - 1, (1 << 252) + 5] + [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(28)]
    arr = pack_ints(vals)
    digs = signed_digits4(_t(arr)).numpy()
    assert digs.shape == (64, len(vals)) and digs.min() >= -8 and digs.max() <= 7
    for i, v in enumerate(vals):
        assert sum(int(digs[j, i]) * 16**j for j in range(64)) == v
    assert np.array_equal(digs, np.asarray(pm.signed_digits4(jnp.asarray(arr))))


def _msm_inputs(n, seed):
    rs = np.random.RandomState(seed)
    scalars = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n)]
    scalars[0] = 0
    pts = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(n - 1)] + [hr.IDENTITY]
    return scalars, pts


@pytest.mark.parametrize("n", [8, 21])  # 21: a ragged second tile
def test_msm_kernel_signed_matches_host(n, monkeypatch):
    scalars, pts = _msm_inputs(n, 17 + n)
    sc, pa = _t(pack_ints(scalars)), ed.from_host(pts, device="cpu")
    want = host_msm(scalars, pts)
    assert hr.point_equal(ed.to_host(msm_kernel(sc, pa, signed=True)), want)
    # signed=None reads BPPT_MSM_SIGNED at call time: signed digits (K7) unless it is "0"
    calls = []
    monkeypatch.setattr(cm, "dyn_acc_signed", lambda *a: calls.append("signed") or cm.dyn_acc_signed_plain(*a))
    monkeypatch.setattr(cm, "dyn_acc", lambda *a: calls.append("unsigned") or cm.dyn_acc_plain(*a))
    monkeypatch.setenv("BPPT_MSM_SIGNED", "0")
    assert hr.point_equal(ed.to_host(msm_kernel(sc, pa)), want)
    monkeypatch.setenv("BPPT_MSM_SIGNED", "1")
    assert hr.point_equal(ed.to_host(msm_kernel(sc, pa)), want)
    monkeypatch.delenv("BPPT_MSM_SIGNED")
    assert hr.point_equal(ed.to_host(msm_kernel(sc, pa)), want)
    assert calls == ["unsigned", "signed", "signed"]


def test_dyn_acc_signed_plain_matches_jax_kernel_body():
    """K7's plain version against the TPU kernel's body, `_dyn_select_signed`
    (the signed table and selection), run eagerly on one 8-lane tile and
    folded over the lanes: the 64 window sums must be the same points."""
    n = 8
    scalars, pts = _msm_inputs(n, 17)
    arr = pack_ints(scalars)
    got = cm.dyn_acc_signed(_t(arr).t().contiguous(), cm.coords_t(ed.from_host(pts, device="cpu")))
    assert tuple(got.shape) == (64, 1, cm.POINT_WORDS)  # one tile of packed partials
    got = cf.words_to_coords(got)
    jpt = jpf.PointS(*(jnp.transpose(c, (1, 0)) for c in jed.from_host(pts)))
    jsel = pm._dyn_select_signed(jpt, pm.signed_digits4(jnp.asarray(arr)), n)
    jsum = jpf.lane_halve_sum(jsel, axis=2, width=n)  # (16, 64, 1)
    want = jed.to_host(jed.PointArray(*(jnp.transpose(c[:, :, 0], (1, 0)) for c in jsum)))
    have = ed.to_host(ed.PointArray(*(c[:, :, 0].t() for c in got)))
    assert all(hr.point_equal(a, b) for a, b in zip(have, want))


def test_compress_matches_jax_and_host():
    """Encodings of affine points, of projective sums (Z != 1) and of the
    identity: the port, the JAX package and the host oracle agree byte for
    byte, and decompress(compress(P)) == P."""
    host_pts = [hr.point_mul(k, hr.BASEPOINT) for k in (1, 2, 3, 1000, 2**200 + 7)] + [hr.IDENTITY]
    pa = ed.from_host(host_pts, device="cpu")
    pa = ed.cat([pa, ed.add(pa, ed.PointArray(*(c.roll(1, 0) for c in pa))), ed.double(pa)])
    want = [hr.compress(p) for p in ed.to_host(pa)]
    assert want[:6] == [hr.compress(p) for p in host_pts] and want[5] == bytes(32)
    got = rist.compress(pa)
    assert [bytes_from_limbs(r).tobytes() for r in got.numpy()] == want
    jgot = jrist.compress(jed.PointArray(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in pa)))
    assert np.array_equal(np.asarray(jgot).astype(np.int64), got.numpy())
    assert np.array_equal(limbs_from_bytes(np.frombuffer(b"".join(want), np.uint8).reshape(-1, 32)), got.numpy())
    back, ok = rist.decompress(got)
    assert bool(ok.all()) and bool(rist.point_equal(back, pa).all())
    shaped = rist.compress(ed.PointArray(*(c.reshape(3, 6, 16) for c in pa)))
    assert torch.equal(shaped.reshape(-1, 16), got)


def test_tree_reduce_and_neg():
    pts = [hr.point_mul(3 * i + 1, hr.BASEPOINT) for i in range(16)]
    pa = ed.from_host(pts, device="cpu")
    total = ed.to_host(tree_reduce(ed.PointArray(*(c.reshape(2, 8, 16) for c in pa))))
    assert hr.point_equal(total[0], host_msm([1] * 8, pts[:8]))
    assert hr.point_equal(total[1], host_msm([1] * 8, pts[8:]))
    assert hr.point_equal(ed.to_host(tree_reduce(ed.PointArray(*(c[:1] for c in pa)))), pts[0])
    with pytest.raises(ValueError):
        tree_reduce(ed.PointArray(*(c[:6] for c in pa)))
    assert bool(rist.is_identity(ed.add(pa, ed.neg(pa))).all())


def test_wrappers_refuse_other_devices(tables):
    """A wrapper runs its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent fallback."""
    meta = tables.to("meta")
    with pytest.raises(ValueError):
        cf.fixed_acc(meta, torch.arange(4, device="meta"), torch.zeros((16, 2, 4), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        cf.fixed_fold(torch.zeros((2, 16, 32), dtype=torch.int32, device="meta"), 2, 4)
    with pytest.raises(ValueError):
        cm.dyn_acc_signed(torch.zeros((16, 4), dtype=torch.int64, device="meta"),
                          torch.zeros((4, 16, 4), dtype=torch.int64, device="meta"))
