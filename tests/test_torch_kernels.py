"""The kernels' plain torch versions against the JAX package's Pallas kernels.

On the CPU the wrappers of K1-K4 take their plain versions; these tests hold
those against the TPU kernels they replace, run as the JAX package's own
tests run them (Pallas interpret mode, or the kernel body run eagerly), or,
for the K1 -> K2 -> K3 chain, against the JAX package's plain MSM (its
`msm_kernel`, which takes no Pallas path on the CPU; tests/test_pallas_msm.py
holds the Pallas MSM against the host at the same shape), and against the
host Pippenger.  MSM results compare with ristretto point equality, pow results
mod p; both are exact.  The CUDA kernels themselves are checked on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bulletproofs_plus_tpu.ops import edwards as jed
from bulletproofs_plus_tpu.ops import msm as jmsm
from bulletproofs_plus_tpu.ops import pallas_msm as pm
from bulletproofs_plus_tpu.ops import ristretto as jrist
from bulletproofs_plus_tpu.ops.limbs import int_from_limbs, limbs_from_bytes, pack_ints
from bulletproofs_plus_tpu.ops.pallas_pow import pow_p58_pallas
from bulletproofs_plus_tpu_torch.ops import cuda_fixed as cf
from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
from bulletproofs_plus_tpu_torch.ops import cuda_pow as cp
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import field as F
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel
from torch_jax_loops import jax_loops_jitted_once  # noqa: F401  (the fixture, used by pytestmark)

P = hr.P
torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores
# the JAX package's eager references: each fori_loop compiled once, not at every call (tests/torch_jax_loops.py)
pytestmark = pytest.mark.usefixtures("jax_loops_jitted_once")


@pytest.fixture
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pm, "_INTERPRET", True)


def _msm_inputs(n, seed):
    rs = np.random.RandomState(seed)
    scalars = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n)]
    scalars[0] = 0  # a zero digit in every window selects T[0], the identity
    pts = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(n - 1)] + [hr.IDENTITY]
    return scalars, pts


@pytest.fixture(scope="module")
def msm8():
    """Eight lanes (a zero scalar, the identity among the points) and their
    MSM by the JAX package's plain `msm_kernel`: one XLA compile a module."""
    scalars, pts = _msm_inputs(8, 8)
    arr = pack_ints(scalars)
    jax_pt = jed.to_host(jmsm.msm_kernel(jnp.asarray(arr), jed.from_host(pts)))
    return scalars, pts, torch.as_tensor(arr.astype(np.int64)), jax_pt


def test_dyn_msm_plain_matches_pallas_and_host(msm8):
    """The plain K1 -> K2 -> K3 chain, the JAX package's MSM and the host
    Pippenger agree at n = 8 (the n = 8 case of test_pallas_msm.py)."""
    scalars, pts, sc, jax_pt = msm8
    got = cm.dyn_msm_plain(sc, ed.from_host(pts, device="cpu"))
    want = host_msm(scalars, pts)
    assert hr.point_equal(ed.to_host(got), want)
    assert hr.point_equal(jax_pt, want)


# eight one-lane tiles; two of three and a ragged one of two; one tile: K1's, then K7's through the JAX
# package's signed digits
@pytest.mark.parametrize("tile, signed", [(1, False), (3, False), (8, False), (1, True), (3, True), (8, True)],
                         ids=["1", "3", "8", "signed-1", "signed-3", "signed-8"])
def test_dyn_acc_tile_widths_match_jax_and_host(msm8, tile, signed):
    """K1's (and K7's) tile width moves additions between K1 and K2 and
    changes no result: each packed partial [w, b] is the sum over tile b's
    lanes of digit_w(s) P (for K7 the JAX package's signed digit,
    `signed_digits4`, in [-8, 7]), K2 sums them to the window sums, and the
    chain's MSM is the JAX package's and the host's."""
    scalars, pts, sc, jax_pt = msm8
    plain = cm.dyn_acc_signed_plain if signed else cm.dyn_acc_plain
    parts = plain(sc.t().contiguous(), cm.coords_t(ed.from_host(pts, device="cpu")), tile)
    tiles = -(-8 // tile)
    assert tuple(parts.shape) == (64, tiles, cm.POINT_WORDS) and parts.dtype == torch.int32
    coords = cf.words_to_coords(parts)  # (4, 16, 64, tiles)
    jax_digits = np.asarray(pm.signed_digits4(jnp.asarray(sc.numpy().astype(np.uint32)))) if signed else None
    for w in (0, 63):
        digits = [int(d) for d in jax_digits[w]] if signed else [(s >> (4 * w)) & 15 for s in scalars]
        for b in range(tiles):
            got = tuple(int_from_limbs(coords[c, :, w, b].numpy()) % P for c in range(4))
            lanes = slice(b * tile, (b + 1) * tile)
            assert hr.point_equal(got, host_msm(digits[lanes], pts[lanes]))
    res = ed.to_host(ed.PointArray(*cm.horner(cm.lane_fold(parts))))
    assert hr.point_equal(res, jax_pt) and hr.point_equal(res, host_msm(scalars, pts))


def test_pick_tile_fills_one_wave():
    """The tile width the K1 (and K7) wrapper picks: 16 lanes while 16-lane tiles fit
    in one wave of resident blocks, then the narrowest that does, at most
    32.  On the CPU the plain version tiles for an H100's 264 (18
    lanes for the 4736 of a 256-proof verify); on a card that held one block
    an SM the same MSM would take 36 tiles of 132 and so the widest tile."""
    cpu = cm.resident_tiles("cpu")
    lanes = (1, 16, 2048, 4224, 4225, 4736, 8448, 8449, 10**6)
    assert [cm.pick_tile(n, cpu) for n in lanes] == [16, 16, 16, 16, 17, 18, 32, 32, 32]
    for n in (4225, 4736, 6000, 8448):
        assert -(-n // cm.pick_tile(n, cpu)) <= cm.CPU_RESIDENT_TILES
    assert cm.pick_tile(4736, lambda tile: 132) == cm.MAX_TILE
    assert cm.pick_tile(2048, lambda tile: 132) == 16
    assert tuple(cm.dyn_acc(torch.zeros((16, 20), dtype=torch.int64), cm.coords_t(ed.identity((20,), device="cpu"))).shape) \
        == (64, -(-20 // cm.MIN_TILE), cm.POINT_WORDS)  # the CPU wrapper takes the plain version at the picked width
    with pytest.raises(ValueError):
        cm.dyn_acc_plain(torch.zeros((16, 4), dtype=torch.int64), torch.zeros((4, 16, 4), dtype=torch.int64), 33)
    # K7 tiles as K1 does, over its own occupancy (on the CPU the same H100 figure)
    assert cm.resident_tiles("cpu", "dyn_acc_signed")(18) == cm.CPU_RESIDENT_TILES
    assert tuple(cm.dyn_acc_signed(torch.zeros((16, 20), dtype=torch.int64),
                                   cm.coords_t(ed.identity((20,), device="cpu"))).shape) \
        == (64, -(-20 // cm.MIN_TILE), cm.POINT_WORDS)
    with pytest.raises(ValueError):
        cm.dyn_acc_signed_plain(torch.zeros((16, 4), dtype=torch.int64), torch.zeros((4, 16, 4), dtype=torch.int64), 0)


@pytest.mark.parametrize("n", [1, 21, 40])  # 21: a ragged K1 tile; 40: a K2 fold over 3 tiles
def test_dyn_msm_plain_matches_host(n):
    scalars, pts = _msm_inputs(n, n)
    got = cm.dyn_msm_plain(torch.as_tensor(pack_ints(scalars).astype(np.int64)), ed.from_host(pts, device="cpu"))
    assert hr.point_equal(ed.to_host(got), host_msm(scalars, pts))


def test_msm_stages_compose():
    """K1's partials sum (K2) to the window sums, and K3's Horner of those
    is the MSM: each stage checked against the host on its own."""
    scalars, pts = _msm_inputs(20, 5)
    sc_t = torch.as_tensor(pack_ints(scalars).astype(np.int64)).t().contiguous()
    pts_t = cm.coords_t(ed.from_host(pts, device="cpu"))
    parts = cm.dyn_acc(sc_t, pts_t)  # CPU tensor: the plain version
    assert tuple(parts.shape) == (64, 2, cm.POINT_WORDS)  # two 16-lane tiles of packed partials, the last ragged
    wsum = cm.lane_fold(parts)
    host_w = [ed.to_host(ed.PointArray(*(c[:, w] for c in wsum))) for w in range(64)]
    for w in (0, 17, 63):
        digits = [(s >> (4 * w)) & 15 for s in scalars]
        assert hr.point_equal(host_w[w], host_msm(digits, pts))
    res = cm.horner(wsum)
    assert hr.point_equal(ed.to_host(ed.PointArray(*res)), host_msm(scalars, pts))


def _window_sums(seed):
    """64 window sums as host points and as the (4, 16, 64) tensor K3 takes."""
    rs = np.random.RandomState(seed)
    pts = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(64)]
    return pts, cm.coords_t(ed.from_host(pts, device="cpu"))


def _not_canonical(pts):
    """The same points with p added to every coordinate of windows 0 to 31,
    and windows 32 to 63 the identity written as (2p : p + 1 : p + 1 : 2p)."""
    moved = [tuple(v + P for v in p) for p in pts[:32]] + [(2 * P, P + 1, P + 1, 2 * P)] * 32
    coords = [pack_ints([p[i] for p in moved]).astype(np.int64) for i in range(4)]
    return pts[:32] + [hr.IDENTITY] * 32, torch.as_tensor(np.stack(coords)).transpose(1, 2).contiguous()


HORNER_CASES = ["all_identity", "only_w63", "only_w0", "not_canonical"]


class _Ref:
    """What a Pallas kernel body reads and writes, for running it eagerly."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, key):
        return self.value[key]

    def __setitem__(self, key, value):
        self.value = value


@pytest.fixture(scope="module")
def horner_edges():
    """K3's edge inputs, the four stacked on a trailing axis, through the
    plain version (CPU tensor: one call of the wrapper's path) and through
    the TPU kernel's body, `pm._horner_kernel`, run eagerly on the same limbs
    in its bit-reversed window order (its six levels' doubling loops over
    one jitted doubling, tests/torch_jax_loops.py): {case: (host window
    sums, torch result, JAX result)}, results as host points."""
    pts, wsum = _window_sums(63)
    identity = cm.coords_t(ed.identity((64,), device="cpu"))
    moved_host, moved = _not_canonical(pts)
    assert int(moved.max()) < 2**16 and int_from_limbs(moved[0, :, 40].numpy()) == 2**256 - 38
    inputs = {
        "all_identity": ([hr.IDENTITY] * 64, identity),
        "only_w63": ([hr.IDENTITY] * 63 + [pts[63]], torch.cat([identity[..., :63], wsum[..., 63:]], dim=-1)),
        "only_w0": ([pts[0]] + [hr.IDENTITY] * 63, torch.cat([wsum[..., :1], identity[..., 1:]], dim=-1)),
        "not_canonical": (moved_host, moved),
    }
    stacked = torch.stack([inputs[c][1] for c in HORNER_CASES], dim=-1)  # (4, 16, 64, 4)
    got = cm.horner_plain(stacked)  # (4, 16, 4)
    ins = [_Ref(jnp.asarray(stacked[c].numpy().astype(np.uint32))[:, pm._BREV6]) for c in range(4)]
    outs = [_Ref() for _ in range(4)]
    pm._horner_kernel(*ins, *outs)
    want = [np.asarray(o.value) for o in outs]  # 4 x (16, 1, 4)
    return {
        case: (
            inputs[case][0],
            inputs[case][1],
            tuple(int_from_limbs(got[c, :, k].numpy()) % P for c in range(4)),
            tuple(int_from_limbs(want[c][:, 0, k]) % P for c in range(4)),
        )
        for k, case in enumerate(HORNER_CASES)
    }


@pytest.mark.parametrize("case", HORNER_CASES)
def test_horner_plain_edge_inputs_match_host(horner_edges, case):
    """K3's plain version on the inputs where a Horner kernel can go wrong:
    nothing to sum, only the window with the longest chain of doublings,
    only the window with none, and limbs at and above p.  Held against the
    JAX package's `_horner_kernel` on the same limbs and against the host's
    integers."""
    host, wsum, got, jax_got = horner_edges[case]
    assert hr.point_equal(got, jax_got)
    assert hr.point_equal(got, host_msm([16**j for j in range(64)], host))
    assert hr.is_identity(got) == (case == "all_identity")
    if case == "only_w0":  # the wrapper on a CPU tensor is the plain version, one input at a time too
        alone = cm.horner(wsum)
        assert tuple(alone.shape) == (4, 16)
        assert hr.point_equal(tuple(int_from_limbs(c.numpy()) % P for c in alone), got)


def test_msm_kernel_matches_host_16_lanes():
    scalars, pts = _msm_inputs(16, 9)
    got = msm_kernel(torch.as_tensor(pack_ints(scalars).astype(np.int64)), ed.from_host(pts, device="cpu"))
    assert hr.point_equal(ed.to_host(got), host_msm(scalars, pts))


def test_pow_p58_plain_matches_pallas(_interpret_mode):
    rs = np.random.RandomState(2)
    vals = [int.from_bytes(rs.bytes(32), "little") for _ in range(6)] + [0, 1, P - 1, 2**256 - 30]
    arr = pack_ints(vals)
    got = cp.pow_p58(torch.as_tensor(arr.astype(np.int64)))  # CPU tensor: the plain chain
    jax_out = np.asarray(pow_p58_pallas(jnp.asarray(arr)))
    want = [pow(v, (P - 5) // 8, P) for v in vals]
    assert [int_from_limbs(r) % P for r in got.numpy()] == want
    assert [int_from_limbs(r) % P for r in jax_out] == want


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent fallback."""
    x = torch.zeros((4, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        cp.pow_p58(x)
    with pytest.raises(ValueError):
        cm.dyn_acc(torch.zeros((16, 4), dtype=torch.int64, device="meta"),
                   torch.zeros((4, 16, 4), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        cm.lane_fold(torch.zeros((64, 2, cm.POINT_WORDS), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        cm.horner(torch.zeros((4, 16, 64), dtype=torch.int64, device="meta"))


def _ratio_inputs():
    """u, v for SQRT_RATIO_M1: squares, non-squares, v = 0, u = 0, both 0, and
    values at the reduction edges."""
    rs = np.random.RandomState(6)
    rnd = [int.from_bytes(rs.bytes(32), "little") for _ in range(8)]
    us = [1, 1, 4, 7, 0, 0, 2**256 - 1, P + 1] + rnd[:4]
    vs = [4, 2, 9, 0, 5, 0, 3, 2**256 - 30] + rnd[4:]
    return pack_ints(us), pack_ints(vs)


def test_sqrt_ratio_m1_matches_jax():
    """The plain version, which CPU tensors take, against the JAX package:
    the same mask and, mod p, the same root."""
    ua, va = _ratio_inputs()
    was_square, r = rist.sqrt_ratio_m1(torch.as_tensor(ua.astype(np.int64)), torch.as_tensor(va.astype(np.int64)))
    jsq, jr = jrist.sqrt_ratio_m1(jnp.asarray(ua), jnp.asarray(va))
    assert was_square.tolist() == np.asarray(jsq).tolist()
    assert was_square.tolist()[:6] == [True, False, True, False, True, True]
    got = [int_from_limbs(x) % P for x in r.numpy()]
    assert got == [int_from_limbs(x) % P for x in np.asarray(jr)]
    assert all(g % 2 == 0 for g in got)  # the non-negative root


@pytest.mark.parametrize("broadcast_u", [False, True])
def test_sqrt_ratio_m1_dispatch(monkeypatch, broadcast_u):
    """CPU tensors take the plain version and never reach the launcher; any
    other device goes to the launcher, which refuses what is not on a card."""
    ua, va = _ratio_inputs()
    v = torch.as_tensor(va.astype(np.int64))
    u = F.limbs_const(1, v).expand(v.shape) if broadcast_u else torch.as_tensor(ua.astype(np.int64))

    def no_launch(*a):
        raise AssertionError("the kernel launcher was called for a CPU tensor")

    monkeypatch.setattr(rist, "sqrt_ratio_m1_cuda", no_launch)
    was_square, r = rist.sqrt_ratio_m1(u, v)
    want_sq, want_r = rist.sqrt_ratio_m1_plain(u, v)
    assert torch.equal(was_square, want_sq) and torch.equal(r, want_r)
    monkeypatch.undo()
    with pytest.raises(ValueError):
        rist.sqrt_ratio_m1(u.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        cp.sqrt_ratio_m1_cuda(u, v)  # a CPU tensor handed to the launcher itself
    with pytest.raises(ValueError):
        cp.sqrt_ratio_m1_cuda(u[:2], v)  # shapes differ


def _encodings():
    valid = [hr.compress(hr.point_mul(k, hr.BASEPOINT)) for k in (1, 2, 3, 1000, 2**200 + 7)]
    valid.append(bytes(32))  # the identity
    noncanonical = [(P + 1).to_bytes(32, "little"), (2**255 - 1 - 1).to_bytes(32, "little")]
    negative = [bytes([1]) + bytes(31), (int.from_bytes(valid[1], "little") | 1).to_bytes(32, "little")]
    arbitrary = [bytes([2]) + bytes(31), bytes(range(0, 64, 2))]
    return valid + noncanonical + negative + arbitrary


def test_decompress_matches_jax():
    enc = _encodings()
    limbs = limbs_from_bytes(np.frombuffer(b"".join(enc), np.uint8).reshape(-1, 32))
    pts, ok = rist.decompress(torch.as_tensor(limbs.astype(np.int64)))
    jpts, jok = jrist.decompress(jnp.asarray(limbs))
    assert ok.tolist() == np.asarray(jok).tolist() == [hr.decompress(e) is not None for e in enc]
    host_t, host_j = ed.to_host(pts), jed.to_host(jpts)
    for i, e in enumerate(enc):
        want = hr.decompress(e) or hr.IDENTITY
        assert hr.point_equal(host_t[i], want) and hr.point_equal(host_j[i], want)
    assert rist.is_identity(pts).tolist() == [hr.is_identity(p) for p in host_t]
