"""The kernels' plain torch versions against the JAX package's Pallas kernels.

On the CPU the wrappers of K1-K4 take their plain versions; these tests hold
those against the TPU kernels they replace, run as the JAX package's own
tests run them (Pallas interpret mode, lane tile 8), and against the host
Pippenger.  MSM results compare with ristretto point equality, pow results
mod p; both are exact.  The CUDA kernels themselves are checked on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bulletproofs_plus_tpu.ops import edwards as jed
from bulletproofs_plus_tpu.ops import pallas_msm as pm
from bulletproofs_plus_tpu.ops import ristretto as jrist
from bulletproofs_plus_tpu.ops.limbs import int_from_limbs, limbs_from_bytes, pack_ints
from bulletproofs_plus_tpu.ops.pallas_pow import pow_p58_pallas
from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
from bulletproofs_plus_tpu_torch.ops import cuda_pow as cp
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel

P = hr.P
torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


@pytest.fixture
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pm, "_INTERPRET", True)


def _msm_inputs(n, seed):
    rs = np.random.RandomState(seed)
    scalars = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n)]
    scalars[0] = 0  # a zero digit in every window selects T[0], the identity
    pts = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(n - 1)] + [hr.IDENTITY]
    return scalars, pts


def test_dyn_msm_plain_matches_pallas_and_host(_interpret_mode):
    """One shape only: the interpret-mode Pallas MSM costs about two minutes
    of XLA CPU work (the same n = 8, lc = 8 case as test_pallas_msm.py)."""
    scalars, pts = _msm_inputs(8, 8)
    arr = pack_ints(scalars)
    got = cm.dyn_msm_plain(torch.as_tensor(arr.astype(np.int64)), ed.from_host(pts, device="cpu"))
    jax_pt = pm.msm_kernel_pallas(jnp.asarray(arr), jed.from_host(pts), lc=8)
    want = host_msm(scalars, pts)
    assert hr.point_equal(ed.to_host(got), want)
    assert hr.point_equal(jed.to_host(jax_pt), want)


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
    assert tuple(parts.shape) == (4, 16, 64, 2)
    wsum = cm.lane_fold(parts)
    host_w = [ed.to_host(ed.PointArray(*(c[:, w] for c in wsum))) for w in range(64)]
    for w in (0, 17, 63):
        digits = [(s >> (4 * w)) & 15 for s in scalars]
        assert hr.point_equal(host_w[w], host_msm(digits, pts))
    res = cm.horner(wsum)
    assert hr.point_equal(ed.to_host(ed.PointArray(*res)), host_msm(scalars, pts))


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
        cm.lane_fold(torch.zeros((4, 16, 64, 2), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        cm.horner(torch.zeros((4, 16, 64), dtype=torch.int64, device="meta"))


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
