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
from bulletproofs_plus_tpu_torch.ops import cuda_msm as cm
from bulletproofs_plus_tpu_torch.ops import cuda_pow as cp
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
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


@pytest.mark.parametrize("n", [1, 16, 40])  # one lane, one full K1 tile, a ragged third tile
def test_msm_kernels_match_host(card, n):
    scalars, pts = _msm_inputs(n, n)
    cuda.reset_launches()
    got = msm_kernel(torch.as_tensor(pack_ints(scalars).astype(np.int64), device=card), ed.from_host(pts, device=card))
    assert hr.point_equal(ed.to_host(got), host_msm(scalars, pts))
    assert [cuda.launches[k] for k in ("dyn_acc", "lane_fold", "horner")] == [1, 1, 1]


def test_msm_kernels_match_plain(card):
    scalars, pts = _msm_inputs(100, 3)
    sc_t = torch.as_tensor(pack_ints(scalars).astype(np.int64), device=card).t().contiguous()
    pts_t = cm.coords_t(ed.from_host(pts, device=card))
    parts = cm.dyn_acc(sc_t, pts_t)
    want = cm.dyn_acc_plain(sc_t, pts_t)
    from bulletproofs_plus_tpu_torch.ops import ristretto as rist

    def pa(coords):
        return ed.PointArray(*(c.movedim(0, -1) for c in coords))

    assert bool(rist.point_equal(pa(parts), pa(want)).all())
    wsum = cm.lane_fold(parts)
    assert bool(rist.point_equal(pa(wsum), pa(cm.lane_fold_plain(parts))).all())
    assert bool(rist.point_equal(pa(cm.horner(wsum)), pa(cm.horner_plain(wsum))))


def test_pow_p58_kernel_matches_python(card):
    rs = np.random.RandomState(4)
    vals = [int.from_bytes(rs.bytes(32), "little") for _ in range(300)] + [0, 1, P - 1, 2**256 - 30]
    x = torch.as_tensor(pack_ints(vals).astype(np.int64), device=card)
    got = cp.pow_p58_cuda(x).cpu().numpy()
    assert [int_from_limbs(r) % P for r in got] == [pow(v, (P - 5) // 8, P) for v in vals]
    assert cp.pow_p58_cuda(x[:0]).shape == (0, 16)
