"""D1, C1 and I1 wrappers: ristretto255 decoding, encoding and the identity
check through the hand-written CUDA kernels of csrc/ristretto.cu.

Counterpart of what XLA fused around the TPU kernel K4 in the JAX package's
bulletproofs_plus_tpu/ops/ristretto.py (`decompress`, `compress`,
`is_identity`).  Each wrapper checks its arguments (`cuda.require`), copies an
input only where its rows are not contiguous already, launches its kernel on
the current stream and counts the launch in `cuda.launches` ("decompress",
"compress", "double_compress", "is_identity").  The plain versions and the dispatch by device
live with the callers in ops/ristretto.py.  D1 and C1 have K4's two forms, one
lane an element and four lanes an element; the launcher takes the second up
to 4224 elements, and `lanes=` forces either.  C1's double-and-encode
(`double_compress_cuda`, the prover's) is a block of 32 points a warp, one
inversion a block; `fe_inv_probe` times its inversion.  There are no
fallbacks.
"""

from __future__ import annotations

import torch

from ..native import cuda
from .cuda_pow import _lanes_arg
from .edwards import PointArray
from .limbs import NLIMBS


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _rows(t: torch.Tensor, what: str, n: int) -> torch.Tensor:
    """(..., 16) limbs -> (n, 16) rows, a view where the rows are contiguous
    already (K3's point, a decode's coordinates), else a copy."""
    rows = t.reshape(n, NLIMBS)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    cuda.require(rows, what, (n, NLIMBS))
    return rows


def _coords(p: PointArray, names: str, what: str):
    """The named coordinates of p as (n, 16) rows on one card, and the batch shape."""
    shape = p.x.shape
    if shape[-1:] != (NLIMBS,) or any(c.shape != shape for c in p):
        raise ValueError(f"{what}: expected four equal (..., {NLIMBS}) coordinates, got {[tuple(c.shape) for c in p]}")
    if any(c.device != p.x.device for c in p):
        raise ValueError(f"{what}: the coordinates lie on different devices")
    n = p.x.numel() // NLIMBS
    return [_rows(getattr(p, c), f"{what} {c}", n) for c in names], shape[:-1], n


def decompress_cuda(s: torch.Tensor, lanes=None):
    """D1: (..., 16) int64 limbs of s on a CUDA device, any value below
    2^256 -> (PointArray of canonical coordinates with Z = 1, valid bool
    (...)) in one launch; rejected lanes hold the identity (0, 1, 1, 0)."""
    if s.shape[-1:] != (NLIMBS,):
        raise ValueError(f"decompress: expected (..., {NLIMBS}) limbs, got {tuple(s.shape)}")
    lead = s.shape[:-1]
    n = s.numel() // NLIMBS
    rows = _rows(s, "decompress s", n)
    out = torch.empty((4, n, NLIMBS), dtype=torch.int64, device=s.device)
    valid = torch.empty((n,), dtype=torch.bool, device=s.device)
    if n:
        with torch.cuda.device(s.device):
            status = cuda.lib("ristretto").bppt_decompress(
                rows.data_ptr(), out.data_ptr(), valid.data_ptr(), n, _lanes_arg(lanes), _stream()
            )
        cuda.check("ristretto", status, "decompress")
        cuda.launches["decompress"] += 1
    return PointArray(*(c.reshape(lead + (NLIMBS,)) for c in out.unbind(0))), valid.reshape(lead)


def compress_cuda(p: PointArray, lanes=None) -> torch.Tensor:
    """C1: points of (..., 16) int64 limb coordinates on a CUDA device ->
    (..., 16) canonical limbs of their encodings, in one launch."""
    (x, y, z, t), lead, n = _coords(p, "xyzt", "compress")
    out = torch.empty((n, NLIMBS), dtype=torch.int64, device=p.x.device)
    if n:
        with torch.cuda.device(p.x.device):
            status = cuda.lib("ristretto").bppt_compress(
                x.data_ptr(), y.data_ptr(), z.data_ptr(), t.data_ptr(), out.data_ptr(), n, _lanes_arg(lanes),
                _stream(),
            )
        cuda.check("ristretto", status, "compress")
        cuda.launches["compress"] += 1
    return out.reshape(lead + (NLIMBS,))


def double_compress_cuda(q: PointArray) -> torch.Tensor:
    """C1's double-and-encode: points Q of (..., 16) int64 limb coordinates
    on a CUDA device -> (..., 16) canonical limbs of the encodings of 2Q, in
    one launch (a block of 32 lanes inverts its lanes' product)."""
    (x, y, z, t), lead, n = _coords(q, "xyzt", "double_compress")
    out = torch.empty((n, NLIMBS), dtype=torch.int64, device=q.x.device)
    if n:
        with torch.cuda.device(q.x.device):
            status = cuda.lib("ristretto").bppt_double_compress(
                x.data_ptr(), y.data_ptr(), z.data_ptr(), t.data_ptr(), out.data_ptr(), n, _stream()
            )
        cuda.check("ristretto", status, "double_compress")
        cuda.launches["double_compress"] += 1
    return out.reshape(lead + (NLIMBS,))


def fe_inv_probe(x: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, lane t a chain of `iters` dependent `fe_inv` of x[t] ((32,
    16) int64 limbs on a CUDA device): x^((-1)^iters) mod p, canonical, 0
    for 0.  Counts no launch."""
    cuda.require(x, "fe_inv_probe input", (32, NLIMBS))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = cuda.lib("ristretto").bppt_fe_inv_latency(x.data_ptr(), out.data_ptr(), iters, _stream())
    cuda.check("ristretto", status, "fe_inv_probe")
    return out


def is_identity_cuda(p: PointArray) -> torch.Tensor:
    """I1: points on a CUDA device -> bool (...), whether each is the
    ristretto identity (X or Y is 0 mod p), in one launch.  Reads X and Y
    in place where their rows are contiguous."""
    (x, y), lead, n = _coords(p, "xy", "is_identity")
    out = torch.empty((n,), dtype=torch.bool, device=p.x.device)
    if n:
        with torch.cuda.device(p.x.device):
            status = cuda.lib("ristretto").bppt_is_identity(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, _stream())
        cuda.check("ristretto", status, "is_identity")
        cuda.launches["is_identity"] += 1
    return out.reshape(lead)
