"""K4 wrappers: x^((p-5)/8) and the whole SQRT_RATIO_M1 around it through
the hand-written CUDA kernels of csrc/pow.cu.

Counterpart of bulletproofs_plus_tpu/ops/pallas_pow.py.  `pow_p58` launches
`pow_p58_kernel` on a CUDA tensor and runs `pow_p58_plain`, the same
addition chain in plain torch, on a CPU tensor; any other device raises.
`sqrt_ratio_m1_cuda` launches `sqrt_ratio_m1_kernel`, the second entry of
the same source, which carries the chain's caller (RFC 9496 SQRT_RATIO_M1)
to its end in one launch; its plain version and its dispatch live with the
caller, ops/ristretto.sqrt_ratio_m1.  Each entry has two forms, one lane an
element and four lanes an element; the launcher takes the second up to 4224
elements, where it is faster, and `lanes=` forces either.  There are no
fallbacks: the kernels run for every CUDA input.  `field_latency_probe`
launches the one-warp chain of dependent multiplications or squarings that
chip_smoke.py times, `point_latency_probe` the chains of point operations.
"""

from __future__ import annotations

import torch

from ..native import cuda
from . import field as F
from .limbs import NLIMBS


def pow_p58_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> x^(2^252 - 3), plain torch (any device)."""
    z_250_0, _ = F.chain_250(x)
    return F.mul25519(F.sqr_n(z_250_0, 2), x)


def _lanes_arg(lanes) -> int:
    """The kernels' form: None lets the launcher pick by the element count
    (four lanes an element up to 4224 elements, one beyond), 1 or 4 forces it."""
    if lanes not in (None, 1, 4):
        raise ValueError(f"lanes an element: expected None, 1 or 4, got {lanes!r}")
    return lanes or 0


def pow_p58_cuda(x: torch.Tensor, lanes=None) -> torch.Tensor:
    """(..., 16) int64 limbs on a CUDA device -> x^(2^252 - 3) by K4.
    Results are below 2^256 but not canonical, like every GF(p) op."""
    lead = x.shape[:-1]
    n = x.numel() // NLIMBS
    if x.shape[-1] != NLIMBS:
        raise ValueError(f"pow_p58: expected (..., {NLIMBS}) limbs, got {tuple(x.shape)}")
    xt = x.reshape(n, NLIMBS).t().contiguous()  # limb-major (16, n): coalesced loads
    cuda.require(xt, "pow_p58 x", (NLIMBS, n))
    out = torch.empty_like(xt)
    if n:
        with torch.cuda.device(x.device):
            status = cuda.lib("pow").bppt_pow_p58(
                xt.data_ptr(), out.data_ptr(), n, _lanes_arg(lanes), torch.cuda.current_stream().cuda_stream
            )
        cuda.check("pow", status, "pow_p58")
        cuda.launches["pow_p58"] += 1
    return out.t().reshape(lead + (NLIMBS,))


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8): K4 on CUDA tensors, the plain chain on CPU tensors."""
    if x.device.type == "cpu":
        return pow_p58_plain(x)
    return pow_p58_cuda(x)


def sqrt_ratio_m1_cuda(u: torch.Tensor, v: torch.Tensor, lanes=None):
    """Batched SQRT_RATIO_M1(u, v) on CUDA tensors of (..., 16) int64 limbs
    -> (was_square bool (...), r (..., 16)) in one launch.  r is canonical
    and non-negative.  A u that broadcasts one value (compress and
    decompress pass u = 1) is read in place with an element stride of 0."""
    if u.shape != v.shape or v.shape[-1:] != (NLIMBS,):
        raise ValueError(f"sqrt_ratio_m1: expected two equal (..., {NLIMBS}) shapes, got {tuple(u.shape)}, {tuple(v.shape)}")
    lead = v.shape[:-1]
    n = v.numel() // NLIMBS
    v_rows = v.reshape(n, NLIMBS).contiguous()
    cuda.require(v_rows, "sqrt_ratio_m1 v", (n, NLIMBS))
    if n and u.stride(-1) == 1 and all(st == 0 or sz == 1 for st, sz in zip(u.stride()[:-1], lead)):
        u_rows, u_stride = u[(0,) * len(lead)].reshape(1, NLIMBS), 0
    else:
        u_rows, u_stride = u.reshape(n, NLIMBS).contiguous(), NLIMBS
    cuda.require(u_rows, "sqrt_ratio_m1 u", (n if u_stride else 1, NLIMBS))
    was_square = torch.empty((n,), dtype=torch.bool, device=v.device)
    r = torch.empty((n, NLIMBS), dtype=torch.int64, device=v.device)
    if n:
        with torch.cuda.device(v.device):
            status = cuda.lib("pow").bppt_sqrt_ratio_m1(
                u_rows.data_ptr(), u_stride, v_rows.data_ptr(), was_square.data_ptr(), r.data_ptr(), n,
                _lanes_arg(lanes), torch.cuda.current_stream().cuda_stream,
            )
        cuda.check("pow", status, "sqrt_ratio_m1")
        cuda.launches["sqrt_ratio_m1"] += 1
    return was_square.reshape(lead), r.reshape(lead + (NLIMBS,))


FIELD_PROBE_OPS = {"mul": 0, "sqr": 1, "mul4": 2, "sqr4": 3}


def field_latency_probe(x: torch.Tensor, op: str, iters: int, warps: int = 1) -> torch.Tensor:
    """One block of `warps` warps (1 to 32), every thread running `iters`
    dependent field multiplications (op "mul", acc <- acc * x) or squarings
    (op "sqr") from x, (16,) int64 limbs on a CUDA device; returns the
    chain's end.  "mul4" and "sqr4" run the four-lane product and squaring
    of csrc/sqrt_ratio.cuh (`FourLanes`, D1's chain), a group of four lanes
    an operation.  One warp gives the dependent latency of an operation, 32
    warps (eight on each of the SM's four schedulers) what a busy scheduler
    takes for one.  Not a kernel of any path, so it counts no launch."""
    cuda.require(x, "field_latency_probe x", (NLIMBS,))
    if not 1 <= warps <= 32:
        raise ValueError("field_latency_probe: 1 to 32 warps")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = cuda.lib("pow").bppt_field_latency(
            x.data_ptr(), out.data_ptr(), FIELD_PROBE_OPS[op], iters, warps,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("pow", status, "field_latency_probe")
    return out


POINT_PROBE_OPS = ("dbl", "add", "dbl4", "add4")


def point_latency_probe(p: torch.Tensor, op: str, iters: int, warps: int = 1) -> torch.Tensor:
    """The same for the point operations of csrc/field25519.cuh: `iters`
    dependent doublings (acc <- 2 acc) or additions (acc <- acc + p) from p,
    (4, 16) int64 limbs on a CUDA device; returns the chain's end, 2^iters p
    or (iters + 1) p.  "dbl" and "add" run ge_dbl and ge_add, a thread a
    point; "dbl4" and "add4" run ge_dbl4 and ge_add4, four lanes a point.
    Counts no launch."""
    cuda.require(p, "point_latency_probe p", (4, NLIMBS))
    if not 1 <= warps <= 32:
        raise ValueError("point_latency_probe: 1 to 32 warps")
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        status = cuda.lib("pow").bppt_point_latency(
            p.data_ptr(), out.data_ptr(), POINT_PROBE_OPS.index(op), iters, warps,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("pow", status, "point_latency_probe")
    return out
