"""K4 wrapper: x^((p-5)/8) through the hand-written CUDA pow-chain kernel.

Counterpart of bulletproofs_plus_tpu/ops/pallas_pow.py.  `pow_p58` launches
csrc/pow.cu on a CUDA tensor and runs `pow_p58_plain`, the same addition
chain in plain torch, on a CPU tensor; any other device raises.  There are
no size thresholds or fallbacks: the kernel runs for every CUDA input.
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


def pow_p58_cuda(x: torch.Tensor) -> torch.Tensor:
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
                xt.data_ptr(), out.data_ptr(), n, torch.cuda.current_stream().cuda_stream
            )
        cuda.check("pow", status, "pow_p58")
        cuda.launches["pow_p58"] += 1
    return out.t().reshape(lead + (NLIMBS,))


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8): K4 on CUDA tensors, the plain chain on CPU tensors."""
    if x.device.type == "cpu":
        return pow_p58_plain(x)
    return pow_p58_cuda(x)
