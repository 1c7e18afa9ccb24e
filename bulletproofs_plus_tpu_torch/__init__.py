"""bulletproofs_plus_tpu_torch — the PyTorch and CUDA port of bulletproofs_plus_tpu.

Batch verification of Bulletproofs+ range proofs over ristretto255 on an
NVIDIA Hopper GPU, bit-compatible with the JAX package beside it (and so
with `tari_bulletproofs_plus` v0.4.1).  This slice of the port covers the
device engine's main path:

  * host Fiat-Shamir replay and batch weights (numpy STROBE, native keccak)
  * the scalar pass, ristretto decompression and the final MSM as torch
    tensors, with the pow chain (K4) and the MSM (K1-K3) as hand-written
    CUDA kernels (csrc/) on CUDA tensors
  * canonical proof serialization

Entry points run on `device="cuda"` unless the caller passes
`device="cpu"`, which runs the kernels' plain torch versions.
"""

from .errors import (
    InvalidArgument,
    InvalidBlake2b,
    InvalidLength,
    ProofError,
    SizeOverflow,
    VerificationFailed,
)
from .gens import (
    BulletproofGens,
    ExtensionDegree,
    PedersenGens,
    RangeParameters,
    create_pedersen_gens_with_extension_degree,
)
from .models import (
    CommitmentOpening,
    ExtendedMask,
    RangeProof,
    RangeStatement,
    RangeWitness,
    VerifyAction,
)
from .utils.merlin import NullRng, OsRng, SeededRng, Transcript

__version__ = "0.1.0"

__all__ = [
    "BulletproofGens",
    "CommitmentOpening",
    "ExtendedMask",
    "ExtensionDegree",
    "InvalidArgument",
    "InvalidBlake2b",
    "InvalidLength",
    "NullRng",
    "OsRng",
    "PedersenGens",
    "ProofError",
    "RangeParameters",
    "RangeProof",
    "RangeStatement",
    "RangeWitness",
    "SeededRng",
    "SizeOverflow",
    "Transcript",
    "VerificationFailed",
    "VerifyAction",
    "create_pedersen_gens_with_extension_degree",
]
