"""bulletproofs_plus_tpu_torch — the PyTorch and CUDA port of bulletproofs_plus_tpu.

Batched proving and batch verification of Bulletproofs+ range proofs over
ristretto255 on an NVIDIA Hopper GPU, bit-compatible with the JAX package
beside it (and so with `tari_bulletproofs_plus` v0.4.1).  The port so far
covers the device engine's two main paths:

  * verification: the Fiat-Shamir replay on the card for a single-shape
    batch (the hand-written kernel R1) or on the host (numpy STROBE, native
    keccak) for any other, batch weights on the host, then the scalar pass
    (one a shape group, the hand-written kernel S1), ristretto decompression
    (D1, with K4's pow chain inside), the final MSM (K7 or K1, K2, K3) and
    its identity check (I1), each a hand-written CUDA kernel (csrc/);
    `verify_batches_pipelined` streams batches over it
  * proving: `RangeProof.prove_batch_with_rng`, B proofs in lockstep with
    every MSM a fixed-base table MSM through the CUDA kernels K5 and K6 and
    every point encoding one launch of C1, and `prove_with_rng`, the
    sequential host prover it is held against
  * canonical proof serialization
  * several cards: `mesh=` (a 1-D torch.distributed DeviceMesh, one process
    a card) shards batch verification and batched proving over the mesh's
    ranks; `parallel/` holds the sharded MSM and the multi-host seams

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
