"""Protocol data model and the batch verifier."""

from .range_proof import (
    MAX_RANGE_PROOF_BATCH_SIZE,
    MAX_RANGE_PROOF_BIT_LENGTH,
    RangeProof,
    VerifyAction,
)
from .statement import CommitmentOpening, ExtendedMask, RangeStatement, RangeWitness

__all__ = [
    "CommitmentOpening",
    "ExtendedMask",
    "MAX_RANGE_PROOF_BATCH_SIZE",
    "MAX_RANGE_PROOF_BIT_LENGTH",
    "RangeProof",
    "RangeStatement",
    "RangeWitness",
    "VerifyAction",
]
