"""Generator subsystem: Pedersen bases, Bulletproof generator chains, params."""

from .bulletproof import BulletproofGens
from .params import MAX_RANGE_PROOF_BIT_LENGTH, RangeParameters
from .pedersen import (
    ExtensionDegree,
    PedersenGens,
    create_pedersen_gens_with_extension_degree,
    ristretto_masking_basepoints,
)

__all__ = [
    "BulletproofGens",
    "ExtensionDegree",
    "MAX_RANGE_PROOF_BIT_LENGTH",
    "PedersenGens",
    "RangeParameters",
    "create_pedersen_gens_with_extension_degree",
    "ristretto_masking_basepoints",
]
