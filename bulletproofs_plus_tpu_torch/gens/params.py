"""Range-proof parameters: Bulletproof + Pedersen generators with validation.

Replaces the reference's `RangeParameters`
(reference src/range_parameters.rs:21-114).
"""

from __future__ import annotations

from typing import List

from ..errors import InvalidArgument
from ..ops import host_ristretto as hr
from .bulletproof import BulletproofGens
from .pedersen import ExtensionDegree, PedersenGens

MAX_RANGE_PROOF_BIT_LENGTH = 64


def _is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def compute_generator_padding(bit_length: int, aggregation_factor: int, max_aggregation_factor: int) -> int:
    """Zero-scalar padding that lets a smaller statement reuse generator
    tables built for max_aggregation_factor
    (reference src/utils/generic.rs:63-82)."""
    padded = 2 * bit_length * max_aggregation_factor
    actual = 2 * bit_length * aggregation_factor
    if actual > padded:
        raise InvalidArgument("Aggregation factor exceeds the maximum")
    return padded - actual


class RangeParameters:
    """Generators and base points for a batch of range proofs."""

    __slots__ = ("bp_gens", "pc_gens")

    def __init__(self, bp_gens: BulletproofGens, pc_gens: PedersenGens):
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens

    @staticmethod
    def init(bit_length: int, max_aggregation_factor: int, pc_gens: PedersenGens) -> "RangeParameters":
        if not _is_power_of_two(max_aggregation_factor):
            raise InvalidArgument("Aggregation factor size must be a power of two")
        if not _is_power_of_two(bit_length):
            raise InvalidArgument("Bit length must be a power of two")
        if bit_length > MAX_RANGE_PROOF_BIT_LENGTH:
            raise InvalidArgument(f"Bit length must be <= {MAX_RANGE_PROOF_BIT_LENGTH}")
        return RangeParameters(BulletproofGens(bit_length, max_aggregation_factor), pc_gens)

    def max_aggregation_factor(self) -> int:
        return self.bp_gens.party_capacity

    def bit_length(self) -> int:
        return self.bp_gens.gens_capacity

    def extension_degree(self) -> ExtensionDegree:
        return self.pc_gens.extension_degree

    def h_base(self) -> hr.Point:
        return self.pc_gens.h_base

    def g_bases(self) -> List[hr.Point]:
        return self.pc_gens.g_base_vec

    def h_base_compressed(self) -> bytes:
        return self.pc_gens.h_base_compressed

    def g_bases_compressed(self) -> List[bytes]:
        return self.pc_gens.g_base_compressed_vec

    def gi_base(self) -> List[hr.Point]:
        """Aggregated G_i over the full (bit_length, max_aggregation) capacity."""
        return self.bp_gens.g_iter(self.bit_length(), self.max_aggregation_factor())

    def hi_base(self) -> List[hr.Point]:
        return self.bp_gens.h_iter(self.bit_length(), self.max_aggregation_factor())
