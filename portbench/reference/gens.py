"""Generators of the plain reference: Pedersen bases with extension
degrees 1-6, the Bulletproof generator chains G_i / H_i and the range
parameters that join them, all host integers (a frozen copy of the host
parts of bulletproofs_plus_tpu_torch/gens/: pedersen.py, bulletproof.py,
params.py; reference src/generators/, src/ristretto.rs:67-112).
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass
from typing import List, Sequence

from . import ristretto as hr
from .errors import InvalidArgument, InvalidLength, SizeOverflow
from .hashing import generators_chain, hash_from_bytes_sha3_512, party_label

class ExtensionDegree(enum.IntEnum):
    """Blinding-factor extension degree (1..=6), values matching the
    reference's `ExtensionDegree` discriminants
    (reference src/generators/pedersen_gens.rs:42-55)."""

    DEFAULT_PEDERSEN = 1
    ADD_ONE_BASE_POINT = 2
    ADD_TWO_BASE_POINTS = 3
    ADD_THREE_BASE_POINTS = 4
    ADD_FOUR_BASE_POINTS = 5
    ADD_FIVE_BASE_POINTS = 6

    MINIMUM = 1
    MAXIMUM = 6

    @staticmethod
    def from_int(value: int) -> "ExtensionDegree":
        if not 1 <= value <= 6:
            raise InvalidArgument("Extension degree not valid")
        return ExtensionDegree(value)


EXTENSION_DEGREE_COUNT = 6


@functools.lru_cache(maxsize=1)
def ristretto_masking_basepoints() -> tuple:
    """Deterministic mask bases G_1..G_6 = SHA3-512 hash-to-group of
    "RISTRETTO_MASKING_BASEPOINT_i" (reference src/ristretto.rs:88-102)."""
    return tuple(
        hash_from_bytes_sha3_512(f"RISTRETTO_MASKING_BASEPOINT_{i}".encode())
        for i in range(1, EXTENSION_DEGREE_COUNT + 1)
    )


@dataclass
class PedersenGens:
    """Base points for (extended) Pedersen commitments.

    h_base commits the value; g_base_vec (length == extension_degree) commits
    the blinding vector.
    """

    h_base: hr.Point
    h_base_compressed: bytes
    g_base_vec: List[hr.Point]
    g_base_compressed_vec: List[bytes]
    extension_degree: ExtensionDegree

    def commit(self, value: int, blindings: Sequence[int]) -> hr.Point:
        """C = value*H + sum_k blindings[k]*G_k
        (reference src/generators/pedersen_gens.rs:112-122)."""
        if len(blindings) == 0 or len(blindings) > int(self.extension_degree):
            raise InvalidLength("blinding vector")
        acc = hr.point_mul(value, self.h_base)
        for r, g in zip(blindings, self.g_base_vec):
            acc = hr.point_add(acc, hr.point_mul(r, g))
        return acc

    def __eq__(self, other) -> bool:
        if not isinstance(other, PedersenGens):
            return NotImplemented
        return (
            self.h_base_compressed == other.h_base_compressed
            and self.g_base_compressed_vec == other.g_base_compressed_vec
            and self.extension_degree == other.extension_degree
        )


def create_pedersen_gens_with_extension_degree(extension_degree: ExtensionDegree) -> PedersenGens:
    """Default generators: h_base = the Ristretto basepoint, g_base_vec = the
    first `extension_degree` masking basepoints
    (reference src/ristretto.rs:67-85)."""
    degree = ExtensionDegree.from_int(int(extension_degree))
    bases = ristretto_masking_basepoints()[: int(degree)]
    return PedersenGens(
        h_base=hr.BASEPOINT,
        h_base_compressed=hr.compress(hr.BASEPOINT),
        g_base_vec=list(bases),
        g_base_compressed_vec=[hr.compress(p) for p in bases],
        extension_degree=degree,
    )


class BulletproofGens:
    """All G_i / H_i generators for up to `party_capacity` parties with up to
    `gens_capacity` bits each."""

    __slots__ = (
        "gens_capacity",
        "party_capacity",
        "g_vec",
        "h_vec",
    )

    def __init__(self, gens_capacity: int, party_capacity: int):
        if party_capacity > 0xFFFFFFFF:
            raise SizeOverflow("party capacity overflows u32 labels")
        self.gens_capacity = gens_capacity
        self.party_capacity = party_capacity
        # Per-party chains, labels "G"+LE32(i) / "H"+LE32(i)
        # (reference src/generators/bulletproof_gens.rs:88-97).
        self.g_vec: List[List[hr.Point]] = [
            generators_chain(party_label(ord("G"), i), gens_capacity) for i in range(party_capacity)
        ]
        self.h_vec: List[List[hr.Point]] = [
            generators_chain(party_label(ord("H"), i), gens_capacity) for i in range(party_capacity)
        ]

    def g_iter(self, n: int, m: int) -> List[hr.Point]:
        """First n of each of the first m parties' G generators, flattened."""
        return [g for party in self.g_vec[:m] for g in party[:n]]

    def h_iter(self, n: int, m: int) -> List[hr.Point]:
        return [h for party in self.h_vec[:m] for h in party[:n]]


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
