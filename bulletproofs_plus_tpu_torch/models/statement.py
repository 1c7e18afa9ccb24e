"""Range-proof statement, witness, opening, and recovered-mask data model.

Replaces the reference's statement stack:
  - CommitmentOpening  (reference src/commitment_opening.rs:15-37)
  - RangeWitness       (reference src/range_witness.rs:15-40)
  - RangeStatement     (reference src/range_statement.rs:21-81)
  - ExtendedMask       (reference src/extended_mask.rs:15-41)

Scalars are canonical Python ints mod l on the host side; points are
host_ristretto extended tuples plus their 32-byte compressed encodings.
Zeroization caveat: Python ints are immutable and JAX arrays live in HBM, so
the reference's `Zeroize` guarantees cannot be replicated; secret lifetimes
are best-effort (documented divergence, SURVEY.md §7 hard part 5).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..errors import InvalidArgument, InvalidLength
from ..gens.params import RangeParameters
from ..gens.pedersen import ExtensionDegree
from ..ops import host_ristretto as hr
from ..utils import trace


def _is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class CommitmentOpening:
    """A value and its extended blinding factors (v, r_1..r_k)."""

    __slots__ = ("v", "r")

    def __init__(self, v: int, r: Sequence[int]):
        if not 0 <= v < 2**64:
            raise InvalidArgument("Value must be an unsigned 64-bit integer")
        self.v = int(v)
        self.r = [s % hr.L for s in r]

    def r_len(self) -> int:
        if not self.r:
            raise InvalidLength("Extended blinding factors cannot be empty")
        return len(self.r)


class RangeWitness:
    """Commitment openings for the aggregated case, with uniform extension degree."""

    __slots__ = ("openings", "extension_degree")

    def __init__(self, openings: List[CommitmentOpening]):
        if not openings:
            raise InvalidLength("Vector openings cannot be empty")
        extension_degree = openings[0].r_len()
        for item in openings[1:]:
            if item.r_len() != extension_degree:
                raise InvalidLength("Extended blinding factors must have consistent length")
        self.openings = openings
        self.extension_degree = ExtensionDegree.from_int(extension_degree)

    @staticmethod
    def init(openings: List[CommitmentOpening]) -> "RangeWitness":
        return RangeWitness(openings)


class RangeStatement:
    """Public statement: generators, commitments, optional minimum-value
    promises, optional seed nonce for mask recovery."""

    __slots__ = (
        "generators",
        "commitments",
        "commitments_compressed",
        "minimum_value_promises",
        "seed_nonce",
    )

    @trace.timed("statement.init")
    def __init__(
        self,
        generators: RangeParameters,
        commitments: List[hr.Point],
        minimum_value_promises: List[Optional[int]],
        seed_nonce: Optional[int] = None,
    ):
        if not _is_power_of_two(len(commitments)):
            raise InvalidArgument("Number of commitments must be a power of two")
        if len(minimum_value_promises) != len(commitments):
            raise InvalidArgument("Incorrect number of minimum value promises")
        if generators.max_aggregation_factor() < len(commitments):
            raise InvalidArgument("Not enough generators for this statement")
        if seed_nonce is not None and len(commitments) > 1:
            raise InvalidArgument("Mask recovery is not supported with an aggregated statement")
        self.generators = generators
        self.commitments = commitments
        self.commitments_compressed = [hr.compress(c) for c in commitments]
        self.minimum_value_promises = minimum_value_promises
        self.seed_nonce = seed_nonce if seed_nonce is None else seed_nonce % hr.L

    @staticmethod
    def init(
        generators: RangeParameters,
        commitments: List[hr.Point],
        minimum_value_promises: List[Optional[int]],
        seed_nonce: Optional[int] = None,
    ) -> "RangeStatement":
        return RangeStatement(generators, commitments, minimum_value_promises, seed_nonce)


class ExtendedMask:
    """Recovered blinding vector for a non-aggregated proof."""

    __slots__ = ("_blindings",)

    def __init__(self, blindings: List[int]):
        self._blindings = blindings

    @staticmethod
    def assign(extension_degree: ExtensionDegree, blindings: List[int]) -> "ExtendedMask":
        if not blindings or len(blindings) != int(extension_degree):
            raise InvalidLength("Extended mask length must correspond to the extension degree")
        return ExtendedMask([b % hr.L for b in blindings])

    def blindings(self) -> List[int]:
        if not self._blindings:
            raise InvalidLength("Extended mask values not assigned yet")
        return list(self._blindings)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ExtendedMask):
            return NotImplemented
        return self._blindings == other._blindings

    def __repr__(self) -> str:
        return f"ExtendedMask(degree={len(self._blindings)})"
