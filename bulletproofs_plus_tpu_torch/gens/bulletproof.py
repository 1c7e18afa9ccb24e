"""Bulletproof generator vectors G_i / H_i with device-resident precomputation.

Replaces the reference's `BulletproofGens`
(reference src/generators/bulletproof_gens.rs:42-134): per-party
SHAKE256 generator chains, the aggregated iterator
(aggregated_gens_iter.rs:10-43), and the interleaved fixed-base
precomputation handle (`Precomputable`, traits.rs:40-43).

Device design: the generators are materialised once per device as a
`PointArray` in the interleaved [G_0 H_0 G_1 H_1 ...] layout the final MSM
consumes, and cached; the host tuples remain available for setup-time host
math.  The fixed-base digit tables of the JAX package are not built: on the
verifier's kernel path the static generators join the dynamic MSM as plain
points (ops/fixed_base.mixed_msm).
"""

from __future__ import annotations

from typing import List

from ..errors import SizeOverflow
from ..ops import host_ristretto as hr
from ..utils.hashing import generators_chain, party_label


class BulletproofGens:
    """All G_i / H_i generators for up to `party_capacity` parties with up to
    `gens_capacity` bits each."""

    __slots__ = (
        "gens_capacity",
        "party_capacity",
        "g_vec",
        "h_vec",
        "_interleaved_device",
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
        self._interleaved_device = {}

    def g_iter(self, n: int, m: int) -> List[hr.Point]:
        """First n of each of the first m parties' G generators, flattened."""
        return [g for party in self.g_vec[:m] for g in party[:n]]

    def h_iter(self, n: int, m: int) -> List[hr.Point]:
        return [h for party in self.h_vec[:m] for h in party[:n]]

    def interleaved(self) -> List[hr.Point]:
        """[G_0, H_0, G_1, H_1, ...] over the full capacity — the static-point
        layout of the precomputation tables
        (reference src/generators/bulletproof_gens.rs:100-103)."""
        g_flat = [g for party in self.g_vec for g in party]
        h_flat = [h for party in self.h_vec for h in party]
        out: List[hr.Point] = []
        for g, h in zip(g_flat, h_flat):
            out.append(g)
            out.append(h)
        return out

    def interleaved_device(self, device="cuda"):
        """PointArray of the interleaved generators on `device` (cached per
        device)."""
        key = str(device)
        if key not in self._interleaved_device:
            from ..ops.edwards import from_host

            self._interleaved_device[key] = from_host(self.interleaved(), device=device)
        return self._interleaved_device[key]
