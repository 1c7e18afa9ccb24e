"""Bulletproof generator vectors G_i / H_i with device-resident precomputation.

Replaces the reference's `BulletproofGens`
(reference src/generators/bulletproof_gens.rs:42-134): per-party
SHAKE256 generator chains, the aggregated iterator
(aggregated_gens_iter.rs:10-43), and the interleaved fixed-base
precomputation handle (`Precomputable`, traits.rs:40-43).

Device design: the generators are materialised once per device as a
`PointArray` in the interleaved [G_0 H_0 G_1 H_1 ...] layout the final MSM
consumes, and cached; the host tuples remain available for setup-time host
math.  The prover's fixed-base digit tables (ops/fixed_base.py) are built
on first use, over as many generators as the proof shape needs, and cached
per device (`fixed_tables_joined` appends the Pedersen bases';
`halved_tables_joined`, the batched prover's, is the same over the halved
points ((l + 1) / 2) P); on the verifier's kernel path the static generators join the
dynamic MSM as plain points (ops/fixed_base.mixed_msm).
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
        "_fixed_tables",
        "_joined_tables",
        "_halved_tables",
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
        self._fixed_tables = {}
        self._joined_tables = {}
        self._halved_tables = {}

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
        device, `ops.edwards.resolve_device`)."""
        from ..ops.edwards import from_host, resolve_device

        key = resolve_device(device)
        if key not in self._interleaved_device:
            self._interleaved_device[key] = from_host(self.interleaved(), device=key)
        return self._interleaved_device[key]

    def fixed_tables(self, device="cuda"):
        """Packed 4-bit digit tables over all interleaved generators on
        `device`: the `Precomputable` analog (traits.rs:40-43)."""
        return self.fixed_tables_sliced(2 * self.gens_capacity * self.party_capacity, device)

    def fixed_tables_sliced(self, n_static: int, device="cuda"):
        """Tables over the first n_static interleaved generators, affine and
        precomputed for the mixed addition: int32 (64, 16, n_static, 24)
        words (96 KB per generator), built once per size and device."""
        from ..ops.edwards import resolve_device

        key = (n_static, resolve_device(device))
        if key not in self._fixed_tables:
            self._fixed_tables[key] = self._build_tables(n_static, key[1])
        return self._fixed_tables[key]

    def _build_tables(self, n_static: int, device):
        from ..ops.edwards import PointArray
        from ..ops.fixed_base import build_tables, pack_tables

        return pack_tables(build_tables(PointArray(*(c[:n_static] for c in self.interleaved_device(device)))))

    def fixed_tables_joined(self, n_static: int, pc_gens, device="cuda"):
        """The tables of `fixed_tables_sliced(n_static)` with the Pedersen
        bases' tables [G_1..G_deg, H] (`pc_gens.device_base_tables`)
        appended on the lane axis: int32 (64, 16, n_static + deg + 1, 24),
        built once per size, Pedersen bases and device, and kept only in
        this form (the sliced cache is not filled).  The batched prover's
        MSMs read the generator lanes and the Pedersen lanes of one such
        table, so each round's L and R are one grouped MSM."""
        import torch

        from ..ops.edwards import resolve_device

        dev = resolve_device(device)
        key = (n_static, dev, tuple(pc_gens.g_base_compressed_vec), pc_gens.h_base_compressed)
        if key not in self._joined_tables:
            self._joined_tables[key] = torch.cat([self._build_tables(n_static, dev), pc_gens.device_base_tables(dev)],
                                                 dim=2)
        return self._joined_tables[key]

    def halved_tables_joined(self, n_static: int, pc_gens, device="cuda"):
        """The batched prover's tables: `fixed_tables_joined`'s layout, int32
        (64, 16, n_static + deg + 1, 24), over the halved points
        ((l + 1) / 2) P (`ops.fixed_base.halve`) of the first n_static
        interleaved generators and of the Pedersen bases [G_1..G_deg, H].  A
        fixed-base MSM over them gives Q with 2Q the ristretto point the
        original generators give, which `ristretto.double_and_compress`
        encodes with one inversion a block and no square root.  Built once
        per size, Pedersen bases and device, under a key of their own; the
        verify's tables and `fixed_tables_joined` are not touched."""
        from ..ops import edwards as ed
        from ..ops.fixed_base import build_tables, halve, pack_tables

        dev = ed.resolve_device(device)
        key = (n_static, dev, tuple(pc_gens.g_base_compressed_vec), pc_gens.h_base_compressed)
        if key not in self._halved_tables:
            gens = ed.PointArray(*(c[:n_static] for c in self.interleaved_device(dev)))
            points = ed.cat([gens, *pc_gens.device_bases(dev)])
            self._halved_tables[key] = pack_tables(build_tables(halve(points)))
        return self._halved_tables[key]
