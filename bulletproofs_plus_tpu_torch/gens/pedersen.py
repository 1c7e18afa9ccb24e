"""Pedersen commitment generators with extension degrees 1-6.

Replaces the reference's `PedersenGens` / `ExtensionDegree`
(reference src/generators/pedersen_gens.rs:25-122) and the Ristretto
instantiation's cached masking basepoints
(reference src/ristretto.rs:67-112).

Host representation: points are host_ristretto extended-coordinate tuples and
32-byte compressed encodings.  Commitment creation is host-side, and it is
most of a wallet's prove call: a commitment and the prover's check of it
each make one.  So `commit` adds entries of fixed-base tables
(`host_ristretto.fixed_base_table`), one a nonzero byte of each scalar,
never doubling.  The tables are built at a base's first commit, once a
process, and shared by every `PedersenGens` with that base.
"""

from __future__ import annotations

import enum
import functools
import threading
from dataclasses import dataclass, field
from typing import List, Sequence

from ..errors import InvalidArgument, InvalidLength
from ..ops import host_ristretto as hr
from ..utils import trace
from ..utils.hashing import hash_from_bytes_sha3_512


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


# A base's 32-byte encoding -> its fixed-base table.  The default bases are
# seven (H and G_1..G_6); the bound only keeps hand-made bases from growing it.
_TABLES_MAX = 16
_tables: dict = {}
_tables_lock = threading.Lock()


@trace.timed("pedersen.tables")
def _build_table(point: hr.Point) -> tuple:
    return hr.fixed_base_table(point)


def base_table(point: hr.Point, encoding: bytes) -> tuple:
    """The process's fixed-base table of `point` (whose encoding is
    `encoding`), built at its first use.  Two threads may each build one;
    only whole tables are stored."""
    table = _tables.get(encoding)
    if table is None:
        table = _build_table(point)
        with _tables_lock:
            if len(_tables) >= _TABLES_MAX:
                del _tables[next(iter(_tables))]
            _tables[encoding] = table
    return table


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
    _device_bases: dict = field(default_factory=dict, compare=False, repr=False)
    _device_tables: dict = field(default_factory=dict, compare=False, repr=False)

    def device_bases(self, device="cuda"):
        """(g_bases PointArray (deg,), h_base PointArray (1,)) on `device`,
        cached per device (`ops.edwards.resolve_device`)."""
        from ..ops.edwards import from_host, resolve_device

        key = resolve_device(device)
        if key not in self._device_bases:
            self._device_bases[key] = (
                from_host(self.g_base_vec, device=key),
                from_host([self.h_base], device=key),
            )
        return self._device_bases[key]

    def device_base_tables(self, device="cuda"):
        """Packed fixed-base digit tables over [G_1..G_deg, H] on `device`,
        int32 (64, 16, deg + 1, 24), cached per device: the prover's alpha,
        eta and ry masks multiply these fixed points in every round."""
        from ..ops.edwards import from_host, resolve_device

        key = resolve_device(device)
        if key not in self._device_tables:
            from ..ops.fixed_base import build_tables, pack_tables

            points = from_host(list(self.g_base_vec) + [self.h_base], device=key)
            self._device_tables[key] = pack_tables(build_tables(points))
        return self._device_tables[key]

    @trace.timed("pedersen.commit")
    def commit(self, value: int, blindings: Sequence[int]) -> hr.Point:
        """C = value*H + sum_k blindings[k]*G_k
        (reference src/generators/pedersen_gens.rs:112-122), over the bases'
        fixed-base tables; a shorter blinding vector takes the first bases."""
        if len(blindings) == 0 or len(blindings) > int(self.extension_degree):
            raise InvalidLength("blinding vector")
        acc = hr.fixed_mul_add(hr.IDENTITY, value, base_table(self.h_base, self.h_base_compressed))
        for r, g, encoding in zip(blindings, self.g_base_vec, self.g_base_compressed_vec):
            acc = hr.fixed_mul_add(acc, r, base_table(g, encoding))
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
