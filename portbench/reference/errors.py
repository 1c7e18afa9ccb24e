"""Proof error hierarchy, mirroring the reference's `ProofError`
(reference src/errors.rs:12-28)."""

from __future__ import annotations


class ProofError(Exception):
    """Base error for proof creation, verification, or parsing."""


class VerificationFailed(ProofError):
    """A proof component failed to verify."""


class InvalidArgument(ProofError):
    """Internal data is invalid."""


class InvalidLength(ProofError):
    """Invalid array/vector length."""


class InvalidBlake2b(ProofError):
    """Invalid Blake2b hash operation."""


class SizeOverflow(ProofError):
    """Internal size overflow."""
