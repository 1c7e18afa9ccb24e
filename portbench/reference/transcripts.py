"""Range-proof Fiat-Shamir transcript wrapper, batched over proofs.

Replaces the reference's `RangeProofTranscript` + `TranscriptProtocol`
(reference src/transcripts.rs:36-201,
reference src/protocols/transcript_protocol.rs:17-78) with the same
byte-exact framing, but vectorised: a `RangeProofTranscript` advances B
Merlin transcripts in lockstep (one numpy-batched STROBE sponge), which is
how a 256-proof batch replays all Fiat-Shamir challenges in one pass.

Semantics preserved from the reference:
  * domain separator "Bulletproofs+ Range Proof"
  * identity points are rejected before being appended
  * challenges are 64-byte wide-reduced scalars, rejected if zero
  * the transcript RNG is rebuilt (clone + rekey-with-witness + external rng)
    after every transcript mutation
  * `random_not_zero` draws 64 bytes per attempt per lane, retrying only the
    offending lane so other lanes' RNG streams stay bit-identical
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .errors import VerificationFailed
from . import ristretto as hr
from .merlin import Transcript, TranscriptRng

DOMAIN_SEPARATOR = b"Bulletproofs+ Range Proof"


def _as_point_batch(data, batch: int) -> np.ndarray:
    """bytes | (32,) | (B, 32) -> (B, 32) uint8."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data, dtype=np.uint8)
    if arr.ndim == 1:
        arr = np.broadcast_to(arr, (batch, arr.shape[0]))
    if arr.shape != (batch, 32):
        raise ValueError(f"point batch shape {arr.shape} != ({batch}, 32)")
    return arr


def _scalars_to_bytes(scalars: Sequence[int]) -> np.ndarray:
    """List of B canonical scalars -> (B, 32) uint8."""
    return np.stack([np.frombuffer(hr.scalar_to_bytes(s), dtype=np.uint8) for s in scalars])


def _wide_to_scalars(wide: np.ndarray) -> List[int]:
    """(B, 64) uint8 -> B canonical scalars via wide reduction."""
    return [int.from_bytes(row.tobytes(), "little") % hr.L for row in wide]


class BatchTranscriptRng:
    """A batched Merlin TranscriptRng plus nonzero-scalar sampling."""

    __slots__ = ("rng",)

    def __init__(self, rng: TranscriptRng):
        self.rng = rng

    def fill_bytes(self, n: int) -> np.ndarray:
        return self.rng.fill_bytes(n)

    def random_scalars(self) -> List[int]:
        """One wide-reduced random scalar per lane (dalek `Scalar::random`)."""
        return _wide_to_scalars(self.fill_bytes(64))

    def random_not_zero(self) -> List[int]:
        """Nonzero random scalar per lane (scalar_protocol.rs:12-18 parity).

        For B=1 a zero draw (probability ~2^-252) retries exactly like the
        reference.  For B>1 a retry would desynchronise the shared sponge
        position and silently corrupt every other lane's stream, so the
        batched path raises an explicit error instead of being subtly wrong —
        the caller re-runs with a fresh external RNG.
        """
        out = self.random_scalars()
        if 0 not in out:
            return out
        if self.rng.strobe.batch == 1:  # pragma: no cover - 2^-252
            while out[0] == 0:
                out = self.random_scalars()
            return out
        raise VerificationFailed(  # pragma: no cover - 2^-252
            "Batched transcript RNG drew a zero scalar; lanes cannot retry in "
            "lockstep — re-run the batch with a fresh external RNG"
        )


class RangeProofTranscript:
    """B range-proof transcripts advancing in lockstep.

    The prover uses B=1 with its witness bytes; the verifier stacks every
    same-shape proof in the batch into one lockstep replay with no witness.
    """

    def __init__(
        self,
        transcript: Transcript,
        h_base_compressed: bytes,
        g_bases_compressed: Sequence[bytes],
        bit_length: int,
        extension_degree: int,
        aggregation_factor: int,
        commitments_compressed: Sequence,  # m entries: bytes | (B, 32)
        minimum_value_promises: Sequence,  # m entries: int|None | list over B
        witness_bytes: Optional[np.ndarray],  # None | (B, W) uint8
        external_rng,
        lazy_rng: bool = False,
    ):
        """lazy_rng=True skips the RNG rebuild after each transcript mutation
        (transcripts.rs:124-176 rebuilds eagerly, but the verifier's replay
        only ever consumes the FINAL rng from to_verifier_rng — the
        intermediate rebuilds are pure wasted sponge work for a verifier,
        and skipping them cannot change any transcript state because
        build_rng operates on a clone)."""
        self.transcript = transcript
        batch = transcript.batch
        self.batch = batch
        self.witness_bytes = witness_bytes
        self.external_rng = external_rng
        self.lazy_rng = lazy_rng

        self.transcript.append_message(b"dom-sep", DOMAIN_SEPARATOR)
        self.validate_and_append_point(b"H", h_base_compressed)
        for g in g_bases_compressed:
            self.validate_and_append_point(b"G", g)
        self.transcript.append_u64(b"N", bit_length)
        self.transcript.append_u64(b"T", extension_degree)
        self.transcript.append_u64(b"M", aggregation_factor)
        for c in commitments_compressed:
            self.append_point(b"Ci", c)
        for promise in minimum_value_promises:
            if isinstance(promise, (list, tuple, np.ndarray)):
                vals = [0 if p is None else int(p) for p in promise]
            else:
                vals = [0 if promise is None else int(promise)] * batch
            self.transcript.append_u64(b"vi - minimum_value", np.asarray(vals, dtype=np.uint64))

        self._rng = self._build_rng()

    # -- point / scalar appends ------------------------------------------------

    def append_point(self, label: bytes, point) -> None:
        self.transcript.append_message(label, _as_point_batch(point, self.batch))

    def validate_and_append_point(self, label: bytes, point) -> None:
        arr = _as_point_batch(point, self.batch)
        if np.any(np.all(arr == 0, axis=-1)):
            raise VerificationFailed("Identity element cannot be added to the transcript")
        self.transcript.append_message(label, arr)

    def append_scalar(self, label: bytes, scalars: Sequence[int]) -> None:
        self.transcript.append_message(label, _scalars_to_bytes(scalars))

    # -- challenges --------------------------------------------------------------

    def _challenge_scalar(self, label: bytes) -> List[int]:
        out = _wide_to_scalars(self.transcript.challenge_bytes(label, 64))
        if any(v == 0 for v in out):  # pragma: no cover - unreachable
            raise VerificationFailed("Transcript challenge cannot be zero")
        return out

    def _build_rng(self) -> Optional[BatchTranscriptRng]:
        if self.lazy_rng:
            return None
        builder = self.transcript.build_rng()
        if self.witness_bytes is not None:
            builder = builder.rekey_with_witness_bytes(b"witness", self.witness_bytes)
        return BatchTranscriptRng(builder.finalize(self.external_rng))

    def challenges_y_z(self, a) -> tuple:
        """Append A, rebuild the RNG, return per-lane (y, z) challenge lists."""
        self.validate_and_append_point(b"A", a)
        self._rng = self._build_rng()
        return self._challenge_scalar(b"y"), self._challenge_scalar(b"z")

    def challenge_round_e(self, l, r) -> List[int]:
        self.validate_and_append_point(b"L", l)
        self.validate_and_append_point(b"R", r)
        self._rng = self._build_rng()
        return self._challenge_scalar(b"e")

    def challenge_final_e(self, a1, b) -> List[int]:
        self.validate_and_append_point(b"A1", a1)
        self.validate_and_append_point(b"B", b)
        self._rng = self._build_rng()
        return self._challenge_scalar(b"e")

    def to_verifier_rng(self, r1: Sequence[int], s1: Sequence[int], d1: Sequence[Sequence[int]]) -> BatchTranscriptRng:
        """Bind the responses r1, s1, d1 and return the final RNG (used by the
        batch verifier to seed the weight transcript)."""
        self.append_scalar(b"r1", r1)
        self.append_scalar(b"s1", s1)
        for d1_k in d1:
            self.append_scalar(b"d1", d1_k)
        was_lazy, self.lazy_rng = self.lazy_rng, False
        self._rng = self._build_rng()
        self.lazy_rng = was_lazy
        return self._rng

    def rng(self) -> BatchTranscriptRng:
        return self._rng
