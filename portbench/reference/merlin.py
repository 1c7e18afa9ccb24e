"""Batched Merlin transcripts (bit-exact with the `merlin` Rust crate v3).

The reference builds all Fiat-Shamir state on `merlin::Transcript`
(reference src/transcripts.rs:8, Cargo.toml:16).  This module
reimplements the full Merlin construction — transcript framing,
`TranscriptRngBuilder` (rekey-with-witness) and `TranscriptRng` — on top of
the batched STROBE-128 in ``strobe.py``, so that B proofs' transcripts run
in lockstep as one numpy-vectorised sponge batch.

Framing (must match merlin/src/transcript.rs exactly):
  new(label):            strobe = Strobe128("Merlin v1.0"); append_message("dom-sep", label)
  append_message(l, m):  meta_ad(l); meta_ad(LE32(len(m)), more); ad(m)
  challenge_bytes(l, n): meta_ad(l); meta_ad(LE32(n), more); prf(n)
  build_rng():           clone strobe
    .rekey_with_witness_bytes(l, w): meta_ad(l); meta_ad(LE32(len(w)), more); key(w)
    .finalize(rng):      meta_ad("rng"); key(rng.fill_bytes(32))
  TranscriptRng.fill_bytes(n): meta_ad(LE32(n)); prf(n)
"""

from __future__ import annotations

import numpy as np

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _le32(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


class Transcript:
    """A batch of B Merlin transcripts in lockstep (B=1 matches upstream API)."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes = b"", batch: int = 1, _strobe: Strobe128 | None = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL, batch=batch)
        self.append_message(b"dom-sep", label)

    @property
    def batch(self) -> int:
        return self.strobe.batch

    def clone(self) -> "Transcript":
        return Transcript(_strobe=self.strobe.clone())

    @staticmethod
    def stack(transcripts: "list[Transcript]") -> "Transcript":
        """Merge single (or multi) lane transcripts into one batched transcript.

        Requires lockstep sponge positions; raises ValueError otherwise.
        """
        return Transcript(_strobe=Strobe128.stack([t.strobe for t in transcripts]))

    def lane(self, i: int) -> "Transcript":
        return Transcript(_strobe=self.strobe.lane(i))

    def append_message(self, label: bytes, message) -> None:
        """message: bytes (broadcast) or (B, L) uint8 array."""
        if isinstance(message, (bytes, bytearray, memoryview)):
            n = len(message)
        else:
            message = np.asarray(message, dtype=np.uint8)
            n = message.shape[-1]
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        self.strobe.ad(message, False)

    def append_messages_seq(self, label: bytes, items: np.ndarray) -> None:
        """Append n same-label, same-length messages in sequence — ONE lane's
        transcript absorbing n items (the verifier's weight transcript,
        range_proof.rs:845-850)."""
        items = np.ascontiguousarray(items, dtype=np.uint8)
        for i in range(items.shape[0]):
            self.append_message(label, items[i : i + 1])

    def append_u64(self, label: bytes, value) -> None:
        """value: int (broadcast) or (B,) integer array."""
        if np.ndim(value) == 0:
            self.append_message(label, int(value).to_bytes(8, "little"))
        else:
            data = np.asarray(value, dtype="<u8").reshape(self.batch, 1).view(np.uint8)
            self.append_message(label, data)

    def challenge_bytes(self, label: bytes, n: int) -> np.ndarray:
        """Returns (B, n) uint8."""
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())


class TranscriptRngBuilder:
    __slots__ = ("strobe",)

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness) -> "TranscriptRngBuilder":
        if isinstance(witness, (bytes, bytearray, memoryview)):
            n = len(witness)
        else:
            witness = np.asarray(witness, dtype=np.uint8)
            n = witness.shape[-1]
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, rng) -> "TranscriptRng":
        """rng: object with fill_bytes(batch, n) -> (batch, n) uint8."""
        random_bytes = rng.fill_bytes(self.strobe.batch, 32)
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(random_bytes, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    """Merlin transcript-based RNG; rand_core::RngCore-compatible framing."""

    __slots__ = ("strobe",)

    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> np.ndarray:
        """Returns (B, n) uint8 — one draw per lane, in lockstep."""
        self.strobe.meta_ad(_le32(n), False)
        return self.strobe.prf(n, False)

    def fill_bytes_seq(self, n_draws: int, draw_len: int) -> np.ndarray:
        """n_draws sequential fill_bytes(draw_len) calls from ONE lane's RNG
        (the verifier's per-proof weight draws, range_proof.rs:890-894)."""
        return np.concatenate([self.fill_bytes(draw_len) for _ in range(n_draws)], axis=0)


class NullRng:
    """All-zero external RNG, matching the reference's deterministic verifier
    weight generation (reference src/utils/nullrng.rs:16-40)."""

    @staticmethod
    def fill_bytes(batch: int, n: int) -> np.ndarray:
        return np.zeros((batch, n), dtype=np.uint8)
