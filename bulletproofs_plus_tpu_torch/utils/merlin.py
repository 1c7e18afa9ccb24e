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

import os

import numpy as np

from . import trace
from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _le32(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


def _strobe_native():
    """The native STROBE helper library, or None (numpy fallback)."""
    from ..native import keccak_lib

    return keccak_lib()


class Transcript:
    """A batch of B Merlin transcripts in lockstep (B=1 matches upstream API)."""

    __slots__ = ("strobe",)

    @trace.timed("transcript.init")
    def __init__(self, label: bytes = b"", batch: int = 1):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL, batch=batch)
        self.append_message(b"dom-sep", label)

    @classmethod
    def _of(cls, strobe: Strobe128) -> "Transcript":
        """A transcript around a sponge that is already set up."""
        transcript = object.__new__(cls)
        transcript.strobe = strobe
        return transcript

    @property
    def batch(self) -> int:
        return self.strobe.batch

    def clone(self) -> "Transcript":
        return Transcript._of(self.strobe.clone())

    @staticmethod
    def stack(transcripts: "list[Transcript]") -> "Transcript":
        """Merge single (or multi) lane transcripts into one batched transcript.

        Requires lockstep sponge positions; raises ValueError otherwise.
        """
        return Transcript._of(Strobe128.stack([t.strobe for t in transcripts]))

    def lane(self, i: int) -> "Transcript":
        return Transcript._of(self.strobe.lane(i))

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
        range_proof.rs:845-850).  Native single-call fast path when the C
        helper is available; bit-exact Python fallback otherwise."""
        items = np.ascontiguousarray(items, dtype=np.uint8)
        n, item_len = items.shape
        lib = _strobe_native() if self.batch == 1 else None
        if lib is None:
            for i in range(n):
                self.append_message(label, items[i : i + 1])
            return
        import ctypes

        st = self.strobe
        pos = ctypes.c_int32(st.pos)
        pos_begin = ctypes.c_int32(st.pos_begin)
        lib.strobe_append_seq(
            st.state.ctypes.data, ctypes.byref(pos), ctypes.byref(pos_begin),
            label, len(label), items.ctypes.data, n, item_len,
        )
        st.pos = pos.value
        st.pos_begin = pos_begin.value
        from .strobe import FLAG_A

        st.cur_flags = FLAG_A

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
        (the verifier's per-proof weight draws, range_proof.rs:890-894) —
        one native call instead of n_draws Python/numpy round trips."""
        lib = _strobe_native() if self.strobe.batch == 1 else None
        if lib is None:
            return np.concatenate([self.fill_bytes(draw_len) for _ in range(n_draws)], axis=0)
        import ctypes

        st = self.strobe
        out = np.empty((n_draws, draw_len), dtype=np.uint8)
        pos = ctypes.c_int32(st.pos)
        pos_begin = ctypes.c_int32(st.pos_begin)
        lib.strobe_rng_draws(
            st.state.ctypes.data, ctypes.byref(pos), ctypes.byref(pos_begin),
            n_draws, draw_len, out.ctypes.data,
        )
        st.pos = pos.value
        st.pos_begin = pos_begin.value
        from .strobe import FLAG_A, FLAG_C, FLAG_I

        st.cur_flags = FLAG_I | FLAG_A | FLAG_C
        return out


class NullRng:
    """All-zero external RNG, matching the reference's deterministic verifier
    weight generation (reference src/utils/nullrng.rs:16-40)."""

    @staticmethod
    def fill_bytes(batch: int, n: int) -> np.ndarray:
        return np.zeros((batch, n), dtype=np.uint8)


class OsRng:
    """Operating-system CSPRNG (os.urandom), per-lane independent bytes."""

    @staticmethod
    def fill_bytes(batch: int, n: int) -> np.ndarray:
        return np.frombuffer(os.urandom(batch * n), dtype=np.uint8).reshape(batch, n).copy()


class SeededRng:
    """Deterministic external RNG for tests (NOT cryptographically secure).

    Uses SHAKE-256 of a seed as the byte stream; each lane gets an
    independent stream domain-separated by lane index.
    """

    def __init__(self, seed: int):
        self.seed = seed
        self._count = 0

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        import hashlib

        out = np.zeros((batch, n), dtype=np.uint8)
        for b in range(batch):
            h = hashlib.shake_256(
                b"bppt-test-rng" + self.seed.to_bytes(8, "little") + b"%" + self._count.to_bytes(8, "little") + b"%" + b.to_bytes(4, "little")
            )
            out[b] = np.frombuffer(h.digest(n), dtype=np.uint8)
        self._count += 1
        return out
