"""Batched STROBE-128 duplex construction (the subset Merlin uses).

Bit-exact reimplementation of the STROBE-128 framing used by the `merlin`
crate (which backs the reference's Fiat-Shamir transcripts,
reference src/transcripts.rs and Cargo.toml:16).  Operations supported:
``meta_ad``, ``ad``, ``prf``, ``key`` — exactly the set Merlin exposes.

States are *batched*: a ``Strobe128`` holds B sponge states that advance in
lockstep (same operation sequence, same lengths, possibly different data per
lane).  A batch of range proofs replays B transcripts simultaneously; the
Keccak permutations are numpy-vectorised across the batch.  Lockstep is a
hard requirement — the per-lane sponge positions are shared scalars — and is
naturally satisfied by the range-proof protocol, where all transcript
messages have fixed lengths for a given proof shape.
"""

from __future__ import annotations

import numpy as np

from .keccak import bytes_as_states, keccak_f1600, states_as_bytes

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


def _as_batch(data, batch: int) -> np.ndarray:
    """Coerce bytes / (L,) / (B, L) uint8 input to a (B, L) uint8 array."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data, dtype=np.uint8)
    if arr.ndim == 1:
        arr = np.broadcast_to(arr, (batch, arr.shape[0]))
    if arr.shape[0] != batch:
        raise ValueError(f"batch mismatch: {arr.shape} vs B={batch}")
    return arr


class Strobe128:
    """A batch of B STROBE-128 states in lockstep."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags", "batch")

    def __init__(self, protocol_label: bytes, batch: int = 1, _raw: bool = False):
        self.batch = batch
        if _raw:
            return
        st = np.zeros((batch, 200), dtype=np.uint8)
        st[:, 0:6] = np.frombuffer(bytes([1, STROBE_R + 2, 1, 0, 1, 96]), dtype=np.uint8)
        st[:, 6:18] = np.frombuffer(b"STROBEv1.0.2", dtype=np.uint8)
        self.state = states_as_bytes(keccak_f1600(bytes_as_states(st)))
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- construction helpers -------------------------------------------------

    def clone(self) -> "Strobe128":
        s = Strobe128(b"", batch=self.batch, _raw=True)
        s.state = self.state.copy()
        s.pos = self.pos
        s.pos_begin = self.pos_begin
        s.cur_flags = self.cur_flags
        return s

    @staticmethod
    def stack(strobes: "list[Strobe128]") -> "Strobe128":
        """Stack B single-lane strobes into one batched strobe.

        Requires identical (pos, pos_begin, cur_flags) — i.e. the lanes must
        already be in lockstep.  Raises ValueError otherwise (callers fall
        back to sequential processing).
        """
        first = strobes[0]
        for s in strobes[1:]:
            if (s.pos, s.pos_begin, s.cur_flags) != (first.pos, first.pos_begin, first.cur_flags):
                raise ValueError("strobe states not in lockstep; cannot batch")
        out = Strobe128(b"", batch=sum(s.batch for s in strobes), _raw=True)
        out.state = np.concatenate([s.state for s in strobes], axis=0)
        out.pos = first.pos
        out.pos_begin = first.pos_begin
        out.cur_flags = first.cur_flags
        return out

    def lane(self, i: int) -> "Strobe128":
        s = Strobe128(b"", batch=1, _raw=True)
        s.state = self.state[i : i + 1].copy()
        s.pos = self.pos
        s.pos_begin = self.pos_begin
        s.cur_flags = self.cur_flags
        return s

    # -- core sponge ops -------------------------------------------------------

    def _run_f(self) -> None:
        self.state[:, self.pos] ^= np.uint8(self.pos_begin)
        self.state[:, self.pos + 1] ^= np.uint8(0x04)
        self.state[:, STROBE_R + 1] ^= np.uint8(0x80)
        self.state = states_as_bytes(keccak_f1600(bytes_as_states(self.state)))
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: np.ndarray) -> None:
        off, n = 0, data.shape[1]
        while off < n:
            k = min(STROBE_R - self.pos, n - off)
            self.state[:, self.pos : self.pos + k] ^= data[:, off : off + k]
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: np.ndarray) -> None:
        off, n = 0, data.shape[1]
        while off < n:
            k = min(STROBE_R - self.pos, n - off)
            self.state[:, self.pos : self.pos + k] = data[:, off : off + k]
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> np.ndarray:
        out = np.zeros((self.batch, n), dtype=np.uint8)
        off = 0
        while off < n:
            k = min(STROBE_R - self.pos, n - off)
            out[:, off : off + k] = self.state[:, self.pos : self.pos + k]
            self.state[:, self.pos : self.pos + k] = 0
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()
        return out

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("continued op flag mismatch")
            return
        if flags & FLAG_T:
            raise ValueError("transport flags not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(np.broadcast_to(np.array([old_begin, flags], dtype=np.uint8), (self.batch, 2)))
        force_f = 0 != (flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public STROBE ops (the Merlin subset) ----------------------------------

    def meta_ad(self, data, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(_as_batch(data, self.batch))

    def ad(self, data, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(_as_batch(data, self.batch))

    def prf(self, n: int, more: bool) -> np.ndarray:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(_as_batch(data, self.batch))
