"""STROBE-128 and Merlin transcripts on torch tensors: B sponges at once.

Counterpart of bulletproofs_plus_tpu/utils/jstrobe.py.  The numpy layer
(utils/strobe.py, utils/merlin.py) advances B sponges on the host; this one
advances a (B, 200) uint8 state tensor wherever it lives.  For a fixed
proof shape the transcript's op sequence -- labels, lengths, framing -- is
static, so the sponge position, the begin marker and the flags are host
integers shared by every lane; only the bytes differ.

Every state change goes through four byte-level primitives (`_xor`, `_set`,
`_take`, `_permute`) and every piece of data through `_chunk`/`_join`.
That keeps the STROBE framing in one place: ops/cuda_replay.py subclasses
`JStrobe` with primitives that record a span program (one op a call)
instead of running it, and the replay kernel (csrc/replay.cu) and the
prover's transcript kernel (csrc/transcript.cu) execute such programs.

Bit-exactness contract: given the same inputs, `JStrobe` produces the same
state bytes as `strobe.Strobe128` (tests/test_torch_replay.py); its
`_begin_op` forces a permutation exactly where utils/strobe.py does.
Merlin framing matches utils/merlin.py and hence the merlin crate.
"""

from __future__ import annotations

from typing import Union

import torch

from .jkeccak import bytes_to_state, keccak_f1600, state_to_bytes
from .strobe import FLAG_A, FLAG_C, FLAG_I, FLAG_K, FLAG_M, FLAG_T, STROBE_R

Data = Union[bytes, torch.Tensor]


def _le32(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


def _data_len(data) -> int:
    return int(data.shape[-1]) if isinstance(data, torch.Tensor) else len(data)


class JStrobe:
    """A batch of B STROBE-128 states as a (B, 200) uint8 tensor."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, state: torch.Tensor, pos: int = 0, pos_begin: int = 0, cur_flags: int = 0):
        self.state = state
        self.pos = pos
        self.pos_begin = pos_begin
        self.cur_flags = cur_flags

    @staticmethod
    def from_host(strobe, device="cpu") -> "JStrobe":
        """Copy a host strobe.Strobe128 onto `device`."""
        return JStrobe(torch.as_tensor(strobe.state, device=device).clone(), strobe.pos, strobe.pos_begin,
                       strobe.cur_flags)

    def clone(self) -> "JStrobe":
        return JStrobe(self.state.clone(), self.pos, self.pos_begin, self.cur_flags)

    # -- byte-level primitives (the only code that touches the state) ------------

    def _bytes(self, data: bytes) -> torch.Tensor:
        return torch.tensor(list(data), dtype=torch.uint8, device=self.state.device)

    def _as_chunk(self, chunk) -> torch.Tensor:
        return self._bytes(chunk) if isinstance(chunk, bytes) else chunk

    def _xor(self, pos: int, chunk) -> None:
        self.state[:, pos : pos + _data_len(chunk)] ^= self._as_chunk(chunk)

    def _set(self, pos: int, chunk) -> None:
        self.state[:, pos : pos + _data_len(chunk)] = self._as_chunk(chunk)

    def _take(self, pos: int, k: int) -> torch.Tensor:
        out = self.state[:, pos : pos + k].clone()
        self.state[:, pos : pos + k] = 0
        return out

    def _permute(self) -> None:
        self.state = state_to_bytes(keccak_f1600(bytes_to_state(self.state)))

    @staticmethod
    def _chunk(data, off: int, k: int):
        if isinstance(data, (bytes, bytearray, memoryview)):
            return bytes(data[off : off + k])
        return data[..., off : off + k]

    @staticmethod
    def _join(outs):
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    # -- core sponge -----------------------------------------------------------

    def _run_f(self) -> None:
        self._xor(self.pos, bytes([self.pos_begin]))
        self._xor(self.pos + 1, b"\x04")
        self._xor(STROBE_R + 1, b"\x80")
        self._permute()
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data) -> None:
        off, n = 0, _data_len(data)
        while off < n:
            k = min(STROBE_R - self.pos, n - off)
            self._xor(self.pos, self._chunk(data, off, k))
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data) -> None:
        off, n = 0, _data_len(data)
        while off < n:
            k = min(STROBE_R - self.pos, n - off)
            self._set(self.pos, self._chunk(data, off, k))
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int):
        outs = []
        off = 0
        while off < n:
            k = min(STROBE_R - self.pos, n - off)
            outs.append(self._take(self.pos, k))
            self.pos += k
            off += k
            if self.pos == STROBE_R:
                self._run_f()
        return self._join(outs)

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
        self._absorb(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    # -- Merlin subset -----------------------------------------------------------

    def meta_ad(self, data: Data, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: Data, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool):
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: Data, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


class JTranscript:
    """Merlin transcript over a JStrobe (framing per utils/merlin.py)."""

    __slots__ = ("strobe",)

    def __init__(self, strobe: JStrobe):
        self.strobe = strobe

    @staticmethod
    def from_host(transcript, device="cpu") -> "JTranscript":
        return JTranscript(JStrobe.from_host(transcript.strobe, device))

    def append_message(self, label: bytes, message: Data) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(_data_len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value) -> None:
        """value: int (every lane) or (B, 8) uint8 little-endian."""
        if isinstance(value, int):
            self.append_message(label, value.to_bytes(8, "little"))
        else:
            self.append_message(label, value)

    def challenge_bytes(self, label: bytes, n: int):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "JTranscriptRngBuilder":
        return JTranscriptRngBuilder(self.strobe.clone())


class JTranscriptRngBuilder:
    __slots__ = ("strobe",)

    def __init__(self, strobe: JStrobe):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: Data) -> "JTranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(_data_len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize_with(self, random_bytes: Data) -> "JTranscriptRng":
        """finalize(rng) with the external RNG's 32 bytes drawn beforehand
        on the host and passed in ((B, 32) uint8): how the prover's
        Fiat-Shamir on the card (ops/cuda_transcript.py) keeps the host
        prover's RNG stream."""
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(random_bytes, False)
        return JTranscriptRng(self.strobe)

    def finalize_null(self) -> "JTranscriptRng":
        """finalize(NullRng): key 32 zero bytes (nullrng.rs parity)."""
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(bytes(32), False)
        return JTranscriptRng(self.strobe)


class JTranscriptRng:
    __slots__ = ("strobe",)

    def __init__(self, strobe: JStrobe):
        self.strobe = strobe

    def fill_bytes(self, n: int):
        self.strobe.meta_ad(_le32(n), False)
        return self.strobe.prf(n, False)
