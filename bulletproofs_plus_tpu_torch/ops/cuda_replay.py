"""R1 wrapper: a transcript's Fiat-Shamir replay through csrc/replay.cu.

The replay of one proof shape is a fixed op sequence over a batch of
STROBE-128 sponges (models/replay_device.py writes it as a function of a
transcript, a row accessor and an identity check).  This module runs that
sequence two ways:

  * `replay_plain`: the sequence itself on `utils/jstrobe.py`'s tensors,
    wherever they live -- the plain version;
  * `replay_cuda`: the sequence compiled once (`Program`) into the byte
    program that `replay_kernel` executes, one thread a proof.

`Program` compiles by running the sequence through `_Recorder`, a `JStrobe`
whose four byte primitives append ops to a list instead of changing a
state, so the STROBE framing that both paths follow is one piece of code.
An op is one packed int32, kind << 24 | state position << 16 | argument:

  PERMUTE     Keccak-f[1600] of the state
  XOR_CONST   state[pos] ^= argument
  XOR_DATA    state[pos] ^= row[argument]
  SET_CONST   state[pos] = argument
  TAKE        out[argument] = state[pos]; state[pos] = 0
  CHECK_ZERO  flag the lane if row[argument : argument + 32] is all zeroes

`replay_model` executes a program in numpy exactly as the kernel's loop
does, op for op, so the CPU tests hold each compiled program against the
plain version.  `replay` takes the kernel for a CUDA tensor and the plain
version for a CPU one; any other device raises.  `keccak_latency_probe`
times the kernel's permutation for one warp (`chain_ms`); it counts no
launch.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..native import cuda
from ..utils.jstrobe import JStrobe, JTranscript

PERMUTE, XOR_CONST, XOR_DATA, SET_CONST, TAKE, CHECK_ZERO = range(6)
POINT_BYTES = 32


def encode(kind: int, pos: int, arg: int) -> int:
    if not (0 <= pos < 200 and 0 <= arg < 1 << 16):
        raise ValueError(f"replay op out of range: kind {kind}, position {pos}, argument {arg}")
    return kind << 24 | pos << 16 | arg


class RowSlice:
    """Bytes [offset, offset + length) of each lane's packed row."""

    __slots__ = ("offset", "length")

    def __init__(self, offset: int, length: int):
        self.offset, self.length = offset, length

    def __len__(self) -> int:
        return self.length


class _Tape:
    """The program being recorded: its ops and the output bytes taken so far."""

    __slots__ = ("ops", "n_out")

    def __init__(self):
        self.ops: List[int] = []
        self.n_out = 0


class _Recorder(JStrobe):
    """A JStrobe that records the byte program of what it is asked to do.
    Data is `bytes` (the same on every lane) or a `RowSlice`; squeezed bytes
    come back as (offset, length) ranges of the output row."""

    __slots__ = ("tape",)

    def __init__(self, tape: _Tape, pos: int, pos_begin: int, cur_flags: int):
        super().__init__(None, pos, pos_begin, cur_flags)
        self.tape = tape

    def clone(self) -> "_Recorder":
        """The program has one state a lane: the clone continues it, and this
        recorder may not be used again."""
        tape, self.tape = self.tape, None
        return _Recorder(tape, self.pos, self.pos_begin, self.cur_flags)

    def _xor(self, pos: int, chunk) -> None:
        if isinstance(chunk, RowSlice):
            self.tape.ops += [encode(XOR_DATA, pos + i, chunk.offset + i) for i in range(chunk.length)]
        else:
            self.tape.ops += [encode(XOR_CONST, pos + i, b) for i, b in enumerate(chunk) if b]

    def _set(self, pos: int, chunk) -> None:
        if isinstance(chunk, RowSlice):
            raise ValueError("the replay program keys constant bytes only")
        self.tape.ops += [encode(SET_CONST, pos + i, b) for i, b in enumerate(chunk)]

    def _take(self, pos: int, k: int):
        start = self.tape.n_out
        self.tape.ops += [encode(TAKE, pos + i, start + i) for i in range(k)]
        self.tape.n_out += k
        return (start, k)

    def _permute(self) -> None:
        self.tape.ops.append(encode(PERMUTE, 0, 0))

    @staticmethod
    def _chunk(data, off: int, k: int):
        if isinstance(data, RowSlice):
            return RowSlice(data.offset + off, k)
        return bytes(data[off : off + k])

    @staticmethod
    def _join(outs):
        for (a, n), (b, _) in zip(outs, outs[1:]):
            if a + n != b:
                raise AssertionError("squeezed pieces are not consecutive")
        return (outs[0][0], sum(n for _, n in outs))


class Program:
    """A replay sequence, the transcript position it starts from, and the
    byte program it compiles to.

    `sequence(t, row, check)` runs the transcript `t` and returns (a list of
    squeezed outputs, the seeds); `row(offset, length)` reads those bytes of
    every lane's packed row and `check(point)` flags the lanes whose 32-byte
    point is all zeroes.  Its outputs must be squeezed in order and fill the
    output row: `out` is their concatenation."""

    def __init__(self, sequence: Callable, pos: int, pos_begin: int, cur_flags: int):
        self.sequence = sequence
        self.position = (pos, pos_begin, cur_flags)
        tape = _Tape()
        rec = _Recorder(tape, pos, pos_begin, cur_flags)
        outs, seeds = sequence(JTranscript(rec), RowSlice, lambda point: _check(tape, point))
        offsets = [o for o, _ in outs + [seeds]]
        ends = [o + n for o, n in outs + [seeds]]
        if offsets[0] != 0 or offsets[1:] != ends[:-1] or ends[-1] != tape.n_out:
            raise AssertionError("the replay's outputs do not fill the output row in order")
        self.ops = np.asarray(tape.ops, dtype=np.int32)
        self.n_out = tape.n_out
        kinds = self.ops >> 24
        self.n_permutations = int((kinds == PERMUTE).sum())
        self.n_byte_ops = int((kinds != PERMUTE).sum())
        self._on: dict = {}

    def ops_on(self, device) -> torch.Tensor:
        """The program as an int32 tensor on `device`, uploaded once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.ops, device=device)
        return self._on[key]


def _check(tape: _Tape, point) -> None:
    if point.length != POINT_BYTES:
        raise ValueError("the identity check reads 32-byte points")
    tape.ops.append(encode(CHECK_ZERO, 0, point.offset))


def replay_plain(program: Program, state: torch.Tensor, buf: torch.Tensor):
    """The sequence on (B, 200) uint8 states and the (B, stride) uint8 rows,
    plain torch on any device -> (out (B, n_out) uint8, bad_identity (B,) bool)."""
    pos, pos_begin, cur_flags = program.position
    t = JTranscript(JStrobe(state.clone(), pos, pos_begin, cur_flags))
    bad = torch.zeros(state.shape[0], dtype=torch.bool, device=state.device)

    def check(point):
        nonlocal bad
        bad = bad | (point == 0).all(dim=-1)

    outs, seeds = program.sequence(t, lambda offset, length: buf[:, offset : offset + length], check)
    return torch.cat(outs + [seeds], dim=1), bad


def replay_model(program: Program, state: np.ndarray, buf: np.ndarray):
    """The kernel's loop in numpy, op for op, every lane at once: the word-
    for-word model of csrc/replay.cu that the CPU tests hold against
    `replay_plain`.  Returns (out, bad_identity) as numpy arrays."""
    from ..utils.keccak import bytes_as_states, keccak_f1600, states_as_bytes

    st = np.array(state, dtype=np.uint8, copy=True)
    out = np.zeros((st.shape[0], program.n_out), dtype=np.uint8)
    bad = np.zeros(st.shape[0], dtype=bool)
    for op in program.ops.tolist():
        kind, pos, arg = op >> 24, (op >> 16) & 0xFF, op & 0xFFFF
        if kind == XOR_CONST:
            st[:, pos] ^= arg
        elif kind == XOR_DATA:
            st[:, pos] ^= buf[:, arg]
        elif kind == SET_CONST:
            st[:, pos] = arg
        elif kind == TAKE:
            out[:, arg] = st[:, pos]
            st[:, pos] = 0
        elif kind == CHECK_ZERO:
            bad |= ~buf[:, arg : arg + POINT_BYTES].any(axis=1)
        else:
            st = states_as_bytes(keccak_f1600(bytes_as_states(st)))
    return out, bad


def replay_cuda(program: Program, state: torch.Tensor, buf: torch.Tensor):
    """R1 on CUDA tensors: (B, 200) uint8 states and (B, stride) uint8 rows
    -> (out (B, n_out) uint8, bad_identity (B,) bool)."""
    batch = state.shape[0]
    cuda.require(state, "replay state", (batch, 200), "torch.uint8")
    if batch == 0 or state.data_ptr() % 8:
        raise ValueError("replay state: expected a non-empty batch at an 8-byte aligned address")
    cuda.require(buf, "replay rows", (batch, buf.shape[1]), "torch.uint8")
    ops = program.ops_on(state.device)
    out = torch.empty((batch, program.n_out), dtype=torch.uint8, device=state.device)
    bad = torch.empty((batch,), dtype=torch.bool, device=state.device)
    with torch.cuda.device(state.device):
        status = cuda.lib("replay").bppt_replay(
            state.data_ptr(), buf.data_ptr(), buf.shape[1], ops.data_ptr(), ops.numel(), out.data_ptr(),
            program.n_out, bad.data_ptr(), batch, torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("replay", status, "replay")
    cuda.launches["replay"] += 1
    return out, bad


def replay(program: Program, state: torch.Tensor, buf: torch.Tensor):
    """R1 on CUDA tensors, its plain version on CPU tensors."""
    if state.device.type == "cpu":
        return replay_plain(program, state, buf)
    return replay_cuda(program, state, buf)


def keccak_latency_probe(words: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, every thread `iters` dependent permutations of `words`, (25,)
    int64 on a CUDA device (the 64-bit lanes' bit patterns); returns the
    chain's end.  Not a kernel of any path, so it counts no launch."""
    cuda.require(words, "keccak_latency_probe words", (25,))
    out = torch.empty_like(words)
    with torch.cuda.device(words.device):
        status = cuda.lib("replay").bppt_keccak_latency(
            words.data_ptr(), out.data_ptr(), iters, torch.cuda.current_stream().cuda_stream)
    cuda.check("replay", status, "keccak_latency_probe")
    return out
