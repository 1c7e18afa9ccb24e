"""R1 wrapper: a transcript's Fiat-Shamir replay and the reduction of its
challenges mod l, through csrc/replay.cu.

The replay of one proof shape is a fixed op sequence over a batch of
STROBE-128 sponges (models/replay_device.py writes it as a function of a
transcript, a row accessor and an identity check).  This module runs it two
ways:

  * `replay_fn_plain`: the sequence itself on `utils/jstrobe.py`'s tensors
    (`replay_plain`), then `field.reduce_wide_l` and `field.is_zero_l` on its
    wide challenges, wherever the tensors live -- the plain version;
  * `replay_cuda`: the sequence compiled once (`Program`) into the span
    program that `replay_kernel` executes, a warp a proof, with the
    reduction in the same launch.

Both return (scalars (B, challenges, 16) int64 canonical limbs, seeds
(B, n_seed) uint8, bad_identity (B,) bool, bad_zero (B,) bool).

`Program` compiles by running the sequence through `_Recorder`, a `JStrobe`
whose four primitives append ops instead of changing a state, so the STROBE
framing that both paths follow is one piece of code.  Each call of a
primitive is one op (kind, state position, length, argument); a constant
span that continues the previous one in the state and in the pool is merged
into it:

  PERMUTE     Keccak-f[1600] of the state
  XOR_CONST   state[pos : pos + len] ^= pool[arg : arg + len]
  XOR_DATA    state[pos : pos + len] ^= row[arg : arg + len]
  SET_CONST   state[pos : pos + len] = pool[arg : arg + len]
  TAKE        out[arg : arg + len] = state[pos : pos + len]; those bytes = 0
  CHECK_ZERO  flag the lane if row[arg : arg + 32] is all zeroes
  SET_DATA    state[pos : pos + len] = row[arg : arg + len]
  SAVE        the second state = the state
  SWAP        exchange the state and the second state

(the last three in the prover's programs only, ops/cuda_transcript.py).

The pool holds every constant byte of the program, zeroes included.  The
kernel takes the program as 64-bit words (an op is two int32,
kind << 16 | pos << 8 | len and arg), then the pool.

`replay_model` executes a program in numpy as the kernel does, word for
word: each lane's 8-byte window of a span and its byte mask, the warp's
permutation lane by lane (`keccak_warp`, shuffles as index tables), and the
epilogue's reduction through ops/scalar_model.py; the CPU tests hold it
against the plain version.  `replay` takes the kernel for a CUDA tensor and
the plain version for a CPU one; any other device raises.
`perm_latency_probe` (the warp's permutation, `perm_ns`),
`keccak_latency_probe` (the one-thread permutation of the design before,
`keccak_ns`) and `reduce_wide_probe` (the epilogue alone on given inputs)
count no launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List

import numpy as np
import torch

from ..native import cuda
from ..utils.jstrobe import JStrobe, JTranscript
from ..utils.keccak import _RC as KECCAK_RC
from ..utils.keccak import bytes_as_states
from . import field as F
from . import scalar_model

PERMUTE, XOR_CONST, XOR_DATA, SET_CONST, TAKE, CHECK_ZERO, SET_DATA, SAVE, SWAP = range(9)  # csrc/sponge.cuh SpanOp
POINT_BYTES = 32
WIDE = 64  # bytes of a challenge before its reduction
STATE_BYTES = 200
STATE_WORDS = 25
PAD_FRONT, PAD_BACK = 8, 16  # bytes around each source's copy in shared memory (csrc/replay.cu)
WARP_CHOICES = (1, 2, 4, 8, 16, 32)  # warps a block, smallest first


def encode(kind: int, pos: int, length: int, arg: int) -> List[int]:
    if not (kind in range(9) and 0 <= pos and 0 <= length < 256 and pos + length <= STATE_BYTES
            and 0 <= arg < 1 << 31):
        raise ValueError(f"replay op out of range: kind {kind}, position {pos}, length {length}, argument {arg}")
    return [kind << 16 | pos << 8 | length, arg]


class RowSlice:
    """Bytes [offset, offset + length) of each lane's packed row."""

    __slots__ = ("offset", "length")

    def __init__(self, offset: int, length: int):
        self.offset, self.length = offset, length

    def __len__(self) -> int:
        return self.length


class _Tape:
    """The program being recorded: its ops, its pool of constant bytes and
    the output bytes taken so far; `live`, in a program of two states
    (ops/cuda_transcript.py), the recorder whose state the lanes hold."""

    __slots__ = ("ops", "pool", "n_out", "live")

    def __init__(self):
        self.ops: List[List[int]] = []
        self.pool = bytearray()
        self.n_out = 0
        self.live = None

    def span(self, kind: int, pos: int, chunk) -> None:
        if isinstance(chunk, RowSlice):
            if chunk.length:
                self.ops.append([kind, pos, chunk.length, chunk.offset])
            return
        if not chunk:
            return
        last = self.ops[-1] if self.ops else None
        if (last is not None and last[0] == kind and last[1] + last[2] == pos and last[3] + last[2] == len(self.pool)
                and last[2] + len(chunk) < 256):
            last[2] += len(chunk)
        else:
            self.ops.append([kind, pos, len(chunk), len(self.pool)])
        self.pool += chunk


class _Recorder(JStrobe):
    """A JStrobe that records the span program of what it is asked to do.
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
        self.tape.span(XOR_DATA if isinstance(chunk, RowSlice) else XOR_CONST, pos, chunk)

    def _set(self, pos: int, chunk) -> None:
        if isinstance(chunk, RowSlice):
            raise ValueError("the replay program keys constant bytes only")
        self.tape.span(SET_CONST, pos, chunk)

    def _take(self, pos: int, k: int):
        start = self.tape.n_out
        self.tape.ops.append([TAKE, pos, k, start])
        self.tape.n_out += k
        return (start, k)

    def _permute(self) -> None:
        self.tape.ops.append([PERMUTE, 0, 0, 0])

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


class _Compiled:
    """A recorded span program as the kernels read it: its ops (kind,
    position, length, argument), its pool of constant bytes, the output
    bytes it takes, its permutations and other ops ("spans"), and the
    bytes those move."""

    def _assemble(self, tape: _Tape) -> None:
        self.ops = np.asarray(tape.ops, dtype=np.int64).reshape(-1, 4)
        self.pool = bytes(tape.pool)
        self.n_out = tape.n_out
        kinds = self.ops[:, 0]
        self.n_permutations = int((kinds == PERMUTE).sum())
        self.n_spans = int((kinds != PERMUTE).sum())
        self.span_bytes = int(self.ops[np.isin(kinds, (XOR_CONST, XOR_DATA, SET_CONST, SET_DATA, TAKE)), 2].sum())
        words = np.asarray([encode(*op) for op in tape.ops], dtype="<i4").tobytes()
        pool = self.pool + bytes(-len(self.pool) % 8)
        self.pool_words = len(pool) // 8
        self.blob = np.frombuffer(words + pool, dtype="<i8")
        self._on: dict = {}

    def blob_on(self, device) -> torch.Tensor:
        """The program and its pool as int64 words on `device`, uploaded once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.blob.copy(), device=device)
        return self._on[key]


class Program(_Compiled):
    """A replay sequence, the transcript position it starts from, and the
    span program it compiles to.

    `sequence(t, row, check)` runs the transcript `t` and returns (a list of
    squeezed 64-byte challenges, the seeds); `row(offset, length)` reads
    those bytes of every lane's packed row and `check(point)` flags the
    lanes whose 32-byte point is all zeroes.  Its outputs must be squeezed
    in order and fill the output row: `out` is their concatenation."""

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
        if any(n != WIDE for _, n in outs):
            raise AssertionError("every challenge of the replay is 64 bytes wide")
        self._assemble(tape)
        self.n_challenges, self.n_seed = len(outs), seeds[1]


def _check(tape: _Tape, point) -> None:
    if point.length != POINT_BYTES:
        raise ValueError("the identity check reads 32-byte points")
    tape.ops.append([CHECK_ZERO, 0, POINT_BYTES, point.offset])


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


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


def replay_fn_plain(program: Program, state: torch.Tensor, buf: torch.Tensor):
    """The whole function in plain torch: `replay_plain`, then its
    challenges reduced mod l by `field.reduce_wide_l` and tested by
    `field.is_zero_l` -> (scalars, seeds, bad_identity, bad_zero)."""
    out, bad_identity = replay_plain(program, state, buf)
    n_wide = WIDE * program.n_challenges
    wide = out[:, :n_wide].reshape(out.shape[0], program.n_challenges, WIDE)
    scalars = F.reduce_wide_l(wide[..., 0::2].long() | (wide[..., 1::2].long() << 8))
    return scalars, out[:, n_wide:], bad_identity, F.is_zero_l(scalars).any(dim=1)


# ---------------------------------------------------------------------------
# The kernel's model
# ---------------------------------------------------------------------------

M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_LANES = np.arange(32)
_LIVE = _LANES < STATE_WORDS
_X, _Y = _LANES % 5, _LANES // 5
# rho's rotation of word x + 5y (csrc/replay.cu KECCAK_RHO); lanes 25-31 rotate by 0
KECCAK_RHO = np.array([0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
                      + [0] * 7)
_D_MINUS, _D_PLUS = (_X + 4) % 5, (_X + 1) % 5
_PI_SRC = np.where(_LIVE, (_X + 3 * _Y) % 5 + 5 * _X, _LANES)  # pi: the lane whose rotated word lands here
# pi then chi: the sources of words x + 1 and x + 2 of the lane's row
_PI_CHI1 = _PI_SRC[np.where(_LIVE, (_X + 1) % 5 + 5 * _Y, _LANES)]
_PI_CHI2 = _PI_SRC[np.where(_LIVE, (_X + 2) % 5 + 5 * _Y, _LANES)]


def _funnel_l(lo: np.ndarray, hi: np.ndarray, s: np.ndarray) -> np.ndarray:
    """__funnelshift_l: the upper 32 bits of (hi:lo) << s, s below 32."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((wide << s.astype(np.uint64)) >> np.uint64(32)) & np.uint64(0xFFFFFFFF)


def _rotl_lane(a: np.ndarray) -> np.ndarray:
    """Each lane's word rotated by its rho offset, as the kernel does it: a
    swap of the 32-bit halves for 32 and more, then two funnel shifts."""
    lo, hi = a & np.uint64(0xFFFFFFFF), a >> np.uint64(32)
    swap = KECCAK_RHO >= 32
    l, h = np.where(swap, hi, lo), np.where(swap, lo, hi)
    s = KECCAK_RHO & 31
    return (_funnel_l(l, h, s) << np.uint64(32)) | _funnel_l(h, l, s)


def keccak_warp(a: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] as a warp runs it, (B, 32) uint64 lanes (lane w < 25
    word w, lanes 25-31 along): each shuffle is an index table over the
    lanes, pi and chi read the rotated words at once."""
    one, s63 = np.uint64(1), np.uint64(63)
    for r in range(24):
        c = a[:, _X] ^ a[:, _X + 5] ^ a[:, _X + 10] ^ a[:, _X + 15] ^ a[:, _X + 20]
        cp = c[:, _D_PLUS]
        a = a ^ c[:, _D_MINUS] ^ ((cp << one) | (cp >> s63))
        rotated = _rotl_lane(a)
        a = rotated[:, _PI_SRC] ^ (~rotated[:, _PI_CHI1] & rotated[:, _PI_CHI2])
        a[:, 0] ^= KECCAK_RC[r]
    return a


def _padded_words(data: np.ndarray) -> np.ndarray:
    """(B, n) bytes -> (B, (PAD_FRONT + round8(n) + PAD_BACK) / 8) uint64, as
    the kernel lays a source out in shared memory (the pads read as zeroes
    here and as whatever is there on the card: masked out either way)."""
    n = data.shape[1]
    out = np.zeros((data.shape[0], PAD_FRONT + n + (-n % 8) + PAD_BACK), dtype=np.uint8)
    out[:, PAD_FRONT : PAD_FRONT + n] = data
    return out.view("<u8")


def _window(words: np.ndarray, arg: int, pos: int, w: int) -> np.ndarray:
    p = PAD_FRONT + arg - pos + 8 * w
    assert p >= 1 and 8 * (p // 8) + 16 <= 8 * words.shape[1], "a window reads outside its source's copy"
    q, sh = p >> 3, 8 * (p & 7)
    if sh == 0:
        return words[:, q]
    return (words[:, q] >> np.uint64(sh)) | ((words[:, q + 1] << np.uint64(64 - sh)) & M64)


def _byte_mask(lo: int, hi: int, w: int) -> np.uint64:
    nb = hi - lo
    return np.uint64(((1 << (8 * nb)) - 1) << (8 * (lo - 8 * w)))


def run_ops_model(program: _Compiled, state: np.ndarray, buf: np.ndarray):
    """csrc/sponge.cuh `sponge_run` in numpy, every lane of every warp at
    once: the program's ops on (B, 200) states and the (B, stride) rows ->
    (final states as (B, 32) uint64 lanes, out (B, n_out) uint8,
    bad_identity (B,) bool).  The span ops act on 64-bit words
    under byte masks, the permutation is the warp's (`keccak_warp`), and
    SAVE and SWAP keep the second state in a second set of lanes."""
    batch = state.shape[0]
    a = np.zeros((batch, 32), dtype=np.uint64)
    a[:, :STATE_WORDS] = bytes_as_states(np.ascontiguousarray(state, dtype=np.uint8))
    s = np.zeros_like(a)
    row = _padded_words(np.ascontiguousarray(buf, dtype=np.uint8))
    row_bytes = row.view(np.uint8)
    pool = _padded_words(np.frombuffer(program.pool, dtype=np.uint8)[None])
    out = np.zeros((batch, program.n_out), dtype=np.uint8)
    bad = np.zeros(batch, dtype=bool)
    for kind, pos, length, arg in program.ops.tolist():
        if kind == PERMUTE:
            a = keccak_warp(a)
            continue
        if kind == CHECK_ZERO:
            bad |= ~(row_bytes[:, PAD_FRONT + arg + _LANES] != 0).any(axis=1)
            continue
        if kind == SAVE:
            s = a.copy()
            continue
        if kind == SWAP:
            a, s = s, a
            continue
        for w in range(STATE_WORDS):
            lo, hi = max(8 * w, pos), min(8 * w + 8, pos + length)
            if lo >= hi:
                continue
            mask = _byte_mask(lo, hi, w)
            if kind == TAKE:
                for b in range(8):
                    if lo <= 8 * w + b < hi:
                        out[:, arg + 8 * w + b - pos] = (a[:, w] >> np.uint64(8 * b)) & np.uint64(0xFF)
                a[:, w] &= ~mask
            else:
                v = _window(row if kind in (XOR_DATA, SET_DATA) else pool, arg, pos, w) & mask
                a[:, w] = (a[:, w] & ~mask) | v if kind in (SET_CONST, SET_DATA) else a[:, w] ^ v
    return a, out, bad


def reduce_model(wide: np.ndarray):
    """The epilogue's reduction, as ops/scalar_model.py runs it word for
    word: (B, k, 64) uint8 -> (scalars (B, k, 16) int64 limbs, zero (B, k)
    bool)."""
    batch, k = wide.shape[:2]
    words = np.ascontiguousarray(wide).view("<u4").reshape(batch, k, 16)
    scalars = np.zeros((batch, k, 16), dtype=np.int64)
    zero = np.zeros((batch, k), dtype=bool)
    for lane in range(batch):
        for c in range(k):
            r = scalar_model.reduce_fold([int(v) for v in words[lane, c]])
            scalars[lane, c, 0::2] = [v & 0xFFFF for v in r]
            scalars[lane, c, 1::2] = [v >> 16 for v in r]
            zero[lane, c] = not any(r)
    return scalars, zero


def replay_model(program: Program, state: np.ndarray, buf: np.ndarray):
    """csrc/replay.cu's replay_kernel in numpy (`run_ops_model`, then the
    epilogue's reduction through ops/scalar_model.py).  Returns (scalars,
    seeds, bad_identity, bad_zero) as numpy arrays."""
    batch = state.shape[0]
    _, out, bad = run_ops_model(program, state, buf)
    n_ch = program.n_challenges
    scalars, zero = reduce_model(out[:, : WIDE * n_ch].reshape(batch, n_ch, WIDE))
    return scalars, out[:, WIDE * n_ch :], bad, zero.any(axis=1)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def occupancy(device: int, n_ops: int, pool_words: int, stride: int, n_ch: int, n_seed: int, warps: int) -> int:
    """Blocks of `warps` warps that one SM of CUDA device `device` holds at
    once for a program of this size, by the CUDA occupancy calculator."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = cuda.lib("replay").bppt_replay_occupancy(n_ops, pool_words, stride, n_ch, n_seed, warps,
                                                          ctypes.byref(blocks))
    cuda.check("replay", status, "replay occupancy")
    return blocks.value


def pick_warps(batch: int, resident) -> int:
    """Warps a block: the fewest from WARP_CHOICES whose ceil(batch / warps)
    blocks the card holds at once (one wave), the most where none does.
    `resident(warps)` is the number of such blocks the card holds at once."""
    return next((w for w in WARP_CHOICES if -(-batch // w) <= resident(w)), WARP_CHOICES[-1])


def launch_shape(program: Program, batch: int, stride: int, device) -> dict:
    """R1's grid for this batch on CUDA `device`: warps a block, blocks, and
    the blocks the card holds at once (its SMs times the occupancy)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def resident(warps):
        return sms * occupancy(index, len(program.ops), program.pool_words, stride, program.n_challenges,
                               program.n_seed, warps)

    warps = pick_warps(batch, resident)
    return {"warps": warps, "blocks": -(-batch // warps), "resident_blocks": resident(warps)}


def replay_cuda(program: Program, state: torch.Tensor, buf: torch.Tensor, warps: int | None = None):
    """R1 on CUDA tensors: (B, 200) uint8 states and (B, stride) uint8 rows
    -> (scalars (B, challenges, 16) int64, seeds (B, n_seed) uint8,
    bad_identity (B,) bool, bad_zero (B,) bool), one launch.  `warps` a
    block is `launch_shape`'s unless given."""
    batch = state.shape[0]
    cuda.require(state, "replay state", (batch, STATE_BYTES), "torch.uint8")
    if batch == 0 or state.data_ptr() % 8:
        raise ValueError("replay state: expected a non-empty batch at an 8-byte aligned address")
    stride = buf.shape[1]
    cuda.require(buf, "replay rows", (batch, stride), "torch.uint8")
    if stride % 8 or buf.data_ptr() % 8:
        raise ValueError("replay rows: expected rows of a multiple of 8 bytes at an 8-byte aligned address")
    dev = state.device
    if warps is None:
        warps = launch_shape(program, batch, stride, dev)["warps"]
    blob = program.blob_on(dev)
    scalars = torch.empty((batch, program.n_challenges, 16), dtype=torch.int64, device=dev)
    seeds = torch.empty((batch, program.n_seed), dtype=torch.uint8, device=dev)
    bad_identity = torch.empty((batch,), dtype=torch.bool, device=dev)
    bad_zero = torch.empty((batch,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        status = cuda.lib("replay").bppt_replay(
            state.data_ptr(), buf.data_ptr(), stride, blob.data_ptr(), len(program.ops), program.pool_words,
            program.n_challenges, program.n_seed, scalars.data_ptr(), seeds.data_ptr(), bad_identity.data_ptr(),
            bad_zero.data_ptr(), batch, warps, torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("replay", status, "replay")
    cuda.launches["replay"] += 1
    return scalars, seeds, bad_identity, bad_zero


def replay(program: Program, state: torch.Tensor, buf: torch.Tensor):
    """R1 on CUDA tensors, its plain version on CPU tensors."""
    if state.device.type == "cpu":
        return replay_fn_plain(program, state, buf)
    return replay_cuda(program, state, buf)


def _probe_stream():
    return torch.cuda.current_stream().cuda_stream


def perm_latency_probe(words: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, lane w holding word w of `words` ((25,) int64 on a CUDA
    device, the 64-bit lanes' bit patterns), `iters` dependent permutations
    as R1 runs them; returns the chain's end.  Counts no launch."""
    cuda.require(words, "perm_latency_probe words", (STATE_WORDS,))
    out = torch.empty_like(words)
    with torch.cuda.device(words.device):
        status = cuda.lib("replay").bppt_perm_latency(words.data_ptr(), out.data_ptr(), iters, _probe_stream())
    cuda.check("replay", status, "perm_latency_probe")
    return out


def keccak_latency_probe(words: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, every thread `iters` dependent permutations of `words`, (25,)
    int64 on a CUDA device, in one thread's registers (the design before the
    warp's); returns the chain's end.  Counts no launch."""
    cuda.require(words, "keccak_latency_probe words", (STATE_WORDS,))
    out = torch.empty_like(words)
    with torch.cuda.device(words.device):
        status = cuda.lib("replay").bppt_keccak_latency(words.data_ptr(), out.data_ptr(), iters, _probe_stream())
    cuda.check("replay", status, "keccak_latency_probe")
    return out


def reduce_wide_probe(wide: torch.Tensor):
    """R1's epilogue alone: (n, 64) uint8 on a CUDA device -> (limbs (n, 16)
    int64 canonical mod l, zero (n,) bool).  Counts no launch."""
    n = wide.shape[0]
    cuda.require(wide, "reduce_wide_probe input", (n, WIDE), "torch.uint8")
    if n == 0 or wide.data_ptr() % 4:
        raise ValueError("reduce_wide_probe input: expected a non-empty batch at a 4-byte aligned address")
    limbs = torch.empty((n, 16), dtype=torch.int64, device=wide.device)
    zero = torch.empty((n,), dtype=torch.bool, device=wide.device)
    with torch.cuda.device(wide.device):
        status = cuda.lib("replay").bppt_reduce_wide(wide.data_ptr(), limbs.data_ptr(), zero.data_ptr(), n,
                                                     _probe_stream())
    cuda.check("replay", status, "reduce_wide_probe")
    return limbs, zero
