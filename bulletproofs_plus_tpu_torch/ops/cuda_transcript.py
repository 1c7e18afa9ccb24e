"""T1 wrapper: the batched prover's Fiat-Shamir on the card, a launch a
phase, through csrc/transcript.cu.

A prove of `rounds` rounds runs rounds + 2 phases (`phase_specs`), the
traced sponge of the JAX package's `_prover_fn_core`
(bulletproofs_plus_tpu/models/prover_device.py:134-160) cut where the
prover's points arrive: after A, after each round's L and R, after A1 and
B.  A phase appends its points, each checked against the identity's
encoding; rebuilds the transcript RNG where the prover draws from it before
the next challenge (a clone of the state, rekeyed with the lane's witness
bytes, finalized with the phase's external block, which the host drew
beforehand in the sequential prover's order); draws those masks; squeezes
the challenges; and reduces every draw and challenge mod l, flagging a
zero, and inverts y or e (on the card by scalar_l.cuh `sc_inv_l_var`, the
warp for one value, in variable time: the challenges are public).  The draws of phase p are round p's d_L and d_R
(degree each, unless the statements carry a seed nonce), or, in the phase
after the last round (phase 0 of a prove without rounds), r_s, s_s and, on
unseeded statements, d and eta.  The last phase builds no RNG.

Each phase is one `Phase`: its op sequence recorded once a shape and
sponge position (`prover_phases`) through `_TwoStates`, a recording STROBE
(ops/cuda_replay.py `_Recorder`) whose `clone` saves the state into a
second register set of the lanes (SAVE) and whose recorders bring their
state back with SWAP, and the row-keyed overwrite SET_DATA.  Three
forms run it:

  * `transcript_plain`: the sequence on utils/jstrobe.py's tensors, then
    `field.reduce_wide_l`, `is_zero_l` and `inv_l` -- the plain version,
    any device;
  * `transcript_model`: the span program in numpy as the kernel runs it,
    word for word (`cuda_replay.run_ops_model`, the reduction and the
    warp's variable-time inverse through ops/scalar_model.py, `inv_l_var`);
  * `transcript_cuda`: the kernel, a warp a proof.

`prove_transcript` takes the kernel for CUDA tensors and the plain
version for CPU ones, and any other device raises.  Both write in place:
the (B, 200) states, each scalar into the (B, 16) int64 view the caller
names (the limb tensors P1-P3 read), and a flag byte a proof, bits
`IDENTITY`, `ZERO_CHALLENGE`, `ZERO_DRAW`.

`inv_latency_probe` is `sc_inv_var_ns`'s probe.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..native import cuda
from ..utils.jstrobe import JStrobe, JTranscript
from . import field as F
from . import scalar_model
from .cuda_replay import (
    POINT_BYTES, SAVE, SET_DATA, STATE_BYTES, STATE_WORDS, SWAP, WIDE, RowSlice, _check, _Compiled, _Recorder, _Tape,
    pick_warps, reduce_model, run_ops_model,
)

BLOCK_BYTES = 32  # an external RNG block, the finalize key
MAX_OUTS = 32  # csrc/transcript.cu T1_MAX_OUTS
IDENTITY, ZERO_CHALLENGE, ZERO_DRAW = 1, 2, 4  # a phase's flag bits


class PhaseSpec(NamedTuple):
    labels: Tuple[bytes, ...]  # the points appended, each checked against the identity's encoding
    draws: int  # 64-byte draws from the rebuilt RNG (0: the phase builds none)
    challenges: Tuple[bytes, ...]  # the challenges squeezed, 64 bytes each
    invert: Tuple[int, ...]  # the challenges (their indices) whose inverses the phase writes


def phase_specs(rounds: int, deg: int, seeded: bool) -> List[PhaseSpec]:
    """A prove's rounds + 2 phases in order (transcripts.rs:124-176, and
    the prover's draws, range_proof.rs:409-553)."""
    masks = 0 if seeded else 2 * deg  # a round's d_L and d_R: nonces on seeded statements
    finals = 2 + masks  # r_s and s_s, then d and eta
    specs = [PhaseSpec((b"A",), masks if rounds else finals, (b"y", b"z"), (0,))]
    for r in range(rounds):
        specs.append(PhaseSpec((b"L", b"R"), masks if r + 1 < rounds else finals, (b"e",), (0,)))
    specs.append(PhaseSpec((b"A1", b"B"), 0, (b"e",), ()))
    return specs


class _TwoStates(_Recorder):
    """A recorder of a program with two states a lane: `clone` (the RNG
    builder's) copies the state into the second (SAVE), and a recorder that
    acts while the other's state is in the lanes exchanges the two (SWAP).
    Data keyed from the row records as SET_DATA."""

    __slots__ = ()

    def _use(self) -> None:
        if self.tape.live is not self:
            self.tape.ops.append([SWAP, 0, 0, 0])
            self.tape.live = self

    def clone(self) -> "_TwoStates":
        if any(op[0] == SAVE for op in self.tape.ops):
            raise ValueError("a phase program holds two states: one clone")
        self._use()
        self.tape.ops.append([SAVE, 0, 0, 0])
        twin = _TwoStates(self.tape, self.pos, self.pos_begin, self.cur_flags)
        self.tape.live = twin
        return twin

    def _xor(self, pos: int, chunk) -> None:
        self._use()
        super()._xor(pos, chunk)

    def _set(self, pos: int, chunk) -> None:
        self._use()
        if isinstance(chunk, RowSlice):
            self.tape.span(SET_DATA, pos, chunk)
        else:
            super()._set(pos, chunk)

    def _take(self, pos: int, k: int):
        self._use()
        return super()._take(pos, k)

    def _permute(self) -> None:
        self._use()
        super()._permute()


def _sequence(spec: PhaseSpec, witness_len: int):
    """The phase as a function of a transcript `t`, a row accessor `row(offset,
    length)` and an identity check `check(point)`: returns its 64-byte
    outputs, the draws then the challenges.  The row is the phase's points,
    the lane's witness bytes, its external block."""

    def run(t, row, check):
        for i, label in enumerate(spec.labels):
            point = row(POINT_BYTES * i, POINT_BYTES)
            check(point)
            t.append_message(label, point)
        outs = []
        if spec.draws:
            at = POINT_BYTES * len(spec.labels)
            rng = (t.build_rng().rekey_with_witness_bytes(b"witness", row(at, witness_len))
                   .finalize_with(row(at + witness_len, BLOCK_BYTES)))
            outs = [rng.fill_bytes(WIDE) for _ in range(spec.draws)]
        return outs + [t.challenge_bytes(label, WIDE) for label in spec.challenges]

    return run


class Phase(_Compiled):
    """One phase of a prove: its spec, the sponge position it starts from
    and ends at, and the span program it compiles to."""

    def __init__(self, spec: PhaseSpec, witness_len: int, position: tuple):
        self.spec, self.witness_len, self.position = spec, witness_len, position
        self.n_points = len(spec.labels)
        self.stride = POINT_BYTES * self.n_points + witness_len + BLOCK_BYTES
        self.sequence = _sequence(spec, witness_len)
        tape = _Tape()
        rec = _TwoStates(tape, *position)
        tape.live = rec
        outs = self.sequence(JTranscript(rec), RowSlice, lambda point: _check(tape, point))
        rec._use()  # the transcript's own state is the one written back
        if [o for o, _ in outs] != [WIDE * i for i in range(len(outs))] or any(n != WIDE for _, n in outs) \
                or tape.n_out != WIDE * len(outs):
            raise AssertionError("the phase's outputs do not fill the output row in order")
        self.end = (rec.pos, rec.pos_begin, rec.cur_flags)
        self._assemble(tape)
        self.n_wide, self.n_draws = len(outs), spec.draws
        if any(not 0 <= i < len(spec.challenges) for i in spec.invert):
            raise ValueError("a phase inverts only its challenges (public values), never a draw")
        self.invert = [spec.draws + i for i in spec.invert]  # among the outputs
        self.inv_mask = sum(1 << c for c in self.invert)
        if self.n_wide + len(self.invert) > MAX_OUTS:
            raise ValueError(f"a phase writes at most {MAX_OUTS} scalars")


@functools.lru_cache(maxsize=None)
def prover_phases(rounds: int, deg: int, seeded: bool, witness_len: int, pos: int, pos_begin: int,
                  cur_flags: int) -> Tuple[Tuple[Phase, ...], tuple]:
    """A prove's phases from the sponge position its transcript stands at
    after the statement, and the position after the last: (phases, (pos,
    pos_begin, cur_flags))."""
    phases, position = [], (pos, pos_begin, cur_flags)
    for spec in phase_specs(rounds, deg, seeded):
        phases.append(Phase(spec, witness_len, position))
        position = phases[-1].end
    return tuple(phases), position


# ---------------------------------------------------------------------------
# The plain version and the kernel's model
# ---------------------------------------------------------------------------


def phase_row(points: torch.Tensor, witness: torch.Tensor, block: torch.Tensor | None) -> torch.Tensor:
    """The warp's row: (B, k, 16) canonical limbs as (B, 32 k) bytes, the
    (B, W) witness bytes, the (B, 32) block (zeroes where there is none)."""
    batch = points.shape[0]
    limbs = points.reshape(batch, -1)
    as_bytes = torch.stack([limbs & 0xFF, limbs >> 8], dim=-1).reshape(batch, -1).to(torch.uint8)
    if block is None:
        block = torch.zeros((batch, BLOCK_BYTES), dtype=torch.uint8, device=points.device)
    return torch.cat([as_bytes, witness, block], dim=1)


def _flags(bad_identity, zero: torch.Tensor, n_draws: int) -> torch.Tensor:
    return (bad_identity.to(torch.uint8) * IDENTITY | zero[:, n_draws:].any(dim=1).to(torch.uint8) * ZERO_CHALLENGE
            | zero[:, :n_draws].any(dim=1).to(torch.uint8) * ZERO_DRAW)


def transcript_plain(phase: Phase, state: torch.Tensor, points: torch.Tensor, witness: torch.Tensor,
                     block: torch.Tensor | None):
    """The phase in plain torch on any device: (B, 200) uint8 states, (B, k,
    16) points, (B, W) witness bytes, (B, 32) block or None -> (states,
    scalars (B, n_wide, 16), inverses (B, n_inv, 16), flags (B,) uint8)."""
    row = phase_row(points, witness, block)
    t = JTranscript(JStrobe(state.clone(), *phase.position))
    bad = torch.zeros(state.shape[0], dtype=torch.bool, device=state.device)

    def check(point):
        nonlocal bad
        bad = bad | (point == 0).all(dim=-1)

    wide = torch.stack(phase.sequence(t, lambda offset, length: row[:, offset : offset + length], check), dim=1)
    scalars = F.reduce_wide_l(wide[..., 0::2].long() | (wide[..., 1::2].long() << 8))
    inverses = F.inv_l(scalars[:, phase.invert])
    return t.strobe.state, scalars, inverses, _flags(bad, F.is_zero_l(scalars), phase.n_draws)


def _limbs_to_words(limbs) -> list:
    return [int(limbs[2 * j]) | int(limbs[2 * j + 1]) << 16 for j in range(8)]


def transcript_model(phase: Phase, state: np.ndarray, row: np.ndarray):
    """csrc/transcript.cu in numpy, word for word: `run_ops_model` over the
    phase's program, the reduction and the warp's variable-time inverse of
    ops/scalar_model.py (`inv_l_var`).  state (B, 200) and row (B, stride)
    uint8 -> (states, scalars, inverses, flags) as numpy arrays."""
    batch = state.shape[0]
    a, out, bad = run_ops_model(phase, state, row)
    new_state = np.ascontiguousarray(a[:, :STATE_WORDS]).astype("<u8").view(np.uint8).reshape(batch, STATE_BYTES)
    scalars, zero = reduce_model(out.reshape(batch, phase.n_wide, WIDE))
    inverses = np.zeros((batch, len(phase.invert), 16), dtype=np.int64)
    for lane in range(batch):
        for i, c in enumerate(phase.invert):
            words = scalar_model.inv_l_var(_limbs_to_words(scalars[lane, c]))
            inverses[lane, i, 0::2] = [w & 0xFFFF for w in words]
            inverses[lane, i, 1::2] = [w >> 16 for w in words]
    flags = (bad * IDENTITY | zero[:, phase.n_draws :].any(axis=1) * ZERO_CHALLENGE
             | zero[:, : phase.n_draws].any(axis=1) * ZERO_DRAW).astype(np.uint8)
    return new_state, scalars, inverses, flags


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def occupancy(device: int, n_ops: int, pool_words: int, stride: int, n_wide: int, warps: int) -> int:
    """Blocks of `warps` warps that one SM of CUDA device `device` holds at
    once for a phase program of this size, by the CUDA occupancy calculator."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = cuda.lib("transcript").bppt_transcript_occupancy(n_ops, pool_words, stride, n_wide, warps,
                                                                  ctypes.byref(blocks))
    cuda.check("transcript", status, "transcript occupancy")
    return blocks.value


def launch_shape(phase: Phase, batch: int, device) -> dict:
    """T1's grid for this batch on CUDA `device`, chosen as R1's is
    (`cuda_replay.pick_warps`): warps a block, blocks, and the blocks the
    card holds at once."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def resident(warps):
        return sms * occupancy(index, len(phase.ops), phase.pool_words, phase.stride, phase.n_wide, warps)

    warps = pick_warps(batch, resident)
    return {"warps": warps, "blocks": -(-batch // warps), "resident_blocks": resident(warps)}


def _check_args(phase: Phase, state, points, witness, block, outs: Sequence[torch.Tensor], flags) -> int:
    batch = state.shape[0]
    if phase.inv_mask & ((1 << phase.n_draws) - 1) or phase.inv_mask >> phase.n_wide:
        raise ValueError("prove_transcript: the phase inverts a draw, a secret mask, or no output "
                         "(only challenges, which are public, take the variable-time inversion)")
    if len(outs) != phase.n_wide + len(phase.invert):
        raise ValueError(f"prove_transcript: the phase writes {phase.n_wide + len(phase.invert)} scalars, "
                         f"got {len(outs)} outputs")
    if (block is None) != (phase.n_draws == 0):
        raise ValueError("prove_transcript: a block exactly where the phase draws from its RNG")
    for view in list(outs) + [flags]:
        if view.device != state.device:
            raise ValueError(f"prove_transcript: an output on {view.device}, the state on {state.device}")
    for view in outs:
        if view.dtype != torch.int64 or tuple(view.shape) != (batch, 16) or view.stride(1) != 1:
            raise ValueError(f"prove_transcript: outputs are ({batch}, 16) int64 views with unit limb stride")
    if flags.dtype != torch.uint8 or tuple(flags.shape) != (batch,):
        raise ValueError(f"prove_transcript: flags are a ({batch},) uint8 view")
    return batch


def transcript_cuda(phase: Phase, state: torch.Tensor, points: torch.Tensor, witness: torch.Tensor,
                    block: torch.Tensor | None, outs: Sequence[torch.Tensor], flags: torch.Tensor,
                    warps: int | None = None) -> None:
    """T1 on CUDA tensors, one launch: the phase on the (B, 200) uint8
    states in place, its scalars into `outs`, its flags into `flags`.
    `warps` a block is `launch_shape`'s unless given."""
    batch = _check_args(phase, state, points, witness, block, outs, flags)
    cuda.require(state, "transcript state", (batch, STATE_BYTES), "torch.uint8")
    if batch == 0 or state.data_ptr() % 8:
        raise ValueError("transcript state: expected a non-empty batch at an 8-byte aligned address")
    cuda.require(points, "transcript points", (batch, phase.n_points, 16))
    cuda.require(witness, "transcript witness bytes", (batch, phase.witness_len), "torch.uint8")
    if block is not None:
        cuda.require(block, "transcript block", (batch, BLOCK_BYTES), "torch.uint8")
    dev = state.device
    if warps is None:
        warps = launch_shape(phase, batch, dev)["warps"]
    blob = phase.blob_on(dev)
    n = len(outs)
    ptrs = (ctypes.c_void_p * n)(*[view.data_ptr() for view in outs])
    strides = (ctypes.c_long * n)(*[view.stride(0) for view in outs])
    with torch.cuda.device(dev):
        status = cuda.lib("transcript").bppt_prove_transcript(
            state.data_ptr(), points.data_ptr(), phase.n_points, witness.data_ptr(), phase.witness_len,
            None if block is None else block.data_ptr(), blob.data_ptr(), len(phase.ops), phase.pool_words,
            phase.n_wide, phase.n_draws, phase.inv_mask, ptrs, strides, n, flags.data_ptr(), flags.stride(0), batch,
            warps, torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("transcript", status, "prove_transcript")
    cuda.launches["prove_transcript"] += 1


def inv_latency_probe(x: torch.Tensor, iters: int) -> torch.Tensor:
    """`sc_inv_var_ns`'s probe: warp i (a one-warp block) runs `iters`
    dependent inversions by sc_inv_l_var from acc = x[i], each but the
    first of x[i] + acc mod l ((n, 16) canonical int64 limbs on a CUDA
    device; iters = 1 gives x's inverses, 0 for 0).  Counts no launch."""
    cuda.require(x, "inversion probe input", (x.shape[0], 16))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = cuda.lib("transcript").bppt_transcript_inv_latency(
            x.data_ptr(), out.data_ptr(), x.shape[0], iters, torch.cuda.current_stream().cuda_stream)
    cuda.check("transcript", status, "transcript inversion probe")
    return out


def prove_transcript(phase: Phase, state: torch.Tensor, points: torch.Tensor, witness: torch.Tensor,
                     block: torch.Tensor | None, outs: Sequence[torch.Tensor], flags: torch.Tensor) -> None:
    """T1 on CUDA tensors, its plain version on CPU ones (any other device
    raises): runs `phase` on the (B, 200) uint8 states in place and writes
    its reduced draws and challenges, then its inverses, into `outs`
    ((B, 16) int64 views) and its flag bits into `flags` ((B,) uint8)."""
    if state.device.type != "cpu":
        return transcript_cuda(phase, state, points, witness, block, outs, flags)
    _check_args(phase, state, points, witness, block, outs, flags)
    new_state, scalars, inverses, bits = transcript_plain(phase, state, points, witness, block)
    state.copy_(new_state)
    for j, view in enumerate(outs):
        view.copy_(scalars[:, j] if j < phase.n_wide else inverses[:, j - phase.n_wide])
    flags.copy_(bits)
