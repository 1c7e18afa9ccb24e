"""Device-side Fiat-Shamir challenge replay (verifier pass 1).

Counterpart of bulletproofs_plus_tpu/models/replay_device.py.  The host
replay (range_proof._replay_challenges) advances B numpy sponges; here the
same Merlin op sequence (models/transcripts.py framing) runs on the card,
a warp a proof, in the hand-written kernel R1 (csrc/replay.cu through
ops/cuda_replay.py), which also reduces each challenge mod l; on a CPU
tensor it runs as the plain torch sequence over utils/jstrobe.py and the
plain reduction.  Commitments, proof elements and responses come in as one
packed (B, stride) byte buffer, the same one that `verify_group_bytes` reads
next: one upload a batch.  Challenges come out as canonical scalar limbs on
the device, ready for the scalar pass.

Replaces the host half of the reference's per-proof challenge replay with
NullRng (range_proof.rs:816-850) for the device engine.

Validation parity: identity points appended to the transcript and zero
challenges come back as flags; the caller raises `VerificationFailed` with
the reference's messages before any pass-2 work, preserving the error
precedence.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops import cuda_replay
from ..ops.cuda_replay import WIDE  # bytes of a challenge before its reduction
from .transcripts import DOMAIN_SEPARATOR

__all__ = ["pack_replay_inputs", "replay_fn", "row_layout", "unpack_row_buffer"]


def row_layout(m: int, rounds: int, deg: int):
    """Static byte layout of one proof's packed row:
    [commits | min_vals | a | a1 | b | li | ri | r1 | s1 | d1]."""
    sizes = {
        "commits": m * 32,
        "min_vals": m * 8,
        "a": 32,
        "a1": 32,
        "b": 32,
        "li": rounds * 32,
        "ri": rounds * 32,
        "r1": 32,
        "s1": 32,
        "d1": deg * 32,
    }
    offsets = {}
    off = 0
    for name, size in sizes.items():
        offsets[name] = (off, off + size)
        off += size
    return offsets, off


def unpack_row_buffer(buf: torch.Tensor, m: int, rounds: int, deg: int):
    """Slice a (B, stride) packed row buffer back into its fields (views)."""
    offsets, stride = row_layout(m, rounds, deg)
    if buf.shape[-1] != stride:
        raise ValueError(f"row buffer of width {buf.shape[-1]}, expected {stride}")

    def f(name, *shape):
        lo, hi = offsets[name]
        out = buf[:, lo:hi]
        return out.reshape(buf.shape[0], *shape) if shape else out

    return dict(
        commits=f("commits", m, 32),
        min_vals=f("min_vals", m, 8),
        a=f("a"),
        a1=f("a1"),
        b=f("b"),
        li=f("li", rounds, 32),
        ri=f("ri", rounds, 32),
        r1=f("r1"),
        s1=f("s1"),
        d1=f("d1", deg, 32),
    )


def replay_sequence(h_base_compressed: bytes, g_bases_compressed: Tuple[bytes, ...], bit_length: int,
                    extension_degree: int, m: int, rounds: int):
    """The verifier's transcript for one proof shape as
    `sequence(t, row, check) -> ([y, z, e_1..e_rounds, e], seeds)`, the op
    sequence of the JAX package's replay (replay_device.py:124-178) and of
    RangeProofTranscript with NullRng: `t` is a JTranscript (or the replay
    program's recorder), `row(offset, length)` reads bytes of each proof's
    packed row, `check(point)` flags the lanes whose point is the identity."""
    offsets, _ = row_layout(m, rounds, extension_degree)

    def field(row, name, j=0, size=32):
        return row(offsets[name][0] + j * size, size)

    def sequence(t, row, check):
        def validate_append(label, point):
            check(point)
            t.append_message(label, point)

        # RangeProofTranscript.__init__ (models/transcripts.py)
        t.append_message(b"dom-sep", DOMAIN_SEPARATOR)
        t.append_message(b"H", h_base_compressed)  # valid by construction
        for g in g_bases_compressed:
            t.append_message(b"G", g)
        t.append_u64(b"N", bit_length)
        t.append_u64(b"T", extension_degree)
        t.append_u64(b"M", m)
        for j in range(m):
            t.append_message(b"Ci", field(row, "commits", j))
        for j in range(m):
            t.append_u64(b"vi - minimum_value", field(row, "min_vals", j, 8))

        # challenges_y_z, the rounds' challenge_round_e, challenge_final_e
        validate_append(b"A", field(row, "a"))
        wide = [t.challenge_bytes(b"y", WIDE), t.challenge_bytes(b"z", WIDE)]
        for j in range(rounds):
            validate_append(b"L", field(row, "li", j))
            validate_append(b"R", field(row, "ri", j))
            wide.append(t.challenge_bytes(b"e", WIDE))
        validate_append(b"A1", field(row, "a1"))
        validate_append(b"B", field(row, "b"))
        wide.append(t.challenge_bytes(b"e", WIDE))

        # to_verifier_rng: bind r1, s1, d1; the final RNG seeded with NullRng
        t.append_message(b"r1", field(row, "r1"))
        t.append_message(b"s1", field(row, "s1"))
        for k in range(extension_degree):
            t.append_message(b"d1", field(row, "d1", k))
        seeds = t.build_rng().finalize_null().fill_bytes(32)
        return wide, seeds

    return sequence


@functools.lru_cache(maxsize=None)
def replay_fn(
    h_base_compressed: bytes,
    g_bases_compressed: Tuple[bytes, ...],
    bit_length: int,
    extension_degree: int,
    m: int,
    rounds: int,
    pos: int,
    pos_begin: int,
    cur_flags: int,
):
    """Build (and cache) the replay for one proof shape, generator set and
    starting transcript position, its R1 program compiled once.

    Returned fn(state (B, 200) uint8, buf (B, stride) uint8 per row_layout)
      -> (y, z (B, 16), es (B, rounds, 16), e (B, 16) canonical int64 limbs,
          seeds (B, 32) uint8, bad_identity (B,) bool, bad_zero (B,) bool)
    on the tensors' device: one R1 launch and views of its outputs on a CUDA
    device, the plain sequence and reduction on the CPU.  `fn.program` is
    the compiled program.
    """
    program = cuda_replay.Program(
        replay_sequence(h_base_compressed, g_bases_compressed, bit_length, extension_degree, m, rounds),
        pos, pos_begin, cur_flags,
    )

    def replay(state: torch.Tensor, buf: torch.Tensor):
        scalars, seeds, bad_identity, bad_zero = cuda_replay.replay(program, state, buf)
        return (scalars[:, 0], scalars[:, 1], scalars[:, 2 : 2 + rounds], scalars[:, 2 + rounds], seeds,
                bad_identity, bad_zero)

    replay.program = program
    return replay


def pack_replay_inputs(statements, proofs) -> np.ndarray:
    """Pack the whole batch into ONE (B, stride) uint8 buffer (row_layout
    order) -- a single host->device transfer feeds both the replay kernel and
    `verify_group_bytes`.  Pure byte joins; the only per-int work is the
    response scalars' to_bytes."""
    from ..ops import host_ristretto as hr

    B = len(proofs)
    m = len(statements[0].commitments)
    rounds = len(proofs[0].li)
    deg = len(proofs[0].d1)
    _, stride = row_layout(m, rounds, deg)

    rows = []
    for s, p in zip(statements, proofs):
        rows.append(b"".join(s.commitments_compressed))
        rows.append(b"".join((v or 0).to_bytes(8, "little") for v in s.minimum_value_promises))
        rows.append(p.a)
        rows.append(p.a1)
        rows.append(p.b)
        rows.append(b"".join(p.li))
        rows.append(b"".join(p.ri))
        rows.append(hr.scalar_to_bytes(p.r1))
        rows.append(hr.scalar_to_bytes(p.s1))
        rows.append(b"".join(hr.scalar_to_bytes(v) for v in p.d1))
    return np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(B, stride)
