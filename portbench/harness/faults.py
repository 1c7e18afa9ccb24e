"""The timed path broken on purpose, for the control and the fault tests
(`run.py --fault NAME`; a benchmark run never takes one).  Each acts on an
entry (entries.py) once set-up and warm-up are done, so it breaks only the
window.

  * accept_all: the verify cells' control.  It breaks the guarantee that a
    block with an invalid proof is refused: a refusal is reported as valid.
  * null_rng: the prove cells' control.  It breaks the guarantee that the
    masks come from the wallet's RNG: the prover gets an RNG of zeros.
  * half_batch: half of each call into the port left out: the first half
    of a verify call's blocks (of a prove call's statements) is verified
    (proved) and stands for the whole.
  * half_block: half of each block's proofs left out at its decode: the
    first half is verified and stands for the whole block.
  * stale_state: a step that returns its state unchanged: each decode
    (prove call) hands back the previous block's (call's) result.
  * altered_answer: an answer altered where it is produced: the first
    call's verdict reversed; one byte of a proof of each prove call.
"""

from __future__ import annotations

import numpy as np

from . import entries


def apply(entry, name: str) -> None:
    verify = isinstance(entry, entries.VerifyStream)
    if name == "accept_all" and verify:
        run = entry.run_verify

        def accept(call):
            run(call)
            return ("valid",)

        entry.run_verify = accept
    elif name == "null_rng" and not verify:
        prove = entry.prove
        entry.prove = lambda st, w, rng: prove(st, w, _ZeroRng())
    elif name == "half_batch" and verify:
        pipelined = entry.pipelined
        entry.pipelined = lambda blocks: pipelined(blocks[: len(blocks) // 2])
    elif name == "half_block" and verify:
        decode = entry.decode
        entry.decode = lambda wire: decode(wire[: max(1, len(wire) // 2)])
    elif name == "half_batch":
        prove = entry.prove

        def half(statements, witnesses, rng):
            k = max(1, len(statements) // 2)
            proofs = prove(statements[:k], witnesses[:k], rng)
            return (proofs * 2)[: len(statements)]

        entry.prove = half
    elif name == "stale_state" and verify:
        decode, last = entry.decode, []

        def stale(wire):
            out = last[0] if last else decode(wire)
            last[:] = [out]
            return out

        entry.decode = stale
    elif name == "stale_state":
        prove, last = entry.prove, []

        def stale(statements, witnesses, rng):
            out = last[0] if last else prove(statements, witnesses, rng)
            last[:] = [out]
            return out

        entry.prove = stale
    elif name == "altered_answer" and verify:
        run, calls = entry.run_verify, []

        def altered(call):
            out = run(call)
            calls.append(out)
            if len(calls) == 1:
                return ("error", "VerificationFailed", "Range proof batch not valid") if out[0] == "valid" else ("valid",)
            return out

        entry.run_verify = altered
    elif name == "altered_answer":
        prove = entry.prove

        def altered(statements, witnesses, rng):
            proofs = prove(statements, witnesses, rng)
            flipped = bytearray(proofs[0].to_bytes())
            flipped[-2] ^= 1  # inside the last R point
            proofs[0] = type(proofs[0]).from_bytes(bytes(flipped))
            return proofs

        entry.prove = altered
    else:
        raise ValueError(f"no fault {name!r} for this cell")


class _ZeroRng:
    @staticmethod
    def fill_bytes(batch: int, n: int) -> np.ndarray:
        return np.zeros((batch, n), dtype=np.uint8)

