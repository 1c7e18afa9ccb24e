"""Bulletproofs+ range proof: prover, batch verifier, canonical serialization.

Counterpart of bulletproofs_plus_tpu/models/range_proof.py: the sequential
host prover and the batched device prover (reference
src/range_proof.rs:221-608), the batch verifier's two engines
(range_proof.rs:610-1065) -- the exact-integer host oracle, and the device
engine with its staged dispatch (Fiat-Shamir replay on the device for a
single-shape batch, host replay and one scalar pass a shape group for the
rest), the pipelined stream over it, and the proof codec with its pickle
hooks (range_proof.rs:1112-1309).  With a `mesh=` (a 1-D
torch.distributed DeviceMesh, parallel/) the device engine and the batched
prover shard the batch over the mesh's ranks under the JAX package's
routing.

The `verify_batch` 256-proof cap — including the reference quirk that proofs
beyond the first chunk are silently ignored (range_proof.rs:740-749) — is
replicated for parity.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..errors import (
    InvalidArgument,
    InvalidLength,
    SizeOverflow,
    VerificationFailed,
)
from ..gens.pedersen import ExtensionDegree
from ..ops import host_ristretto as hr
from ..ops.msm import msm
from ..utils import trace
from ..utils.hashing import nonce
from ..utils.merlin import NullRng, OsRng, Transcript
from .statement import ExtendedMask, RangeStatement, RangeWitness
from .transcripts import RangeProofTranscript

L = hr.L

MAX_RANGE_PROOF_BIT_LENGTH = 64
MAX_RANGE_PROOF_BATCH_SIZE = 256
SERIALIZED_ELEMENT_SIZE = 32
ENCODED_EXTENSION_SIZE = 1


class VerifyAction(enum.Enum):
    """Mask extraction mode for verification (range_proof.rs:46-54)."""

    VERIFY_ONLY = "verify_only"
    RECOVER_AND_VERIFY = "recover_and_verify"
    RECOVER_ONLY = "recover_only"


class _FetchStage:
    """A device-engine stage blocked on one device->host fetch.

    `arrays` is a tuple (lists inside allowed) of tensors.  Their copy to the
    host starts when the stage is made: from a CUDA device into pinned host
    memory with non_blocking=True, then a CUDA event is recorded behind the
    copies, so the copy waits in the stream behind the work that makes the
    values while the host goes on.  `fetch()` waits on that event (not on
    the whole device) and returns the values as numpy arrays;
    `cont(values)` returns the final result or another `_FetchStage`.  CPU
    tensors are read as they are."""

    __slots__ = ("cont", "_host", "_event")

    def __init__(self, arrays, cont):
        import torch

        self.cont = cont
        self._event = None
        cuda_device = None

        def start(t):
            nonlocal cuda_device
            if t.device.type != "cuda":
                return t
            cuda_device = t.device
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host

        self._host = _tree_map(start, arrays)
        if cuda_device is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda_device))

    def fetch(self):
        if self._event is not None:
            self._event.synchronize()
        return _tree_map(lambda t: t.numpy(), self._host)

    def run(self):
        """Fetch and continue: the single-batch path."""
        with trace.span("verify.wait"):
            values = self.fetch()
        with trace.span("verify.continue"):
            return self.cont(values)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _pipeline_lookahead() -> int:
    """BPPT_PIPELINE_LOOKAHEAD: how many fetches of each kind one pump of
    `verify_batches_pipelined` serves.  2 by default, and wherever the value
    is not an integer of at least 1."""
    import os

    try:
        value = int(os.environ.get("BPPT_PIPELINE_LOOKAHEAD", "2"))
    except ValueError:
        return 2
    return value if value >= 1 else 2


def _check_batch_lengths(transcripts, statements, proofs) -> None:
    if not statements or not proofs or not transcripts:
        raise InvalidArgument("Range statements or proofs length empty")
    if len(statements) != len(proofs):
        raise InvalidArgument("Range statements and proofs length mismatch")
    if len(transcripts) != len(statements):
        raise InvalidArgument("Range statements and transcripts length mismatch")


def _rank_device(mesh, device):
    """The device a call runs on: `device`, or with a mesh this rank's
    device of it (a `device` naming another raises)."""
    if mesh is None:
        return device
    from ..parallel.collectives import mesh_device

    return mesh_device(mesh, device)


def _static_points(max_statement, max_mn: int, device):
    """The interleaved G_i/H_i generators of the batch's widest statement,
    the MSM's 2 * max_mn static lanes, on `device`."""
    interleaved = max_statement.generators.bp_gens.interleaved_device(device)
    return type(interleaved)(*(c[: 2 * max_mn] for c in interleaved))


def _inv(x: int) -> int:
    return pow(x, -1, L)


def _decompress_or(name: str, data: bytes) -> hr.Point:
    p = hr.decompress(data)
    if p is None:
        raise InvalidArgument(f"Member '{name}' was not the canonical encoding of a point")
    return p


class RangeProof:
    """A Bulletproofs+ range proof.

    Elements `a, a1, b, li, ri` are stored compressed (32-byte encodings);
    `r1, s1, d1` are canonical scalars (ints mod l).
    """

    __slots__ = ("a", "a1", "b", "r1", "s1", "d1", "li", "ri", "extension_degree")

    def __init__(
        self,
        a: bytes,
        a1: bytes,
        b: bytes,
        r1: int,
        s1: int,
        d1: List[int],
        li: List[bytes],
        ri: List[bytes],
        extension_degree: ExtensionDegree,
    ):
        self.a = a
        self.a1 = a1
        self.b = b
        self.r1 = r1
        self.s1 = s1
        self.d1 = d1
        self.li = li
        self.ri = ri
        self.extension_degree = extension_degree

    def __eq__(self, other) -> bool:
        if not isinstance(other, RangeProof):
            return NotImplemented
        return self.to_bytes() == other.to_bytes()

    # Pickle through the canonical byte codec — the serde analog
    # (range_proof.rs:1270-1309 serializes as canonical bytes too).
    def __getstate__(self):
        return self.to_bytes()

    def __setstate__(self, state: bytes):
        other = RangeProof.from_bytes(state)
        for slot in self.__slots__:
            setattr(self, slot, getattr(other, slot))

    # ------------------------------------------------------------------
    # Prover
    # ------------------------------------------------------------------

    @staticmethod
    def prove(
        transcript: Transcript,
        statement: RangeStatement,
        witness: RangeWitness,
        rng=None,
    ) -> "RangeProof":
        """Create a (possibly aggregated) range proof with the OS RNG."""
        return RangeProof.prove_with_rng(transcript, statement, witness, rng or OsRng())

    @staticmethod
    def prove_batch_with_rng(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        witnesses: Sequence[RangeWitness],
        rng,
        device="cuda",
        mesh=None,
    ) -> List["RangeProof"]:
        """Prove B same-shape statements in lockstep on `device`: the batched
        prover (models/prover_device.py), whose MSMs are the fixed-base
        kernels on a CUDA device.  Bit-identical to sequential
        `prove_with_rng` calls fed the same per-lane RNG streams.  Pass
        device="cpu" to run the kernels' plain torch versions instead.  A
        1-D mesh shards the proof-lane axis over its ranks (each proves its
        run of lanes on its own device; every rank returns all B proofs)."""
        from .prover_device import prove_batch_with_rng as _impl

        return _impl(transcripts, statements, witnesses, rng, device=device, mesh=mesh)

    @staticmethod
    def prove_with_rng(
        transcript: Transcript,
        statement: RangeStatement,
        witness: RangeWitness,
        rng,
        msm_backend: Optional[str] = None,
        device="cuda",
    ) -> "RangeProof":
        """Create one range proof on the host in exact integer arithmetic
        (range_proof.rs:232-608 parity): the sequential prover the batched
        one is held against.  Its five MSMs go through `ops.msm.msm`:
        `msm_backend` "device" runs them on `device`, "host" (the default)
        as host integers."""
        gens = statement.generators
        bit_length = gens.bit_length()
        aggregation_factor = len(statement.commitments)
        extension_degree = int(gens.extension_degree())
        full_length = bit_length * aggregation_factor

        if len(witness.openings) != len(statement.commitments):
            raise InvalidLength("Witness openings and statement commitments do not match!")
        if int(witness.extension_degree) != int(gens.extension_degree()):
            raise InvalidLength("Witness and statement extension degrees do not match!")
        for opening in witness.openings:
            if bit_length < 64 and opening.v >> bit_length > 0:
                raise InvalidLength("Value exceeds bit vector capacity!")
        for opening, commitment in zip(witness.openings, statement.commitments):
            if not hr.point_equal(gens.pc_gens.commit(opening.v, opening.r), commitment):
                raise InvalidArgument("Witness opening is invalid!")

        # Witness bytes: v LE64 then each blinding, per opening (transcripts.rs:91-109)
        witness_bytes = bytearray()
        for opening in witness.openings:
            witness_bytes += opening.v.to_bytes(8, "little")
            for r in opening.r:
                witness_bytes += hr.scalar_to_bytes(r)

        rpt = RangeProofTranscript(
            transcript,
            gens.h_base_compressed(),
            gens.g_bases_compressed(),
            bit_length,
            extension_degree,
            aggregation_factor,
            statement.commitments_compressed,
            statement.minimum_value_promises,
            np.frombuffer(bytes(witness_bytes), dtype=np.uint8).reshape(1, -1),
            rng,
        )

        # Bit decomposition with minimum-value offsets
        a_li: List[int] = []
        a_ri: List[int] = []
        for minimum_value, opening in zip(statement.minimum_value_promises, witness.openings):
            if minimum_value is not None:
                if minimum_value > opening.v:
                    raise InvalidArgument("Minimum value is larger than value")
                offset_value = opening.v - minimum_value
            else:
                offset_value = opening.v
            for i in range(bit_length):
                bit = (offset_value >> i) & 1
                a_li.append(bit)
                a_ri.append((bit - 1) % L)

        # alpha masks
        seed_nonce = statement.seed_nonce
        if seed_nonce is not None:
            alpha = [nonce(seed_nonce, "alpha", None, k) for k in range(extension_degree)]
        else:
            alpha = [rpt.rng().random_not_zero()[0] for _ in range(extension_degree)]

        # A = interleave(a_li, a_ri) . interleave(gi, hi) + alpha . g_bases
        gi_base = gens.gi_base()[:full_length]
        hi_base = gens.hi_base()[:full_length]
        a_scalars: List[int] = []
        a_points: List[hr.Point] = []
        for s_l, s_r, g, h in zip(a_li, a_ri, gi_base, hi_base):
            a_scalars += [s_l, s_r]
            a_points += [g, h]
        a_scalars += alpha
        a_points += gens.g_bases()
        a = msm(a_scalars, a_points, backend=msm_backend, device=device)

        y_list, z_list = rpt.challenges_y_z(hr.compress(a))
        y, z = y_list[0], z_list[0]
        z_square = z * z % L

        # Powers of y
        y_powers = [1]
        for _ in range(full_length + 1):
            y_powers.append(y_powers[-1] * y % L)

        # d vector
        d = [z_square]
        for _ in range(1, bit_length):
            d.append(d[-1] * 2 % L)
        for j in range(1, aggregation_factor):
            for i in range(bit_length):
                d.append(d[(j - 1) * bit_length + i] * z_square % L)

        # Prepare for the inner product
        a_li = [(s - z) % L for s in a_li]
        a_ri = [(s + d[i] * y_powers[full_length - i] + z) % L for i, s in enumerate(a_ri)]
        z_even_powers = 1
        for opening in witness.openings:
            z_even_powers = z_even_powers * z_square % L
            for k, r in enumerate(opening.r):
                alpha[k] = (alpha[k] + z_even_powers * r % L * y_powers[full_length + 1]) % L

        gi_base = list(gi_base)
        hi_base = list(hi_base)
        g_base = gens.g_bases()
        h_base = gens.h_base()

        li: List[hr.Point] = []
        ri: List[hr.Point] = []
        n = full_length
        round_idx = 0

        while n > 1:
            n //= 2
            a_lo, a_hi = a_li[:n], a_li[n:]
            b_lo, b_hi = a_ri[:n], a_ri[n:]
            gi_lo, gi_hi = gi_base[:n], gi_base[n:]
            hi_lo, hi_hi = hi_base[:n], hi_base[n:]

            y_n = y_powers[n]
            if y_n == 0:
                raise InvalidArgument("Cannot invert a zero valued Scalar")
            y_n_inverse = _inv(y_n)

            a_lo_offset = [s * y_n_inverse % L for s in a_lo]
            a_hi_offset = [s * y_n % L for s in a_hi]

            if seed_nonce is not None:
                d_l = [nonce(seed_nonce, "dL", round_idx, k) for k in range(extension_degree)]
                d_r = [nonce(seed_nonce, "dR", round_idx, k) for k in range(extension_degree)]
            else:
                d_l = [rpt.rng().random_not_zero()[0] for _ in range(extension_degree)]
                d_r = [rpt.rng().random_not_zero()[0] for _ in range(extension_degree)]
            round_idx += 1

            c_l = sum(a * y_powers[1 + i] % L * b for i, (a, b) in enumerate(zip(a_lo, b_hi))) % L
            c_r = sum(a * y_powers[n + 1 + i] % L * b for i, (a, b) in enumerate(zip(a_hi, b_lo))) % L

            li.append(
                msm([c_l] + d_l + a_lo_offset + b_hi, [h_base] + g_base + gi_hi + hi_lo, backend=msm_backend,
                    device=device)
            )
            ri.append(
                msm([c_r] + d_r + a_hi_offset + b_lo, [h_base] + g_base + gi_lo + hi_hi, backend=msm_backend,
                    device=device)
            )

            e = rpt.challenge_round_e(hr.compress(li[-1]), hr.compress(ri[-1]))[0]
            e_square = e * e % L
            e_inverse = _inv(e)
            e_inverse_square = e_inverse * e_inverse % L
            e_y_n_inverse = e * y_n_inverse % L

            gi_base = [
                hr.point_add(hr.point_mul(e_inverse, lo), hr.point_mul(e_y_n_inverse, hi))
                for lo, hi in zip(gi_lo, gi_hi)
            ]
            hi_base = [
                hr.point_add(hr.point_mul(e, lo), hr.point_mul(e_inverse, hi))
                for lo, hi in zip(hi_lo, hi_hi)
            ]
            a_li = [(lo * e + hi * e_inverse) % L for lo, hi in zip(a_lo, a_hi_offset)]
            a_ri = [(lo * e_inverse + hi * e) % L for lo, hi in zip(b_lo, b_hi)]
            alpha = [
                (al + dl * e_square + dr * e_inverse_square) % L
                for al, dl, dr in zip(alpha, d_l, d_r)
            ]

        # Final masks
        r = rpt.rng().random_not_zero()[0]
        s = rpt.rng().random_not_zero()[0]
        if seed_nonce is not None:
            d_mask = [nonce(seed_nonce, "d", None, k) for k in range(extension_degree)]
            eta = [nonce(seed_nonce, "eta", None, k) for k in range(extension_degree)]
        else:
            d_mask = [rpt.rng().random_not_zero()[0] for _ in range(extension_degree)]
            eta = [rpt.rng().random_not_zero()[0] for _ in range(extension_degree)]

        y1 = y_powers[1]
        a1 = msm(
            [r, s, (r * y1 % L * a_ri[0] + s * y1 % L * a_li[0]) % L] + d_mask,
            [gi_base[0], hi_base[0], h_base] + g_base,
            backend=msm_backend,
            device=device,
        )
        b_point = msm([r * y1 % L * s % L] + eta, [h_base] + g_base, backend=msm_backend, device=device)

        e = rpt.challenge_final_e(hr.compress(a1), hr.compress(b_point))[0]
        e_square = e * e % L

        r1 = (r + a_li[0] * e) % L
        s1 = (s + a_ri[0] * e) % L
        d1 = [(et + dm * e + al * e_square) % L for et, dm, al in zip(eta, d_mask, alpha)]

        return RangeProof(
            a=hr.compress(a),
            a1=hr.compress(a1),
            b=hr.compress(b_point),
            r1=r1,
            s1=s1,
            d1=d1,
            li=[hr.compress(p) for p in li],
            ri=[hr.compress(p) for p in ri],
            extension_degree=ExtensionDegree.from_int(extension_degree),
        )

    # ------------------------------------------------------------------
    # Verifier
    # ------------------------------------------------------------------

    @staticmethod
    def _verify_consistency(
        statements: Sequence[RangeStatement], proofs: Sequence["RangeProof"]
    ) -> Tuple[int, int]:
        """range_proof.rs:610-709 parity: batch-wide generator consistency;
        returns (max_mn, max_index)."""
        if not statements:
            raise InvalidArgument("Empty proof statements")
        if not proofs:
            raise InvalidArgument("Empty proofs")
        if len(statements) != len(proofs):
            raise InvalidArgument("Range statements and proofs length mismatch")

        first = statements[0]
        g_base_compressed = first.generators.g_bases_compressed()
        h_base_compressed = first.generators.h_base_compressed()
        bit_length = first.generators.bit_length()
        extension_degree = first.generators.extension_degree()
        max_mn = len(first.commitments) * bit_length
        max_index = 0

        if int(extension_degree) != len(proofs[0].d1):
            raise InvalidArgument("Inconsistent extension degree")
        for i, (statement, proof) in enumerate(zip(statements, proofs)):
            if i == 0:
                continue
            if statement.generators.g_bases_compressed() != g_base_compressed:
                raise InvalidArgument("Inconsistent G generator point in batch statement")
            if statement.generators.h_base_compressed() != h_base_compressed:
                raise InvalidArgument("Inconsistent H generator point in batch statement")
            if statement.generators.bit_length() != bit_length:
                raise InvalidArgument("Inconsistent bit length in batch statement")
            if int(statement.generators.extension_degree()) != int(extension_degree) or int(
                extension_degree
            ) != len(proof.d1):
                raise InvalidArgument("Inconsistent extension degree")
            full_length = len(statement.commitments) * bit_length
            if full_length > max_mn:
                max_mn = full_length
                max_index = i

        max_statement = statements[max_index]
        max_gi = max_statement.generators.gi_base()
        max_hi = max_statement.generators.hi_base()
        for i, statement in enumerate(statements):
            for value in statement.minimum_value_promises:
                if value is not None and bit_length < 64 and value >> bit_length > 0:
                    raise InvalidLength("Minimum value promise exceeds bit vector capacity")
            if i == max_index:
                continue
            # Same generator object (the common case: one RangeParameters
            # shared across the batch) is trivially prefix-consistent —
            # skips ~2 host field mults per generator per statement.
            if (
                statement.generators is max_statement.generators
                or statement.generators.bp_gens is max_statement.generators.bp_gens
            ):
                continue
            gi = statement.generators.gi_base()
            hi = statement.generators.hi_base()
            k = min(len(gi), len(max_gi))
            if any(not hr.point_equal(a, b) for a, b in zip(gi[:k], max_gi[:k])):
                raise InvalidArgument("Inconsistent Gi generator point vector in batch statement")
            k = min(len(hi), len(max_hi))
            if any(not hr.point_equal(a, b) for a, b in zip(hi[:k], max_hi[:k])):
                raise InvalidArgument("Inconsistent Hi generator point vector in batch statement")

        return max_mn, max_index

    @staticmethod
    def verify_batch(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        action: VerifyAction,
        msm_backend: Optional[str] = None,
        engine: str = "device",
        device="cuda",
        mesh=None,
    ) -> List[Optional[ExtendedMask]]:
        """Verify a batch of proofs with one folded MSM.

        engine="device" (the port's default): the JAX package's device
        engine on `device`.  A single-shape, well-formed batch replays
        Fiat-Shamir on the device (models/replay_device.py, the CUDA kernel
        R1 on a CUDA device), draws the batch weights on the host and runs
        `verify_group_bytes`; any other batch replays on the host and runs
        one `group_contrib` a shape group and one `combine_groups_msm`
        (models/verifier_kernels.py), whose pow chain and MSM are CUDA
        kernels on a CUDA device.  engine="host" (the JAX package's
        default): the exact-integer oracle, whose one final MSM goes through
        `ops.msm.msm` with `msm_backend` ("device": on `device`).  Pass
        device="cpu" to run the kernels' plain torch versions instead.  The
        two engines word a non-canonical L or R point differently, as the
        JAX package's do.

        A 1-D `torch.distributed` DeviceMesh (parallel/) with
        engine="device" runs the batch on every rank of the mesh, each on
        its own device: the replay stays on the host, and a single-shape
        batch whose size divides by the mesh's is sharded over the ranks
        (parallel/verify.py); any other runs whole on every rank.  Every
        rank returns the same result or raises the same error.
        engine="host" ignores the mesh, as the JAX package's does.

        Parity quirk (range_proof.rs:740-749): only the FIRST chunk of
        MAX_RANGE_PROOF_BATCH_SIZE=256 proofs is processed; any proofs beyond
        256 are silently ignored and contribute no masks.
        """
        _check_batch_lengths(transcripts, statements, proofs)
        batch = (
            transcripts[:MAX_RANGE_PROOF_BATCH_SIZE],
            statements[:MAX_RANGE_PROOF_BATCH_SIZE],
            proofs[:MAX_RANGE_PROOF_BATCH_SIZE],
            action,
        )
        if engine == "device":
            return RangeProof._verify_device(*batch, _rank_device(mesh, device), mesh)
        if engine == "host":
            return RangeProof._verify(*batch, msm_backend, device)
        raise ValueError(f"unknown engine {engine!r}: expected 'host' or 'device'")

    @staticmethod
    def verify_batches_pipelined(
        batches: Sequence[Tuple[List[Transcript], Sequence["RangeStatement"], Sequence["RangeProof"]]],
        action: VerifyAction,
        device="cuda",
        mesh=None,
    ) -> List[List[Optional[ExtendedMask]]]:
        """Verify a stream of proof batches on the device engine, with host
        and device work overlapped: while the card runs batch k's kernels
        (launches are asynchronous; only fetches wait), the host replays or
        packs batch k+1.

        Each batch follows `verify_batch(engine="device")` semantics,
        including the 256-proof cap.  A batch is a chain of stages, each
        blocked on one device->host fetch (seeds and flags after the replay,
        then the verdict); the driver serves the oldest `lookahead` pending
        fetches of each kind together, in batch order.  `lookahead` is
        BPPT_PIPELINE_LOOKAHEAD, 2 by default and wherever the value does not
        parse as an integer of at least 1 (the JAX package's bare `int()`
        raises there instead).

        Failure ordering: the LOWEST-indexed failing batch raises, even when a
        later batch's failure surfaces first, and nothing new is dispatched
        once any failure is known; batches already in flight are abandoned.
        An extension of the reference, whose API is synchronous per batch.

        With a `mesh`, each batch routes as in `verify_batch`.  Its
        collectives run inside its dispatch, and every rank dispatches the
        same batches and reaches the same verdicts, so every rank stops at
        the same batch.
        """
        from ..errors import ProofError

        device = _rank_device(mesh, device)
        lookahead = _pipeline_lookahead()
        trace.new_call()
        b_q: List = []  # (idx, _FetchStage) pending seed fetch
        c_q: List = []  # (idx, _FetchStage) pending verdict fetch
        done: dict = {}
        errors: dict = {}
        n = 0

        def doomed(idx: int) -> bool:
            return bool(errors) and min(errors) < idx

        def pump():
            """Serve the oldest `lookahead` verdict fetches and seed fetches,
            then run their continuations in batch order."""
            serve = [c_q.pop(0) for _ in range(min(lookahead, len(c_q)))]
            serve += [b_q.pop(0) for _ in range(min(lookahead, len(b_q)))]
            serve = [(idx, st) for idx, st in serve if not doomed(idx)]
            values = []
            for idx, st in serve:
                with trace.span("verify.wait", idx):
                    values.append(st.fetch())
            for (idx, st), vals in sorted(zip(serve, values), key=lambda p: p[0][0]):
                if doomed(idx):  # a lower-indexed continuation in this pump failed
                    continue
                try:
                    with trace.span("verify.continue", idx):
                        step = st.cont(vals)
                except ProofError as exc:
                    errors[idx] = exc
                    continue
                if isinstance(step, _FetchStage):
                    c_q.append((idx, step))
                else:
                    done[idx] = step

        for transcripts, statements, proofs in batches:
            if errors:
                break  # abandon the rest of the stream
            try:
                _check_batch_lengths(transcripts, statements, proofs)
                with trace.span("verify.dispatch", n):
                    stage = RangeProof._verify_device_dispatch(
                        transcripts[:MAX_RANGE_PROOF_BATCH_SIZE],
                        statements[:MAX_RANGE_PROOF_BATCH_SIZE],
                        proofs[:MAX_RANGE_PROOF_BATCH_SIZE],
                        action,
                        device,
                        mesh,
                    )
            except ProofError as exc:
                errors[n] = exc
                n += 1
                break
            if isinstance(stage, _FetchStage):
                b_q.append((n, stage))
            else:
                done[n] = stage  # e.g. RECOVER_ONLY after a host replay: masks are host-complete
            n += 1
            if len(b_q) >= lookahead:
                pump()
        while b_q or c_q:
            pump()
        if errors:
            raise errors[min(errors)]
        return [done[i] for i in range(n)]

    @staticmethod
    def _verify_device(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        action: VerifyAction,
        device="cuda",
        mesh=None,
    ) -> List[Optional[ExtendedMask]]:
        """The device engine: dispatch, then run its stages until done."""
        trace.new_call()
        with trace.span("verify.dispatch", 0):
            step = RangeProof._verify_device_dispatch(transcripts, statements, proofs, action, device, mesh)
        while isinstance(step, _FetchStage):
            step = step.run()
        return step

    @staticmethod
    def _verify_device_dispatch(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        action: VerifyAction,
        device="cuda",
        mesh=None,
    ):
        """Run the host half (replay, weights, packing) and launch the device
        work without waiting for it; returns the masks where nothing is left
        for the device, else a `_FetchStage` -- the seam that
        `verify_batches_pipelined` interleaves.  `device` is this rank's
        device of `mesh` where there is one.  Every rank replays, weighs and
        checks the whole batch on the host, so an error found there is found
        by every rank before the first collective."""
        from .verifier_kernels import DeviceVerifier, combine_groups_msm, group_contrib, verify_group_full

        max_mn, max_index = RangeProof._verify_consistency(statements, proofs)
        max_statement = statements[max_index]
        gens = statements[0].generators
        bit_length = gens.bit_length()
        extension_degree = int(gens.extension_degree())

        groups: dict = {}
        for idx, (statement, proof) in enumerate(zip(statements, proofs)):
            groups.setdefault((len(statement.commitments), len(proof.li)), []).append(idx)

        # Fastest path, under the JAX package's condition: one shape group,
        # well-formed round counts and no mesh -- the replay runs on the
        # device and only the weight draws stay on the host.  Malformed round
        # counts take the host replay, which keeps the reference's error
        # precedence.
        well_formed = all(
            len(p.li) == len(p.ri) and len(p.li) < 64 and (1 << len(p.li)) == len(s.commitments) * bit_length
            for s, p in zip(statements, proofs)
        )
        if len(groups) == 1 and mesh is None and well_formed:
            try:
                stacked = Transcript.stack(transcripts)
            except ValueError:
                stacked = None
            if stacked is not None:
                return RangeProof._dispatch_device_replay(stacked, statements, proofs, action, groups,
                                                          max_statement, device)

        with trace.span("verify.host_replay"):
            batch_challenges, seeds = RangeProof._replay_challenges(transcripts, statements, proofs)
        weights = RangeProof._draw_weights(seeds, len(proofs))

        # Pass-2 prologue in reference order (range_proof.rs:856-888): per
        # proof, decompression of a/a1/b/li/ri precedes the length and round
        # checks, and ALL of it precedes mask recovery.
        RangeProof._device_structural_checks(statements, proofs, bit_length, action, device)

        if action == VerifyAction.VERIFY_ONLY:
            masks: List[Optional[ExtendedMask]] = [None] * len(proofs)
        else:
            masks = [
                RangeProof._recover_mask(statement, proof, challenge, extension_degree)
                for statement, proof, challenge in zip(statements, proofs, batch_challenges)
            ]
            if action == VerifyAction.RECOVER_ONLY:
                return masks

        static_points = _static_points(max_statement, max_mn, device)
        g_base_pts, h_base_pt = gens.pc_gens.device_bases(device)

        if len(groups) == 1:
            ((m, rounds),) = groups.keys()
            if mesh is not None and len(proofs) % mesh.size() == 0:
                # each rank packs only its shard (a non-empty batch that
                # divides by the mesh's size has at least one proof a rank)
                from ..parallel.verify import shard_packed, sharded_verifier

                packed = DeviceVerifier.pack(
                    *shard_packed((statements, proofs, batch_challenges, weights), mesh), device
                )
                ok, valid = sharded_verifier(
                    mesh, m=m, bit_length=bit_length, extension_degree=extension_degree, max_mn=max_mn
                )(
                    *packed, static_points, g_base_pts, h_base_pt
                )
            else:
                packed = DeviceVerifier.pack(statements, proofs, batch_challenges, weights, device)
                ok, valid = verify_group_full(
                    *packed, static_points, g_base_pts, h_base_pt,
                    m=m, bit_length=bit_length, extension_degree=extension_degree, max_mn=max_mn,
                )

            def finish_group(vals, m=m, rounds=rounds, masks=masks):
                ok_np, valid_np = vals
                DeviceVerifier.raise_canonicality(valid_np, m, rounds)
                if not bool(ok_np):
                    raise VerificationFailed("Range proof batch not valid")
                return masks

            return _FetchStage((ok, valid), finish_group)

        # Mixed shapes: one `group_contrib` a shape group, every group's scalar
        # pass at the batch's max_mn so the static accumulators line up, then
        # one `combine_groups_msm`; every validity flag and the verdict come
        # back in one fetch.
        parts = []
        group_meta = []  # (indices, m, rounds)
        for (m, rounds), indices in groups.items():
            packed = DeviceVerifier.pack(
                [statements[i] for i in indices],
                [proofs[i] for i in indices],
                [batch_challenges[i] for i in indices],
                [weights[i] for i in indices],
                device,
            )
            parts.append(group_contrib(
                *packed, m=m, bit_length=bit_length, extension_degree=extension_degree, max_mn=max_mn
            ))
            group_meta.append((indices, m, rounds))
        gis, his, gbs, hbs, dyn_scalars, dyn_points, valids = zip(*parts)
        ok = combine_groups_msm(gis, his, gbs, hbs, dyn_scalars, dyn_points, static_points, g_base_pts, h_base_pt)

        def finish_mixed(vals, masks=masks, group_meta=group_meta):
            ok_np, valids_np = vals
            # Canonicality errors in the reference's PROOF order
            # (range_proof.rs:856-866 iterates the batch in order)
            by_index = {}
            for (indices, m, rounds), valid_np in zip(group_meta, valids_np):
                rows = valid_np.reshape(len(indices), -1)
                for pos, idx in enumerate(indices):
                    by_index[idx] = (rows[pos], m, rounds)
            for idx in sorted(by_index):
                DeviceVerifier.raise_canonicality_row(*by_index[idx])
            if not bool(ok_np):
                raise VerificationFailed("Range proof batch not valid")
            return masks

        return _FetchStage((ok, list(valids)), finish_mixed)

    @staticmethod
    def _dispatch_device_replay(
        stacked: Transcript,
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        action: VerifyAction,
        groups: dict,
        max_statement: RangeStatement,
        device="cuda",
    ):
        """Single-group path with the Fiat-Shamir replay on the device:
        replay (R1 on a CUDA device) -> one fetch of seeds and flags (and the
        challenges when masks are wanted) -> host weight draws, structural
        checks, mask recovery -> `verify_group_bytes` -> one fetch of the
        verdict.  Host work: one byte-level pack and one native STROBE weight
        sequence."""
        import torch

        from ..ops.limbs import pack_ints, unpack_ints
        from .replay_device import pack_replay_inputs, replay_fn
        from .verifier_kernels import DeviceVerifier, verify_group_bytes

        ((m, rounds),) = groups.keys()
        gens = statements[0].generators
        bit_length = gens.bit_length()
        extension_degree = int(gens.extension_degree())
        max_mn = m * bit_length
        B = len(proofs)

        rep = replay_fn(
            gens.h_base_compressed(),
            tuple(gens.g_bases_compressed()),
            bit_length,
            extension_degree,
            m,
            rounds,
            stacked.strobe.pos,
            stacked.strobe.pos_begin,
            stacked.strobe.cur_flags,
        )
        buf = torch.as_tensor(pack_replay_inputs(statements, proofs).copy(), device=device)
        state = torch.as_tensor(stacked.strobe.state, device=device).clone()
        y, z, es, e, seeds, bad_id, bad_zero = rep(state, buf)
        # everything the replay made for the host travels in one fetch; mask
        # recovery takes the challenges along
        fetch1 = (seeds, bad_id, bad_zero)
        if action != VerifyAction.VERIFY_ONLY:
            fetch1 = fetch1 + (y, z, es, e)

        def stage_b(vals):
            seeds_np, bad_id_np, bad_zero_np = vals[:3]
            if bad_id_np.any():
                raise VerificationFailed("Identity element cannot be added to the transcript")
            if bad_zero_np.any():
                raise VerificationFailed("Transcript challenge cannot be zero")
            weights = RangeProof._draw_weights([row.tobytes() for row in seeds_np], B)

            masks: List[Optional[ExtendedMask]] = [None] * B
            if action != VerifyAction.VERIFY_ONLY:
                y_np, z_np, es_np, e_np = vals[3:]
                y_i, z_i, e_i = unpack_ints(y_np), unpack_ints(z_np), unpack_ints(e_np)
                es_i = unpack_ints(es_np.reshape(B * rounds, es_np.shape[-1]))  # no rows at rounds = 0
                RangeProof._device_structural_checks(statements, proofs, bit_length, action, device)
                masks = [
                    RangeProof._recover_mask(
                        st, pr, (y_i[k], z_i[k], es_i[k * rounds : (k + 1) * rounds], e_i[k]), extension_degree,
                    )
                    for k, (st, pr) in enumerate(zip(statements, proofs))
                ]
                if action == VerifyAction.RECOVER_ONLY:
                    return masks

            g_base_pts, h_base_pt = gens.pc_gens.device_bases(device)
            w = torch.as_tensor(pack_ints(weights).astype(np.int64), device=device)
            ok, valid = verify_group_bytes(
                y, z, es, e, w, buf, _static_points(max_statement, max_mn, device), g_base_pts, h_base_pt,
                m=m, bit_length=bit_length, extension_degree=extension_degree, max_mn=max_mn,
            )

            def stage_c(vals2, masks=masks):
                ok_np, valid_np = vals2
                DeviceVerifier.raise_canonicality(valid_np, m, rounds)
                if not bool(ok_np):
                    raise VerificationFailed("Range proof batch not valid")
                return masks

            return _FetchStage((ok, valid), stage_c)

        return _FetchStage(fetch1, stage_b)

    @staticmethod
    def _verify(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        action: VerifyAction,
        msm_backend: Optional[str] = None,
        device="cuda",
    ) -> List[Optional[ExtendedMask]]:
        """The host engine: the JAX package's exact-integer oracle
        (range_proof.rs:610-1065), its one final MSM through `ops.msm.msm`."""
        max_mn, max_index = RangeProof._verify_consistency(statements, proofs)
        first = statements[0]
        max_statement = statements[max_index]

        gens = first.generators
        g_base_vec = gens.g_bases()
        h_base = gens.h_base()
        bit_length = gens.bit_length()
        extension_degree = int(gens.extension_degree())

        two_n_minus_one = (pow(2, bit_length, L) - 1) % L

        g_base_scalars = [0] * extension_degree
        h_base_scalar = 0
        gi_base_scalars = [0] * max_mn
        hi_base_scalars = [0] * max_mn
        dynamic_scalars: List[int] = []
        dynamic_points: List[hr.Point] = []
        masks: List[Optional[ExtendedMask]] = []

        # Pass 1: challenge replay + weight transcript (range_proof.rs:810-853)
        batch_challenges, seeds = RangeProof._replay_challenges(transcripts, statements, proofs)
        weights = RangeProof._draw_weights(seeds, len(proofs))

        # Pass 2: per-proof scalar accumulation (range_proof.rs:856-1033)
        for proof, statement, challenge, weight in zip(proofs, statements, batch_challenges, weights):
            commitments = statement.commitments
            minimum_value_promises = statement.minimum_value_promises
            a = _decompress_or("a", proof.a)
            a1 = _decompress_or("a1", proof.a1)
            b = _decompress_or("b", proof.b)
            r1, s1, d1 = proof.r1, proof.s1, proof.d1
            # an R point is named 'L' too, as in the JAX package's host engine
            li = [_decompress_or("L", p) for p in proof.li]
            ri = [_decompress_or("L", p) for p in proof.ri]

            aggregation_factor = len(commitments)
            full_length = aggregation_factor * bit_length
            rounds = len(li)
            if len(li) != len(ri):
                raise InvalidLength("Vector L length not equal to vector R length")
            if rounds >= 64:
                raise SizeOverflow("Vector L/R length not adequate")
            if (1 << rounds) != full_length:
                raise InvalidLength("Vector L/R length not adequate")

            y, z, challenges_list, e = challenge

            y_inverse = _inv(y)
            y_1_inverse = _inv((y - 1) % L)
            challenges_inv = [_inv(c) for c in challenges_list]
            challenges_inv_prod = 1
            for c in challenges_inv:
                challenges_inv_prod = challenges_inv_prod * c % L

            z_square = z * z % L
            e_square = e * e % L
            challenges_sq = [c * c % L for c in challenges_list]
            challenges_sq_inv = [c * c % L for c in challenges_inv]
            y_nm = pow(y, full_length, L)
            y_nm_1 = y_nm * y % L
            y_sum = y * (y_nm - 1) % L * y_1_inverse % L

            # d vector
            d = [z_square]
            for _ in range(1, bit_length):
                d.append(d[-1] * 2 % L)
            for j in range(1, aggregation_factor):
                for i in range(bit_length):
                    d.append(d[(j - 1) * bit_length + i] * z_square % L)

            # d_sum
            d_sum = z_square
            d_sum_temp_z = z_square
            for _ in range(aggregation_factor.bit_length() - 1):
                d_sum = (d_sum + d_sum * d_sum_temp_z) % L
                d_sum_temp_z = d_sum_temp_z * d_sum_temp_z % L
            d_sum = d_sum * two_n_minus_one % L

            # Mask recovery (range_proof.rs:941-969)
            if action == VerifyAction.VERIFY_ONLY:
                masks.append(None)
            else:
                masks.append(RangeProof._recover_mask(statement, proof, challenge, extension_degree))
                if action == VerifyAction.RECOVER_ONLY:
                    continue

            # s vector via prefix products (range_proof.rs:975-986)
            s_vec = [challenges_inv_prod]
            for i in range(1, full_length):
                log_i = i.bit_length() - 1
                j = 1 << log_i
                s_vec.append(s_vec[i - j] * challenges_sq[rounds - log_i - 1] % L)

            r1_e = r1 * e % L
            s1_e = s1 * e % L
            e_square_z = e_square * z % L
            y_inv_i = 1
            y_nm_i = y_nm
            for i in range(full_length):
                g = r1_e * y_inv_i % L * s_vec[i] % L
                h = s1_e * s_vec[full_length - 1 - i] % L
                gi_base_scalars[i] = (gi_base_scalars[i] + weight * ((g + e_square_z) % L)) % L
                hi_base_scalars[i] = (
                    hi_base_scalars[i] + weight * ((h - e_square * ((d[i] * y_nm_i + z) % L)) % L)
                ) % L
                y_inv_i = y_inv_i * y_inverse % L
                y_nm_i = y_nm_i * y_inverse % L

            # Remaining dynamic terms
            z_even_powers = 1
            for minimum_value_promise in minimum_value_promises:
                z_even_powers = z_even_powers * z_square % L
                weighted = weight * (-(e_square * z_even_powers % L * y_nm_1 % L)) % L
                dynamic_scalars.append(weighted)
                if minimum_value_promise is not None:
                    h_base_scalar = (h_base_scalar - weighted * minimum_value_promise) % L
            dynamic_points.extend(commitments)

            h_base_scalar = (
                h_base_scalar
                + weight
                * ((r1 * y % L * s1 + e_square * ((y_nm_1 * z % L * d_sum + (z_square - z) % L * y_sum) % L)) % L)
            ) % L
            for k in range(extension_degree):
                g_base_scalars[k] = (g_base_scalars[k] + weight * d1[k]) % L

            dynamic_scalars.append(weight * (-e) % L)
            dynamic_points.append(a1)
            dynamic_scalars.append(-weight % L)
            dynamic_points.append(b)
            dynamic_scalars.append(weight * (-e_square) % L)
            dynamic_points.append(a)

            dynamic_scalars.extend(weight * (-(e_square * c % L)) % L for c in challenges_sq)
            dynamic_points.extend(li)
            dynamic_scalars.extend(weight * (-(e_square * c % L)) % L for c in challenges_sq_inv)
            dynamic_points.extend(ri)

        if action == VerifyAction.RECOVER_ONLY:
            return masks

        # Pedersen generators
        dynamic_scalars.extend(g_base_scalars)
        dynamic_points.extend(g_base_vec)
        dynamic_scalars.append(h_base_scalar)
        dynamic_points.append(h_base)

        # Final check: one giant MSM against the identity (range_proof.rs:1044-1062)
        static_scalars: List[int] = []
        static_points: List[hr.Point] = []
        max_gi = max_statement.generators.gi_base()
        max_hi = max_statement.generators.hi_base()
        for i in range(max_mn):
            static_scalars += [gi_base_scalars[i], hi_base_scalars[i]]
            static_points += [max_gi[i], max_hi[i]]

        result = msm(
            static_scalars + dynamic_scalars, static_points + dynamic_points, backend=msm_backend, device=device
        )
        if not hr.is_identity(result):
            raise VerificationFailed("Range proof batch not valid")

        return masks

    @staticmethod
    def _draw_weights(seeds: Sequence[bytes], n: int) -> List[int]:
        """Deterministic per-proof batch weights (range_proof.rs:845-894):
        a weight transcript absorbs each proof's 32-byte RNG seed, then every
        proof draws one nonzero wide-reduced scalar.  Sequential sponge work —
        runs as two native STROBE calls (utils/merlin.py fast paths)."""
        weight_transcript = Transcript(b"Bulletproofs+ verifier weights")
        weight_transcript.append_messages_seq(
            b"proof", np.frombuffer(b"".join(seeds), dtype=np.uint8).reshape(len(seeds), 32)
        )
        weight_rng = weight_transcript.build_rng().finalize(NullRng())
        st = weight_rng.strobe
        backup = (st.state.copy(), st.pos, st.pos_begin, st.cur_flags)
        data = weight_rng.fill_bytes_seq(n, 64).tobytes()
        weights = [int.from_bytes(data[i * 64 : (i + 1) * 64], "little") % L for i in range(n)]
        if 0 not in weights:
            return weights
        # ~2^-252: restore the sponge and replay with per-draw rejection,
        # matching the reference's draw-until-nonzero stream exactly.
        st.state[:], st.pos, st.pos_begin, st.cur_flags = backup  # pragma: no cover
        weights = []  # pragma: no cover
        while len(weights) < n:  # pragma: no cover
            v = int.from_bytes(weight_rng.fill_bytes(64)[0].tobytes(), "little") % L
            if v != 0:
                weights.append(v)
        return weights  # pragma: no cover

    @staticmethod
    def _device_structural_checks(
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        bit_length: int,
        action: VerifyAction,
        device="cuda",
    ) -> None:
        """Reference-ordered pass-2 validation (range_proof.rs:856-888).

        Per proof, in batch order: decompress a, a1, b, li, ri (rejecting
        non-canonical encodings), then li/ri length equality, then the
        SizeOverflow round check, then 2^rounds == m*n.  On the hot
        VERIFY_ONLY path with no length errors this is free — the fused
        kernel performs decompression and `raise_canonicality` reports any
        failure with the same per-proof member ordering.
        """

        def _length_error(statement, proof):
            full_length = len(statement.commitments) * bit_length
            rounds = len(proof.li)
            if len(proof.li) != len(proof.ri):
                return InvalidLength("Vector L length not equal to vector R length")
            if rounds >= 64:
                return SizeOverflow("Vector L/R length not adequate")
            if (1 << rounds) != full_length:
                return InvalidLength("Vector L/R length not adequate")
            return None

        first_error: Optional[Tuple[int, Exception]] = None
        for idx, (statement, proof) in enumerate(zip(statements, proofs)):
            exc = _length_error(statement, proof)
            if exc is not None:
                first_error = (idx, exc)
                break

        if action == VerifyAction.VERIFY_ONLY and first_error is None:
            return

        # Decompress proofs 0..=first_error_idx (all of them when recovering
        # masks) in one batched device call; decompression failures in earlier
        # proofs — or in the failing proof itself — take precedence, exactly
        # like the sequential reference loop.
        from .verifier_kernels import _on, _points_bytes_to_limbs, decompress_batch

        upto = len(proofs) if first_error is None else first_error[0] + 1
        blobs: List[bytes] = []
        spans: List[int] = []
        for proof in proofs[:upto]:
            spans.append(len(blobs))
            blobs.append(proof.a)
            blobs.append(proof.a1)
            blobs.append(proof.b)
            blobs.extend(proof.li)
            blobs.extend(proof.ri)
        spans.append(len(blobs))
        valid = decompress_batch(_on(_points_bytes_to_limbs(blobs), device))[1].cpu().numpy()
        for idx in range(upto):
            lane = valid[spans[idx] : spans[idx + 1]]
            if not lane.all():
                j = int(np.argmin(lane))
                if j < 3:
                    name = ("a", "a1", "b")[j]
                    raise InvalidArgument(
                        f"Member '{name}' was not the canonical encoding of a point"
                    )
                raise InvalidArgument(
                    "An item in member 'L' was not the canonical encoding of a point"
                )
        if first_error is not None:
            raise first_error[1]

    @staticmethod
    def _replay_challenges(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
    ) -> Tuple[List[Tuple[int, int, List[int], int]], List[bytes]]:
        """Pass 1: replay Fiat-Shamir for every proof; returns per-proof
        (y, z, round_es, e) and the 32-byte weight-transcript seed.

        Proofs sharing a transcript shape are replayed in lockstep through one
        batched STROBE sponge; mixed shapes fall back per group.  A proof
        with len(li) != len(ri) replays min(len(li), len(ri)) rounds, like
        the reference's zip (range_proof.rs:832-838); the length error
        surfaces in pass 2.
        """
        groups: dict = {}
        for idx, (statement, proof) in enumerate(zip(statements, proofs)):
            key = (len(statement.commitments), min(len(proof.li), len(proof.ri)))
            groups.setdefault(key, []).append(idx)

        challenges: List[Optional[Tuple[int, int, List[int], int]]] = [None] * len(proofs)
        seeds: List[Optional[bytes]] = [None] * len(proofs)

        for (m, rounds), indices in groups.items():
            try:
                stacked = Transcript.stack([transcripts[i] for i in indices])
            except ValueError:
                stacked = None

            lanes = (
                [(stacked, indices)]
                if stacked is not None
                else [(Transcript.stack([transcripts[i]]), [i]) for i in indices]
            )
            for transcript, idxs in lanes:
                sts = [statements[i] for i in idxs]
                prs = [proofs[i] for i in idxs]
                first = sts[0]
                gens = first.generators
                rpt = RangeProofTranscript(
                    transcript,
                    gens.h_base_compressed(),
                    gens.g_bases_compressed(),
                    gens.bit_length(),
                    int(gens.extension_degree()),
                    m,
                    [
                        np.stack(
                            [
                                np.frombuffer(s.commitments_compressed[j], dtype=np.uint8)
                                for s in sts
                            ]
                        )
                        for j in range(m)
                    ],
                    [[s.minimum_value_promises[j] for s in sts] for j in range(m)],
                    None,
                    NullRng(),
                    lazy_rng=True,
                )
                y_l, z_l = rpt.challenges_y_z(np.stack([np.frombuffer(p.a, dtype=np.uint8) for p in prs]))
                round_es: List[List[int]] = []
                for j in range(rounds):
                    round_es.append(
                        rpt.challenge_round_e(
                            np.stack([np.frombuffer(p.li[j], dtype=np.uint8) for p in prs]),
                            np.stack([np.frombuffer(p.ri[j], dtype=np.uint8) for p in prs]),
                        )
                    )
                e_l = rpt.challenge_final_e(
                    np.stack([np.frombuffer(p.a1, dtype=np.uint8) for p in prs]),
                    np.stack([np.frombuffer(p.b, dtype=np.uint8) for p in prs]),
                )
                rng = rpt.to_verifier_rng(
                    [p.r1 for p in prs],
                    [p.s1 for p in prs],
                    [[p.d1[k] for p in prs] for k in range(len(prs[0].d1))],
                )
                seed_bytes = rng.fill_bytes(32)
                for lane, i in enumerate(idxs):
                    challenges[i] = (y_l[lane], z_l[lane], [es[lane] for es in round_es], e_l[lane])
                    seeds[i] = seed_bytes[lane].tobytes()

        return challenges, seeds  # type: ignore[return-value]

    @staticmethod
    def _recover_mask(
        statement: RangeStatement,
        proof: "RangeProof",
        challenge: Tuple[int, int, List[int], int],
        extension_degree: int,
    ) -> Optional[ExtendedMask]:
        """Mask recovery from d1 and deterministic nonces
        (range_proof.rs:941-969)."""
        if statement.seed_nonce is None:
            return None
        seed_nonce = statement.seed_nonce
        y, z, challenges_list, e = challenge
        full_length = len(statement.commitments) * statement.generators.bit_length()
        z_square = z * z % L
        e_square = e * e % L
        y_nm_1 = pow(y, full_length + 1, L)
        challenges_sq = [c * c % L for c in challenges_list]
        challenges_sq_inv = [_inv(c) for c in challenges_sq]
        temp_masks = []
        for k in range(extension_degree):
            this_mask = (
                (proof.d1[k] - nonce(seed_nonce, "eta", None, k) - e * nonce(seed_nonce, "d", None, k))
                % L
                * _inv(e_square)
                % L
            )
            this_mask = (this_mask - nonce(seed_nonce, "alpha", None, k)) % L
            for j, (c_sq, c_sq_inv) in enumerate(zip(challenges_sq, challenges_sq_inv)):
                this_mask = (this_mask - c_sq * nonce(seed_nonce, "dL", j, k)) % L
                this_mask = (this_mask - c_sq_inv * nonce(seed_nonce, "dR", j, k)) % L
            this_mask = this_mask * _inv(z_square * y_nm_1 % L) % L
            temp_masks.append(this_mask)
        return ExtendedMask.assign(ExtensionDegree.from_int(extension_degree), temp_masks)

    # ------------------------------------------------------------------
    # Serialization (range_proof.rs:1112-1309)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Canonical encoding:
        [ext_degree u8 | d1[deg] | a | a1 | b | r1 | s1 | (L_i, R_i)*]."""
        buf = bytearray()
        buf.append(int(self.extension_degree))
        for d1 in self.d1:
            buf += hr.scalar_to_bytes(d1)
        buf += self.a
        buf += self.a1
        buf += self.b
        buf += hr.scalar_to_bytes(self.r1)
        buf += hr.scalar_to_bytes(self.s1)
        for l, r in zip(self.li, self.ri):
            buf += l
            buf += r
        return bytes(buf)

    @staticmethod
    def from_bytes(data: bytes) -> "RangeProof":
        """Strict canonical parse; rejects non-canonical scalars, empty L/R,
        and any unused trailing data."""
        if len(data) < 1:
            raise InvalidLength("Serialized proof is too short")
        try:
            extension_degree = ExtensionDegree.from_int(data[0])
        except InvalidArgument:
            raise InvalidArgument("Extension degree not valid")

        body = data[ENCODED_EXTENSION_SIZE:]
        n_chunks = len(body) // SERIALIZED_ELEMENT_SIZE
        remainder = len(body) % SERIALIZED_ELEMENT_SIZE
        chunks = [
            body[i * SERIALIZED_ELEMENT_SIZE : (i + 1) * SERIALIZED_ELEMENT_SIZE] for i in range(n_chunks)
        ]
        pos = 0

        def parse_scalar() -> int:
            nonlocal pos
            if pos >= len(chunks):
                raise InvalidLength("Serialized proof is too short")
            value = hr.scalar_from_canonical_bytes(chunks[pos])
            if value is None:
                raise InvalidArgument("Invalid parsing")
            pos += 1
            return value

        def parse_point() -> bytes:
            nonlocal pos
            if pos >= len(chunks):
                raise InvalidLength("Serialized proof is too short")
            out = chunks[pos]
            pos += 1
            return out

        d1 = [parse_scalar() for _ in range(int(extension_degree))]
        a = parse_point()
        a1 = parse_point()
        b = parse_point()
        r1 = parse_scalar()
        s1 = parse_scalar()

        li: List[bytes] = []
        ri: List[bytes] = []
        while pos + 1 < len(chunks):
            li.append(parse_point())
            ri.append(parse_point())

        if not li or not ri:
            raise InvalidLength("Serialized proof is too short")
        # Canonicality: no leftover chunk (odd element) and no partial chunk
        if pos != len(chunks) or remainder != 0:
            raise InvalidLength("Unused data after deserialization")

        return RangeProof(
            a=a, a1=a1, b=b, r1=r1, s1=s1, d1=d1, li=li, ri=ri, extension_degree=extension_degree
        )

    @staticmethod
    def extension_degree_from_proof_bytes(data: bytes) -> ExtensionDegree:
        if len(data) < 1:
            raise InvalidLength("Serialized proof is too short")
        return ExtensionDegree.from_int(data[0])
