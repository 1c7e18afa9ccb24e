"""Bulletproofs+ range proof: batch verification and canonical serialization.

Counterpart of bulletproofs_plus_tpu/models/range_proof.py, in part: the
device engine's batch verifier for one shape group, with the JAX package's
host Fiat-Shamir replay (reference src/range_proof.rs:610-1065), and the
proof codec (range_proof.rs:1112-1309).  The prover, the host oracle engine,
mesh sharding, the device transcript replay and the pipelined stream are
later slices of the port.

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
from ..utils.hashing import nonce
from ..utils.merlin import NullRng, Transcript
from .statement import ExtendedMask, RangeStatement
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


def _inv(x: int) -> int:
    return pow(x, -1, L)


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
        engine: str = "device",
        device="cuda",
    ) -> List[Optional[ExtendedMask]]:
        """Verify a batch of proofs with one folded MSM on `device`.

        Only engine="device" is ported: host Fiat-Shamir replay and weight
        draws, then the scalar pass, batched decompression and the MSM as
        torch tensors on `device` (models/verifier_kernels.py), whose pow
        chain and MSM are CUDA kernels on a CUDA device.  Pass device="cpu"
        to run the kernels' plain torch versions instead.

        Parity quirk (range_proof.rs:740-749): only the FIRST chunk of
        MAX_RANGE_PROOF_BATCH_SIZE=256 proofs is processed; any proofs beyond
        256 are silently ignored and contribute no masks.
        """
        if not statements or not proofs or not transcripts:
            raise InvalidArgument("Range statements or proofs length empty")
        if len(statements) != len(proofs):
            raise InvalidArgument("Range statements and proofs length mismatch")
        if len(transcripts) != len(statements):
            raise InvalidArgument("Range statements and transcripts length mismatch")
        if engine != "device":
            raise NotImplementedError(f"engine={engine!r} is not ported; only engine='device'")
        return RangeProof._verify_device(
            transcripts[:MAX_RANGE_PROOF_BATCH_SIZE],
            statements[:MAX_RANGE_PROOF_BATCH_SIZE],
            proofs[:MAX_RANGE_PROOF_BATCH_SIZE],
            action,
            device,
        )

    @staticmethod
    def _verify_device(
        transcripts: List[Transcript],
        statements: Sequence[RangeStatement],
        proofs: Sequence["RangeProof"],
        action: VerifyAction,
        device="cuda",
    ) -> List[Optional[ExtendedMask]]:
        """Host Fiat-Shamir replay and weights, reference-ordered structural
        checks and mask recovery, then one device verification of the
        single shape group."""
        from .verifier_kernels import DeviceVerifier, verify_group_full

        max_mn, max_index = RangeProof._verify_consistency(statements, proofs)
        gens = statements[0].generators
        bit_length = gens.bit_length()
        extension_degree = int(gens.extension_degree())

        groups: dict = {}
        for idx, (statement, proof) in enumerate(zip(statements, proofs)):
            groups.setdefault((len(statement.commitments), len(proof.li)), []).append(idx)

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

        if len(groups) != 1:
            raise NotImplementedError(
                "batches mixing (aggregation, rounds) shapes need the mixed-shape "
                "verifier (group_contrib / combine_groups_msm), a later slice of the port"
            )
        ((m, rounds),) = groups.keys()
        interleaved = statements[max_index].generators.bp_gens.interleaved_device(device)
        static_points = type(interleaved)(*(c[: 2 * max_mn] for c in interleaved))
        g_base_pts, h_base_pt = gens.pc_gens.device_bases(device)
        packed = DeviceVerifier.pack(statements, proofs, batch_challenges, weights, device)
        ok, valid = verify_group_full(
            *packed, static_points, g_base_pts, h_base_pt, m=m, bit_length=bit_length, max_mn=max_mn,
        )
        DeviceVerifier.raise_canonicality(valid.cpu().numpy(), m, rounds)
        if not bool(ok):
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
