"""Bulletproofs+ range proofs in exact integer arithmetic: the sequential
prover, the batch verifier and the canonical codec (reference
src/range_proof.rs:221-1309).  A frozen copy of the host prover
(`prove_with_rng`), the host engine (`_verify`, here `verify_batch`) and the
codec of bulletproofs_plus_tpu_torch/models/range_proof.py, every MSM
through the plain Pippenger in msm.py.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .errors import (
    InvalidArgument,
    InvalidLength,
    SizeOverflow,
    VerificationFailed,
)
from .gens import ExtensionDegree
from . import ristretto as hr
from .msm import host_msm
from .hashing import nonce
from .merlin import NullRng, Transcript
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


def _check_batch_lengths(transcripts, statements, proofs) -> None:
    if not statements or not proofs or not transcripts:
        raise InvalidArgument("Range statements or proofs length empty")
    if len(statements) != len(proofs):
        raise InvalidArgument("Range statements and proofs length mismatch")
    if len(transcripts) != len(statements):
        raise InvalidArgument("Range statements and transcripts length mismatch")


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

    # ------------------------------------------------------------------
    # Prover
    # ------------------------------------------------------------------

    @staticmethod
    def prove_with_rng(
        transcript: Transcript,
        statement: RangeStatement,
        witness: RangeWitness,
        rng,
    ) -> "RangeProof":
        """Create one range proof in exact integer arithmetic
        (range_proof.rs:232-608 parity)."""
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
        a = host_msm(a_scalars, a_points)

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
                host_msm([c_l] + d_l + a_lo_offset + b_hi, [h_base] + g_base + gi_hi + hi_lo)
            )
            ri.append(
                host_msm([c_r] + d_r + a_hi_offset + b_lo, [h_base] + g_base + gi_lo + hi_hi)
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
        a1 = host_msm(
            [r, s, (r * y1 % L * a_ri[0] + s * y1 % L * a_li[0]) % L] + d_mask,
            [gi_base[0], hi_base[0], h_base] + g_base,
        )
        b_point = host_msm([r * y1 % L * s % L] + eta, [h_base] + g_base)

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
    ) -> List[Optional[ExtendedMask]]:
        """Verify a batch with one folded MSM in exact integer arithmetic
        (range_proof.rs:610-1065); raises VerificationFailed on a bad batch."""
        _check_batch_lengths(transcripts, statements, proofs)
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

        result = host_msm(static_scalars + dynamic_scalars, static_points + dynamic_points)
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
