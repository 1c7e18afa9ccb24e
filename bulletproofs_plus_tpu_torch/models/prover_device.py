"""Batched device prover: B same-shape proofs in lockstep.

Counterpart of bulletproofs_plus_tpu/models/prover_device.py (the
reference's prover, range_proof.rs:232-608), built on the same idea:

**Fixed-base reformulation.**  The reference folds the generator vectors
every round and computes L/R as variable-point MSMs over the folded points
(range_proof.rs:409-537).  Folded generators are linear in the ORIGINAL
generators, so no point is ever folded: per-lane scalar coefficients
(g_coeff/h_coeff) are tracked instead, and every round's L/R and the final
A1/B are fixed-base MSMs over the original gi/hi and the Pedersen bases
[G_1..G_deg, H], whose 4-bit digit tables are precomputed
(ops/fixed_base.py), joined on the lane axis and read by the kernels K5 and
K6 (ops/cuda_fixed.py): a round's L and R are one grouped MSM.

**Halved generators.**  The tables hold ((l + 1) / 2) P for every generator
and Pedersen base P (`BulletproofGens.halved_tables_joined`), so each MSM
gives Q whose double is the proof's point as a ristretto point, and each
batch of points is encoded with `double_and_compress`: one launch of C1's
double-and-encode (csrc/ristretto.cu), which inverts a block's points
together and takes no square root.  No scalar changes.

**The scalar protocol on the card.**  The vector prep, each round's fold
and MSM scalars, the final fold and responses, and the A commitment's
masked sum are the kernels P1-P4 of csrc/prover.cu on a card, their plain
twins on the CPU (models/prover_kernels.py): one launch of P1, one of P2 a
round, two of P3 and one of P4 a prove.

**Fiat-Shamir on the card.**  The JAX package runs the Merlin sponge inside
its one jitted program.  The port runs it as T1 (csrc/transcript.cu, by way
of ops/cuda_transcript.py; its plain twin on the CPU), a launch a phase:
after A, after each round's L and R and after A1 and B, each phase appends
the points that C1' wrote, rebuilds the transcript RNG and draws the masks
the prover needs before the next challenge, squeezes the challenges and
inverts y or e, writing every scalar into the tensors P1-P3 read.  The
host keeps what the JAX package keeps there: the statement's absorption
(`RangeProofTranscript`), alpha's draws from the first RNG, the seed
nonces, and the external RNG's 32-byte blocks, one a phase, drawn after
alpha in the sequential prover's call order (the last phase's rebuild
draws nothing, but its block is consumed as the host path consumed it).
Everything is uploaded once, and one device-to-host copy at the end brings
back every point, r1, s1, d1, the states and the phases' flags; a flag
raises the host path's error of the earliest phase.  One deviation: a
one-lane batch whose RNG draws a zero mask (probability 2^-252) raises the
batched error where the sequential prover would draw again, as the JAX
package's fused prover does.

Bit-exactness contract: proofs and the callers' final transcript states are
byte-identical to sequential `RangeProof.prove_with_rng` calls fed the same
per-lane RNG streams (tests/test_torch_prover.py).

**Sharding.**  With a 1-D mesh every rank checks every lane's arguments,
proves its contiguous run of lanes (`host_shard`) on its own device, and
one gather hands every rank all B proofs and final transcript states.  The
lanes are independent, so that is the whole collective work; the one tie is
the external RNG, which the unsharded batch draws for all B lanes at once
(`_RunRng`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..errors import InvalidArgument, InvalidLength, VerificationFailed
from ..gens.pedersen import ExtensionDegree
from ..ops import host_ristretto as hr
from ..ops import ristretto as rist
from ..ops.cuda_transcript import IDENTITY, ZERO_CHALLENGE, ZERO_DRAW, prove_transcript, prover_phases
from ..ops.edwards import PointArray
from ..ops.fixed_base import fixed_msm_batched, fixed_msm_grouped
from ..ops.limbs import NLIMBS, bytes_from_limbs, int_from_limbs, pack_ints
from ..utils import trace
from ..utils.hashing import nonce
from ..utils.merlin import Transcript
from .prover_kernels import bit_sum, prove_final, prove_prep, prove_responses, prove_round, round_lanes
from .statement import RangeStatement, RangeWitness
from .transcripts import RangeProofTranscript
from .verifier_kernels import _on

L = hr.L


class _RunRng:
    """The external RNG as the unsharded batch draws it: every call draws
    the rows of all `batch` lanes, in order, and hands back those of this
    rank's run of lanes, so each lane's stream is the unsharded one's."""

    def __init__(self, rng, batch: int, run: slice):
        self.rng, self.batch, self.run = rng, batch, run

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        return self.rng.fill_bytes(self.batch, n)[self.run]


def prove_batch_with_rng(
    transcripts: List[Transcript],
    statements: Sequence[RangeStatement],
    witnesses: Sequence[RangeWitness],
    rng,
    device="cuda",
    mesh=None,
) -> list:
    """Prove B same-shape statements in lockstep on `device`.

    All statements must share generators, bit length, aggregation factor and
    extension degree, and either all or none carry a seed nonce; transcripts
    must be at identical sponge positions (fresh transcripts with the same
    label qualify).  Proof bytes AND final transcript states are identical
    to sequential `RangeProof.prove_with_rng` calls with the same per-lane
    RNG streams.  device="cpu" runs the kernels' plain torch versions.  A
    1-D `mesh` shards the lanes over its ranks, each on its own device of
    the mesh; B must divide by the mesh's size, and every rank returns all
    B proofs and advances all B transcripts.
    """
    trace.new_call()
    with trace.span("prove"):
        return _prove_batch(transcripts, statements, witnesses, rng, device, mesh)


def _prove_batch(transcripts, statements, witnesses, rng, device, mesh) -> list:
    from .range_proof import RangeProof

    B = len(statements)
    if not (len(transcripts) == len(witnesses) == B and B > 0):
        raise InvalidArgument("Batch prove needs equal non-empty inputs")
    gens = statements[0].generators
    bit_length = gens.bit_length()
    m = len(statements[0].commitments)
    deg = int(gens.extension_degree())
    seeded = statements[0].seed_nonce is not None
    with trace.span("prove.arg_checks"):
        for statement, witness in zip(statements, witnesses):
            if statement.generators is not gens and (
                statement.generators.g_bases_compressed() != gens.g_bases_compressed()
                or statement.generators.h_base_compressed() != gens.h_base_compressed()
                or statement.generators.bit_length() != bit_length
            ):
                raise InvalidArgument("Batch prove needs identical generators")
            if len(statement.commitments) != m:
                raise InvalidArgument("Batch prove needs a uniform aggregation factor")
            if (statement.seed_nonce is not None) != seeded:
                raise InvalidArgument("Batch prove needs uniform seed nonce presence")
            if len(witness.openings) != m:
                raise InvalidLength("Witness openings and statement commitments do not match!")
            if int(witness.extension_degree) != deg:
                raise InvalidLength("Witness and statement extension degrees do not match!")
            for opening in witness.openings:
                if bit_length < 64 and opening.v >> bit_length > 0:
                    raise InvalidLength("Value exceeds bit vector capacity!")
            for opening, commitment in zip(witness.openings, statement.commitments):
                if not hr.point_equal(gens.pc_gens.commit(opening.v, opening.r), commitment):
                    raise InvalidArgument("Witness opening is invalid!")
            for minimum_value, opening in zip(statement.minimum_value_promises, witness.openings):
                if minimum_value is not None and minimum_value > opening.v:
                    raise InvalidArgument("Minimum value is larger than value")

    if mesh is None:
        lanes, positions = _prove_lanes(transcripts, statements, witnesses, rng, device)
    else:
        from ..parallel.collectives import gather_rows, mesh_device
        from ..parallel.multihost import host_shard

        device = mesh_device(mesh, device)
        if B % mesh.size() != 0:
            raise InvalidArgument("Batch prove mesh needs B divisible by mesh size")
        run = host_shard(B, mesh)
        own, positions = _prove_lanes(transcripts[run], statements[run], witnesses[run], _RunRng(rng, B, run), device)
        # one gather of every rank's lanes, each lane's outputs as one int64 row
        widths = [a[0].size for a in own.values()]
        rows = np.concatenate([a.reshape(len(a), -1).astype(np.int64) for a in own.values()], axis=1)
        every = gather_rows(_on(rows, device), mesh.get_group()).reshape(B, -1).cpu().numpy()
        lanes = {
            k: part.reshape((B,) + a.shape[1:]).astype(a.dtype)
            for (k, a), part in zip(own.items(), np.split(every, np.cumsum(widths)[:-1], axis=1))
        }

    with trace.span("prove.assemble"):
        _raise_flags(lanes["flags"])
        proofs = [
            RangeProof(
                a=lanes["a"][lane].tobytes(),
                a1=lanes["a1_b"][lane, 0].tobytes(),
                b=lanes["a1_b"][lane, 1].tobytes(),
                r1=int_from_limbs(lanes["r1"][lane]),
                s1=int_from_limbs(lanes["s1"][lane]),
                d1=[int_from_limbs(lanes["d1"][lane, k]) for k in range(deg)],
                li=[lb.tobytes() for lb in lanes["li"][lane]],
                ri=[rb.tobytes() for rb in lanes["ri"][lane]],
                extension_degree=ExtensionDegree.from_int(deg),
            )
            for lane in range(B)
        ]

        # Write the finished transcript state back into the callers' transcripts:
        # the sequential prover mutates its transcript in place.
        for lane, transcript in enumerate(transcripts):
            st = transcript.strobe
            st.state = lanes["state"][lane : lane + 1].copy()
            st.pos, st.pos_begin, st.cur_flags = positions
    return proofs


def _raise_flags(flags: np.ndarray) -> None:
    """The phases' flags (B, phases) -> the host path's error of the earliest
    phase that raised one, within a phase in the host path's order: a point
    appended (the identity), the challenges, then the draws the next step
    makes from the phase's RNG."""
    for column in np.asarray(flags).T:
        if (column & IDENTITY).any():
            raise VerificationFailed("Identity element cannot be added to the transcript")
        if (column & ZERO_CHALLENGE).any():  # pragma: no cover - 2^-252
            raise VerificationFailed("Transcript challenge cannot be zero")
        if (column & ZERO_DRAW).any():  # pragma: no cover - 2^-252
            raise VerificationFailed(
                "Batched transcript RNG drew a zero scalar; lanes cannot retry in "
                "lockstep — re-run the batch with a fresh external RNG"
            )


def _read_back(parts: list) -> np.ndarray:
    """The prove's one device-to-host copy: (B, ...) int64 tensors side by
    side as (B, sum of their widths)."""
    with trace.span("prove.readback"):
        return torch.cat([t.reshape(t.shape[0], -1) for t in parts], dim=1).cpu().numpy()


def _prove_lanes(transcripts, statements, witnesses, rng, device):
    """The batched prover proper, on lanes whose arguments are checked.
    Returns ({name: (B, ...) numpy array}, the final sponge positions):
    the compressed points "a" (B, 32), "li" and "ri" (B, rounds, 32) and
    "a1_b" (B, 2, 32); the scalars' limbs "r1", "s1" (B, 16) and "d1"
    (B, deg, 16); "state", the final transcript states (B, 200); "flags",
    the phases' (B, rounds + 2); all read back in one copy."""
    B = len(statements)
    gens = statements[0].generators
    bit_length = gens.bit_length()
    m = len(statements[0].commitments)
    deg = int(gens.extension_degree())
    mn = m * bit_length
    rounds = mn.bit_length() - 1
    seeded = statements[0].seed_nonce is not None

    with trace.span("prove.transcript"):
        # The batched transcript absorbs the statement and keys its first RNG
        # with each lane's witness bytes (v LE64 then each blinding, per
        # opening: transcripts.rs:91-109) and one external block.
        witness_bytes = np.stack(
            [
                np.frombuffer(
                    b"".join(
                        o.v.to_bytes(8, "little") + b"".join(hr.scalar_to_bytes(r_) for r_ in o.r)
                        for o in witness.openings
                    ),
                    dtype=np.uint8,
                )
                for witness in witnesses
            ]
        )
        stacked = Transcript.stack(transcripts)
        rpt = RangeProofTranscript(
            stacked,
            gens.h_base_compressed(),
            gens.g_bases_compressed(),
            bit_length,
            deg,
            m,
            [
                np.stack([np.frombuffer(s.commitments_compressed[j], dtype=np.uint8) for s in statements])
                for j in range(m)
            ],
            [[s.minimum_value_promises[j] for s in statements] for j in range(m)],
            witness_bytes,
            rng,
        )

        def upload(values, *shape: int) -> torch.Tensor:
            """Python ints mod l -> (*shape, 16) limb tensor on the device."""
            return _on(pack_ints([v % L for v in values]), device).reshape(shape + (NLIMBS,))

        def nonces(label: str, index_j) -> list:
            return [nonce(s.seed_nonce, label, index_j, k) for s in statements for k in range(deg)]

        # alpha (range_proof.rs:299-303): nonces, or lockstep draws from the first RNG
        if seeded:
            alpha = upload(nonces("alpha", None), B, deg)
        else:
            draws = [rpt.rng().random_not_zero() for _ in range(deg)]  # [k][lane]
            alpha = upload([draws[k][lane] for lane in range(B) for k in range(deg)], B, deg)
        # The external RNG's blocks of the rebuilds, one a phase, in the sequential prover's call order
        blocks = np.stack([rng.fill_bytes(B, 32) for _ in range(rounds + 2)])
        phases, final_position = prover_phases(
            rounds, deg, seeded, witness_bytes.shape[1], stacked.strobe.pos, stacked.strobe.pos_begin,
            stacked.strobe.cur_flags,
        )

    with trace.span("prove.dispatch"):
        # Bit decomposition with minimum-value offsets
        bits_np = np.zeros((B, mn), dtype=np.int64)
        for lane, (statement, witness) in enumerate(zip(statements, witnesses)):
            offsets = [
                opening.v - (minimum_value or 0)
                for minimum_value, opening in zip(statement.minimum_value_promises, witness.openings)
            ]
            bits_np[lane] = [(v >> i) & 1 for v in offsets for i in range(bit_length)]
        bits = _on(bits_np, device)
        r_blind = upload(
            [
                witness.openings[j].r[k] if k < len(witness.openings[j].r) else 0
                for witness in witnesses
                for j in range(m)
                for k in range(deg)
            ],
            B, m, deg,
        )
        state = torch.as_tensor(np.ascontiguousarray(stacked.strobe.state), device=device)
        witness_t = torch.as_tensor(witness_bytes, device=device)
        blocks_t = torch.as_tensor(blocks, device=device)
        flags = torch.zeros((B, rounds + 2), dtype=torch.uint8, device=device)

        def scalar() -> torch.Tensor:
            return torch.empty((B, NLIMBS), dtype=torch.int64, device=device)

        def masks() -> torch.Tensor:
            return torch.empty((B, deg, NLIMBS), dtype=torch.int64, device=device)

        # Where each phase's draws go: round p's d_L and d_R, or after the last round r_s, s_s, d and eta; seeded
        # statements take d_L, d_R, d and eta from their nonces
        if seeded:
            d_l = upload([v for r in range(rounds) for v in nonces("dL", r)], rounds, B, deg)
            d_r = upload([v for r in range(rounds) for v in nonces("dR", r)], rounds, B, deg)
            d_mask, eta = upload(nonces("d", None), B, deg), upload(nonces("eta", None), B, deg)
            phase_draws = [[] for _ in range(rounds)]
        else:
            d_l, d_r = [masks() for _ in range(rounds)], [masks() for _ in range(rounds)]
            d_mask, eta = masks(), masks()
            phase_draws = [[d[:, k] for d in (d_l[r], d_r[r]) for k in range(deg)] for r in range(rounds)]
        r_s, s_s = scalar(), scalar()
        phase_draws.append([r_s, s_s] + ([] if seeded else [d[:, k] for d in (d_mask, eta) for k in range(deg)]))

        def run_phase(p: int, points: torch.Tensor, outs: list) -> None:
            block = blocks_t[p] if phases[p].n_draws else None
            prove_transcript(phases[p], state, points, witness_t, block, outs, flags[:, p])

        # The tables of the halved generators joined with the halved Pedersen bases' [G_1..G_deg, H], at lanes
        # 2mn..2mn+deg: every MSM gives Q, and 2Q is the point of the proof, encoded by `double_and_compress`
        tables = gens.bp_gens.halved_tables_joined(2 * mn, gens.pc_gens, device)
        pedersen = 2 * mn + np.arange(deg + 1)

        # --- A commitment (range_proof.rs:299-345): the static scalars ARE the
        # bit decomposition (a_li in {0,1}, a_ri in {0,-1}), so the MSM collapses
        # to a masked sum (P4) on top of the alpha fixed-base MSM.
        a_pt = bit_sum(fixed_msm_batched(alpha, tables, lanes=pedersen[:deg]), bits, tables)
        a_comp = rist.double_and_compress(a_pt)

        # --- challenges y, z (transcripts.rs:124-138); vector prep (range_proof.rs:350-373)
        y, z, y_inv = scalar(), scalar(), scalar()
        run_phase(0, a_comp[:, None], phase_draws[0] + [y, z, y_inv])
        av, bv, y_pows, y_inv_n, alpha = prove_prep(y, z, y_inv, bits, r_blind, alpha, bit_length=bit_length)

        # Rounds (range_proof.rs:409-537): each folds by the previous round's
        # challenge, then L and R are one grouped fixed-base MSM over the ORIGINAL
        # generators (folded generators are linear in them: per-lane coefficients
        # g and h) and the Pedersen lanes [d, c].
        lr_comps = []
        g_coeff = h_coeff = fold = None
        for r in range(rounds):
            av, bv, g_coeff, h_coeff, alpha, scalars = prove_round(
                av, bv, g_coeff, h_coeff, alpha, fold, y_pows, y_inv_n, d_l[r], d_r[r], r=r
            )
            lr_pts = fixed_msm_grouped(scalars, tables, 2, lanes=round_lanes(mn, deg, r))
            lr_comps.append(rist.double_and_compress(lr_pts))  # (B, 2, 16)
            e, e_inv = scalar(), scalar()
            run_phase(r + 1, lr_comps[-1], phase_draws[r + 1] + [e, e_inv])
            fold = (e, e_inv, d_l[r], d_r[r])

        # --- final masks and A1/B (range_proof.rs:540-584): A1 spans ALL original
        # generator lanes after the last fold, and the Pedersen lanes; B only the latter
        a1_scalars, b_scalars, a0, b0, alpha = prove_final(
            av, bv, g_coeff, h_coeff, alpha, fold, y_pows, y_inv_n, r_s, s_s, d_mask, eta
        )
        a1_pt = fixed_msm_batched(a1_scalars, tables)
        b_pt = fixed_msm_batched(b_scalars, tables, lanes=pedersen)
        final_pts = PointArray(*(torch.stack([a, b], dim=1) for a, b in zip(a1_pt, b_pt)))
        final_comp = rist.double_and_compress(final_pts)  # (B, 2, 16)
        e = scalar()
        run_phase(rounds + 1, final_comp, [e])
        r1, s1, d1 = prove_responses(r_s, s_s, a0, b0, eta, d_mask, alpha, e)

    host = _read_back([a_comp, *lr_comps, final_comp, r1, s1, d1, state.view(torch.int64), flags.to(torch.int64)])
    ends = np.cumsum([NLIMBS, 2 * NLIMBS * rounds, 2 * NLIMBS, NLIMBS, NLIMBS, deg * NLIMBS, 25])
    a_l, lr_l, final_l, r1_l, s1_l, d1_l, state_w, flags_l = np.split(host, ends, axis=1)
    lr_bytes = bytes_from_limbs(lr_l.reshape(B, rounds, 2, NLIMBS))  # (B, rounds, 2, 32)
    lanes = {
        "a": bytes_from_limbs(a_l),
        "li": np.ascontiguousarray(lr_bytes[:, :, 0]),
        "ri": np.ascontiguousarray(lr_bytes[:, :, 1]),
        "a1_b": bytes_from_limbs(final_l.reshape(B, 2, NLIMBS)),
        "r1": r1_l,
        "s1": s1_l,
        "d1": d1_l.reshape(B, deg, NLIMBS),
        "state": np.ascontiguousarray(state_w).view(np.uint8).reshape(B, 200),
        "flags": flags_l.astype(np.uint8),
    }
    return lanes, final_position
