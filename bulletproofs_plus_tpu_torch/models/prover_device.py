"""Batched device prover: B same-shape proofs in lockstep.

Counterpart of bulletproofs_plus_tpu/models/prover_device.py (the
reference's prover, range_proof.rs:232-608), built on the same idea:

**Fixed-base reformulation.**  The reference folds the generator vectors
every round and computes L/R as variable-point MSMs over the folded points
(range_proof.rs:409-537).  Folded generators are linear in the ORIGINAL
generators, so no point is ever folded: per-lane scalar coefficients
(g_coeff/h_coeff) are tracked instead, and every round's L/R and the final
A1/B are fixed-base MSMs over the original gi/hi/H/G_k, whose 4-bit digit
tables are precomputed (ops/fixed_base.py) and read by the kernels K5 and K6
(ops/cuda_fixed.py).  Each batch of points is encoded with `compress`, one
launch of C1 (csrc/ristretto.cu, K4's chain inside) on the card.

**Fiat-Shamir on the host.**  The JAX package runs the Merlin sponge inside
its one jitted program because a jit cannot call back to the host.  PyTorch
runs eagerly, so the batched numpy transcript that starts the prover
(`RangeProofTranscript` over B stacked lanes) drives the whole protocol:
after A, after each round's L/R and after A1/B the compressed points are
read back, the challenges are squeezed and the round's masks drawn with
`rpt.rng().random_not_zero()` in the sequential prover's order, and the
scalars are uploaded.  The external RNG is so consumed by the transcript
itself, in the reference's call order.  Challenge inverses (y^-1, each e^-1)
are taken on the host too: B modular inversions instead of one Fermat
ladder of ~380 batched multiplications on the device each.  The scalar
folds and the A commitment's masked sums are plain torch.

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

from ..errors import InvalidArgument, InvalidLength
from ..gens.pedersen import ExtensionDegree
from ..ops import edwards as ed
from ..ops import field as F
from ..ops import host_ristretto as hr
from ..ops import ristretto as rist
from ..ops.edwards import PointArray
from ..ops.fixed_base import fixed_msm_batched, fixed_msm_grouped
from ..ops.limbs import NLIMBS, bytes_from_limbs, int_from_limbs, pack_ints
from ..ops.msm import tree_reduce
from ..utils.hashing import nonce
from ..utils.merlin import Transcript
from .statement import RangeStatement, RangeWitness
from .transcripts import RangeProofTranscript
from .verifier_kernels import _on, _power_ladder

L = hr.L


def _batch_sum_l(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Modular sum of canonical scalars along `dim`: one exact limb-wise
    int64 sum, one carry chain, one Barrett reduction."""
    raw = x.sum(dim=dim)
    return F.barrett_reduce(F.carry_prop(raw, 32, bits=16 + x.shape[dim].bit_length()))


def _point_bytes(comp: torch.Tensor) -> np.ndarray:
    """(..., 16) canonical limbs on the device -> (..., 32) uint8 on the host."""
    return bytes_from_limbs(comp.cpu().numpy())


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
    from .range_proof import RangeProof

    B = len(statements)
    if not (len(transcripts) == len(witnesses) == B and B > 0):
        raise InvalidArgument("Batch prove needs equal non-empty inputs")
    gens = statements[0].generators
    bit_length = gens.bit_length()
    m = len(statements[0].commitments)
    deg = int(gens.extension_degree())
    seeded = statements[0].seed_nonce is not None
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


def _prove_lanes(transcripts, statements, witnesses, rng, device):
    """The batched prover proper, on lanes whose arguments are checked.
    Returns ({name: (B, ...) numpy array}, the final sponge positions):
    the compressed points "a" (B, 32), "li" and "ri" (B, rounds, 32) and
    "a1_b" (B, 2, 32); the scalars' limbs "r1", "s1" (B, 16) and "d1"
    (B, deg, 16); "state", the final transcript states (B, 200)."""
    B = len(statements)
    gens = statements[0].generators
    bit_length = gens.bit_length()
    m = len(statements[0].commitments)
    deg = int(gens.extension_degree())
    mn = m * bit_length
    rounds = mn.bit_length() - 1
    seeded = statements[0].seed_nonce is not None

    # The batched transcript, keyed with each lane's witness bytes
    # (v LE64 then each blinding, per opening: transcripts.rs:91-109).
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

    def upload(values: Sequence[int], *shape: int) -> torch.Tensor:
        """Python ints mod l -> (*shape, 16) limb tensor on the device."""
        return _on(pack_ints([v % L for v in values]), device).reshape(shape + (NLIMBS,))

    def masks(label: str, index_j) -> torch.Tensor:
        """(B, deg, 16) mask scalars: the seed nonce's if the statements carry
        one, else `deg` lockstep draws from the transcript RNG."""
        if seeded:
            return upload([nonce(s.seed_nonce, label, index_j, k) for s in statements for k in range(deg)], B, deg)
        draws = [rpt.rng().random_not_zero() for _ in range(deg)]  # [k][lane]
        return upload([draws[k][lane] for lane in range(B) for k in range(deg)], B, deg)

    alpha = masks("alpha", None)

    # Bit decomposition with minimum-value offsets
    bits_np = np.zeros((B, mn), dtype=np.int64)
    for lane, (statement, witness) in enumerate(zip(statements, witnesses)):
        offsets = [
            opening.v - (minimum_value or 0)
            for minimum_value, opening in zip(statement.minimum_value_promises, witness.openings)
        ]
        bits_np[lane] = [(v >> i) & 1 for v in offsets for i in range(bit_length)]
    bits = _on(bits_np, device)
    ones = bits == 1
    r_blind = upload(
        [
            witness.openings[j].r[k] if k < len(witness.openings[j].r) else 0
            for witness in witnesses
            for j in range(m)
            for k in range(deg)
        ],
        B, m, deg,
    )

    gihi_tables = gens.bp_gens.fixed_tables_sliced(2 * mn, device)
    pedersen_tables = gens.pc_gens.device_base_tables(device)  # [G_1..G_deg, H]
    interleaved = gens.bp_gens.interleaved_device(device)
    gi_pts = PointArray(*(c[0 : 2 * mn : 2] for c in interleaved))
    neg_hi_pts = ed.neg(PointArray(*(c[1 : 2 * mn : 2] for c in interleaved)))

    # --- A commitment (range_proof.rs:299-345): the static scalars ARE the
    # bit decomposition (a_li in {0,1}, a_ri in {0,-1}), so the MSM collapses
    # to two masked halving sums plus the alpha fixed-base MSM.
    idp = ed.identity((B, mn), device=device)
    sel = ed.cat(
        [
            ed.select(ones, PointArray(*(c.expand(B, mn, NLIMBS) for c in gi_pts)), idp),
            ed.select(ones, idp, PointArray(*(c.expand(B, mn, NLIMBS) for c in neg_hi_pts))),
        ],
        dim=1,
    )
    a_pt = ed.add(tree_reduce(sel), fixed_msm_batched(alpha, pedersen_tables))
    a_bytes = _point_bytes(rist.compress(a_pt))

    # --- challenges y, z (transcripts.rs:124-138)
    y_list, z_list = rpt.challenges_y_z(a_bytes)
    y = upload(y_list, B)
    z = upload(z_list, B)
    y_inv = upload([pow(v, -1, L) for v in y_list], B)

    one = F.limbs_const(1, y).expand(y.shape)
    y_powers = _power_ladder(y, one, mn + 2)  # (B, mn+2, 16): y^0..y^{mn+1}
    y_inv_powers = _power_ladder(y_inv, one, mn + 2)
    z_square = F.sqr_l(z)

    # d vector and vector prep (range_proof.rs:350-365)
    two_pows = upload([pow(2, i, L) for i in range(bit_length)], bit_length)
    z2_pows = _power_ladder(z_square, z_square, m)  # (B, m): z^{2(j+1)}
    d = F.mul_l(z2_pows[:, :, None, :], two_pows[None, None]).reshape(B, mn, NLIMBS)
    bits_limb = torch.zeros((B, mn, NLIMBS), dtype=torch.int64, device=device)
    bits_limb[:, :, 0] = bits
    minus_one = F.limbs_const(L - 1, y).expand(B, mn, NLIMBS)
    a_ri0 = F.select(ones, torch.zeros_like(bits_limb), minus_one)
    y_rev = y_powers[:, 1 : mn + 1].flip(1)  # y^{mn-i}
    z_b = z[:, None].expand(B, mn, NLIMBS)
    av = F.sub_l(bits_limb, z_b)  # spread a vector
    bv = F.add_l(a_ri0, F.add_l(F.mul_l(d, y_rev), z_b))  # spread b

    # alpha += z^{2(j+1)} * r_jk * y^{mn+1} (range_proof.rs:367-373)
    alpha_terms = F.mul_l(F.mul_l(z2_pows, y_powers[:, mn + 1][:, None])[:, :, None], r_blind)  # (B, m, deg, 16)
    alpha = F.add_l(alpha, _batch_sum_l(alpha_terms, 1))

    # Per-lane folded-generator coefficients: gi'_r[p] = sum over original
    # lanes i with (i mod 2n) == p of g_coeff[i] * gi[i].
    g_coeff = one[:, None].expand(B, mn, NLIMBS)
    h_coeff = g_coeff

    li_bytes, ri_bytes = [], []
    lanes = np.arange(mn)
    for r in range(rounds):
        n = mn >> (r + 1)
        hi_np = lanes % (2 * n) >= n
        hi_mask = torch.as_tensor(hi_np, device=device)[None]  # (1, mn)
        y_n = y_powers[:, n]
        y_n_inv = y_inv_powers[:, n]

        d_l = masks("dL", r)
        d_r = masks("dR", r)

        # c_l = sum_{j<n} a[j] y^{1+j} b[j+n]; c_r with y^{n+1+j}, halves
        # swapped (range_proof.rs:430-443).  The first 2n spread lanes are
        # the canonical folded vectors, so static slices suffice.
        c_l = _batch_sum_l(F.mul_l(F.mul_l(av[:, :n], y_powers[:, 1 : n + 1]), bv[:, n : 2 * n]), 1)
        c_r = _batch_sum_l(F.mul_l(F.mul_l(av[:, n : 2 * n], y_powers[:, n + 1 : 2 * n + 1]), bv[:, :n]), 1)

        # L/R as fixed-base MSMs over the ORIGINAL generators: substitute
        # gi'[p] = sum g_coeff[i] gi[i] into range_proof.rs:445-458.  Each
        # interleaved lane contributes to EXACTLY ONE of L and R (g_i -> L iff
        # pos >= n, h_i -> L iff pos < n), so one grouped MSM of width 2mn,
        # its lanes permuted so L's come first, computes both.
        av_up, av_down = torch.roll(av, n, 1), torch.roll(av, -n, 1)
        bv_up, bv_down = torch.roll(bv, n, 1), torch.roll(bv, -n, 1)
        g_lane = F.select(
            hi_mask,
            F.mul_l(F.mul_l(g_coeff, av_up), y_n_inv[:, None]),
            F.mul_l(F.mul_l(g_coeff, av_down), y_n[:, None]),
        )  # hi lanes: L's g coefficient; lo lanes: R's
        h_lane = F.select(hi_mask, F.mul_l(h_coeff, bv_up), F.mul_l(h_coeff, bv_down))  # hi: R's h; lo: L's
        combined = torch.stack([g_lane, h_lane], dim=2).reshape(B, 2 * mn, NLIMBS)
        perm = np.concatenate(
            [
                2 * lanes[hi_np],  # g lanes feeding L
                2 * lanes[~hi_np] + 1,  # h lanes feeding L
                2 * lanes[~hi_np],  # g lanes feeding R
                2 * lanes[hi_np] + 1,  # h lanes feeding R
            ]
        )
        lr_static_pts = fixed_msm_grouped(combined[:, _on(perm, device)], gihi_tables, 2, lanes=perm)
        lr_fixed = torch.stack(
            [torch.cat([d_l, c_l[:, None]], dim=1), torch.cat([d_r, c_r[:, None]], dim=1)], dim=1
        )  # (B, 2, deg+1, 16)
        lr_pts = ed.add(lr_static_pts, fixed_msm_batched(lr_fixed, pedersen_tables))
        lr_bytes = _point_bytes(rist.compress(lr_pts))  # (B, 2, 32)
        li_bytes.append(lr_bytes[:, 0])
        ri_bytes.append(lr_bytes[:, 1])

        e_list = rpt.challenge_round_e(lr_bytes[:, 0], lr_bytes[:, 1])
        e = upload(e_list, B)
        e_inv = upload([pow(v, -1, L) for v in e_list], B)
        e_sq = F.sqr_l(e)
        e_inv_sq = F.sqr_l(e_inv)

        # Folds (range_proof.rs:510-537), in spread form: lanes with position
        # p' = i mod n read their lo value at position p' and their hi value
        # at p' + n via static rolls.
        av_lo, av_hi = F.select(hi_mask, av_up, av), F.select(hi_mask, av, av_down)
        bv_lo, bv_hi = F.select(hi_mask, bv_up, bv), F.select(hi_mask, bv, bv_down)
        e_b, e_inv_b = e[:, None].expand(B, mn, NLIMBS), e_inv[:, None].expand(B, mn, NLIMBS)
        av = F.add_l(F.mul_l(av_lo, e_b), F.mul_l(av_hi, F.mul_l(e_inv, y_n)[:, None]))
        bv = F.add_l(F.mul_l(bv_lo, e_inv_b), F.mul_l(bv_hi, e_b))
        g_coeff = F.mul_l(g_coeff, F.select(hi_mask, F.mul_l(e, y_n_inv)[:, None].expand(B, mn, NLIMBS), e_inv_b))
        h_coeff = F.mul_l(h_coeff, F.select(hi_mask, e_inv_b, e_b))
        alpha = F.add_l(alpha, F.add_l(F.mul_l(d_l, e_sq[:, None]), F.mul_l(d_r, e_inv_sq[:, None])))

    # --- final masks and A1/B (range_proof.rs:540-584)
    r_s = upload(rpt.rng().random_not_zero(), B)
    s_s = upload(rpt.rng().random_not_zero(), B)
    d_mask = masks("d", None)
    eta = masks("eta", None)

    a0, b0, y1 = av[:, 0], bv[:, 0], y_powers[:, 1]
    ry = F.mul_l(r_s, y1)
    ry_ar = F.add_l(F.mul_l(ry, b0), F.mul_l(F.mul_l(s_s, y1), a0))
    rys = F.mul_l(ry, s_s)

    # A1 = r*gi'[0] + s*hi'[0] + ry_ar*H + sum d_mask*G; gi'[0] spans ALL
    # original lanes after the last fold.  B has no static component, so it
    # costs only the (deg+1)-lane Pedersen MSM.
    a1_static = torch.stack([F.mul_l(g_coeff, r_s[:, None]), F.mul_l(h_coeff, s_s[:, None])], dim=2).reshape(
        B, 2 * mn, NLIMBS
    )
    final_fixed = torch.stack(
        [torch.cat([d_mask, ry_ar[:, None]], dim=1), torch.cat([eta, rys[:, None]], dim=1)], dim=1
    )
    ped_pts = fixed_msm_batched(final_fixed, pedersen_tables)  # (B, 2)
    a1_pt = ed.add(fixed_msm_batched(a1_static, gihi_tables), PointArray(*(c[:, 0] for c in ped_pts)))
    final_pts = PointArray(*(torch.stack([a, c[:, 1]], dim=1) for a, c in zip(a1_pt, ped_pts)))
    final_bytes = _point_bytes(rist.compress(final_pts))  # (B, 2, 32)

    e_list = rpt.challenge_final_e(final_bytes[:, 0], final_bytes[:, 1])
    e_f = upload(e_list, B)
    e_f_sq = F.sqr_l(e_f)
    r1 = F.add_l(r_s, F.mul_l(a0, e_f))
    s1 = F.add_l(s_s, F.mul_l(b0, e_f))
    d1 = F.add_l(eta, F.add_l(F.mul_l(d_mask, e_f[:, None]), F.mul_l(alpha, e_f_sq[:, None])))
    final = stacked.strobe
    lanes = {
        "a": a_bytes,
        "li": np.array(li_bytes, dtype=np.uint8).reshape(rounds, B, 32).transpose(1, 0, 2),
        "ri": np.array(ri_bytes, dtype=np.uint8).reshape(rounds, B, 32).transpose(1, 0, 2),
        "a1_b": final_bytes,
        "r1": r1.cpu().numpy(),
        "s1": s1.cpu().numpy(),
        "d1": d1.cpu().numpy(),
        "state": np.asarray(final.state).reshape(B, -1),
    }
    return lanes, (final.pos, final.pos_begin, final.cur_flags)
