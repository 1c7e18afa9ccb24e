"""T1, the batched prover's Fiat-Shamir on the card, and K3's identity tail,
on the CPU.

T1's plain twin (`transcript_plain`, through `prove_transcript` on CPU
tensors) is held phase by phase against the host's numpy
`RangeProofTranscript` fed the same external blocks: states, sponge
positions, draws, challenges, inverses and flags; its word model
(`transcript_model`, the kernel's span ops and epilogue in numpy) against
the plain twin.  The epilogue's variable-time inversion (scalar_l.cuh
`sc_inv_l_var`, a warp for one value, lane by lane in ops/scalar_model.py
`inv_l_var`) is held against Python's pow(x, -1, l) at its edges and on
seeded random values, within its cap of batches, its four-step table
against single divsteps, and through a program whose state chooses the
values (`EpiloguePhase`).  The batched prover's use of the external RNG is held
against the sequential prover's.  K3's tail (msm.cu: X or Y 0 mod p) is held
against I1's word model and the plain twins.  The kernels themselves run
only on the card (tests/test_torch_cuda.py).  This file imports no JAX.
Tolerance: exact everywhere.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.models.prover_device import _raise_flags
from bulletproofs_plus_tpu_torch.models.transcripts import RangeProofTranscript
from bulletproofs_plus_tpu_torch.ops import cuda_transcript as ct
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import field_model as fm
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import ristretto as rist
from bulletproofs_plus_tpu_torch.ops import scalar_model as SM
from bulletproofs_plus_tpu_torch.ops.limbs import bytes_from_limbs, int_from_limbs, pack_ints
from bulletproofs_plus_tpu_torch.ops.msm import host_msm, msm_kernel
from bulletproofs_plus_tpu_torch.utils.merlin import SeededRng, Transcript
from torch_prover_inputs import INV_VAR_WORST, EpiloguePhase, inv_edge_values

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores
L = hr.L


class _Blocks:
    """An external RNG that hands out the given (B, 32) blocks in order."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        assert n == 32
        return self.blocks.pop(0)


def _host(bits: int, m: int, deg: int, batch: int, rs):
    """The host's numpy transcript after the statement, its blocks, the
    lanes' witness bytes: (RangeProofTranscript, blocks (rounds + 3, B, 32),
    witness (B, W))."""
    rounds = (bits * m).bit_length() - 1
    blocks = rs.integers(0, 256, (rounds + 3, batch, 32), dtype=np.uint8)
    witness = rs.integers(0, 256, (batch, m * (8 + 32 * deg)), dtype=np.uint8)
    stacked = Transcript.stack([Transcript(b"t1") for _ in range(batch)])
    rpt = RangeProofTranscript(
        stacked, rs.bytes(32), [rs.bytes(32) for _ in range(deg)], bits, deg, m,
        [rs.integers(1, 256, (batch, 32), dtype=np.uint8) for _ in range(m)],
        [[None] * batch for _ in range(m)], witness, _Blocks(blocks),
    )
    return rpt, blocks, witness


def _run_phase(phase, state, points, witness, block):
    """T1's plain twin through its dispatcher, and its word model on the same
    inputs: -> (scalars as ints [output][lane], flags, the model's outputs)."""
    batch = state.shape[0]
    row = ct.phase_row(points, witness, block).numpy()
    model = ct.transcript_model(phase, state.numpy().copy(), row)
    outs = [torch.full((batch, 16), -1, dtype=torch.int64) for _ in range(phase.n_wide + len(phase.invert))]
    flags = torch.full((batch,), 255, dtype=torch.uint8)
    ct.prove_transcript(phase, state, points, witness, block, outs, flags)
    return [[int_from_limbs(o[lane].numpy()) for lane in range(batch)] for o in outs], flags, model, outs


def _assert_model_equal(model, state, outs, flags, phase):
    m_state, m_scalars, m_inverses, m_flags = model
    assert np.array_equal(m_state, state.numpy())
    for j, out in enumerate(outs):
        want = m_scalars[:, j] if j < phase.n_wide else m_inverses[:, j - phase.n_wide]
        assert np.array_equal(want, out.numpy()), j
    assert np.array_equal(m_flags, flags.numpy())


@pytest.mark.parametrize(
    "bits, m, deg, seeded",
    [(64, 1, 1, False), (64, 4, 6, True), (64, 4, 6, False), (1, 1, 1, False)],
    ids=["b64_m1_deg1", "b64_m4_deg6_seeded", "b64_m4_deg6_unseeded", "one_bit"],
)
def test_phases_match_host_transcript(bits, m, deg, seeded):
    """Every phase of a prove, on lanes of random points: the plain twin
    equals the host's `challenges_y_z`, `challenge_round_e` and
    `challenge_final_e` followed by the draws from the rebuilt RNG, y's and
    e's inverses equal pow(., -1, l), the states and the final position
    equal the host's, no flag is raised; the word model equals the twin."""
    batch = 2
    rs = np.random.default_rng(bits * 100 + m * 10 + deg + seeded)
    rpt, blocks, witness = _host(bits, m, deg, batch, rs)
    host = rpt.transcript.strobe
    rounds = (bits * m).bit_length() - 1
    phases, end = ct.prover_phases(rounds, deg, seeded, witness.shape[1], host.pos, host.pos_begin, host.cur_flags)
    assert len(phases) == rounds + 2
    state = torch.as_tensor(host.state.copy())
    witness_t = torch.as_tensor(witness)
    for p, phase in enumerate(phases):
        points = torch.as_tensor(rs.integers(0, 1 << 16, (batch, phase.n_points, 16)))
        comp = bytes_from_limbs(points.numpy())
        if p == 0:
            challenges = list(rpt.challenges_y_z(comp[:, 0]))
        elif p <= rounds:
            challenges = [rpt.challenge_round_e(comp[:, 0], comp[:, 1])]
        else:
            challenges = [rpt.challenge_final_e(comp[:, 0], comp[:, 1])]
        draws = [rpt.rng().random_scalars() for _ in range(phase.n_draws)]
        inverses = [[pow(v, -1, L) for v in challenges[0]]] if p <= rounds else []
        block = torch.as_tensor(blocks[p + 1]) if phase.n_draws else None
        got, flags, model, outs = _run_phase(phase, state, points, witness_t, block)
        assert got == draws + challenges + inverses, p
        assert flags.tolist() == [0] * batch
        assert np.array_equal(state.numpy(), host.state), p
        _assert_model_equal(model, state, outs, flags, phase)
    assert end == (host.pos, host.pos_begin, host.cur_flags)
    # the draws each phase makes: round p's d_L and d_R, or r_s, s_s (d and eta) after the last round
    masks = 0 if seeded else 2 * deg
    assert [ph.n_draws for ph in phases] == [masks] * rounds + [2 + masks, 0]


def _random_scalars(n: int, seed: int) -> list:
    rs = np.random.default_rng(seed)
    return [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]


@pytest.mark.parametrize("values", ["edges", "random"])
def test_inv_l_var_model_matches_pow(values):
    """`inv_l_var`, the warp's inversion lane by lane with its bounds
    asserted, equals pow(x, -1, l) (0 for 0) at the edges (0, 1, 2, l - 1,
    l - 2, every 2^k, long runs of zero bits, the inputs that took the most
    divsteps among 60,000 random ones) and on 1,000 seeded random values; no
    input needs more than 18 batches of the cap of 20, and the most-divstep
    inputs take their 18."""
    xs = inv_edge_values() if values == "edges" else _random_scalars(1000, 18)
    most = 0
    for x in xs:
        counts = {}
        assert SM.from_words(SM.inv_l_var(SM.to_words(x, 8), counts)) == (pow(x, -1, L) if x else 0), x
        most = max(most, counts["batches"])
    assert most <= 18 < SM.INV_VAR_BATCHES
    if values == "edges":
        for x in INV_VAR_WORST:
            counts = {}
            SM.inv_l_var(SM.to_words(x, 8), counts)
            assert counts["batches"] == 18


def test_jump4_table_matches_single_divsteps():
    """Every entry of the four-step table (divsteps.cuh DS_JUMP4) equals four
    single divsteps from any zeta that clamps to its row, on random words
    with the entry's low bits: the same matrix and the same zeta after."""
    rs = np.random.default_rng(4)
    table = SM.jump4_table()
    for idx, ((a, b, c, d), sign, add) in enumerate(table):
        clamped = (idx >> 7) - 4
        for zeta in ({clamped} | ({-40, -9, -5} if clamped == -4 else {9, 40} if clamped == 3 else set())):
            f = int(rs.integers(0, 1 << 27)) << 4 | (idx >> 4 & 7) << 1 | 1
            g = int(rs.integers(0, 1 << 27)) << 4 | (idx & 15)
            zf, ff, gf, uu, vv, qq, rr = zeta, f, g, 1, 0, 0, 1
            for _ in range(4):
                if zf < 0 and gf & 1:
                    zf, ff, gf, uu, vv, qq, rr = -zf - 2, gf, (gf - ff) >> 1, 2 * qq, 2 * rr, qq - uu, rr - vv
                else:
                    gf, qq, rr = (gf + ff, qq + uu, rr + vv) if gf & 1 else (gf, qq, rr)
                    zf, gf, uu, vv = zf - 1, gf >> 1, 2 * uu, 2 * vv
            assert (uu, vv, qq, rr) == (a, b, c, d) and zf == sign * zeta + add, (idx, zeta)
            assert (a * f + b * g) == ff << 4 and (c * f + d * g) == gf << 4


def test_epilogue_phase_reduces_and_inverts_chosen_values():
    """A program that squeezes three outputs straight from the state
    (`EpiloguePhase`, all three inverted, as the card's lanes do it at
    once): the plain twin and the word model give each 512-bit value mod l,
    its inverse (0 for 0) and the zero-challenge flag, lane 1's middle value
    being l, lane 2's last 0."""
    phase = EpiloguePhase(3, (0, 1, 2))
    values = [[2**512 - 1, L - 1, 2**252 + 1], [7, L, 2**511 + 5], [L + 1, 1, 0]]
    state = torch.zeros((3, 200), dtype=torch.uint8)
    for lane, row in enumerate(values):
        for c, v in enumerate(row):
            state[lane, 64 * c : 64 * c + 64] = torch.as_tensor(list(v.to_bytes(64, "little")), dtype=torch.uint8)
    points, witness = torch.zeros((3, 0, 16), dtype=torch.int64), torch.zeros((3, 0), dtype=torch.uint8)
    got, flags, model, outs = _run_phase(phase, state, points, witness, None)
    reduced = [[v % L for v in row] for row in values]
    assert got == [[row[c] for row in reduced] for c in range(3)] + [
        [pow(row[c], -1, L) if row[c] else 0 for row in reduced] for c in range(3)]
    assert flags.tolist() == [0, ct.ZERO_CHALLENGE, ct.ZERO_CHALLENGE]
    assert not state[:, :192].any()
    _assert_model_equal(model, state, outs, flags, phase)


def test_only_challenges_take_the_variable_time_inversion():
    """A draw is a secret mask and never takes T1's variable-time inversion:
    a spec that names no challenge is refused, and a phase whose mask names
    a draw is refused before it runs."""
    phase = ct.prover_phases(2, 1, False, 8, 0, 0, 0)[0][1]  # a round phase: d_L, d_R, then e
    with pytest.raises(ValueError, match="never a draw"):
        ct.Phase(phase.spec._replace(invert=(-1,)), phase.witness_len, phase.position)
    bad = copy.copy(phase)
    bad.invert, bad.inv_mask = [0], 1
    outs = torch.zeros((bad.n_wide + 1, 1, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="inverts a draw"):
        ct.prove_transcript(bad, torch.zeros((1, 200), dtype=torch.uint8),
                            torch.zeros((1, bad.n_points, 16), dtype=torch.int64),
                            torch.zeros((1, bad.witness_len), dtype=torch.uint8),
                            torch.zeros((1, 32), dtype=torch.uint8), list(outs), torch.zeros(1, dtype=torch.uint8))


def test_zero_point_flags_its_lane_only():
    """An all-zero R on lane 1 of three flags lane 1 alone, in the twin and
    the word model, and the flags raise the host path's identity message."""
    batch = 3
    rs = np.random.default_rng(7)
    rpt, blocks, witness = _host(4, 1, 1, batch, rs)
    host = rpt.transcript.strobe
    phases, _ = ct.prover_phases(2, 1, False, witness.shape[1], host.pos, host.pos_begin, host.cur_flags)
    state = torch.as_tensor(host.state.copy())
    points = torch.as_tensor(rs.integers(0, 1 << 16, (batch, 2, 16)))
    points[1, 1] = 0
    _, flags, model, outs = _run_phase(phases[1], state, points, torch.as_tensor(witness), torch.as_tensor(blocks[2]))
    assert flags.tolist() == [0, ct.IDENTITY, 0]
    _assert_model_equal(model, state, outs, flags, phases[1])
    column = np.zeros((batch, 4), dtype=np.uint8)
    column[:, 1] = flags.numpy()
    with pytest.raises(tbp.VerificationFailed, match="^Identity element cannot be added to the transcript$"):
        _raise_flags(column)


@pytest.mark.parametrize(
    "cells, message",
    [
        ([(0, 1, ct.ZERO_DRAW), (1, 2, ct.IDENTITY)], "Batched transcript RNG drew a zero scalar"),
        ([(1, 3, ct.ZERO_DRAW | ct.IDENTITY)], "Identity element cannot be added"),
        ([(0, 1, ct.ZERO_DRAW), (1, 1, ct.ZERO_CHALLENGE)], "Transcript challenge cannot be zero"),
    ],
    ids=["earlier_phase_first", "identity_before_draw", "challenge_before_draw"],
)
def test_flags_raise_the_host_paths_first_error(cells, message):
    """The earliest phase's error, and within a phase the host path's order:
    the appended points, the challenges, then the draws from its RNG."""
    flags = np.zeros((2, 5), dtype=np.uint8)
    for lane, phase, bit in cells:
        flags[lane, phase] |= bit
    with pytest.raises(tbp.VerificationFailed, match=message):
        _raise_flags(flags)
    _raise_flags(np.zeros((2, 5), dtype=np.uint8))


@functools.lru_cache(maxsize=None)
def _params():
    """One parameter set for the module: the port builds its tables once a
    parameter set, as an application keeps one."""
    return tbp.RangeParameters.init(4, 1, tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1)))


class _Counting:
    def __init__(self, rng):
        self.rng, self.calls = rng, []

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        self.calls.append((batch, n))
        return self.rng.fill_bytes(batch, n)


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_external_rng_consumption_unchanged(seeded):
    """The batched prover takes from the external RNG what B sequential
    provers take, one 32-byte block a rebuild (the statement's, then
    rounds + 2), and leaves it where they would: its next bytes are a fresh
    SeededRng's after as many calls."""
    params = _params()
    pc = params.pc_gens
    openings = [tbp.CommitmentOpening(v, [11 + v]) for v in (3, 9)]
    statements = [tbp.RangeStatement.init(params, [pc.commit(o.v, o.r)], [None], (5 + o.v) if seeded else None)
                  for o in openings]
    witnesses = [tbp.RangeWitness.init([o]) for o in openings]
    rng = _Counting(SeededRng(3))
    tbp.RangeProof.prove_batch_with_rng([tbp.Transcript(b"c") for _ in openings], statements, witnesses, rng,
                                        device="cpu")
    sequential = _Counting(SeededRng(3))
    tbp.RangeProof.prove_with_rng(tbp.Transcript(b"c"), statements[0], witnesses[0], sequential)
    rounds = 2
    assert rng.calls == [(2, 32)] * (rounds + 3) and len(sequential.calls) == rounds + 3
    fresh = SeededRng(3)
    for _ in range(rounds + 3):
        fresh.fill_bytes(2, 32)
    assert np.array_equal(rng.fill_bytes(2, 32), fresh.fill_bytes(2, 32))


@pytest.mark.parametrize(
    "coords, want",
    [((0, 1, 1, 0), True), ((hr.P, 1, 1, 0), True), ((0, 2 * hr.P, 3, 0), True), ((7, 5, 1, 9), False)],
    ids=["identity", "x_is_p", "y_is_2p", "not_identity"],
)
def test_horner_tail_model_matches_is_identity_words(coords, want):
    """K3's tail lane by lane (`horner_identity_lanes`) against I1's word
    model at the identity, at X = p, at Y = 2p and at a point that is not
    the identity."""
    words = [fm.to_words(c) for c in coords]
    assert fm.horner_identity_lanes(words) == fm.is_identity_words(words[0], words[1]) == want


def test_msm_identity_verdict_matches_is_identity():
    """`msm_kernel(..., identity=True)` on CPU tensors (K3's plain twin with
    its tail) gives the MSM's point, against the host's, and I1's plain
    verdict on it, for a sum that is the identity and one that is not."""
    rs = np.random.default_rng(11)
    scalars = [int(v) % L for v in rs.integers(1, 2**62, 3)]
    pts = [hr.point_mul(int(k), hr.BASEPOINT) for k in rs.integers(1, 2**31, 3)]
    points = ed.from_host(pts + pts, device="cpu")
    for values, want in ((scalars + [(L - v) % L for v in scalars], True), (scalars + scalars, False)):
        point, flag = msm_kernel(torch.as_tensor(pack_ints(values).astype(np.int64)), points, identity=True)
        assert flag.shape == () and bool(flag) is want and bool(rist.is_identity_plain(point)) is want
        assert hr.point_equal(ed.to_host(point), host_msm(values, pts + pts))
