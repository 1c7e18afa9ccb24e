"""The port's provers against the JAX package's sequential host prover.

`prove_batch_with_rng(device="cpu")` runs the batched prover with its
kernels' plain versions; its contract is byte equality with sequential
`prove_with_rng` calls fed the same per-lane RNG streams, for the proofs
and for the callers' final transcript states.  The sequential prover here is
the JAX package's, on statements built from the same host integers; the
port's own `prove_with_rng` must reproduce it and the golden vectors.
Tolerance: exact everywhere.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from torch_prover_inputs import LaneRng

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_vectors.json")
with open(GOLDEN) as f:
    CELLS = json.load(f)

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def _det(tag: str) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % hr.L


@functools.lru_cache(maxsize=None)
def _params(pkg, bit_length: int, m: int, deg: int):
    """One RangeParameters a shape and package for the whole module, as an
    application keeps one: the port builds its generator tables once a
    parameter set (some 2-8 s on the CPU), not once a test."""
    return pkg.RangeParameters.init(bit_length, m, pkg.create_pedersen_gens_with_extension_degree(pkg.ExtensionDegree(deg)))


def _setup(pkg, seeded: bool, bit_length: int = 4, m: int = 1, deg: int = 1, B: int = 2):
    """B statements and witnesses in package `pkg`, from the same integers
    whichever package: m = 1 is tests/test_prover_batch.py's plain case, m > 1
    its matrix case (aggregation, extension degree, a minimum-value promise
    on slot 0)."""
    params = _params(pkg, bit_length, m, deg)
    pc = params.pc_gens
    statements, witnesses = [], []
    for i in range(B):
        openings, commitments, promises = [], [], []
        for j in range(m):
            if m == 1:
                v, promise = (5 + i) % (1 << bit_length), None
            else:
                v = ((1 << (bit_length - 1)) + 3 * i + j) % (1 << bit_length)
                promise = min(2, v) if j == 0 else None
            blinds = [_det(f"pb-{i}-{j}-{k}") for k in range(deg)]
            openings.append(pkg.CommitmentOpening(v, blinds))
            commitments.append(pc.commit(v, blinds))
            promises.append(promise)
        nonce = _det(f"pb-seed-{i}") if seeded else None
        statements.append(pkg.RangeStatement.init(params, commitments, promises, nonce))
        witnesses.append(pkg.RangeWitness.init(openings))
    return statements, witnesses


def _state(transcript):
    st = transcript.strobe
    return bytes(np.asarray(st.state).tobytes()), st.pos, st.pos_begin, st.cur_flags


@pytest.mark.parametrize(
    "seeded, bit_length, m, deg",
    [(True, 4, 1, 1), (False, 4, 1, 1), (False, 8, 2, 2), (True, 4, 1, 6), (False, 4, 1, 6), (False, 4, 4, 2),
     (False, 4, 4, 6)],
    # an aggregated statement takes no seed nonce (the reference refuses mask recovery there): m = 4 is unseeded
    ids=["seeded", "unseeded", "aggregated", "degree6_seeded", "degree6_unseeded", "m4", "m4_degree6"],
)
def test_prove_batch_matches_jax_sequential(seeded, bit_length, m, deg):
    B, seed = 2, 4242
    t_statements, t_witnesses = _setup(tbp, seeded, bit_length, m, deg, B)
    j_statements, j_witnesses = _setup(jbp, seeded, bit_length, m, deg, B)

    batch_transcripts = [tbp.Transcript(b"pb") for _ in range(B)]
    proofs = tbp.RangeProof.prove_batch_with_rng(
        batch_transcripts, t_statements, t_witnesses, tbp.SeededRng(seed), device="cpu"
    )
    for lane in range(B):
        seq_t = jbp.Transcript(b"pb")
        seq = jbp.RangeProof.prove_with_rng(seq_t, j_statements[lane], j_witnesses[lane], LaneRng(seed, lane))
        assert proofs[lane].to_bytes() == seq.to_bytes()
        # the caller's transcript advances exactly like the sequential one's
        assert _state(batch_transcripts[lane]) == _state(seq_t)

    # the proofs verify through the port and through the JAX package
    action = "RECOVER_AND_VERIFY" if seeded else "VERIFY_ONLY"
    masks = tbp.RangeProof.verify_batch(
        [tbp.Transcript(b"pb") for _ in range(B)], t_statements, proofs, getattr(tbp.VerifyAction, action), device="cpu"
    )
    jmasks = jbp.RangeProof.verify_batch(
        [jbp.Transcript(b"pb") for _ in range(B)], j_statements,
        [jbp.RangeProof.from_bytes(p.to_bytes()) for p in proofs], getattr(jbp.VerifyAction, action), engine="host",
    )
    if seeded:
        for mask, jmask, witness in zip(masks, jmasks, t_witnesses):
            assert mask.blindings() == jmask.blindings() == witness.openings[0].r
    else:
        assert masks == jmasks == [None] * B


@pytest.mark.parametrize("cell", CELLS[:2], ids=["golden1", "golden2"])
def test_prove_with_rng_reproduces_golden(cell):
    """The port's sequential host prover, fed as scripts/gen_golden.py feeds
    the JAX package's, reproduces the pinned proofs byte for byte."""
    seed, deg = cell["seed"], cell["extension_degree"]
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(deg))
    params = tbp.RangeParameters.init(cell["bits"], len(cell["values"]), pc)
    commitments = [pc.commit(v, bl) for v, bl in zip(cell["values"], cell["blindings"])]
    assert [hr.compress(c).hex() for c in commitments] == cell["commitments"]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    statement = tbp.RangeStatement.init(params, commitments, mv, seed_nonce=cell["seed_nonce"])
    witness = tbp.RangeWitness.init([tbp.CommitmentOpening(v, bl) for v, bl in zip(cell["values"], cell["blindings"])])
    transcript = tbp.Transcript(b"golden")
    proof = tbp.RangeProof.prove_with_rng(transcript, statement, witness, tbp.SeededRng(seed))
    assert proof.to_bytes().hex() == cell["proof"]
    # lane 0 of a one-lane batch is the same stream: the batched prover gives the same bytes and state
    batch_t = [tbp.Transcript(b"golden")]
    batch = tbp.RangeProof.prove_batch_with_rng(batch_t, [statement], [witness], tbp.SeededRng(seed), device="cpu")
    assert batch[0].to_bytes().hex() == cell["proof"]
    assert _state(batch_t[0]) == _state(transcript)


def test_prove_uses_os_rng():
    statements, witnesses = _setup(tbp, False, B=1)
    proofs = [tbp.RangeProof.prove(tbp.Transcript(b"os"), statements[0], witnesses[0]) for _ in range(2)]
    assert proofs[0].to_bytes() != proofs[1].to_bytes()  # fresh masks each time
    tbp.RangeProof.verify_batch(
        [tbp.Transcript(b"os")] * 2, statements * 2, proofs, tbp.VerifyAction.VERIFY_ONLY, device="cpu"
    )


def _prove(statements, witnesses, transcripts=None):
    transcripts = [tbp.Transcript(b"pb") for _ in statements] if transcripts is None else transcripts
    return tbp.RangeProof.prove_batch_with_rng(transcripts, statements, witnesses, tbp.SeededRng(1), device="cpu")


def _wrong_opening(witness):
    o = witness.openings[0]
    return tbp.RangeWitness.init([tbp.CommitmentOpening(o.v ^ 1, o.r)])


ERRORS = {
    "empty": (tbp.InvalidArgument, "Batch prove needs equal non-empty inputs", lambda s, w, o: ([], [])),
    "unequal": (tbp.InvalidArgument, "Batch prove needs equal non-empty inputs", lambda s, w, o: (s, w[:1])),
    "generators": (
        tbp.InvalidArgument, "Batch prove needs identical generators",
        lambda s, w, o: ([s[0], _setup(tbp, True, bit_length=8, B=1)[0][0]], w),
    ),
    "aggregation": (
        tbp.InvalidArgument, "Batch prove needs a uniform aggregation factor",
        lambda s, w, o: ([s[0], o["agg"][0][0]], [w[0], o["agg"][1][0]]),
    ),
    "seed_nonce": (
        tbp.InvalidArgument, "Batch prove needs uniform seed nonce presence",
        lambda s, w, o: ([s[0], _setup(tbp, False)[0][1]], w),
    ),
    "openings": (
        tbp.InvalidLength, "Witness openings and statement commitments do not match!",
        lambda s, w, o: (s, [w[0], o["agg"][1][0]]),
    ),
    "degree": (
        tbp.InvalidLength, "Witness and statement extension degrees do not match!",
        lambda s, w, o: (s, [w[0], tbp.RangeWitness.init([tbp.CommitmentOpening(6, [1, 2])])]),
    ),
    "capacity": (
        tbp.InvalidLength, "Value exceeds bit vector capacity!",
        lambda s, w, o: (s, [w[0], tbp.RangeWitness.init([tbp.CommitmentOpening(16, w[1].openings[0].r)])]),
    ),
    "opening": (tbp.InvalidArgument, "Witness opening is invalid!", lambda s, w, o: (s, [w[0], _wrong_opening(w[1])])),
    "minimum": (
        tbp.InvalidArgument, "Minimum value is larger than value",
        lambda s, w, o: (
            [s[0], tbp.RangeStatement.init(s[1].generators, s[1].commitments, [7], s[1].seed_nonce)], w,
        ),
    ),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_prove_batch_argument_errors(case):
    """Each argument check of the batched prover, with the JAX package's
    error class and message."""
    statements, witnesses = _setup(tbp, True)
    other = {"agg": _setup(tbp, False, m=2, B=1)} if case in ("aggregation", "openings") else {}
    exc, message, mutate = ERRORS[case]
    bad_statements, bad_witnesses = mutate(statements, witnesses, other)
    with pytest.raises(exc) as info:
        _prove(bad_statements, bad_witnesses, [tbp.Transcript(b"pb") for _ in statements])
    assert str(info.value) == message


def test_prove_batch_needs_lockstep_transcripts():
    statements, witnesses = _setup(tbp, True)
    with pytest.raises(ValueError):
        _prove(statements, witnesses, [tbp.Transcript(b"pb"), tbp.Transcript(b"another label")])
