"""The port's batch verifier (`verify_batch(engine="device", device="cpu")`)
against the JAX package's host oracle engine and the golden vectors.

Proofs come from the JAX package's host prover with seeded RNGs and cross
to the port as canonical bytes; statements are rebuilt from the same host
points.  Verdicts, error types and messages, challenges and recovered masks
must be identical.  On the CPU the port runs its kernels' plain versions.
"""

import hashlib
import json
import os

import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_vectors.json")
with open(GOLDEN) as f:
    CELLS = json.load(f)

ACTIONS = ["VERIFY_ONLY", "RECOVER_AND_VERIFY", "RECOVER_ONLY"]
torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def _det(tag: str) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % hr.L


def _port_statement(bits, max_m, degree, commitments, min_values, seed_nonce):
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(degree))
    params = tbp.RangeParameters.init(bits, max_m, pc)
    return tbp.RangeStatement.init(params, commitments, min_values, seed_nonce)


def _prove(bits, values, max_m=1, degree=1, seed=1, label=b"torch", seed_nonce=True):
    """One JAX-proved statement: (jax statement, port statement, proof bytes)."""
    pc = jbp.create_pedersen_gens_with_extension_degree(jbp.ExtensionDegree(degree))
    params = jbp.RangeParameters.init(bits, max_m, pc)
    blinds = [[_det(f"b{seed}-{i}-{k}") for k in range(degree)] for i in range(len(values))]
    comms = [pc.commit(v, b) for v, b in zip(values, blinds)]
    nonce = _det(f"nonce{seed}") if seed_nonce else None
    st = jbp.RangeStatement.init(params, comms, [None] * len(values), nonce)
    wit = jbp.RangeWitness.init([jbp.CommitmentOpening(v, b) for v, b in zip(values, blinds)])
    proof = jbp.RangeProof.prove_with_rng(jbp.Transcript(label), st, wit, jbp.SeededRng(seed))
    return st, _port_statement(bits, max_m, degree, comms, [None] * len(values), nonce), proof.to_bytes()


@pytest.fixture(scope="module")
def batch8():
    return [_prove(8, [3 + 50 * i], seed=i + 1) for i in range(3)]


def _outcome(pkg, statements, proof_bytes, action, label=b"torch", **kw):
    """(masks as ints | None per proof) or (error class name, message)."""
    proofs = [pkg.RangeProof.from_bytes(b) for b in proof_bytes]
    try:
        masks = pkg.RangeProof.verify_batch(
            [pkg.Transcript(label) for _ in proofs], statements, proofs, getattr(pkg.VerifyAction, action), **kw
        )
    except pkg.ProofError as exc:
        return (type(exc).__name__, str(exc))
    return [None if m is None else m.blindings() for m in masks]


def _both(cells, action, mutate=None):
    jst = [c[0] for c in cells]
    tst = [c[1] for c in cells]
    raw = [c[2] for c in cells]
    if mutate is not None:
        raw = mutate(raw)
    want = _outcome(jbp, jst, raw, action, engine="host")
    got = _outcome(tbp, tst, raw, action, engine="device", device="cpu")
    return got, want


@pytest.mark.parametrize("action", ACTIONS)
def test_verify_matches_jax_host(batch8, action):
    got, want = _both(batch8, action)
    assert got == want
    if action != "VERIFY_ONLY":
        assert all(m is not None for m in got)


def test_tampered_proof_rejected(batch8):
    def tamper(raw):
        p = jbp.RangeProof.from_bytes(raw[1])
        p.r1 = (p.r1 + 1) % hr.L
        return [raw[0], p.to_bytes(), raw[2]]

    got, want = _both(batch8, "VERIFY_ONLY", tamper)
    assert got == want == ("VerificationFailed", "Range proof batch not valid")


def _set(field, value, index=1):
    def mutate(raw):
        p = jbp.RangeProof.from_bytes(raw[index])
        setattr(p, field, value(p))
        out = list(raw)
        out[index] = p
        return [r if isinstance(r, bytes) else r.to_bytes() for r in out]

    return mutate


_ODD = bytes([1]) + bytes(31)  # negative: not a canonical ristretto encoding
_BIG = (hr.P + 1).to_bytes(32, "little")  # s >= p


def _then(*mutations):
    def mutate(raw):
        for m in mutations:
            raw = m(raw)
        return raw

    return mutate


CASES = {
    "a": _set("a", lambda p: _ODD),
    "a1": _set("a1", lambda p: _BIG),
    "b": _set("b", lambda p: _ODD, index=2),
    "L": _set("li", lambda p: [p.li[0], _ODD, p.li[2]]),
    "R_then_later_a": _then(_set("ri", lambda p: [_BIG] + p.ri[1:]), _set("a", lambda p: _ODD, index=2)),
    "b_and_L_same_proof": _then(_set("li", lambda p: [_BIG] + p.li[1:]), _set("b", lambda p: _ODD)),
}


def _device_wording(outcome):
    """The JAX package words a bad L/R item differently in its two engines:
    the host engine says "Member 'L' ...", its device engine (which the
    port's device engine mirrors: DeviceVerifier.raise_canonicality_row and
    RangeProof._device_structural_checks) says "An item in member 'L' ..."."""
    if isinstance(outcome, tuple) and outcome[1].startswith("Member 'L'"):
        return (outcome[0], "An item in member 'L'" + outcome[1][len("Member 'L'"):])
    return outcome


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_noncanonical_error_parity(batch8, case, action):
    """Non-canonical points raise the same error, message and member order
    as the JAX package, in every action (range_proof.rs:859-888)."""
    got, want = _both(batch8, action, CASES[case])
    assert got == _device_wording(want)
    assert got[0] == "InvalidArgument"
    if case in ("a", "b_and_L_same_proof"):
        assert got[1] == f"Member '{case[0]}' was not the canonical encoding of a point"
    if case == "R_then_later_a":
        assert got[1] == "An item in member 'L' was not the canonical encoding of a point"


@pytest.mark.parametrize("action", ACTIONS)
def test_identity_point_rejected_in_transcript(batch8, action):
    """The transcript refuses the identity's encoding before any device work."""
    got, want = _both(batch8, action, _set("a1", lambda p: bytes(32)))
    assert got == want == ("VerificationFailed", "Identity element cannot be added to the transcript")


def test_oversized_lr_parity(batch8):
    st_j, st_t, raw = batch8[0]
    p = jbp.RangeProof.from_bytes(raw)
    p.li, p.ri = [p.li[0]] * 64, [p.ri[0]] * 64
    big = p.to_bytes()
    for action in ACTIONS:
        got = _outcome(tbp, [st_t], [big], action, engine="device", device="cpu")
        want = _outcome(jbp, [st_j], [big], action, engine="host")
        assert got == want
        assert got[0] == "SizeOverflow"


def _golden_statements(cell):
    commitments = [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    return _port_statement(cell["bits"], len(cell["values"]), cell["extension_degree"], commitments, mv,
                           cell["seed_nonce"])


@pytest.mark.parametrize("cell", CELLS, ids=[f"b{c['bits']}m{len(c['values'])}d{c['extension_degree']}" for c in CELLS])
def test_golden_challenges_masks_and_verdict(cell):
    statement = _golden_statements(cell)
    proof = tbp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    assert proof.to_bytes().hex() == cell["proof"]
    (challenges, _seeds) = tbp.RangeProof._replay_challenges([tbp.Transcript(b"golden")], [statement], [proof])
    y, z, es, e = challenges[0]
    assert (format(y, "064x"), format(z, "064x"), format(e, "064x")) == (cell["y"], cell["z"], cell["e"])
    assert [format(v, "064x") for v in es] == cell["round_es"]
    masks = tbp.RangeProof.verify_batch(
        [tbp.Transcript(b"golden")], [statement], [proof], tbp.VerifyAction.RECOVER_AND_VERIFY, device="cpu"
    )
    got = None if masks[0] is None else [format(b, "064x") for b in masks[0].blindings()]
    assert got == cell["mask"]


def test_mixed_shapes_left_for_later_slice():
    one = _prove(4, [5], max_m=2, seed=21)
    two = _prove(4, [6, 7], max_m=2, seed=22, seed_nonce=False)
    cells = [one, two]
    masks, want = _both(cells, "RECOVER_ONLY")
    assert masks == want and masks[0] is not None and masks[1] is None
    with pytest.raises(NotImplementedError, match="later slice"):
        tbp.RangeProof.verify_batch(
            [tbp.Transcript(b"torch")] * 2, [one[1], two[1]],
            [tbp.RangeProof.from_bytes(one[2]), tbp.RangeProof.from_bytes(two[2])],
            tbp.VerifyAction.VERIFY_ONLY, device="cpu",
        )


def test_batch_cap_ignores_proof_257():
    """range_proof.rs:740-749: only the first 256 proofs are read, so a
    tampered 257th proof neither fails the batch nor yields a mask."""
    st_j, st_t, raw = _prove(2, [2], seed=31)
    bad = jbp.RangeProof.from_bytes(raw)
    bad.r1 = (bad.r1 + 1) % hr.L
    proofs = [tbp.RangeProof.from_bytes(raw)] * 256 + [tbp.RangeProof.from_bytes(bad.to_bytes())]
    masks = tbp.RangeProof.verify_batch(
        [tbp.Transcript(b"torch") for _ in proofs], [st_t] * 257, proofs,
        tbp.VerifyAction.RECOVER_AND_VERIFY, device="cpu",
    )
    assert len(masks) == 256
    want = _outcome(jbp, [st_j], [raw], "RECOVER_AND_VERIFY", engine="host")[0]
    assert all(m.blindings() == want for m in masks)
    with pytest.raises(tbp.VerificationFailed):
        tbp.RangeProof.verify_batch(
            [tbp.Transcript(b"torch") for _ in range(256)], [st_t] * 256, proofs[:255] + proofs[256:],
            tbp.VerifyAction.VERIFY_ONLY, device="cpu",
        )


def test_argument_errors_and_engines():
    with pytest.raises(tbp.InvalidArgument):
        tbp.RangeProof.verify_batch([], [], [], tbp.VerifyAction.VERIFY_ONLY, device="cpu")
    st_j, st_t, raw = _prove(4, [3], seed=41)
    proof = tbp.RangeProof.from_bytes(raw)
    with pytest.raises(tbp.InvalidArgument):
        tbp.RangeProof.verify_batch([tbp.Transcript(b"torch")], [st_t, st_t], [proof], tbp.VerifyAction.VERIFY_ONLY)
    with pytest.raises(NotImplementedError):
        tbp.RangeProof.verify_batch(
            [tbp.Transcript(b"torch")], [st_t], [proof], tbp.VerifyAction.VERIFY_ONLY, engine="host"
        )
