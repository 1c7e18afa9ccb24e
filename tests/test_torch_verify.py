"""The port's batch verifier (`verify_batch(engine="device", device="cpu")`)
against the JAX package's host oracle engine and the golden vectors.

Proofs come from the JAX package's host prover with seeded RNGs and cross
to the port as canonical bytes; statements are rebuilt from the same host
points.  Verdicts, error types and messages, challenges and recovered masks
must be identical.  On the CPU the port runs its kernels' plain versions.
"""

import functools
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


@functools.lru_cache(maxsize=None)
def _port_params(bits, max_m, degree):
    """One port RangeParameters a shape for the whole module, as an
    application keeps one: its generator tables are built once a parameter
    set, not once a statement."""
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(degree))
    return tbp.RangeParameters.init(bits, max_m, pc)


def _port_statement(bits, max_m, degree, commitments, min_values, seed_nonce):
    return tbp.RangeStatement.init(_port_params(bits, max_m, degree), commitments, min_values, seed_nonce)


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


@pytest.fixture(scope="module")
def mixed4():
    """Two shape groups interleaved: m=1 (2 rounds), m=2 (3 rounds), m=1, m=2;
    4-bit proofs, the m=1 ones seeded for mask recovery."""
    return [_prove(4, [5], max_m=2, seed=21), _prove(4, [6, 7], max_m=2, seed=22, seed_nonce=False),
            _prove(4, [9], max_m=2, seed=23), _prove(4, [1, 14], max_m=2, seed=24, seed_nonce=False)]


def test_mixed_shapes_left_for_later_slice(mixed4):
    """Mixed shapes were refused (NotImplementedError) until the device engine
    gained `group_contrib` and `combine_groups_msm`: the batch verifies."""
    got, want = _both(mixed4, "VERIFY_ONLY")
    assert got == want == [None] * 4


@pytest.mark.parametrize("action", ACTIONS)
def test_mixed_shape_batch_matches_jax_host(mixed4, action):
    """Verdict and masks of a two-group batch equal the JAX host engine's."""
    got, want = _both(mixed4, action)
    assert got == want
    if action != "VERIFY_ONLY":
        assert got[0] is not None and got[1] is None and got[2] is not None


def test_mixed_shape_tampered_proof_rejected(mixed4):
    got, want = _both(mixed4, "VERIFY_ONLY", _set("s1", lambda p: (p.s1 + 1) % hr.L, index=3))
    assert got == want == ("VerificationFailed", "Range proof batch not valid")


@pytest.mark.parametrize("action", ["VERIFY_ONLY", "RECOVER_AND_VERIFY"])
def test_mixed_shape_noncanonical_reported_in_proof_order(mixed4, action):
    """Proof 2 (the m=1 group, listed first) has a bad A, proof 1 (the m=2
    group) a bad L: proof 1's error is raised, in the JAX device engine's
    wording, whichever group the engine works through first."""
    mutate = _then(_set("a", lambda p: _ODD, index=2), _set("li", lambda p: [p.li[0], _BIG, p.li[2]], index=1))
    got, want = _both(mixed4, action, mutate)
    assert got == _device_wording(want) == (
        "InvalidArgument", "An item in member 'L' was not the canonical encoding of a point")


def test_device_replay_routing(mixed4, batch8, monkeypatch):
    """The JAX package's condition: a single-shape, well-formed batch whose
    transcripts stack replays on the device; a mixed batch, and one whose
    transcripts sit at different sponge positions, replay on the host."""
    calls = []
    host_replay = tbp.RangeProof._replay_challenges
    monkeypatch.setattr(tbp.RangeProof, "_replay_challenges",
                        staticmethod(lambda *a: calls.append(len(a[0])) or host_replay(*a)))
    assert _both(batch8, "VERIFY_ONLY")[0] == [None] * 3 and calls == []
    assert _both(mixed4, "VERIFY_ONLY")[0] == [None] * 4 and calls == [4]
    st_t, raw = [c[1] for c in batch8[:2]], [c[2] for c in batch8[:2]]
    proofs = [tbp.RangeProof.from_bytes(b) for b in raw]
    transcripts = [tbp.Transcript(b"torch"), tbp.Transcript(b"torch")]
    transcripts[1].append_message(b"x", b"")  # another sponge position: the lanes do not stack
    with pytest.raises(tbp.VerificationFailed):  # and lane 1's transcript is not the prover's
        tbp.RangeProof.verify_batch(transcripts, st_t, proofs, tbp.VerifyAction.VERIFY_ONLY, device="cpu")
    assert calls == [4, 2]


def _replay_stage(cells, action):
    """The device-replay dispatch of a batch, stopped at its first fetch."""
    from bulletproofs_plus_tpu_torch.models.range_proof import _FetchStage

    statements = [c[1] for c in cells]
    proofs = [tbp.RangeProof.from_bytes(c[2]) for c in cells]
    stacked = tbp.Transcript.stack([tbp.Transcript(b"torch") for _ in proofs])
    groups = {(1, len(proofs[0].li)): list(range(len(proofs)))}
    stage = tbp.RangeProof._dispatch_device_replay(stacked, statements, proofs, getattr(tbp.VerifyAction, action),
                                                   groups, statements[0], "cpu")
    assert isinstance(stage, _FetchStage)
    return stage


@pytest.mark.parametrize("flag", ["bad_identity", "bad_zero"])
def test_device_replay_flags_raise_before_structural_checks(batch8, flag):
    """The replay's flags are read before anything else: set by hand (no input
    reaches a zero challenge) on a batch whose proof 1 also has a
    non-canonical A, the flag's error wins over the structural check's."""
    bad_a = _set("a", lambda p: _ODD)([c[2] for c in batch8])
    cells = [(c[0], c[1], r) for c, r in zip(batch8, bad_a)]
    stage = _replay_stage(cells, "RECOVER_AND_VERIFY")
    vals = list(stage.fetch())
    with pytest.raises(tbp.InvalidArgument, match="Member 'a'"):
        stage.cont(vals)
    index = 1 if flag == "bad_identity" else 2
    vals[index] = vals[index].copy()
    vals[index][2] = True
    want = {"bad_identity": "Identity element cannot be added to the transcript",
            "bad_zero": "Transcript challenge cannot be zero"}[flag]
    with pytest.raises(tbp.VerificationFailed, match=want):
        stage.cont(vals)


def test_msm_identity_wrappers():
    """final_msm_is_identity and mixed_msm_is_identity: s P + (l - s) P is the
    identity, s P + (l - s + 1) P is not."""
    from bulletproofs_plus_tpu_torch.models.verifier_kernels import final_msm_is_identity, mixed_msm_is_identity
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints

    p = hr.point_mul(12345, hr.BASEPOINT)
    s = _det("wrapper")
    pts = ed.from_host([p, p], device="cpu")

    def scalars(values):
        return torch.as_tensor(pack_ints(values).astype("int64"))

    assert bool(final_msm_is_identity(scalars([s, hr.L - s]), pts))
    assert not bool(final_msm_is_identity(scalars([s, hr.L - s + 1]), pts))
    one = ed.from_host([p], device="cpu")
    assert bool(mixed_msm_is_identity(scalars([s]), one, scalars([hr.L - s]), one))
    assert not bool(mixed_msm_is_identity(scalars([s]), one, scalars([1]), one))


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
    with pytest.raises(tbp.VerificationFailed):  # the same proof inside the cap fails its batch
        tbp.RangeProof.verify_batch(
            [tbp.Transcript(b"torch") for _ in range(2)], [st_t] * 2, proofs[:1] + proofs[256:],
            tbp.VerifyAction.VERIFY_ONLY, device="cpu",
        )


def test_argument_errors_and_engines():
    with pytest.raises(tbp.InvalidArgument):
        tbp.RangeProof.verify_batch([], [], [], tbp.VerifyAction.VERIFY_ONLY, device="cpu")
    st_j, st_t, raw = _prove(4, [3], seed=41)
    proof = tbp.RangeProof.from_bytes(raw)
    with pytest.raises(tbp.InvalidArgument):
        tbp.RangeProof.verify_batch([tbp.Transcript(b"torch")], [st_t, st_t], [proof], tbp.VerifyAction.VERIFY_ONLY)
    # engine="host" is the exact-integer oracle (tests/test_torch_host_engine.py); an unknown engine is refused
    assert tbp.RangeProof.verify_batch(
        [tbp.Transcript(b"torch")], [st_t], [proof], tbp.VerifyAction.VERIFY_ONLY, engine="host"
    ) == [None]
    with pytest.raises(ValueError, match="unknown engine"):
        tbp.RangeProof.verify_batch(
            [tbp.Transcript(b"torch")], [st_t], [proof], tbp.VerifyAction.VERIFY_ONLY, engine="oracle"
        )


def _one_bit_cells(degree):
    """Two seeded one-bit proofs (n = 1, m = 1: no rounds) of extension
    `degree`, values 1 and 0, from the JAX package's host prover.  A proof
    with no rounds has no byte form (`from_bytes` needs an L/R pair, as the
    reference's does), so it crosses to the port field by field."""
    pc = jbp.create_pedersen_gens_with_extension_degree(jbp.ExtensionDegree(degree))
    params = jbp.RangeParameters.init(1, 1, pc)
    cells = []
    for value, seed in ((1, 3), (0, 4)):
        blinds = [_det(f"one{seed}-{k}") for k in range(degree)]
        comms = [pc.commit(value, blinds)]
        nonce = _det(f"one-nonce{seed}")
        st = jbp.RangeStatement.init(params, comms, [None], nonce)
        wit = jbp.RangeWitness.init([jbp.CommitmentOpening(value, blinds)])
        p = jbp.RangeProof.prove_with_rng(jbp.Transcript(b"one"), st, wit, jbp.SeededRng(seed))
        assert not p.li
        port = tbp.RangeProof(a=p.a, a1=p.a1, b=p.b, r1=p.r1, s1=p.s1, d1=list(p.d1), li=[], ri=[],
                              extension_degree=tbp.ExtensionDegree(degree))
        cells.append((st, _port_statement(1, 1, degree, comms, [None], nonce), p, port))
    return cells


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("degree", [1, 2])
def test_one_bit_proofs_on_device_engine(degree, action):
    """One-bit proofs (no rounds, no round challenges) through the device
    engine on the CPU give the port's host engine's verdicts and masks and
    the JAX package's host engine's: the device replay hands over no round
    challenges, and the scalar pass inverts y and y - 1 alone."""
    cells = _one_bit_cells(degree)

    def outcome(pkg, statements, proofs, **kw):
        masks = pkg.RangeProof.verify_batch([pkg.Transcript(b"one") for _ in proofs], statements, proofs,
                                            getattr(pkg.VerifyAction, action), **kw)
        return [None if m is None else m.blindings() for m in masks]

    port_statements, port_proofs = [c[1] for c in cells], [c[3] for c in cells]
    got = outcome(tbp, port_statements, port_proofs, engine="device", device="cpu")
    assert got == outcome(tbp, port_statements, port_proofs, engine="host")
    assert got == outcome(jbp, [c[0] for c in cells], [c[2] for c in cells], engine="host")
    assert (got[0] is None) == (action == "VERIFY_ONLY")
