"""The port's `RangeProof.verify_batches_pipelined` on the CPU, after
tests/test_pipelined.py: results in batch order and equal to per-batch
`verify_batch`, the lowest-indexed failure raised, nothing dispatched once
a failure is known, a mixed-shape stream, the 256-proof cap applied to each
batch, and BPPT_PIPELINE_LOOKAHEAD's fallback to 2 where the JAX package's
bare `int()` would raise or take 1.

Proofs come from the port's sequential host prover with seeded RNGs; tiny
shapes (2- and 4-bit) keep the file cheap.
"""

import hashlib

import pytest
import torch

import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.models import range_proof as rp
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores

VERIFY_ONLY = tbp.VerifyAction.VERIFY_ONLY
RECOVER_AND_VERIFY = tbp.VerifyAction.RECOVER_AND_VERIFY


def _det(tag: str) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % hr.L


def _prove(params, values, tag, seeded=True):
    """(statement, witness blindings, proof) for one statement of `values`."""
    pc = params.pc_gens
    blinds = [[_det(f"{tag}-{i}")] for i in range(len(values))]
    comms = [pc.commit(v, b) for v, b in zip(values, blinds)]
    st = tbp.RangeStatement.init(params, comms, [None] * len(values), _det(f"{tag}-seed") if seeded else None)
    wit = tbp.RangeWitness.init([tbp.CommitmentOpening(v, b) for v, b in zip(values, blinds)])
    proof = tbp.RangeProof.prove_with_rng(tbp.Transcript(b"pl"), st, wit, tbp.SeededRng(len(tag)))
    return st, blinds[0], proof


@pytest.fixture(scope="module")
def stream():
    """Six 4-bit m=1 batches of sizes 2, 1, 3, 1, 1, 1 with distinct values,
    and one m=2 statement for mixed batches."""
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1))
    params = tbp.RangeParameters.init(4, 1, pc)
    batches, k = [], 0
    for size in (2, 1, 3, 1, 1, 1):
        cells = [_prove(params, [k + i], f"pl{k + i}") for i in range(size)]
        batches.append(([c[0] for c in cells], [c[1] for c in cells], [c[2] for c in cells]))
        k += size
    aggregated = _prove(tbp.RangeParameters.init(4, 2, pc), [3, 12], "plm", seeded=False)
    return batches, aggregated


def _ts(n):
    return [tbp.Transcript(b"pl") for _ in range(n)]


def _run(batches, action=VERIFY_ONLY):
    return tbp.RangeProof.verify_batches_pipelined([(_ts(len(p)), s, p) for s, p in batches], action, device="cpu")


def _tampered(proof, field="r1"):
    bad = tbp.RangeProof.from_bytes(proof.to_bytes())
    setattr(bad, field, (getattr(bad, field) + 1) % hr.L)
    return bad


def _non_canonical(proof):
    bad = tbp.RangeProof.from_bytes(proof.to_bytes())
    bad.a = (hr.P + 1).to_bytes(32, "little")
    return bad


def test_pipelined_matches_unpipelined_in_order(stream):
    batches, _ = stream
    out = _run([(s, p) for s, _, p in batches[:3]], RECOVER_AND_VERIFY)
    assert len(out) == 3
    for masks, (statements, blinds, proofs) in zip(out, batches):
        ref = tbp.RangeProof.verify_batch(_ts(len(proofs)), statements, proofs, RECOVER_AND_VERIFY, device="cpu")
        assert [m.blindings() for m in masks] == [m.blindings() for m in ref] == blinds


def test_pipelined_first_failure_wins(stream):
    """The lowest-indexed failing batch raises, whichever failure surfaces
    first and whatever its kind."""
    batches, _ = stream
    plain = [(s, p) for s, _, p in batches]
    (s1, p1), (s2, p2) = plain[1], plain[2]
    tampered = (s1, [_tampered(p1[0])])  # fails at its verdict
    non_canonical = (s2, [p2[0], _non_canonical(p2[1]), p2[2]])  # fails at its verdict too, as InvalidArgument
    with pytest.raises(tbp.VerificationFailed):
        _run([plain[0], tampered, non_canonical])
    with pytest.raises(tbp.InvalidArgument, match="Member 'a'"):
        _run([plain[0], (s1, [_non_canonical(p1[0])]), (s2, [_tampered(p2[0]), p2[1], p2[2]])])
    # an argument error in a LATER batch (raised at its dispatch, before the earlier verdicts are read)
    # must not shadow an earlier batch's failure
    with pytest.raises(tbp.VerificationFailed):
        _run([plain[0], tampered, (s2, [])])
    with pytest.raises(tbp.InvalidArgument, match="length empty"):
        _run([plain[0], (s2, [])])


@pytest.mark.parametrize("lookahead, dispatched", [("1", 3), ("2", 4)])
def test_pipelined_dispatches_nothing_after_a_failure(stream, monkeypatch, lookahead, dispatched):
    """Batch 1 fails at its verdict.  With one fetch a pump that is known
    once batch 2 is dispatched, with two once batches 2 and 3 are: the
    other batches of the six are never dispatched."""
    batches, _ = stream
    plain = [(s, p) for s, _, p in batches]
    plain[1] = (plain[1][0], [_tampered(plain[1][1][0])])
    monkeypatch.setenv("BPPT_PIPELINE_LOOKAHEAD", lookahead)
    calls = []
    dispatch = tbp.RangeProof._verify_device_dispatch
    monkeypatch.setattr(tbp.RangeProof, "_verify_device_dispatch",
                        staticmethod(lambda *a: calls.append(len(a[2])) or dispatch(*a)))
    with pytest.raises(tbp.VerificationFailed):
        _run(plain)
    assert calls == [len(p) for _, p in plain[:dispatched]]


def test_pipelined_mixed_shape_stream(stream):
    """A single-shape batch (device replay), then a batch mixing m=2 and m=1
    (host replay, two shape groups), in one stream."""
    batches, (s_agg, _, p_agg) = stream
    s0, _, p0 = batches[0]
    mixed = ([s_agg, s0[0]], [p_agg, p0[0]])
    assert _run([(s0, p0), mixed]) == [[None, None], [None, None]]
    with pytest.raises(tbp.VerificationFailed):
        _run([(s0, p0), ([s_agg, s0[0]], [_tampered(p_agg, "s1"), p0[0]])])


def test_pipelined_batch_cap_256_per_batch():
    """Proofs beyond MAX_RANGE_PROOF_BATCH_SIZE=256 are ignored in each batch
    of the stream and contribute no masks (range_proof.rs:740-749) -- even
    an invalid proof at position 257."""
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1))
    st, _, proof = _prove(tbp.RangeParameters.init(2, 1, pc), [2], "cap")
    out = _run([([st] * 257, [proof] * 256 + [_tampered(proof)]), ([st], [proof])])
    assert out == [[None] * 256, [None]]


@pytest.mark.parametrize("value, want", [(None, 2), ("x", 2), ("0", 2), ("-3", 2), ("", 2), ("1", 1), ("3", 3)])
def test_lookahead_falls_back_to_2(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("BPPT_PIPELINE_LOOKAHEAD", raising=False)
    else:
        monkeypatch.setenv("BPPT_PIPELINE_LOOKAHEAD", value)
    assert rp._pipeline_lookahead() == want


def test_stream_runs_under_an_unparsable_lookahead(stream, monkeypatch):
    batches, _ = stream
    monkeypatch.setenv("BPPT_PIPELINE_LOOKAHEAD", "x")
    assert _run([(s, p) for s, _, p in batches[:2]]) == [[None, None], [None]]
