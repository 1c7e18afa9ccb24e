"""The port's tracing (`utils/trace.py`) and its sites, on the CPU.

Off by default and then free of records; nesting, self time and request
ids; `reset`, `snapshot` and the bounded record list; the verify stream's
and the batched prover's spans; and tracing on or off changes no proof
byte, no transcript state and no verdict.  Tiny shapes (4-bit proofs) keep
the file cheap.
"""

import hashlib
import sys
import threading
import time

import pytest
import torch

import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.native import cuda
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.utils import trace

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores

VERIFY_ONLY = tbp.VerifyAction.VERIFY_ONLY
SIX = [[v] for v in range(1, 7)]
PROVE_SPANS = ["prove.arg_checks", "prove.transcript", "prove.dispatch", "prove.readback", "prove.assemble"]


def _det(tag: str) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % hr.L


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def params():
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1))
    return tbp.RangeParameters.init(4, 2, pc)


def _statements(params, values, tag):
    """Statements (seed nonces on m = 1) and witnesses, one a list of values."""
    statements, witnesses = [], []
    for i, vals in enumerate(values):
        blinds = [[_det(f"{tag}-{i}-{j}")] for j in range(len(vals))]
        comms = [params.pc_gens.commit(v, b) for v, b in zip(vals, blinds)]
        nonce = _det(f"{tag}-{i}-seed") if len(vals) == 1 else None
        statements.append(tbp.RangeStatement.init(params, comms, [None] * len(vals), nonce))
        witnesses.append(tbp.RangeWitness.init([tbp.CommitmentOpening(v, b) for v, b in zip(vals, blinds)]))
    return statements, witnesses


def _prove(params, values, tag):
    """(statements, proofs, final transcript states) of one batched prove."""
    statements, witnesses = _statements(params, values, tag)
    transcripts = [tbp.Transcript(b"tr") for _ in statements]
    proofs = tbp.RangeProof.prove_batch_with_rng(transcripts, statements, witnesses, tbp.SeededRng(7), device="cpu")
    return statements, proofs, [t.strobe.state.tobytes() for t in transcripts]


@pytest.fixture(scope="module")
def stream(params):
    """Three single-shape m = 1 batches of 2 proofs from one prove, one
    m = 2 proof, and the prove's proof bytes and final transcript states,
    all made with tracing off, and the snapshot those proves left."""
    trace.disable()
    trace.reset()
    statements, proofs, states = _prove(params, SIX, "six")
    batches = [(statements[k : k + 2], proofs[k : k + 2]) for k in range(0, 6, 2)]
    agg_statements, agg_proofs, _ = _prove(params, [[3, 12]], "agg")
    off = trace.snapshot()
    return batches, (agg_statements[0], agg_proofs[0]), ([p.to_bytes() for p in proofs], states), off


def _verify(batches):
    """The stream's outcome: its masks, or its error's class and message."""
    try:
        return tbp.RangeProof.verify_batches_pipelined(
            [([tbp.Transcript(b"tr") for _ in p], s, p) for s, p in batches], VERIFY_ONLY, device="cpu")
    except tbp.ProofError as exc:
        return (type(exc).__name__, str(exc))


def _tampered(proof):
    bad = tbp.RangeProof.from_bytes(proof.to_bytes())
    bad.r1 = (bad.r1 + 1) % hr.L
    return bad


def test_torch_trace_is_off_by_default(stream):
    assert trace.span("a") is trace.span("b")  # one shared no-op object
    empty = {"spans": {}, "timers": {}, "launches": {}, "dropped": 0}
    assert stream[3] == empty  # the fixture's proves
    before = dict(cuda.launches)
    assert _verify(stream[0]) == [[None, None]] * 3
    assert trace.snapshot() == empty and trace.records() == []
    assert dict(cuda.launches) == before


def test_torch_trace_nesting_self_time_and_request_ids():
    trace.enable()
    trace.new_call()
    trace.new_call()
    with trace.span("outer", 3):
        time.sleep(0.002)
        with trace.span("inner"):
            time.sleep(0.004)
        with trace.span("inner", 5):
            pass
    with trace.span("alone"):
        pass
    recs = {(r["name"], r["request"][1]): r for r in trace.records()}
    outer, inner, other = recs["outer", 3], recs["inner", 3], recs["inner", 5]
    assert outer["request"] == inner["request"] == (2, 3) and other["request"] == (2, 5)
    assert inner["parent"] == other["parent"] == outer["seq"] and outer["parent"] == -1
    assert recs["alone", 0]["parent"] == -1
    assert outer["start_ns"] <= inner["start_ns"] < inner["end_ns"] <= outer["end_ns"]
    spans = trace.snapshot()["spans"]
    assert spans["inner"]["count"] == 2 and spans["outer"]["count"] == 1
    assert spans["outer"]["self_s"] == pytest.approx(spans["outer"]["total_s"] - spans["inner"]["total_s"], abs=1e-9)
    assert spans["outer"]["self_s"] >= 0.002 and spans["inner"]["total_s"] >= 0.004
    assert spans["inner"]["self_s"] == spans["inner"]["total_s"]


def test_torch_trace_reset_snapshot_and_capacity(monkeypatch):
    square = trace.timed("square")(lambda x: x * x)
    assert square(3) == 9
    trace.enable()
    monkeypatch.setattr(trace, "CAPACITY", 3)
    for _ in range(5):
        with trace.span("s"):
            pass
    assert square(4) == 16
    cuda.launches["trace_test"] += 2
    try:
        snap = trace.snapshot()
    finally:
        cuda.launches["trace_test"] -= 2
        del cuda.launches["trace_test"]
    assert len(trace.records()) == 3 and snap["dropped"] == 2
    assert snap["spans"]["s"]["count"] == 5  # the totals stay whole past the capacity
    assert snap["timers"]["square"]["count"] == 1 and snap["timers"]["square"]["s"] >= 0
    assert snap["launches"] == {"trace_test": 2}
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "timers": {}, "launches": {}, "dropped": 0}
    assert trace.records() == []


def test_torch_trace_threads_keep_their_own_spans():
    """More threads than cores, switching often: each thread's spans nest
    under its own, and every span and timer call is counted."""
    tick = trace.timed("tick")(lambda: None)
    threads, rounds = 16, 200

    def work(k):
        for _ in range(rounds):
            with trace.span("outer", k):
                with trace.span("inner"):
                    tick()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    snap = trace.snapshot()
    assert snap["spans"]["outer"]["count"] == snap["spans"]["inner"]["count"] == threads * rounds
    assert snap["timers"]["tick"]["count"] == threads * rounds
    recs = trace.records()
    batch_of = {r["seq"]: r["request"][1] for r in recs if r["name"] == "outer"}
    assert all(batch_of[r["parent"]] == r["request"][1] for r in recs if r["name"] == "inner")


def test_torch_trace_decode_timers(params):
    statements, _ = _statements(params, [[1], [2]], "dec")
    encodings = [c for st in statements for c in st.commitments_compressed]
    trace.enable()
    points = [hr.decompress(c) for c in encodings]
    for p in points:
        tbp.RangeStatement.init(params, [p], [None])
    [tbp.Transcript(b"tr") for _ in range(3)]
    tbp.Transcript(b"tr").clone()  # a clone sets nothing up
    timers = trace.snapshot()["timers"]
    assert {k: v["count"] for k, v in timers.items()} == {
        "ristretto.decompress": 2, "statement.init": 2, "transcript.init": 4}


def test_torch_trace_pipelined_spans_a_batch(stream):
    batches = stream[0]
    trace.enable()
    assert _verify(batches) == [[None, None]] * 3
    recs = trace.records()
    calls = {r["request"][0] for r in recs}
    assert len(calls) == 1 and calls != {0}
    for idx in range(3):
        names = sorted(r["name"] for r in recs if r["request"][1] == idx)
        assert names == ["verify.continue"] * 2 + ["verify.dispatch"] + ["verify.wait"] * 2
    assert {r["request"][1] for r in recs} == {0, 1, 2}
    assert "verify.host_replay" not in trace.snapshot()["spans"]


def test_torch_trace_host_replay_is_a_child_of_dispatch(stream):
    batches, (agg_statement, agg_proof) = stream[:2]
    statements, proofs = batches[0]
    trace.enable()
    assert _verify([(statements + [agg_statement], proofs + [agg_proof])]) == [[None, None, None]]
    recs = trace.records()
    (dispatch,) = [r for r in recs if r["name"] == "verify.dispatch"]
    (replay,) = [r for r in recs if r["name"] == "verify.host_replay"]
    assert replay["parent"] == dispatch["seq"] and replay["request"] == dispatch["request"]
    spans = trace.snapshot()["spans"]
    assert spans["verify.wait"]["count"] == 1 and spans["verify.continue"]["count"] == 1


def test_torch_trace_prove_spans_a_call(params):
    trace.enable()
    _prove(params, [[1], [2]], "p1")
    spans = trace.snapshot()["spans"]
    assert {name: spans[name]["count"] for name in ["prove"] + PROVE_SPANS} == dict.fromkeys(["prove"] + PROVE_SPANS, 1)
    recs = trace.records()
    (top,) = [r for r in recs if r["name"] == "prove"]
    assert sorted(r["name"] for r in recs if r["parent"] == top["seq"]) == sorted(PROVE_SPANS)
    assert {r["request"] for r in recs} == {top["request"]} and top["request"][0] > 0
    children_s = sum(spans[name]["total_s"] for name in PROVE_SPANS)
    assert spans["prove"]["self_s"] == pytest.approx(spans["prove"]["total_s"] - children_s, abs=1e-8)


def test_torch_trace_changes_no_output(params, stream):
    batches, _, (proof_bytes, states), _ = stream
    refused = [(batches[1][0], [batches[1][1][0], _tampered(batches[1][1][1])])]
    outcome = _verify(refused)
    assert outcome[0] == "VerificationFailed"
    trace.enable()
    _, proofs, states_on = _prove(params, SIX, "six")
    assert [p.to_bytes() for p in proofs] == proof_bytes and states_on == states
    assert _verify(refused) == outcome
    assert trace.snapshot()["spans"]["verify.wait"]["count"] == 2
