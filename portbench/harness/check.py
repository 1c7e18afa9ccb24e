"""The comparison that decides a run's `correct`: what the timed path
produced, against the plain reference (portbench/reference), once the
window has closed.

  * verify cells: every call's outcome in the window (valid, or the error
    class and message of its first refused block; the blocks of a refused
    call are each verified again alone) against the reference's verdicts
    on every proof of the pool and every tampered proof; and the
    port's decode of a seeded sample of blocks (proof fields, commitment
    points, promises) against the reference's decode of the same bytes;
  * prove cells: a seeded sample of proofs, from both halves of a call and
    from the window's last call, byte for byte against the reference's
    sequential prover fed the same lane's RNG stream; and every commitment
    of the calls sampled against the reference's.

Each number compared counts disagreements, and its limit is 0.  The
reference runs in worker processes started with `spawn`, which import
numpy and the reference alone, never torch, JAX or the port.
"""

from __future__ import annotations

import multiprocessing
import os

from . import inputs

_CACHE = {}


def _init(cpus) -> None:
    if cpus:
        os.sched_setaffinity(0, cpus)


def _params(config: dict):
    from ..reference import gens

    key = (config["bits"], config["max_aggregation"], config["extension_degree"])
    if key not in _CACHE:
        pc = gens.create_pedersen_gens_with_extension_degree(gens.ExtensionDegree(config["extension_degree"]))
        _CACHE[key] = (pc, gens.RangeParameters.init(config["bits"], config["max_aggregation"], pc))
    return _CACHE[key]


def _ref_decode(params, label: bytes, wire):
    from ..reference import merlin, ristretto, statement
    from ..reference.range_proof import RangeProof

    proofs = [RangeProof.from_bytes(p) for p, _, _ in wire]
    statements = []
    for _, commitments, promises in wire:
        points = [ristretto.decompress(c) for c in commitments]
        if any(p is None for p in points):
            raise ValueError("a commitment of the traffic is not a point")
        statements.append(statement.RangeStatement.init(params, points, list(promises)))
    return [merlin.Transcript(label) for _ in wire], statements, proofs


def verify_task(config: dict, label: bytes, wire) -> list:
    """The reference's verdict on each proof of `wire`: None where it
    verifies, else (error class, message) of that proof verified alone."""
    from ..reference.errors import ProofError
    from ..reference.range_proof import RangeProof, VerifyAction

    _, params = _params(config)
    try:
        RangeProof.verify_batch(*_ref_decode(params, label, wire), VerifyAction.VERIFY_ONLY)
        return [None] * len(wire)
    except ProofError as exc:
        if len(wire) == 1:
            return [(type(exc).__name__, str(exc))]
    out = []
    for item in wire:
        try:
            RangeProof.verify_batch(*_ref_decode(params, label, [item]), VerifyAction.VERIFY_ONLY)
            out.append(None)
        except ProofError as exc:
            out.append((type(exc).__name__, str(exc)))
    return out


def prove_task(config: dict, traffic: dict, seed: int, call: int, lanes: list) -> tuple:
    """The reference's commitments of every output of prove call `call`,
    and its proofs of `lanes` of it."""
    from ..reference import merlin, ristretto, statement
    from ..reference.range_proof import RangeProof
    from ..reference.rng import LaneRng

    pc, params = _params(config)
    outs = inputs.call_outputs(seed, traffic, config, call)
    seeded = traffic.get("seed_nonce", False)
    commitments = [[pc.commit(v, bl) for v, bl in zip(o.values, o.blindings)] for o in outs]
    encoded = [[ristretto.compress(c) for c in cs] for cs in commitments]
    proofs = {}
    for lane in lanes:
        o = outs[lane]
        st = statement.RangeStatement.init(params, commitments[lane], list(o.promises), o.nonce if seeded else None)
        witness = statement.RangeWitness.init(
            [statement.CommitmentOpening(v, bl) for v, bl in zip(o.values, o.blindings)])
        proofs[lane] = RangeProof.prove_with_rng(merlin.Transcript(traffic["label"].encode()), st, witness,
                                                 LaneRng(seed, call, lane)).to_bytes()
    return encoded, proofs


def _pool(workers: int, cpus):
    ctx = multiprocessing.get_context("spawn")
    return ctx.Pool(workers, initializer=_init, initargs=(cpus,))


def verify_checks(entry, workers: int, cpus) -> dict:
    config, traffic = entry.config, entry.traffic
    label = traffic["label"].encode()
    chunk = traffic.get("reference_chunk", 64)
    tampered = {}
    for numbers, _ in entry.outcomes:
        for n in numbers:
            b = inputs.block(entry.seed, traffic, n)
            if b.tampered is not None:
                tampered[(n, b.tampered)] = entry.wire(b)[b.tampered]
    jobs = [(g, s, wire[s : s + chunk]) for g, wire in enumerate(entry.pool) for s in range(0, len(wire), chunk)]
    with _pool(workers, cpus) as pool:
        pending = [pool.apply_async(verify_task, (config, label, w)) for _, _, w in jobs]
        bad = [pool.apply_async(verify_task, (config, label, [w])) for w in tampered.values()]
        verdicts = {}
        for (g, s, w), res in zip(jobs, pending):
            for i, v in enumerate(res.get()):
                verdicts[(g, s + i)] = v
        tampered_verdicts = {key: res.get()[0] for key, res in zip(tampered, bad)}
        pool.close()
        pool.join()

    def expected(n):
        b = inputs.block(entry.seed, traffic, n)
        for pos, proof in enumerate(b.proofs):
            v = tampered_verdicts[(n, pos)] if pos == b.tampered else verdicts[proof]
            if v is not None:
                return ("error",) + tuple(v)
        return ("valid",)

    wrong = 0
    for numbers, outcome in entry.outcomes:  # a call's outcome is its first refused block's
        first = next((w for w in map(expected, numbers) if w[0] == "error"), ("valid",))
        wrong += outcome != first
    return {"verdicts_wrong": wrong, "decode_wrong": decode_wrong(entry)}


def decode_wrong(entry) -> int:
    """Disagreements between the port's decode of the kept blocks and the
    reference's decode of the same bytes."""
    from ..reference import ristretto

    _, params = _params(entry.config)
    label = entry.traffic["label"].encode()
    wrong = 0
    for n, (statements, proofs) in entry.kept.items():
        wire = entry.wire(inputs.block(entry.seed, entry.traffic, n))
        _, ref_statements, ref_proofs = _ref_decode(params, label, wire)
        wrong += abs(len(statements) - len(wire)) + abs(len(proofs) - len(wire))
        for st, pr, rst, rpr, (_, commitments, promises) in zip(statements, proofs, ref_statements, ref_proofs, wire):
            fields = ("a", "a1", "b", "r1", "s1", "d1", "li", "ri")
            same = all(getattr(pr, f) == getattr(rpr, f) for f in fields)
            same &= int(pr.extension_degree) == int(rpr.extension_degree)
            same &= [ristretto.compress(p) for p in st.commitments] == commitments
            same &= [0 if p is None else p for p in st.minimum_value_promises] == list(promises)
            same &= st.seed_nonce is None
            wrong += not same
    return wrong


def prove_checks(entry, workers: int, cpus) -> dict:
    """Proofs of `proof_sample` (call, lane) pairs and the commitments of
    their calls, against the reference."""
    calls = len(entry.made)
    batch = entry.traffic["outputs_per_call"]
    k = entry.traffic.get("proof_sample", 8)
    half = batch // 2
    picks = {calls - 1: {0, batch - 1}}  # the last call's first and last lanes
    for i, index in enumerate(inputs.sample(entry.seed, calls * batch, k - 2, inputs.CALL)):
        call, lane = divmod(index, batch)
        lane = lane % half + (half if i % 2 else 0)  # both halves of a call
        picks.setdefault(call, set()).add(lane)
    with _pool(workers, cpus) as pool:
        pending = {c: pool.apply_async(prove_task, (entry.config, entry.traffic, entry.seed, c, sorted(lanes)))
                   for c, lanes in picks.items()}
        results = {c: r.get() for c, r in pending.items()}
        pool.close()
        pool.join()
    proofs_wrong = commitments_wrong = 0
    for c, (commitments, proofs) in results.items():
        made_commitments, made_proofs = entry.made[c]
        commitments_wrong += sum(a != b for a, b in zip(made_commitments, commitments))
        commitments_wrong += abs(len(made_commitments) - len(commitments))
        proofs_wrong += sum(made_proofs[lane] != proof for lane, proof in proofs.items())
    return {"proofs_wrong": proofs_wrong, "commitments_wrong": commitments_wrong}
