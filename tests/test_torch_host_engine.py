"""The port's host engine, MSM dispatcher, pickle hooks and per-device caches
against the JAX package.

`verify_batch(engine="host")` is the exact-integer oracle whose one final
MSM goes through `ops.msm.msm`; `msm_backend="device"` runs that MSM (and
the sequential prover's five) through `msm_kernel` on the device passed,
here "cpu", where the kernels' plain versions run.  Verdicts, masks, error
classes and messages must equal the JAX package's host engine; proofs must
be byte-identical.  Tiny shapes (4-bit proofs) keep the file cheap.
"""

import hashlib
import inspect
import json
import os
import pickle

import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import msm as tmsm

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_vectors.json")
with open(GOLDEN) as f:
    CELLS = json.load(f)

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def _det(tag: str) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % hr.L


def _prove(values, max_m, seed, seed_nonce=True):
    """One proof by the JAX package's host prover: (jax statement, port statement, proof bytes)."""
    pcs = [pkg.create_pedersen_gens_with_extension_degree(pkg.ExtensionDegree(1)) for pkg in (jbp, tbp)]
    blinds = [[_det(f"h{seed}-{i}")] for i in range(len(values))]
    comms = [pcs[0].commit(v, b) for v, b in zip(values, blinds)]
    nonce = _det(f"nonce{seed}") if seed_nonce else None
    jst, tst = (pkg.RangeStatement.init(pkg.RangeParameters.init(4, max_m, pc), comms, [None] * len(values), nonce)
                for pkg, pc in zip((jbp, tbp), pcs))
    wit = jbp.RangeWitness.init([jbp.CommitmentOpening(v, b) for v, b in zip(values, blinds)])
    proof = jbp.RangeProof.prove_with_rng(jbp.Transcript(b"host"), jst, wit, jbp.SeededRng(seed))
    return jst, tst, proof.to_bytes()


@pytest.fixture(scope="module")
def mixed():
    """An m = 1 and an m = 2 proof (two shape groups), the first seeded for mask recovery."""
    return [_prove([5], 2, 61), _prove([6, 7], 2, 62, seed_nonce=False)]


def _outcome(pkg, statements, raw, action, **kw):
    proofs = [pkg.RangeProof.from_bytes(b) for b in raw]
    try:
        masks = pkg.RangeProof.verify_batch(
            [pkg.Transcript(b"host") for _ in proofs], statements, proofs, getattr(pkg.VerifyAction, action), **kw
        )
    except pkg.ProofError as exc:
        return (type(exc).__name__, str(exc))
    return [None if m is None else m.blindings() for m in masks]


def _both(cells, action, raw=None, **kw):
    raw = raw or [c[2] for c in cells]
    want = _outcome(jbp, [c[0] for c in cells], raw, action, engine="host")
    got = _outcome(tbp, [c[1] for c in cells], raw, action, engine="host", device="cpu", **kw)
    return got, want


def test_host_engine_mixed_batch_matches_jax(mixed):
    """A batch of two shape groups, which the device engine does not take
    yet: the same masks as the JAX host engine, with the final MSM on the
    device backend (its plain versions, on the CPU)."""
    got, want = _both(mixed, "RECOVER_AND_VERIFY", msm_backend="device")
    assert got == want and want[0] is not None and want[1] is None


def _with(raw, index, **fields):
    p = jbp.RangeProof.from_bytes(raw[index])
    for k, v in fields.items():
        setattr(p, k, v(p))
    return [p.to_bytes() if i == index else r for i, r in enumerate(raw)]


_ODD = bytes([1]) + bytes(31)  # negative: not a canonical ristretto encoding


@pytest.mark.parametrize("case", ["tampered", "L", "R"])
def test_host_engine_errors_match_jax(mixed, case):
    """A tampered proof fails the batch; a non-canonical L or R point is
    refused with the JAX host engine's wording, which names 'L' for an R
    point too (the device engine says "An item in member 'L' ...")."""
    raw = [c[2] for c in mixed]
    if case == "tampered":
        raw = _with(raw, 1, r1=lambda p: (p.r1 + 1) % hr.L)
    else:
        member = "li" if case == "L" else "ri"
        raw = _with(raw, 1, **{member: lambda p: [_ODD] + getattr(p, member)[1:]})
    got, want = _both(mixed, "VERIFY_ONLY", raw)
    assert got == want
    if case == "tampered":
        assert got == ("VerificationFailed", "Range proof batch not valid")
    else:
        assert got == ("InvalidArgument", "Member 'L' was not the canonical encoding of a point")


def test_prove_with_device_backend_is_byte_identical():
    """The sequential prover's five MSMs on the device backend (here the
    CPU's plain versions) give golden proof 1 byte for byte, as the host
    backend does."""
    cell = CELLS[0]
    assert (cell["bits"], len(cell["values"])) == (4, 1)
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(cell["extension_degree"]))
    params = tbp.RangeParameters.init(cell["bits"], 1, pc)
    statement = tbp.RangeStatement.init(params, [pc.commit(cell["values"][0], cell["blindings"][0])], [None],
                                        seed_nonce=cell["seed_nonce"])
    witness = tbp.RangeWitness.init([tbp.CommitmentOpening(cell["values"][0], cell["blindings"][0])])
    proofs = [
        tbp.RangeProof.prove_with_rng(tbp.Transcript(b"golden"), statement, witness, tbp.SeededRng(cell["seed"]),
                                      msm_backend=backend, device="cpu")
        for backend in ("device", "host")
    ]
    assert proofs[0].to_bytes() == proofs[1].to_bytes() == bytes.fromhex(cell["proof"])


def test_msm_dispatch_and_default_backend(monkeypatch):
    """set_default_backend refuses what it does not know; "device" runs
    device_msm on the device passed, with no fallback where that fails."""
    with pytest.raises(ValueError, match="unknown msm backend 'x'"):
        tmsm.set_default_backend("x")
    with pytest.raises(ValueError, match="unknown msm backend 'gpu'"):
        tmsm.msm([1], [hr.BASEPOINT], backend="gpu")
    pts = [hr.point_mul(k, hr.BASEPOINT) for k in (3, 5, 7)]
    scalars = [hr.L + 2, 0, 11]  # taken mod l
    want = tmsm.host_msm(scalars, pts)
    assert hr.point_equal(tmsm.msm(scalars, pts), want)
    monkeypatch.setattr(tmsm, "_default_backend", tmsm._default_backend)
    tmsm.set_default_backend("device")
    assert hr.point_equal(tmsm.msm(scalars, pts, device="cpu"), want)
    assert tmsm.msm([], [], device="cpu") == hr.IDENTITY
    with pytest.raises(ValueError):  # a device the kernels do not run on: an error, not the host
        tmsm.msm(scalars, pts, device="meta")


def test_serde_hooks_match_jax():
    """Pickling goes through the canonical codec, as the JAX package's does:
    a structured proof round-trips and pickles to its bytes, a non-canonical
    state is refused by from_bytes, and the extension degree reads from the
    first byte."""
    identity = bytes(32)
    fields = dict(a=identity, a1=identity, b=identity, r1=5, s1=7, d1=[1, 2], li=[identity] * 3, ri=[identity] * 3)
    proof = tbp.RangeProof(extension_degree=tbp.ExtensionDegree(2), **fields)
    jproof = jbp.RangeProof(extension_degree=jbp.ExtensionDegree(2), **fields)
    data = proof.to_bytes()
    assert proof.__getstate__() == jproof.__getstate__() == data
    back = pickle.loads(pickle.dumps(proof))
    assert back == proof and back.to_bytes() == data and back.li == proof.li
    bad = tbp.RangeProof.__new__(tbp.RangeProof)
    with pytest.raises(tbp.InvalidArgument, match="Invalid parsing"):
        bad.__setstate__(data[:1] + hr.L.to_bytes(32, "little") + data[33:])  # d1[0] = l: not canonical
    for cell in CELLS:
        raw = bytes.fromhex(cell["proof"])
        got = tbp.RangeProof.extension_degree_from_proof_bytes(raw)
        assert int(got) == int(jbp.RangeProof.extension_degree_from_proof_bytes(raw)) == cell["extension_degree"]
    for pkg in (tbp, jbp):
        with pytest.raises(pkg.InvalidLength, match="Serialized proof is too short"):
            pkg.RangeProof.extension_degree_from_proof_bytes(b"")


def _params(fn):
    return list(inspect.signature(fn).parameters.items())


def test_signatures_follow_jax():
    """verify_batch and prove_with_rng take JAX's parameters in JAX's order;
    the port's verify_batch defaults to engine="device" and takes device=
    before JAX's last parameter, mesh=, as verify_batches_pipelined and
    prove_batch_with_rng do, and prove_with_rng takes device= after them."""
    port, jax = _params(tbp.RangeProof.verify_batch), _params(jbp.RangeProof.verify_batch)
    assert [k for k, _ in port] == [k for k, _ in jax][:-1] + ["device", "mesh"]
    assert jax[-1][0] == "mesh" and port[-1][1].default is None and jax[-1][1].default is None
    assert port[-3][1].default == "device" and jax[-2][1].default == "host"
    assert [v.default for _, v in port[:-3]] == [v.default for _, v in jax[:-2]]
    for name in ("verify_batches_pipelined", "prove_batch_with_rng"):
        port, jax = _params(getattr(tbp.RangeProof, name)), _params(getattr(jbp.RangeProof, name))
        assert [(k, v.default) for k, v in port] == [(k, v.default) for k, v in jax[:-1]] + [
            ("device", "cuda"), ("mesh", None)]
    port, jax = _params(tbp.RangeProof.prove_with_rng), _params(jbp.RangeProof.prove_with_rng)
    assert [(k, v.default) for k, v in port[:-1]] == [(k, v.default) for k, v in jax]
    assert port[-1][0] == "device"


def test_device_caches_key_on_resolved_device():
    """"cpu" and torch.device("cpu") are one cache entry: the generator
    tensors are built once a device, not once a spelling."""
    gens = tbp.BulletproofGens(4, 1)
    assert gens.interleaved_device("cpu") is gens.interleaved_device(torch.device("cpu"))
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1))
    assert pc.device_bases("cpu") is pc.device_bases(torch.device("cpu"))
    assert list(pc._device_bases) == [torch.device("cpu")]
    assert ed.resolve_device("cpu") == torch.device("cpu")
