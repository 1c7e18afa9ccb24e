"""The port's parallel/ package and the mesh= paths against the JAX package.

In process: the Edwards ladder helpers against the JAX package's at
bits=16 (compared after `compress`), `pad_for_mesh` and `make_pod_stream`
against the JAX package's, and the helpers' behaviour without a process
group.  Across ranks: one spawn of two gloo ranks and one of four, on the
CPU (tests/torch_ranks.py), started when the module's tests start so that
they run beside the in-process tests.  Their sharded proves must equal the
JAX package's sequential prover byte for byte (proofs and final transcript
states), their sharded verifies the unsharded port's and the JAX package's
`engine="host"` masks, verdicts and error texts, on every rank, and the
sharded MSM `host_msm`'s point.  The JAX mesh programs are not compiled
here: the JAX package's own tests hold them against its unsharded paths.
Tolerance: exact everywhere.
"""

import jax
import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
import torch_ranks as R
from bulletproofs_plus_tpu.ops import edwards as jed
from bulletproofs_plus_tpu.parallel import make_pod_stream as jax_make_pod_stream
from bulletproofs_plus_tpu.parallel.sharded_msm import pad_for_mesh as jax_pad_for_mesh
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints
from bulletproofs_plus_tpu_torch.parallel import (
    global_dp_mesh,
    host_shard,
    initialize_distributed,
    make_pod_stream,
    pad_for_mesh,
)
from torch_prover_inputs import LaneRng

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def _jax_sequential(key, B=None):
    """The JAX package's sequential prover on shape `key`, lane by lane on
    lane-split SeededRng streams: (proof hex, final transcript states)."""
    statements, witnesses = R.shape(jbp, key, B)
    proofs, states = [], []
    for lane, (statement, witness) in enumerate(zip(statements, witnesses)):
        transcript = jbp.Transcript(R.LABEL)
        proof = jbp.RangeProof.prove_with_rng(transcript, statement, witness, LaneRng(R.RNG_SEED[key], lane))
        proofs.append(proof.to_bytes().hex())
        st = transcript.strobe
        states.append([bytes(np.asarray(st.state)).hex(), st.pos, st.pos_begin, st.cur_flags])
    return proofs, states


def _jax_host(statements, proof_hex, action):
    """The JAX package's `engine="host"` outcome, in torch_ranks.outcome's form."""
    proofs = [jbp.RangeProof.from_bytes(bytes.fromhex(b)) for b in proof_hex]
    try:
        masks = jbp.RangeProof.verify_batch(
            [jbp.Transcript(R.LABEL) for _ in proofs], statements, proofs, getattr(jbp.VerifyAction, action),
            engine="host")
    except jbp.ProofError as exc:
        return [type(exc).__name__, str(exc)]
    return [None if m is None else m.blindings() for m in masks]


class _Spawned:
    """The module's two spawns, started at once; `ranks` waits for them and
    makes the references (`refs`) meanwhile."""

    def __init__(self):
        self.b8_m1 = _jax_sequential("b8_m1")[0]
        self._two = R.Ranks(R.cpu_checks, 2, "gloo", "cpu")
        self._four = R.Ranks(R.world4_checks, 4, "gloo", "cpu", args=(self.b8_m1,))
        self._results = None

    def results(self):
        """Both spawns' results (a failure is kept and raised again)."""
        if self._results is None:
            try:
                self.refs = self._references()
                self._results = (self._two.results(), self._four.results())
            except Exception as exc:  # every test that reads the ranks reports it
                self._results = exc
        if isinstance(self._results, Exception):
            raise self._results
        return self._results

    def close(self):
        self._two.close()
        self._four.close()

    def _references(self):
        b4_m1, b4_m1_states = _jax_sequential("b4_m1")
        b4_m2, b4_m2_states = _jax_sequential("b4_m2")
        j4 = R.shape(jbp, "b4_m1")[0]
        j42 = R.shape(jbp, "b4_m2")[0]
        t4 = R.shape(tbp, "b4_m1")[0]
        p4 = R.from_hex(b4_m1)
        n = len(p4)
        refs = {
            "prove_b4_m1": {"proofs": b4_m1, "states": b4_m1_states},
            "prove_b4_m2": {"proofs": b4_m2, "states": b4_m2_states},
            "host_verify_b4_m2": _jax_host(j42, b4_m2, "RECOVER_AND_VERIFY"),
            "host_verify_b8_m1": _jax_host(R.shape(jbp, "b8_m1")[0], self.b8_m1, "RECOVER_AND_VERIFY"),
            "host_indivisible": _jax_host(j4[: n - 1], b4_m1[: n - 1], "RECOVER_AND_VERIFY"),
            "host_mixed": _jax_host(*R.mixed(j42, b4_m2, j4, b4_m1), "RECOVER_AND_VERIFY"),
            "port_tampered": R.verify(t4, R.tampered(p4, 2), "VERIFY_ONLY", device="cpu"),
            "port_noncanonical": R.verify(t4, R.noncanonical(p4, n - 2, n - 1), "VERIFY_ONLY", device="cpu"),
        }
        for action in ("VERIFY_ONLY", "RECOVER_ONLY", "RECOVER_AND_VERIFY"):
            refs[f"host_{action}"] = _jax_host(j4, b4_m1, action)
            refs[f"port_{action}"] = R.verify(t4, p4, action, device="cpu")
        return refs


_SPAWNED = []


@pytest.fixture(scope="module", autouse=True)
def _spawn_ranks():
    """Start the ranks before the module's first test, so they run while
    the in-process tests do."""
    _SPAWNED.append(_Spawned())
    yield
    _SPAWNED.pop().close()  # never leave a rank running


@pytest.fixture
def ranks():
    two, four = _SPAWNED[0].results()
    return two, four, _SPAWNED[0].refs


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------


def _ladder_inputs(n=4):
    rs = np.random.RandomState(16)
    points = [hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(n - 1)] + [hr.IDENTITY]
    small = [int(v) for v in rs.randint(0, 2**16, size=n)]
    wide = [int.from_bytes(rs.bytes(32), "little") % hr.L for _ in range(n)]
    return points, small, wide


def _compressed(points):
    return [hr.compress(p).hex() for p in points]


def _jax_points(points):
    return jed.from_host(points)


def test_scalar_mul_matches_jax():
    points, small, _ = _ladder_inputs()
    got = ed.scalar_mul(torch.as_tensor(pack_ints(small).astype(np.int64)), ed.from_host(points, device="cpu"), bits=16)
    want = jed.to_host(jed.scalar_mul(pack_ints(small), _jax_points(points), bits=16))
    assert _compressed(ed.to_host(got)) == _compressed(want)
    assert _compressed(ed.to_host(got)) == _compressed([hr.point_mul(k, p) for k, p in zip(small, points)])


def test_double_scalar_mul_matches_jax():
    points, small, wide = _ladder_inputs()
    qs = points[1:] + points[:1]
    got = ed.double_scalar_mul(torch.as_tensor(pack_ints(wide).astype(np.int64)), ed.from_host(points, device="cpu"),
                               torch.as_tensor(pack_ints(small).astype(np.int64)), ed.from_host(qs, device="cpu"),
                               bits=16)
    want = jed.to_host(jed.double_scalar_mul(pack_ints(wide), _jax_points(points), pack_ints(small), _jax_points(qs),
                                             bits=16))
    assert _compressed(ed.to_host(got)) == _compressed(want)


def test_cond_add_matches_jax():
    points, _, _ = _ladder_inputs()
    qs = points[2:] + points[:2]
    mask = np.array([True, False, True, True])
    got = ed.cond_add(torch.as_tensor(mask), ed.from_host(points, device="cpu"), ed.from_host(qs, device="cpu"))
    want = jed.to_host(jax.jit(jed.cond_add)(mask, _jax_points(points), _jax_points(qs)))
    assert _compressed(ed.to_host(got)) == _compressed(want)


@pytest.mark.parametrize("n, shards", [(5, 2), (8, 2), (6, 4), (1100, 2)])
def test_pad_for_mesh_shapes_match_jax(n, shards):
    scalars = torch.ones((n, 16), dtype=torch.int64)
    s, p = pad_for_mesh(scalars, ed.identity((n,), device="cpu"), shards)
    js, jp = jax_pad_for_mesh(np.ones((n, 16), dtype=np.uint32), jed.identity((n,)), shards)
    assert s.shape == js.shape and all(c.shape == jc.shape for c, jc in zip(p, jp))
    assert int(s[n:].abs().sum()) == 0 and bool((s[:n] == 1).all())


def test_make_pod_stream_matches_jax():
    statements, proofs = list(range(10)), [f"p{i}" for i in range(10)]
    got = make_pod_stream(statements, proofs, b"pod", batch_size=4)
    want = jax_make_pod_stream(statements, proofs, b"pod", batch_size=4)
    assert [(s, p) for _, s, p in got] == [(s, p) for _, s, p in want]
    for (ts, _, _), (js, _, _) in zip(got, want):
        assert len(ts) == len(js)
        assert all(t.strobe.state.tobytes() == np.asarray(j.strobe.state).tobytes() for t, j in zip(ts, js))


def test_helpers_without_a_process_group(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not torch.distributed.is_initialized()
    assert host_shard(16) == slice(0, 16)
    initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_mesh_device_must_be_the_ranks_device():
    """A world of one on the CPU: `device=` naming another device raises,
    in the verifier and in the prover, before any work."""
    statements, witnesses = R.shape(tbp, "b8_m1", 2)
    mesh = global_dp_mesh("cpu")
    try:
        assert mesh.size() == 1 and host_shard(16, mesh) == slice(0, 16)
        with pytest.raises(tbp.InvalidArgument, match="not this rank's device"):
            tbp.RangeProof.verify_batch([tbp.Transcript(R.LABEL)] * 2, statements, R.from_hex(_SPAWNED[0].b8_m1[:2]),
                                        tbp.VerifyAction.VERIFY_ONLY, mesh=mesh)
        with pytest.raises(tbp.InvalidArgument, match="not this rank's device"):
            tbp.RangeProof.prove_batch_with_rng([tbp.Transcript(R.LABEL) for _ in range(2)], statements, witnesses,
                                                tbp.SeededRng(1), device="meta", mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Across ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["b4_m1", "b4_m2"])
def test_sharded_prove_matches_jax_sequential(ranks, key):
    two, _, refs = ranks
    for rank in two:
        assert rank[f"prove_{key}"] == refs[f"prove_{key}"]


def test_sharded_prove_needs_a_divisible_batch(ranks):
    two, _, _ = ranks
    for rank in two:
        assert rank["prove_indivisible"] == ["InvalidArgument", "Batch prove mesh needs B divisible by mesh size"]


@pytest.mark.parametrize("action", ["VERIFY_ONLY", "RECOVER_ONLY", "RECOVER_AND_VERIFY"])
def test_sharded_verify_matches_unsharded_and_host(ranks, action):
    two, _, refs = ranks
    for rank in two:
        assert rank[f"verify_b4_m1_{action}"] == refs[f"port_{action}"] == refs[f"host_{action}"]
    if action != "VERIFY_ONLY":
        assert all(m is not None for m in refs[f"host_{action}"])


def test_sharded_verify_aggregated(ranks):
    two, _, refs = ranks
    for rank in two:
        assert rank["verify_b4_m2"] == refs["host_verify_b4_m2"] == [None] * 8


def test_sharded_verify_refuses_a_tampered_proof(ranks):
    two, _, refs = ranks
    for rank in two:
        assert rank["tampered"] == refs["port_tampered"] == ["VerificationFailed", "Range proof batch not valid"]


def test_sharded_verify_reports_noncanonical_points_as_unsharded(ranks):
    """A bad L in proof 6 and a bad A in proof 7, both in the last rank's
    shard: every rank raises proof 6's error, in the unsharded wording."""
    two, _, refs = ranks
    want = ["InvalidArgument", "An item in member 'L' was not the canonical encoding of a point"]
    for rank in two:
        assert rank["noncanonical"] == refs["port_noncanonical"] == want


@pytest.mark.parametrize("case", ["indivisible", "mixed"])
def test_mesh_batch_that_cannot_shard_runs_whole(ranks, case):
    """7 proofs over 2 ranks, and a batch of two shapes: every rank runs the
    unsharded path and agrees with the JAX host engine."""
    two, _, refs = ranks
    for rank in two:
        assert rank[case] == refs[f"host_{case}"]
    assert any(m is not None for m in refs[f"host_{case}"])


def test_verify_stream_pod(ranks):
    two, _, _ = ranks
    for rank in two:
        assert rank["stream"] == [[None] * 8, [None] * 8]
        assert rank["stream_tampered"] == ["VerificationFailed", "Range proof batch not valid"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_msm_matches_host_msm(ranks, world):
    two, four, _ = ranks
    for rank in two if world == 2 else four:
        got, want = rank["sharded_msm"]
        assert got == want


def test_four_ranks_verify_8_bit(ranks):
    _, four, refs = ranks
    for rank in four:
        assert rank["verify_b8_m1"] == refs["host_verify_b8_m1"]
    assert all(m is not None for m in refs["host_verify_b8_m1"])
