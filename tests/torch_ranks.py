"""Rank bodies and a spawner for the port's multi-rank tests.

tests/test_torch_parallel.py (gloo ranks on the CPU) and the card cases of
tests/test_torch_cuda.py spawn ranks that run the functions below.  This
module imports torch and the port only, so that a spawned rank starts
quickly and the card tests run where JAX is not installed.  Every rank
joins one process group through a `file://` store in a temporary directory
(no port to race for), under a timeout, so a rank that hangs fails the test.
Each rank writes what it saw as JSON; the caller holds it against its own
references.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.native import cuda
from bulletproofs_plus_tpu_torch.ops import edwards as ed
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints
from bulletproofs_plus_tpu_torch.ops.msm import host_msm
from bulletproofs_plus_tpu_torch.parallel import global_dp_mesh, make_mesh, make_pod_stream, sharded_msm_fn
from bulletproofs_plus_tpu_torch.parallel import verify_stream_pod

COLLECTIVE_TIMEOUT_S = 90
LABEL = b"ranks"
BAD_POINT = (hr.P + 1).to_bytes(32, "little")  # s >= p: not a canonical encoding


def det(tag: str) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % hr.L


def setup(pkg, bits: int, m: int, deg: int, B: int, seeded: bool, max_m: int = 2, tag: str = ""):
    """B statements and witnesses in package `pkg` (the port or the JAX
    package) from the same integers: values spread over the range, a
    minimum-value promise on slot 0 when m > 1, generators of aggregation
    `max_m`."""
    pc = pkg.create_pedersen_gens_with_extension_degree(pkg.ExtensionDegree(deg))
    params = pkg.RangeParameters.init(bits, max_m, pc)
    statements, witnesses = [], []
    for i in range(B):
        openings, commitments, promises = [], [], []
        for j in range(m):
            v = (3 + 5 * i + 7 * j) % (1 << bits)
            blinds = [det(f"ranks{tag}-{i}-{j}-{k}") for k in range(deg)]
            openings.append(pkg.CommitmentOpening(v, blinds))
            commitments.append(pc.commit(v, blinds))
            promises.append(min(2, v) if m > 1 and j == 0 else None)
        nonce = det(f"ranks{tag}-seed-{i}") if seeded else None
        statements.append(pkg.RangeStatement.init(params, commitments, promises, nonce))
        witnesses.append(pkg.RangeWitness.init(openings))
    return statements, witnesses


# (bits, m, deg, B, seeded, tag): the shapes of the multi-rank tests.  Two
# ranks prove b4_m1 and b4_m2 with a mesh (the first four of each make a
# batch of two shapes); four ranks verify b8_m1, proved by the caller.
SHAPES = {
    "b4_m1": (4, 1, 1, 8, True, "a"),
    "b4_m2": (4, 2, 1, 8, False, "b"),
    "b8_m1": (8, 1, 2, 8, True, "c"),
}
RNG_SEED = {"b4_m1": 11, "b4_m2": 12, "b8_m1": 13}


def shape(pkg, key: str, B=None):
    bits, m, deg, batch, seeded, tag = SHAPES[key]
    return setup(pkg, bits, m, deg, batch if B is None else B, seeded, tag=tag)


def state_hex(transcript) -> list:
    st = transcript.strobe
    return [bytes(st.state).hex(), st.pos, st.pos_begin, st.cur_flags]


def outcome(fn):
    """fn()'s masks (as ints, None where none), or [error class, message]."""
    try:
        masks = fn()
    except tbp.ProofError as exc:
        return [type(exc).__name__, str(exc)]
    return [None if m is None else m.blindings() for m in masks]


def verify(statements, proofs, action: str, **kw):
    return outcome(lambda: tbp.RangeProof.verify_batch(
        [tbp.Transcript(LABEL) for _ in proofs], statements, proofs, getattr(tbp.VerifyAction, action), **kw))


def copy_proof(proof, **fields):
    out = tbp.RangeProof.from_bytes(proof.to_bytes())
    for name, value in fields.items():
        setattr(out, name, value)
    return out


def from_hex(blobs) -> list:
    return [tbp.RangeProof.from_bytes(bytes.fromhex(b)) for b in blobs]


def tampered(proofs, at: int):
    """`proofs` with proof `at`'s s1 moved by one: a batch that must not verify."""
    return proofs[:at] + [copy_proof(proofs[at], s1=(proofs[at].s1 + 1) % hr.L)] + proofs[at + 1 :]


def noncanonical(proofs, l_at: int, a_at: int):
    """`proofs` with a non-canonical second L point in proof `l_at` and a
    non-canonical A in proof `a_at`: the earlier proof's error is raised."""
    bad = list(proofs)
    bad[l_at] = copy_proof(proofs[l_at], li=[proofs[l_at].li[0], BAD_POINT] + proofs[l_at].li[2:])
    bad[a_at] = copy_proof(proofs[a_at], a=BAD_POINT)
    return bad


def mixed(statements_m2, proofs_m2, statements_m1, proofs_m1):
    """The first four proofs of each shape, interleaved: a batch of two shape groups."""
    return ([s for pair in zip(statements_m2[:4], statements_m1[:4]) for s in pair],
            [p for pair in zip(proofs_m2[:4], proofs_m1[:4]) for p in pair])


def msm_inputs(n: int):
    """n seeded scalars and points for the sharded MSM."""
    scalars = [det(f"msm-s-{i}") for i in range(n)]
    points = [hr.point_mul(det(f"msm-p-{i}"), hr.BASEPOINT) for i in range(n)]
    return scalars, points


def sharded_msm(n: int, device) -> list:
    """`sharded_msm_fn` over n seeded lanes on an "mp" mesh: [its point, host_msm's], compressed."""
    scalars, points = msm_inputs(n)
    fn = sharded_msm_fn(make_mesh(torch.device(device).type))
    got = fn(torch.as_tensor(pack_ints(scalars).astype("int64"), device=device), ed.from_host(points, device=device))
    return [hr.compress(ed.to_host(got)).hex(), hr.compress(host_msm(scalars, points)).hex()]


def prove(statements, witnesses, key: str, mesh=None, device="cpu"):
    """(proofs, the callers' final transcript states), or the prover's error."""
    transcripts = [tbp.Transcript(LABEL) for _ in statements]
    try:
        proofs = tbp.RangeProof.prove_batch_with_rng(
            transcripts, statements, witnesses, tbp.SeededRng(RNG_SEED[key]), device=device, mesh=mesh)
    except tbp.ProofError as exc:
        return [type(exc).__name__, str(exc)]
    return proofs, [state_hex(t) for t in transcripts]


def cpu_checks(mesh, device):
    """The checks of tests/test_torch_parallel.py's two-rank case, on one
    rank: the sharded prove, the sharded verify and its routing, the pod
    stream and the sharded MSM."""
    world = mesh.size()
    out = {}
    made = {}
    for key in ("b4_m1", "b4_m2"):
        statements, witnesses = shape(tbp, key)
        proofs, states = prove(statements, witnesses, key, mesh, device)
        made[key] = (statements, proofs)
        out[f"prove_{key}"] = {"proofs": [p.to_bytes().hex() for p in proofs], "states": states}
        if key == "b4_m1":
            out["prove_indivisible"] = prove(statements[: world + 1], witnesses[: world + 1], key, mesh, device)

    st4, pr4 = made["b4_m1"]
    n = len(pr4)
    for action in ("VERIFY_ONLY", "RECOVER_ONLY", "RECOVER_AND_VERIFY"):
        out[f"verify_b4_m1_{action}"] = verify(st4, pr4, action, device=device, mesh=mesh)
    out["verify_b4_m2"] = verify(*made["b4_m2"], "RECOVER_AND_VERIFY", device=device, mesh=mesh)
    out["tampered"] = verify(st4, tampered(pr4, 2), "VERIFY_ONLY", device=device, mesh=mesh)
    out["noncanonical"] = verify(st4, noncanonical(pr4, n - 2, n - 1), "VERIFY_ONLY", device=device, mesh=mesh)
    out["indivisible"] = verify(st4[: n - 1], pr4[: n - 1], "RECOVER_AND_VERIFY", device=device, mesh=mesh)
    out["mixed"] = verify(*mixed(*made["b4_m2"], st4, pr4), "RECOVER_AND_VERIFY", device=device, mesh=mesh)

    out["stream"] = stream_outcome(make_pod_stream(st4 + st4, pr4 + pr4, LABEL, batch_size=n), mesh)
    # one pump a batch: the tampered first batch stops the stream before the second is dispatched
    os.environ["BPPT_PIPELINE_LOOKAHEAD"] = "1"
    out["stream_tampered"] = stream_outcome(make_pod_stream(st4 + st4, tampered(pr4, 5) + pr4, LABEL, n), mesh)
    del os.environ["BPPT_PIPELINE_LOOKAHEAD"]
    out["sharded_msm"] = sharded_msm(8, device)
    return out


def world4_checks(mesh, device, b8_m1_hex):
    """The four-rank case: a sharded verify of two 8-bit proofs a rank, and the sharded MSM."""
    return {"verify_b8_m1": verify(shape(tbp, "b8_m1")[0], from_hex(b8_m1_hex), "RECOVER_AND_VERIFY",
                                   device=device, mesh=mesh),
            "sharded_msm": sharded_msm(8, device)}


def card_checks(mesh, device):
    """The card cases of tests/test_torch_cuda.py on one rank: the sharded
    prove and verify against the unsharded ones on this rank's card, with
    the kernels each launched here."""
    statements, witnesses = shape(tbp, "b8_m1")
    proofs, states = prove(statements, witnesses, "b8_m1", None, device)
    cuda.reset_launches()
    sharded, sharded_states = prove(statements, witnesses, "b8_m1", mesh, device)
    torch.cuda.synchronize()
    out = {"prove_launches": dict(cuda.launches),
           "prove_equal": [p.to_bytes() for p in sharded] == [p.to_bytes() for p in proofs]
           and sharded_states == states}
    want = verify(statements, proofs, "RECOVER_AND_VERIFY", device=device)
    cuda.reset_launches()
    got = verify(statements, proofs, "RECOVER_AND_VERIFY", device=device, mesh=mesh)
    torch.cuda.synchronize()
    out.update(verify_launches=dict(cuda.launches), verify_equal=got == want, masks=got,
               tampered=verify(statements, tampered(proofs, 1), "VERIFY_ONLY", device=device, mesh=mesh))
    return out


def stream_outcome(batches, mesh):
    """`verify_stream_pod`'s masks a batch, or [error class, message]."""
    try:
        results = verify_stream_pod(batches, tbp.VerifyAction.VERIFY_ONLY, mesh)
    except tbp.ProofError as exc:
        return [type(exc).__name__, str(exc)]
    return [[None if m is None else m.blindings() for m in batch] for batch in results]


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------


def _rank_main(rank, world, backend, device_type, store, out_dir, body, args):
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = body(global_dp_mesh(device_type), device_type, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


class Ranks:
    """`world` spawned ranks, each running body(mesh, device_type, *args) on
    a "dp" mesh of `device_type` over `backend` (gloo ranks share card 0,
    NCCL rank r takes card r); `results()` waits for them and returns each
    rank's JSON, in rank order, and `close()` ends any rank still running."""

    def __init__(self, body, world: int, backend: str, device_type: str, args=(), timeout_s: float = 240):
        self._dir = tempfile.TemporaryDirectory()
        self._world = world
        self._deadline = time.monotonic() + timeout_s
        self._ctx = mp.start_processes(
            _rank_main,
            args=(world, backend, device_type, os.path.join(self._dir.name, "store"), self._dir.name, body, args),
            nprocs=world, join=False, start_method="spawn",
        )

    def results(self) -> list:
        while not self._ctx.join(timeout=max(0.0, self._deadline - time.monotonic())):
            if time.monotonic() >= self._deadline:
                raise TimeoutError("a rank did not finish in time")
        out = []
        for rank in range(self._world):
            with open(os.path.join(self._dir.name, f"rank{rank}.json")) as f:
                out.append(json.load(f))
        return out

    def close(self) -> None:
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        self._dir.cleanup()
