"""The port's device Fiat-Shamir replay on the CPU: the torch sponge
(`utils/jkeccak.py`, `utils/jstrobe.py`), the replay kernel's compiled byte
program (`ops/cuda_replay.py`, run by its numpy model of csrc/replay.cu)
and `models/replay_device.replay_fn` (its plain version on CPU tensors).

Held byte for byte against the port's host sponge and transcript, the host
replay `RangeProof._replay_challenges`, the golden vectors, and once (the
smallest shape, one XLA compile) the JAX package's `replay_fn`.  Inputs come
from seeds through numpy.  The kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.models.replay_device import pack_replay_inputs, replay_fn, row_layout
from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops.limbs import unpack_ints
from bulletproofs_plus_tpu_torch.utils import jkeccak
from bulletproofs_plus_tpu_torch.utils.jstrobe import JTranscript
from bulletproofs_plus_tpu_torch.utils.keccak import bytes_as_states, keccak_f1600, states_as_bytes

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_vectors.json")
with open(GOLDEN) as f:
    CELLS = json.load(f)

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def test_keccak_f1600_matches_host():
    """Random states, two chained permutations, against the host keccak."""
    st = np.random.default_rng(7).integers(0, 256, size=(6, 200), dtype=np.uint8)
    want = st.copy()
    got = torch.as_tensor(st)
    for _ in range(2):
        want = states_as_bytes(keccak_f1600(bytes_as_states(want)))
        got = jkeccak.state_to_bytes(jkeccak.keccak_f1600(jkeccak.bytes_to_state(got)))
    assert np.array_equal(got.numpy(), want)


def test_jtranscript_matches_host_transcript():
    """The replay's op mix, with a rekeyed RNG beside the transcript: every
    output and the final states byte for byte."""
    B = 4
    rng = np.random.default_rng(13)
    msgs = rng.integers(0, 256, size=(3, B, 32), dtype=np.uint8)
    wit = rng.integers(0, 256, size=(B, 40), dtype=np.uint8)
    u64s = rng.integers(0, 256, size=(B, 8), dtype=np.uint8)

    host = tbp.Transcript(b"jstrobe-test", batch=B)
    start = host.clone()
    host.append_message(b"dom-sep", b"proto")
    host.append_u64(b"N", 64)
    host.append_message(b"vi", u64s)
    for m in msgs:
        host.append_message(b"P", m)
    want = [host.challenge_bytes(b"y", 64)]
    host_rng = host.build_rng().rekey_with_witness_bytes(b"witness", wit).finalize(tbp.NullRng())
    want += [host_rng.fill_bytes(32), host.challenge_bytes(b"e", 200)]

    t = JTranscript.from_host(start)
    t.append_message(b"dom-sep", b"proto")
    t.append_u64(b"N", 64)
    t.append_u64(b"vi", torch.as_tensor(u64s))
    for m in msgs:
        t.append_message(b"P", torch.as_tensor(m))
    got = [t.challenge_bytes(b"y", 64)]
    rng_t = t.build_rng().rekey_with_witness_bytes(b"witness", torch.as_tensor(wit)).finalize_null()
    got += [rng_t.fill_bytes(32), t.challenge_bytes(b"e", 200)]  # 200 bytes: a squeeze across a permutation
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(t.strobe.state.numpy(), host.strobe.state)
    assert np.array_equal(rng_t.strobe.state.numpy(), host_rng.strobe.state)
    assert (t.strobe.pos, t.strobe.pos_begin, t.strobe.cur_flags) == (
        host.strobe.pos, host.strobe.pos_begin, host.strobe.cur_flags)


def _golden_batch(cell, batch=2):
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(cell["extension_degree"]))
    params = tbp.RangeParameters.init(cell["bits"], len(cell["values"]), pc)
    commitments = [hr.decompress(bytes.fromhex(h)) for h in cell["commitments"]]
    mv = cell["min_values"] if cell["min_values"] is not None else [None] * len(commitments)
    statement = tbp.RangeStatement.init(params, commitments, mv, seed_nonce=cell["seed_nonce"])
    proof = tbp.RangeProof.from_bytes(bytes.fromhex(cell["proof"]))
    return params, [statement] * batch, [proof] * batch


def _replay(params, statements, proofs, label=b"golden"):
    """replay_fn for the batch's shape -> (fn, state (B, 200), buf (B, stride)) on the CPU."""
    stacked = tbp.Transcript.stack([tbp.Transcript(label) for _ in proofs])
    fn = replay_fn(params.h_base_compressed(), tuple(params.g_bases_compressed()), params.bit_length(),
                   int(params.extension_degree()), len(statements[0].commitments), len(proofs[0].li),
                   stacked.strobe.pos, stacked.strobe.pos_begin, stacked.strobe.cur_flags)
    return fn, torch.as_tensor(stacked.strobe.state.copy()), torch.as_tensor(pack_replay_inputs(statements, proofs).copy())


@pytest.mark.parametrize("cell", CELLS, ids=[f"b{c['bits']}m{len(c['values'])}d{c['extension_degree']}" for c in CELLS])
def test_replay_fn_matches_host_replay_and_golden(cell):
    """Challenges, seeds and flags of replay_fn's plain version equal the host
    replay and the golden vectors; the compiled program, run by the kernel's
    model, gives the same output row byte for byte."""
    params, statements, proofs = _golden_batch(cell)
    fn, state, buf = _replay(params, statements, proofs)
    y, z, es, e, seeds, bad_identity, bad_zero = fn(state, buf)
    challenges, host_seeds = tbp.RangeProof._replay_challenges(
        [tbp.Transcript(b"golden") for _ in proofs], statements, proofs)
    rounds = len(proofs[0].li)
    for k, (hy, hz, hes, he) in enumerate(challenges):
        got = (unpack_ints(y.numpy())[k], unpack_ints(z.numpy())[k], unpack_ints(es[k].numpy()),
               unpack_ints(e.numpy())[k])
        assert got == (hy, hz, hes, he)
        assert seeds[k].numpy().tobytes() == host_seeds[k]
    assert [format(v, "064x") for v in unpack_ints(es[0].numpy())] == cell["round_es"]
    assert (format(unpack_ints(y.numpy())[1], "064x"), format(unpack_ints(e.numpy())[1], "064x")) == (
        cell["y"], cell["e"])
    assert es.shape == (2, rounds, 16) and not bad_identity.any() and not bad_zero.any()

    out_plain, bad_plain = cr.replay_plain(fn.program, state, buf)
    out_model, bad_model = cr.replay_model(fn.program, state.numpy(), buf.numpy())
    assert np.array_equal(out_model, out_plain.numpy()) and np.array_equal(bad_model, bad_plain.numpy())
    assert out_plain.shape == (2, 64 * (rounds + 3) + 32)
    assert fn.program.n_permutations >= 10


@pytest.mark.parametrize("member", ["a", "li", "b"])
def test_replay_flags_an_identity_point_on_its_lane_only(member):
    """A lane whose A (or first L, or B) is all zeroes raises bad_identity on
    that lane only, in the plain version and in the kernel's model."""
    params, statements, proofs = _golden_batch(CELLS[0], batch=3)
    fn, state, buf = _replay(params, statements, proofs)
    offsets, _ = row_layout(len(statements[0].commitments), len(proofs[0].li), len(proofs[0].d1))
    lo = offsets[member][0]
    buf[1, lo : lo + 32] = 0
    *_, bad_identity, _ = fn(state, buf)
    assert bad_identity.tolist() == [False, True, False]
    _, bad_model = cr.replay_model(fn.program, state.numpy(), buf.numpy())
    assert bad_model.tolist() == [False, True, False]


def test_replay_wrapper_takes_no_other_device():
    """The wrapper runs the plain version only for CPU tensors: any other
    device goes to the kernel's launcher, which refuses what is not CUDA."""
    params, statements, proofs = _golden_batch(CELLS[0])
    fn, state, buf = _replay(params, statements, proofs)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cr.replay(fn.program, state.to("meta"), buf.to("meta"))


def test_replay_fn_matches_jax_replay_fn():
    """Once, at the smallest shape (4-bit, m=1, B=2): the JAX package's
    replay_fn and the port's give the same challenges, seeds and flags."""
    from bulletproofs_plus_tpu.models.replay_device import replay_fn as jax_replay_fn

    pc = jbp.create_pedersen_gens_with_extension_degree(jbp.ExtensionDegree(1))
    jparams = jbp.RangeParameters.init(4, 1, pc)
    rs = np.random.RandomState(3)
    jst, proofs = [], []
    for lane in range(2):
        v, r = int(rs.randint(16)), int.from_bytes(rs.bytes(32), "little") % hr.L
        st = jbp.RangeStatement.init(jparams, [pc.commit(v, [r])], [None], None)
        wit = jbp.RangeWitness.init([jbp.CommitmentOpening(v, [r])])
        proofs.append(jbp.RangeProof.prove_with_rng(jbp.Transcript(b"jax"), st, wit, jbp.SeededRng(lane)))
        jst.append(st)
    tpc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1))
    tparams = tbp.RangeParameters.init(4, 1, tpc)
    tst = [tbp.RangeStatement.init(tparams, [hr.decompress(c) for c in s.commitments_compressed], [None], None)
           for s in jst]
    tproofs = [tbp.RangeProof.from_bytes(p.to_bytes()) for p in proofs]

    fn, state, buf = _replay(tparams, tst, tproofs, label=b"jax")
    got = fn(state, buf)
    stacked = jbp.Transcript.stack([jbp.Transcript(b"jax") for _ in proofs])
    jfn = jax_replay_fn(jparams.h_base_compressed(), tuple(jparams.g_bases_compressed()), 4, 1, 1,
                        len(proofs[0].li), stacked.strobe.pos, stacked.strobe.pos_begin, stacked.strobe.cur_flags)
    from bulletproofs_plus_tpu.models.replay_device import pack_replay_inputs as jax_pack

    want = jfn(stacked.strobe.state, jax_pack(jst, proofs))
    assert np.array_equal(buf.numpy(), np.asarray(jax_pack(jst, proofs)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
