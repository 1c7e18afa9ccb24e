"""The port's device Fiat-Shamir replay on the CPU: the torch sponge
(`utils/jkeccak.py`, `utils/jstrobe.py`), the replay kernel's compiled span
program (`ops/cuda_replay.py`, run by its numpy model of csrc/replay.cu:
the spans on 64-bit words, the warp's permutation lane by lane, the
epilogue's reduction mod l through ops/scalar_model.py) and
`models/replay_device.replay_fn` (its plain version on CPU tensors).

Held byte for byte against the port's host sponge and transcript, the host
replay `RangeProof._replay_challenges`, the golden vectors, Python integers
and the JAX package's `reduce_wide_l`, and once (the smallest shape, one XLA
compile) the JAX package's `replay_fn`.  Inputs come from seeds through
numpy.  The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import bulletproofs_plus_tpu as jbp
import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu.ops import field as JF
from bulletproofs_plus_tpu_torch.models.replay_device import pack_replay_inputs, replay_fn, row_layout
from bulletproofs_plus_tpu_torch.ops import cuda_replay as cr
from bulletproofs_plus_tpu_torch.ops import field as F
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.ops import scalar_model as SM
from bulletproofs_plus_tpu_torch.ops.limbs import int_from_limbs, unpack_ints
from bulletproofs_plus_tpu_torch.utils import jkeccak
from bulletproofs_plus_tpu_torch.utils.jstrobe import JTranscript
from bulletproofs_plus_tpu_torch.utils.strobe import STROBE_R
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

    out_plain, _ = cr.replay_plain(fn.program, state, buf)
    model = cr.replay_model(fn.program, state.numpy(), buf.numpy())
    for got, want in zip(model, cr.replay_fn_plain(fn.program, state, buf)):
        assert np.array_equal(got, want.numpy())
    assert np.array_equal(model[1], seeds.numpy())
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
    _, _, bad_model, _ = cr.replay_model(fn.program, state.numpy(), buf.numpy())
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


CELL_IDS = [f"b{c['bits']}m{len(c['values'])}d{c['extension_degree']}" for c in CELLS]


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_span_model_matches_plain_replay_fn(cell):
    """At every golden shape, the kernel's model of the span program and its
    epilogue equals the plain replay_fn (the sequence, then reduce_wide_l and
    is_zero_l) on limbs, seeds and both flags: the golden proof on lane 0,
    random state and row bytes on lanes 1-3, an identity A on lane 1 and an
    identity first L on lane 3."""
    params, statements, proofs = _golden_batch(cell, batch=4)
    fn, state, buf = _replay(params, statements, proofs)
    rs = np.random.default_rng(cell["seed"])
    state[1:] = torch.as_tensor(rs.integers(0, 256, size=tuple(state[1:].shape), dtype=np.uint8))
    buf[1:] = torch.as_tensor(rs.integers(0, 256, size=tuple(buf[1:].shape), dtype=np.uint8))
    offsets, _ = row_layout(len(statements[0].commitments), len(proofs[0].li), len(proofs[0].d1))
    for lane, member in ((1, "a"), (3, "li")):
        buf[lane, offsets[member][0] : offsets[member][0] + 32] = 0
    want = cr.replay_fn_plain(fn.program, state, buf)
    got = cr.replay_model(fn.program, state.numpy(), buf.numpy())
    for name, g, w in zip(("scalars", "seeds", "bad_identity", "bad_zero"), got, want):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy()), name
    assert want[2].tolist() == [False, True, False, True] and not want[3].any()
    assert got[0].shape == (4, len(proofs[0].li) + 3, 16)


def _wide_batch():
    """One numpy-seeded batch of 512-bit values at the reduction's edges, then random ones."""
    L = SM.L
    rs = np.random.default_rng(29)
    vals = [0, 1, L - 1, L, L + 1, 2**252, 2**256 - 1, 2**512 - 1, L * ((2**512 - 1) // L)]
    vals += [L * (2**259 + k) for k in (-2, -1, 0, 1, 3)]
    vals += [int.from_bytes(rs.bytes(64), "little") for _ in range(24)]
    vals += [int.from_bytes(rs.bytes(64), "little") >> int(rs.integers(1, 500)) for _ in range(8)]
    return vals


def test_reduce_wide_model_matches_integers_and_reduce_wide_l():
    """R1's epilogue, word for word (ops/scalar_model.py's fold, every carry
    and bound checked), against int % l, the port's F.reduce_wide_l and the
    JAX package's: equal on every value; zero exactly on the multiples of l."""
    vals = _wide_batch()
    model = [SM.from_words(SM.reduce_fold(SM.to_words(v, 16))) for v in vals]
    assert model == [v % SM.L for v in vals]
    arr = np.frombuffer(b"".join(v.to_bytes(64, "little") for v in vals), dtype=np.uint8).reshape(-1, 64)
    limbs = (arr[:, 0::2].astype(np.int64) | (arr[:, 1::2].astype(np.int64) << 8))
    port = F.reduce_wide_l(torch.as_tensor(limbs))
    jax_out = np.asarray(JF.reduce_wide_l(limbs.astype(np.uint32)))
    assert [int_from_limbs(r) for r in port.numpy()] == model
    assert [int_from_limbs(r) for r in jax_out] == model
    assert 0 < sum(_fold_before_csub(v) >= SM.L for v in vals) < len(vals)
    zero = [not any(SM.reduce_fold(SM.to_words(v, 16))) for v in vals]
    assert zero == [v % SM.L == 0 for v in vals] == F.is_zero_l(port).tolist()
    assert sum(zero) == 8  # 0, l, the largest multiple below 2^512 and k l for five k near 2^259


def _fold_before_csub(v: int) -> int:
    """The fold's value before its conditional subtraction of l, in integers."""
    low = (1 << 252) - 1
    x1 = (v >> 252) * SM.DELTA
    w = (x1 >> 252) * SM.DELTA + SM.L + (v & low) - (x1 & low)
    return (w & low) + SM.L - (w >> 252) * SM.DELTA


def test_scalar_header_constants_match_model():
    """csrc/scalar_l.cuh's l and delta words are the model's."""
    import re

    path = os.path.join(os.path.dirname(cr.__file__), "..", "csrc", "scalar_l.cuh")
    with open(path) as f:
        text = f.read()

    def words(name):
        body = re.search(r"#define " + name + r" \{([^}]*)\}", text).group(1)
        return [int(w.strip().rstrip("u"), 0) for w in body.split(",")]

    assert words("SC_L_WORDS") == SM.L_WORDS and words("SC_DELTA") == SM.DELTA_WORDS


def test_keccak_warp_lane_schedule_matches_host():
    """The warp's permutation as the model runs it (shuffles as lane tables,
    rho as swap and funnel shifts, lanes 25-31 along) against the host
    permutation, over two chained permutations."""
    a = np.random.default_rng(31).integers(0, 2**63, size=(5, 32), dtype=np.uint64) * np.uint64(2)
    want = a[:, :25].copy()
    for _ in range(2):
        a = cr.keccak_warp(a)
        want = keccak_f1600(want)
    assert np.array_equal(a[:, :25], want)


def test_span_program_spans_and_pool():
    """No span crosses a permutation: each lies below the rate (the constant
    block-end byte at STROBE_R + 1 aside) and the first after a permutation
    starts at 0.  The pool holds every constant byte, zeroes included: the
    finalize_null key is one 32-byte SET_CONST span of zeroes."""
    params, statements, proofs = _golden_batch(CELLS[2])
    fn, _, _ = _replay(params, statements, proofs)
    p = fn.program
    after_permute = False
    for kind, pos, length, arg in p.ops.tolist():
        if kind == cr.PERMUTE:
            after_permute = True
            continue
        if kind == cr.CHECK_ZERO:
            continue
        assert length > 0 and pos + length <= (STROBE_R + 2 if kind == cr.XOR_CONST else STROBE_R)
        if after_permute:
            assert pos == 0
            after_permute = False
    const = p.ops[np.isin(p.ops[:, 0], (cr.XOR_CONST, cr.SET_CONST))]
    assert int(const[:, 2].sum()) == len(p.pool)
    sets = p.ops[p.ops[:, 0] == cr.SET_CONST].tolist()
    assert len(sets) == 1 and sets[0][2] == 32 and p.pool[sets[0][3] : sets[0][3] + 32] == bytes(32)
    assert p.pool.count(0) > 32
    assert p.n_spans + p.n_permutations == len(p.ops) and p.n_challenges == len(proofs[0].li) + 3
