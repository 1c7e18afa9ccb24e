"""The port's scalar pass on the CPU: S1's GF(l) words (ops/scalar_model.py,
the word-exact model of csrc/scalar_l.cuh), S1's two programs
(ops/cuda_scalar.scalar_pass_model, the model of csrc/scalar_pass.cu) and
the plain torch scalar pass (models/verifier_kernels.scalar_pass_plain,
which `scalar_pass` runs on CPU tensors).

Held against Python integers, against each other, and against the JAX
package's jitted `scalar_pass` run on the CPU (XLA only; one compiled
shape).  Inputs come from seeds through numpy (tests/torch_scalar_inputs.py).
Tolerance: exact -- every output is a canonical scalar, so equal values are
equal limbs.  The kernel itself runs only on a card
(tests/test_torch_cuda.py -k scalar).
"""

import os
import re

import numpy as np
import pytest
import torch

from bulletproofs_plus_tpu.models import verifier_kernels as JV
from bulletproofs_plus_tpu_torch.models import verifier_kernels as TV
from bulletproofs_plus_tpu_torch.native import cuda
from bulletproofs_plus_tpu_torch.ops import cuda_scalar as cs
from bulletproofs_plus_tpu_torch.ops import scalar_model as SM
from torch_scalar_inputs import scalar_inputs as _inputs

L = SM.L
CSRC = os.path.join(os.path.dirname(cs.__file__), "..", "csrc")

torch.set_num_threads(1)  # small plain torch ops: keep parallel pytest workers off each other's cores


def _edge_values(seed):
    rs = np.random.default_rng(seed)
    return [0, 1, L - 1, L - 2, 2**252] + [int.from_bytes(rs.bytes(32), "little") % L for _ in range(6)]


def _w(v):
    return SM.to_words(v, 8)


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "inv"])
def test_scalar_model_field_ops_match_integers(op):
    """sc_mul_l, sc_sqr_l, sc_add_l, sc_sub_l and sc_inv_l word for word
    (every carry and bound checked) against Python integers on 0, 1, l - 1,
    l - 2, 2^252 and seeded values; the product also on values up to
    2^256 - 1, where only its reduction makes it canonical; inv(0) = 0."""
    vals = _edge_values(41)
    if op == "mul":
        wide = vals + [2**256 - 1, L, 2**255 + 12345]
        for a in wide:
            for b in wide:
                assert SM.from_words(SM.mul_l(_w(a), _w(b))) == a * b % L
    elif op == "sqr":
        for a in vals + [2**256 - 1]:
            assert SM.from_words(SM.sqr_l(_w(a))) == a * a % L
    elif op == "add":
        for a in vals:
            for b in vals:
                assert SM.from_words(SM.add_l(_w(a), _w(b))) == (a + b) % L
    elif op == "sub":
        for a in vals:
            for b in vals:
                assert SM.from_words(SM.sub_l(_w(a), _w(b))) == (a - b) % L
    else:
        for a in vals[:2] + vals[3:6]:
            assert SM.from_words(SM.inv_l(_w(a))) == (pow(a, L - 2, L) if a else 0)
        assert SM.from_words(SM.inv_l(_w(L - 1))) == L - 1


def test_scalar_model_fold_product_edges(monkeypatch):
    """sc_reduce_fold, the product's three folds of 2^252 = -delta, against
    Python integers where its bounds are tight: (2^256 - 1)^2 (the largest
    product), (l - 1)^2, l^2, products whose low 252 bits are 0 or 2^252 - 1
    (the first fold's L1 at its ends), 2^504, and 400 seeded pairs below
    2^256; the model asserts each fold's bound (X1 < 2^385, X2 < 2^258, v <
    2^260, r in (l - 2^133, l + 2^252)).  The final conditional subtraction
    both takes l away and keeps r."""
    seen = set()
    csub = SM._csub_l

    def recording(cc, r):
        out = csub(cc, r)
        seen.add(out == list(r))
        return out

    monkeypatch.setattr(SM, "_csub_l", recording)
    rs = np.random.default_rng(43)
    top = 2**256 - 1
    pairs = [(top, top), (L - 1, L - 1), (L, L), (top, 1), (2**252, 2**252), (2**252, top), (2**252 - 1, 2**252 - 1),
             (2**252 - 1, 1), (L, 1), (L + 1, L - 1), (2**253, 2**251), (1, 1), (0, top)]
    pairs += [(int.from_bytes(rs.bytes(32), "little"), int.from_bytes(rs.bytes(32), "little")) for _ in range(400)]
    for a, b in pairs:
        assert SM.from_words(SM.mul_l(_w(a), _w(b))) == a * b % L, (a, b)
    assert seen == {True, False}


def test_scalar_model_inverse_by_divsteps():
    """sc_inv_l's divsteps word for word against Python's pow(x, -1, l): 0
    (gives 0), 1, 2, l - 1, l - 2, (l + 1) / 2, 2^252, the small values
    3..40, the inputs of a seeded set that need the most and the fewest
    batches of 30 divsteps, and 100 seeded values; each also with batches
    run past its own g = 0 (as a warp runs them for its slowest lane), to
    the 20-batch cap, which leave the inverse the same."""
    rs = np.random.default_rng(44)
    rand = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(100)]
    batches = {v: SM.inv_batches(_w(v)) for v in rand}
    assert set(batches.values()) <= set(range(16, SM.INV_BATCHES + 1))
    longest, shortest = max(rand, key=batches.get), min(rand, key=batches.get)
    edges = [0, 1, 2, L - 1, L - 2, (L + 1) // 2, 2**252] + list(range(3, 41)) + [longest, shortest]
    for v in edges + rand:
        assert SM.from_words(SM.inv_l(_w(v))) == (pow(v, -1, L) if v else 0), v
    for v in edges[:8] + [longest, shortest]:
        want = SM.inv_l(_w(v))
        assert SM.inv_l(_w(v), extra_batches=1) == want
        assert SM.inv_l(_w(v), extra_batches=SM.INV_BATCHES) == want


def test_proof_program_schedule():
    """S1a's program: lanes a proof from the rounds (room for rounds + 2
    inversions, at least 8), the inversions all in one step, the 64-bit
    programs' chains of product steps (y^mn's squarings and two products
    after them), m = 512 past 1,024 slots, m = 1,024 at one proof a block,
    and m = 2,048, whose slots a block's shared memory cannot hold, in
    global memory."""
    assert [cs.lanes_per_proof(k) for k in (0, 6, 7, 14, 15, 30)] == [8, 8, 16, 16, 32, 32]
    for (rounds, m, deg), mul_steps in (((6, 1, 1), 9), ((8, 4, 5), 11), ((0, 1, 2), 7)):
        prog = cs.proof_program(rounds, m, deg)
        ops = prog.words[..., 2] >> cs.OP_SHIFT
        assert prog.mul_steps == mul_steps and prog.lanes == cs.lanes_per_proof(rounds)
        assert (ops[prog.inv_step] == cs.OP_MUL).sum() == rounds + 2 and prog.inv_step <= 1
        assert prog.slots <= cs.MAX_SLOTS and len(prog.outs) == m + 3 + 2 * rounds + cs.scratch_columns(
            rounds, m, deg)
    big = cs.proof_program(10, 512, 1)  # slot indices past 10 bits, shared memory past 48 KB
    assert big.slots > 1024 and cs.smem_bytes(big, 10, 512, 1) > 48 * 1024
    assert int(big.words[..., 2].max()) >> cs.OP_SHIFT < 4 and not cs.in_global(big, 10, 512, 1)
    one = cs.proof_program(10, 1024, 1)  # two proofs a block do not fit: one, at 32 lanes
    assert one.lanes == cs.WARP and not cs.in_global(one, 10, 1024, 1)
    wide = cs.proof_program(11, 2048, 1)
    assert wide.lanes == cs.WARP and cs.in_global(wide, 11, 2048, 1)
    assert int((wide.words[..., :2].max())) < wide.slots and len(wide.outs) == 2048 + 3 + 22 + cs.scratch_columns(
        11, 2048, 1)


def _plain(args, **kw):
    return [t.numpy() for t in TV.scalar_pass_plain(**{k: torch.as_tensor(v) for k, v in args.items()}, **kw)]


# (batch, m, bit length, extension degree, max_mn, minimum values, zero-challenge lane, lane with y = 1)
MODEL_CASES = {
    "b2_mn8_deg2_min_padded": (2, 1, 8, 2, 16, True, None, None),
    "b2_mn8_zero_challenge_y_one": (2, 2, 4, 1, 8, False, 0, 1),
    "b2_mn1": (2, 1, 1, 3, 2, True, None, None),
    "b3_mn1_y_one": (3, 1, 1, 1, 4, True, None, 2),
    "b3_m4_mn8_y_one": (3, 4, 2, 2, 8, True, None, 1),
    "b33_mn2": (33, 1, 2, 1, 2, False, 5, None),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_scalar_model_matches_plain(case):
    """S1's programs in Python (S1a's program proof by proof, S1b's blocks
    with their threads striding over the proofs and the tree of sums) equal
    the plain scalar pass limb for limb at mn = 8 (padding, degree 2,
    minimum values; a zero challenge and a y of 1 poisoning their proofs),
    at mn = 1 (no rounds: only y and y - 1 are inverted; one proof with
    y = 1), at m = 4 (the z^(2(j+1)) ladder's squarings; y = 1) and at 33
    proofs (S1b's blocks of 64 threads, a tree over 33 terms and 31
    zeros)."""
    batch, m, n, deg, max_mn, mins, zero_lane, one_y = MODEL_CASES[case]
    args = _inputs(batch, m, n, deg, 11, mins, zero_lane, one_y)
    got = cs.scalar_pass_model(**args, m=m, bit_length=n, max_mn=max_mn)
    want = _plain(args, m=m, bit_length=n, max_mn=max_mn)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), k
    if one_y is not None:
        assert not want[9][one_y].any()


def test_scalar_pass_routes_by_device():
    """`scalar_pass` runs the plain version on CPU tensors (no launch), and
    refuses a tensor on another device and shapes S1 does not take."""
    args = _inputs(2, 1, 4, 1, 3)
    kw = {"m": 1, "bit_length": 4, "max_mn": 4}
    cuda.reset_launches()
    got = TV.scalar_pass(**{k: torch.as_tensor(v) for k, v in args.items()}, **kw)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, _plain(args, **kw)))
    assert not cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        TV.scalar_pass(**{k: torch.as_tensor(v, device="meta") for k, v in args.items()}, **kw)
    with pytest.raises(ValueError, match="mn must be 2"):
        cs.check_shape(2, 3, 1, 4, 4)
    with pytest.raises(ValueError, match="max_mn"):
        cs.check_shape(2, 2, 1, 4, 2)
    with pytest.raises(ValueError, match="non-empty"):
        cs.check_shape(0, 2, 1, 4, 4)
    assert [cs.lane_threads(b) for b in (1, 32, 33, 100, 256, 257)] == [32, 32, 64, 128, 256, 256]


def test_scalar_sources_match_wrapper_constants():
    """csrc/scalar_l.cuh's delta, l in 30-bit limbs, l^-1 mod 2^30 and batch
    cap are the model's; the kernel's round, lane, slot and shared-memory
    caps, block sizes, scratch columns, program operations and input slots
    are the wrapper's."""
    with open(os.path.join(CSRC, "scalar_l.cuh")) as f:
        header = f.read()

    def array(name):
        body = re.search(rf"#define {name} \{{([^}}]*)\}}", header).group(1)
        return [int(w.strip().rstrip("u"), 0) for w in body.split(",")]

    assert array("SC_DELTA") == SM.DELTA_WORDS and array("SC_L_S30") == SM.L_S30
    assert int(re.search(r"#define SC_L_INV30 (\w+)u", header).group(1), 0) == SM.L_INV30
    assert int(re.search(r"#define SC_INV_BATCHES (\d+)", header).group(1)) == SM.INV_BATCHES
    with open(os.path.join(CSRC, "scalar_pass.cu")) as f:
        source = f.read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", source).group(1))

    assert define("S1_MAX_ROUNDS") == cs.MAX_ROUNDS and define("S1_WARP") == cs.WARP
    assert define("S1_MAX_SLOTS") == cs.MAX_SLOTS and define("SLOT_FIXED") == cs.IN_FIXED
    assert define("OP_SHIFT") == cs.OP_SHIFT and define("OP_WORDS") == cs.proof_program(6, 1, 1).words.shape[-1]
    assert define("S1_MAX_SMEM") == cs.MAX_SMEM
    assert define("S1_MAX_LANE_THREADS") == cs.LANE_THREAD_CHOICES[-1]
    assert [define(c) for c in ("COL_A", "COL_D", "COL_C", "COL_H", "COL_CHSQ")] == [
        cs.COL_A, cs.COL_D, cs.COL_C, cs.COL_H, cs.COL_CHSQ]
    assert [int(re.search(rf"#define {c} (\d+)u", source).group(1)) for c in ("OP_NOP", "OP_MUL", "OP_ADD", "OP_SUB")
            ] == [cs.OP_NOP, cs.OP_MUL, cs.OP_ADD, cs.OP_SUB]


# One compiled shape (batch, m, bit length, extension degree, max_mn): 3 proofs, m=2, degree 2, padded to twice
# its mn; the cases (minimum values, zero-challenge lane) differ in data only
JAX_SHAPE = (3, 2, 8, 2, 32)
JAX_CASES = {
    "b3_m2_deg2_padded": (False, None),
    "b3_m2_deg2_min_padded": (True, None),
    "b3_m2_deg2_min_padded_zero_challenge": (True, 1),
}


@pytest.fixture(scope="module", autouse=True)
def jax_program():
    """The JAX package's jitted scalar pass at JAX_SHAPE, lowered and
    compiled in a thread from the module's first test on (some 40 s of XLA
    on one core), while the module's other tests, which come first, run."""
    from concurrent.futures import ThreadPoolExecutor

    batch, m, n, deg, max_mn = JAX_SHAPE
    args = {k: v.astype(np.uint32) for k, v in _inputs(batch, m, n, deg, 0).items()}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: JV.scalar_pass.lower(**args, m=m, bit_length=n, extension_degree=deg,
                                                       max_mn=max_mn).compile())


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_plain_scalar_pass_matches_jax(case, jax_program):
    """The port's plain scalar pass and S1's programs in Python against the
    JAX package's jitted one, output for output, limb for limb, on a 3-proof
    m=2 group of extension degree 2 padded to twice its mn: without and with
    minimum values, and with a lane whose zero challenge poisons its
    inversions."""
    batch, m, n, deg, max_mn = JAX_SHAPE
    mins, zero_lane = JAX_CASES[case]
    args = _inputs(batch, m, n, deg, 7, mins, zero_lane)
    want = jax_program.result()(**{k: v.astype(np.uint32) for k, v in args.items()})
    got = _plain(args, m=m, bit_length=n, max_mn=max_mn)
    model = cs.scalar_pass_model(**args, m=m, bit_length=n, max_mn=max_mn)
    assert len(got) == len(want) == len(model) == 10
    for k, (g, w, md) in enumerate(zip(got, want, model)):
        assert g.shape == np.shape(w) and np.array_equal(g, np.asarray(w).astype(np.int64)), k
        assert np.array_equal(md, g), k
    assert not got[0][m * n:].any() and not got[1][m * n:].any()  # the padding lanes
    if zero_lane is not None:
        assert not got[9][zero_lane].any() and got[9][0].any()
