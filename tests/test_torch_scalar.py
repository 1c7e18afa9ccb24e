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


def _plain(args, **kw):
    return [t.numpy() for t in TV.scalar_pass_plain(**{k: torch.as_tensor(v) for k, v in args.items()}, **kw)]


# (batch, m, bit length, extension degree, max_mn, minimum values, zero-challenge lane, lane with y = 1)
MODEL_CASES = {
    "b2_mn8_deg2_min_padded": (2, 1, 8, 2, 16, True, None, None),
    "b2_mn8_zero_challenge_y_one": (2, 2, 4, 1, 8, False, 0, 1),
    "b2_mn1": (2, 1, 1, 3, 2, True, None, None),
    "b33_mn2": (33, 1, 2, 1, 2, False, 5, None),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_scalar_model_matches_plain(case):
    """S1's programs in Python (S1a proof by proof, S1b's blocks with their
    threads striding over the proofs and the tree of sums) equal the plain
    scalar pass limb for limb at mn = 8 (padding, degree 2, minimum values;
    a zero challenge and a y of 1 poisoning their lanes), at mn = 1 (no
    rounds: the batch inversion covers y and y - 1 alone) and at 33 proofs
    (S1b's blocks of 64 threads, a tree over 33 terms and 31 zeros)."""
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
    """csrc/scalar_l.cuh's Fermat exponent is the model's l - 2; the kernel's
    round cap, block sizes and scratch columns are the wrapper's."""
    with open(os.path.join(CSRC, "scalar_l.cuh")) as f:
        header = f.read()
    body = re.search(r"SC_L_MINUS_2\[8\] = \{([^}]*)\}", header).group(1)
    assert [int(w.strip().rstrip("u"), 0) for w in body.split(",")] == SM.LM2_WORDS
    with open(os.path.join(CSRC, "scalar_pass.cu")) as f:
        source = f.read()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", source).group(1))

    assert define("S1_MAX_ROUNDS") == cs.MAX_ROUNDS and define("S1_PROOF_THREADS") == cs.PROOF_THREADS
    assert define("S1_MAX_LANE_THREADS") == cs.LANE_THREAD_CHOICES[-1]
    assert [define(c) for c in ("COL_A", "COL_D", "COL_C", "COL_H", "COL_CHSQ")] == [
        cs.COL_A, cs.COL_D, cs.COL_C, cs.COL_H, cs.COL_CHSQ]


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
    """The port's plain scalar pass against the JAX package's jitted one,
    output for output, limb for limb, on a 3-proof m=2 group of extension
    degree 2 padded to twice its mn: without and with minimum values, and
    with a lane whose zero challenge poisons its inversions."""
    batch, m, n, deg, max_mn = JAX_SHAPE
    mins, zero_lane = JAX_CASES[case]
    args = _inputs(batch, m, n, deg, 7, mins, zero_lane)
    want = jax_program.result()(**{k: v.astype(np.uint32) for k, v in args.items()})
    got = _plain(args, m=m, bit_length=n, max_mn=max_mn)
    assert len(got) == len(want) == 10
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == np.shape(w) and np.array_equal(g, np.asarray(w).astype(np.int64)), k
    assert not got[0][m * n:].any() and not got[1][m * n:].any()  # the padding lanes
    if zero_lane is not None:
        assert not got[9][zero_lane].any() and got[9][0].any()
