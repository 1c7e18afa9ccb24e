"""Seeded inputs of the prover's kernels P1-P4 (csrc/prover.cu), shared by
the port's CPU tests (tests/test_torch_prover_kernels.py), its card tests
(tests/test_torch_cuda.py), chip_smoke.py and scripts/profile_torch_p2.py, and `LaneRng`, one lane of a batched SeededRng
for the sequential prover (tests/test_torch_prover.py,
tests/test_torch_parallel.py and chip_smoke.py).  Canonical scalars as numpy int64 limbs, from
numpy's seeded generator; y^k and y^-n consistent with one random y a proof.
This module imports numpy and the port only, so that the card tests run where
JAX is not installed."""

import hashlib

import numpy as np

from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints
from bulletproofs_plus_tpu_torch.ops.scalar_model import L


class LaneRng:
    """Single-lane view of SeededRng's per-lane stream (utils/merlin.py): the
    bytes that lane `lane` of a batched SeededRng with the same seed gives
    under the same call sequence."""

    def __init__(self, seed: int, lane: int):
        self.seed = seed
        self.lane = lane
        self._count = 0

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        assert batch == 1
        h = hashlib.shake_256(
            b"bppt-test-rng"
            + self.seed.to_bytes(8, "little")
            + b"%"
            + self._count.to_bytes(8, "little")
            + b"%"
            + self.lane.to_bytes(4, "little")
        )
        self._count += 1
        return np.frombuffer(h.digest(n), dtype=np.uint8).reshape(1, n).copy()


def _limbs(values, shape):
    return pack_ints([v % L for v in values]).astype(np.int64).reshape(tuple(shape) + (16,))


def _ints(rs, count):
    return [int.from_bytes(rs.bytes(32), "little") % L for _ in range(count)]


def _zero_free(rs, count):
    """Values below 2^252 none of whose sixteen limbs is zero."""
    return [sum(int(rs.integers(1, 1 << 16 if k < 15 else 1 << 12)) << (16 * k) for k in range(16))
            for _ in range(count)]


def _y_powers(ys, mn):
    """(y^1..y^(mn+1), y^-(mn >> (r + 1)) for each round r) a proof, as ints."""
    rounds = mn.bit_length() - 1
    pows, invs = [], []
    for y in ys:
        acc, row = 1, []
        for _ in range(mn + 1):
            acc = acc * y % L
            row.append(acc)
        pows.append(row)
        y_inv = pow(y, -1, L)
        invs.append([pow(y_inv, mn >> (r + 1), L) for r in range(rounds)])
    return pows, invs


def prep_inputs(batch, m, n, deg, seed):
    """P1's inputs: y, z, y^-1, the bits (batch, mn) and the blindings and alpha masks."""
    rs = np.random.default_rng(seed)
    mn = m * n
    ys = _ints(rs, batch)
    if batch > 1:
        ys[0] = 1  # every power of y 1
    return {"y": _limbs(ys, (batch,)), "z": _limbs(_ints(rs, batch), (batch,)),
            "y_inv": _limbs([pow(y, -1, L) for y in ys], (batch,)),
            "bits": rs.integers(0, 2, size=(batch, mn)).astype(np.int64),
            "r_blind": _limbs(_ints(rs, batch * m * deg), (batch, m, deg)),
            "alpha0": _limbs(_ints(rs, batch * deg), (batch, deg))}


def _fold(rs, batch, deg, zero_free):
    values = _zero_free if zero_free else _ints
    es = values(rs, batch)
    return (_limbs(es, (batch,)), _limbs([pow(e, -1, L) for e in es], (batch,)),
            _limbs(_ints(rs, batch * deg), (batch, deg)), _limbs(_ints(rs, batch * deg), (batch, deg)))


def round_inputs(batch, m, n, deg, r, seed, zero_free=False):
    """P2's inputs for round r: compact a and b of 4n values (2n in round 0),
    g and h, alpha, the fold (None in round 0; its e zero-free if asked),
    y's powers, and the round's masks d_L and d_R."""
    rs = np.random.default_rng(seed)
    mn = m * n
    half = mn >> (r + 1)
    width = 2 * half if r == 0 else 4 * half
    pows, invs = _y_powers(_ints(rs, batch), mn)
    return {"a": _limbs(_ints(rs, batch * width), (batch, width)),
            "b": _limbs(_ints(rs, batch * width), (batch, width)),
            "g": None if r == 0 else _limbs(_ints(rs, batch * mn), (batch, mn)),
            "h": None if r == 0 else _limbs(_ints(rs, batch * mn), (batch, mn)),
            "alpha": _limbs(_ints(rs, batch * deg), (batch, deg)),
            "fold": None if r == 0 else _fold(rs, batch, deg, zero_free),
            "y_pows": _limbs([v for row in pows for v in row], (batch, mn + 1)),
            "y_inv_n": _limbs([v for row in invs for v in row], (batch, mn.bit_length() - 1)),
            "d_l": _limbs(_ints(rs, batch * deg), (batch, deg)), "d_r": _limbs(_ints(rs, batch * deg), (batch, deg))}


def final_inputs(batch, m, n, deg, seed, zero_free=False):
    """P3's first entry's inputs: a and b of 2 values (1 without rounds), g,
    h, alpha, the last round's fold, y's powers, and the masks r, s, d, eta."""
    rs = np.random.default_rng(seed)
    mn = m * n
    rounds = mn.bit_length() - 1
    width = 2 if rounds else 1
    pows, invs = _y_powers(_ints(rs, batch), mn)
    return {"a": _limbs(_ints(rs, batch * width), (batch, width)),
            "b": _limbs(_ints(rs, batch * width), (batch, width)),
            "g": _limbs(_ints(rs, batch * mn), (batch, mn)) if rounds else None,
            "h": _limbs(_ints(rs, batch * mn), (batch, mn)) if rounds else None,
            "alpha": _limbs(_ints(rs, batch * deg), (batch, deg)),
            "fold": _fold(rs, batch, deg, zero_free) if rounds else None,
            "y_pows": _limbs([v for row in pows for v in row], (batch, mn + 1)),
            "y_inv_n": _limbs([v for row in invs for v in row], (batch, rounds)),
            "r_s": _limbs(_ints(rs, batch), (batch,)), "s_s": _limbs(_ints(rs, batch), (batch,)),
            "d_mask": _limbs(_ints(rs, batch * deg), (batch, deg)), "eta": _limbs(_ints(rs, batch * deg), (batch, deg))}


def responses_inputs(batch, deg, seed):
    """P3's second entry's inputs: r, s, a0, b0, eta, d_mask, alpha and e."""
    rs = np.random.default_rng(seed)
    one = {k: _limbs(_ints(rs, batch), (batch,)) for k in ("r_s", "s_s", "a0", "b0")}
    many = {k: _limbs(_ints(rs, batch * deg), (batch, deg)) for k in ("eta", "d_mask", "alpha")}
    return {**one, **many, "e": _limbs(_ints(rs, batch), (batch,))}


def bit_sum_inputs(batch, m, n, deg, device, seed):
    """P4's inputs on `device`: the tables the prove sums, the halved
    generators' joined with the halved Pedersen bases'
    (`BulletproofGens.halved_tables_joined`); bits (batch, mn), lane 0 all
    ones and lane 1 (where there is one) all zeros; and seeded start points,
    contiguous and as K6 leaves them (a (batch, 16) view of limb-major
    storage)."""
    import torch

    import bulletproofs_plus_tpu_torch as tbp
    from bulletproofs_plus_tpu_torch.ops import edwards as ed
    from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr

    mn = m * n
    pc = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(deg))
    table = tbp.RangeParameters.init(n, m, pc).bp_gens.halved_tables_joined(2 * mn, pc, device)
    rs = np.random.RandomState(seed)
    bits = rs.randint(0, 2, size=(batch, mn)).astype(np.int64)
    bits[0] = 1
    bits[1:2] = 0
    start = ed.from_host([hr.point_mul(int(rs.randint(1, 2**31)), hr.BASEPOINT) for _ in range(batch)], device=device)
    view = ed.PointArray(*(c.t().contiguous().t() for c in start))
    return table, torch.as_tensor(bits, device=device), start, view


def to_device(inputs, torch, device):
    """The same inputs as torch tensors on `device` (a fold as a tuple of them)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return torch.as_tensor(v, device=device)

    return {k: conv(v) for k, v in inputs.items()}
