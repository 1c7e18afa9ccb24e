"""Seeded inputs of the scalar pass, shared by the port's CPU tests
(tests/test_torch_scalar.py) and its card tests (tests/test_torch_cuda.py).
This module imports numpy and the port only, so that the card tests run
where JAX is not installed."""

import numpy as np

from bulletproofs_plus_tpu_torch.ops.limbs import pack_ints
from bulletproofs_plus_tpu_torch.ops.scalar_model import L


def scalar_inputs(batch, m, n, deg, seed, mins=False, zero_lane=None, one_y=None):
    """Scalar-pass inputs as numpy int64 limbs: canonical scalars, minimum
    values below 2^63 (or zero), round challenge e_k of `zero_lane` zero, y
    of `one_y` 1."""
    rs = np.random.default_rng(seed)
    rounds = (m * n).bit_length() - 1

    def scalars(*shape):
        vals = [int.from_bytes(rs.bytes(32), "little") % L for _ in range(int(np.prod(shape)))]
        return pack_ints(vals).astype(np.int64).reshape(shape + (16,))

    args = {"y": scalars(batch), "z": scalars(batch), "round_es": scalars(batch, rounds), "e": scalars(batch),
            "weight": scalars(batch), "r1": scalars(batch), "s1": scalars(batch), "d1": scalars(batch, deg),
            "min_values": pack_ints([int(rs.integers(0, 2**63)) if mins else 0 for _ in range(batch * m)])
            .astype(np.int64).reshape(batch, m, 16)}
    if zero_lane is not None:
        args["round_es"][zero_lane, rounds - 1] = 0
    if one_y is not None:
        args["y"][one_y] = pack_ints([1])[0]
    return args
