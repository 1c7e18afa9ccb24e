"""The external RNG the benchmark hands to both sides.

`StreamRng(seed, call)` is the batched form the port's prover takes
(`fill_bytes(batch, n)` -> (batch, n) uint8, one row a lane, a counter
a call); `LaneRng(seed, call, lane)` gives the same bytes as lane `lane`
of it under the same call sequence, in the one-lane form the reference's
sequential prover takes.  Each row is SHAKE-256 of the run's seed, the
prove call, the draw's count and the lane.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _row(seed: int, call: int, count: int, lane: int, n: int) -> np.ndarray:
    key = b"portbench-rng%" + b"%".join(
        int(x).to_bytes(16, "little", signed=True) for x in (seed, call, count, lane)
    )
    return np.frombuffer(hashlib.shake_256(key).digest(n), dtype=np.uint8)


class StreamRng:
    def __init__(self, seed: int, call: int):
        self.seed, self.call, self.count = seed, call, 0

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        out = np.stack([_row(self.seed, self.call, self.count, lane, n) for lane in range(batch)])
        self.count += 1
        return out


class LaneRng:
    def __init__(self, seed: int, call: int, lane: int):
        self.seed, self.call, self.lane, self.count = seed, call, lane, 0

    def fill_bytes(self, batch: int, n: int) -> np.ndarray:
        if batch != 1:
            raise ValueError("LaneRng is one lane's stream")
        out = _row(self.seed, self.call, self.count, self.lane, n)[None, :]
        self.count += 1
        return out
