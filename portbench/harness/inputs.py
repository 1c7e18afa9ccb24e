"""The benchmark's one traffic generator: every input of a run from its seed.

A traffic mix is a JSON file of parameters (portbench/traffic/<name>.json);
this module reads it, with the configuration's sizes, and nothing else.
Every draw comes from a numpy generator keyed by the seed and the draw's own
place (the pool's group and index, the block's or call's number), so the
same seed gives the same inputs whatever else the run did, and every seed
gives the same sizes, shares and schedule in another order.  Imports neither
torch nor the port: the reference's workers call it to rebuild what a run
drew.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

L = 2**252 + 27742317777372353535851937790883648493
# Keys that separate the streams the generator draws from
POOL, BLOCK, CALL, WARM, PLACE = 1, 2, 3, 4, 5


def stream(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *keys])


class Output(NamedTuple):
    """One statement's secrets and public values: m commitments' values,
    their blindings (degree scalars each), their minimum-value promises and
    the seed nonce (or None)."""

    values: List[int]
    blindings: List[List[int]]
    promises: List[int]
    nonce: Optional[int]


def scalars(g: np.random.Generator, n: int) -> List[int]:
    raw = g.bytes(32 * n)
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") % L or 1 for i in range(n)]


def outputs(g: np.random.Generator, count: int, m: int, bits: int, degree: int, seeded: bool,
            promise_every: int, first: int = 0) -> List[Output]:
    """`count` statements of `m` commitments each.  Values are uniform below
    2^bits; commitment j (counted from `first` over the run) carries a
    nonzero promise, a uniform fraction of its value, when
    j % promise_every == 0, else the promise 0."""
    values = g.integers(0, 2**bits, size=(count, m), dtype=np.uint64, endpoint=False)
    blinds = scalars(g, count * m * degree)
    nonces = scalars(g, count) if seeded else [None] * count
    fractions = g.integers(0, 2**32, size=(count, m), dtype=np.uint64)
    out = []
    for i in range(count):
        vs = [int(v) for v in values[i]]
        promises = [
            (v * int(f)) >> 32 if (first + i * m + j) % promise_every == 0 else 0
            for j, (v, f) in enumerate(zip(vs, fractions[i]))
        ]
        bl = [blinds[(i * m + j) * degree : (i * m + j + 1) * degree] for j in range(m)]
        out.append(Output(vs, bl, promises, nonces[i]))
    return out


def pool_outputs(seed: int, traffic: dict, config: dict) -> List[List[Output]]:
    """The verify cells' pool, one list of outputs a group of the mix's
    `pool` (each group its own m and count)."""
    return [
        outputs(stream(seed, POOL, k), group["count"], group["m"], config["bits"], config["extension_degree"],
                traffic.get("seed_nonce", False), traffic["promise_every"])
        for k, group in enumerate(traffic["pool"])
    ]


class Block(NamedTuple):
    """A block: its proofs as (pool group, index in the group), in arrival
    order, and the position of its tampered proof (or None)."""

    proofs: List[tuple]
    tampered: Optional[int]


def tampered_place(seed: int, traffic: dict, call: int, key: int = BLOCK) -> Optional[int]:
    """The place, among the `blocks_per_call` blocks of call `call`, of the
    block that carries a tampered proof, or None: every `tamper_every`-th
    call carries one.  The places of `blocks_per_call` such calls in a row
    are a seeded permutation, so every place of a call is refused in turn
    and every seed makes the same work."""
    every, per_call = traffic.get("tamper_every", 0), traffic.get("blocks_per_call", 1)
    if not every or call % every != every - 1:
        return None
    t = call // every
    return int(stream(seed, PLACE, key, t // per_call).permutation(per_call)[t % per_call])


def block(seed: int, traffic: dict, number: int, key: int = BLOCK) -> Block:
    """Block `number` of the stream: each group of the mix's `block` draws
    its count from its pool group without replacement; a mix of several
    groups is shuffled; the block at its call's `tampered_place` carries
    one tampered proof, at a seeded position."""
    g = stream(seed, key, number)
    proofs = []
    for share in traffic["block"]:
        picks = g.choice(traffic["pool"][share["group"]]["count"], size=share["count"], replace=False)
        proofs += [(share["group"], int(i)) for i in picks]
    if len(traffic["block"]) > 1:
        proofs = [proofs[i] for i in g.permutation(len(proofs))]
    per_call = traffic.get("blocks_per_call", 1)
    place = tampered_place(seed, traffic, number // per_call, key)
    tampered = int(g.integers(len(proofs))) if place == number % per_call else None
    return Block(proofs, tampered)


def call_outputs(seed: int, traffic: dict, config: dict, number: int, key: int = CALL) -> List[Output]:
    """The prove cells' call `number`: `outputs_per_call` fresh statements."""
    count, m = traffic["outputs_per_call"], traffic["m"]
    return outputs(stream(seed, key, number), count, m, config["bits"], config["extension_degree"],
                   traffic.get("seed_nonce", False), traffic["promise_every"], first=number * count * m)


def tamper(proof: bytes, degree: int, field: str) -> bytes:
    """The proof with one response scalar (r1, s1 or d1[0]) moved by one,
    still canonical: a well-formed proof that must not verify."""
    offset = {"d1": 1, "r1": 1 + 32 * degree + 96, "s1": 1 + 32 * degree + 128}[field]
    value = (int.from_bytes(proof[offset : offset + 32], "little") + 1) % L
    return proof[:offset] + value.to_bytes(32, "little") + proof[offset + 32 :]


def sample(seed: int, population: int, k: int, key: int) -> List[int]:
    """k distinct indices below `population`, drawn from the seed."""
    g = stream(seed, key, population)
    return sorted(int(i) for i in g.choice(population, size=min(k, population), replace=False))
