"""The port's Pedersen commitments over fixed-base tables, on the CPU.

`PedersenGens.commit` adds table entries (`host_ristretto.fixed_base_table`,
`fixed_mul_add`); the oracle is the double-and-add sum
`point_mul(v, H) + sum_k point_mul(r_k, G_k)`.  Points are compared after
`compress` and by ristretto equality.  The tables of all seven bases build
in about a second, once a process.
"""

import hashlib
import sys
import threading
import time

import pytest

import bulletproofs_plus_tpu_torch as tbp
from bulletproofs_plus_tpu_torch.errors import InvalidLength
from bulletproofs_plus_tpu_torch.gens import pedersen
from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr
from bulletproofs_plus_tpu_torch.utils import trace

L = hr.L
VALUES = [0, 1, 2**64 - 1, "random"]
BLINDING_EDGES = [0, 1, L - 1, L, L + 1, 2**256 - 1]


def _det(tag: str, bits: int = 256) -> int:
    return int.from_bytes(hashlib.shake_256(tag.encode()).digest(64), "little") % (1 << bits)


def _gens(degree: int):
    return tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(degree))


def _double_and_add(pc, value, blindings):
    acc = hr.point_mul(value, pc.h_base)
    for r, g in zip(blindings, pc.g_base_vec):
        acc = hr.point_add(acc, hr.point_mul(r, g))
    return acc


def _same(got, want):
    assert hr.compress(got) == hr.compress(want)
    assert hr.point_equal(got, want)


@pytest.mark.parametrize("value", VALUES, ids=["0", "1", "2^64-1", "random"])
@pytest.mark.parametrize("degree", range(1, 7))
def test_torch_pedersen_commit_matches_double_and_add(degree, value):
    """Every edge blinding in every base's place, the rest random, and one
    vector all random."""
    pc = _gens(degree)
    if value == "random":
        value = _det(f"v-{degree}", 64)
    vectors = [[_det(f"r-{degree}-{i}-{k}") for k in range(degree)] for i in range(len(BLINDING_EDGES) + 1)]
    for i, edge in enumerate(BLINDING_EDGES):
        vectors[i][i % degree] = edge
    for blindings in vectors:
        _same(pc.commit(value, blindings), _double_and_add(pc, value, blindings))


def test_torch_pedersen_commit_of_zero_is_the_identity():
    pc = _gens(6)
    assert hr.is_identity(pc.commit(0, [0] * 6))
    assert hr.is_identity(pc.commit(L, [L, 2 * L, 0, L, 3 * L, 0]))
    assert hr.compress(pc.commit(0, [L])) == hr.compress(hr.IDENTITY)


@pytest.mark.parametrize("length", range(1, 6))
def test_torch_pedersen_shorter_blinding_vector_takes_the_first_bases(length):
    pc = _gens(6)
    blindings = [_det(f"short-{length}-{k}") for k in range(length)]
    value = _det(f"short-{length}", 64)
    got = pc.commit(value, blindings)
    _same(got, _double_and_add(pc, value, blindings))
    _same(got, _gens(length).commit(value, blindings))


@pytest.mark.parametrize("degree, length", [(1, 0), (1, 2), (3, 0), (3, 4), (6, 7)])
def test_torch_pedersen_commit_refuses_the_blinding_length(degree, length):
    with pytest.raises(InvalidLength):
        _gens(degree).commit(5, [1] * length)


def test_torch_pedersen_tables_built_once_a_base_and_shared(monkeypatch):
    """A fresh cache: two `PedersenGens` with the same bases build each
    base's table once between them; every commit is timed."""
    monkeypatch.setattr(pedersen, "_tables", {})
    trace.disable()
    trace.reset()
    trace.enable()
    try:
        first, second = _gens(2), _gens(2)
        assert first is not second and first == second
        a = first.commit(3, [4, 5])
        b = second.commit(3, [4, 5])
        second.commit(6, [7])
        timers = trace.snapshot()["timers"]
    finally:
        trace.disable()
        trace.reset()
    assert hr.compress(a) == hr.compress(b)
    assert timers["pedersen.tables"]["count"] == 3  # H, G_1, G_2
    assert timers["pedersen.commit"]["count"] == 3
    assert set(pedersen._tables) == {first.h_base_compressed, *first.g_base_compressed_vec}


def test_torch_pedersen_tables_stay_bounded(monkeypatch):
    monkeypatch.setattr(pedersen, "_tables", {})
    monkeypatch.setattr(pedersen, "_TABLES_MAX", 2)
    monkeypatch.setattr(hr, "fixed_base_table", lambda point: ("table", point))
    bases = [hr.point_mul(k, hr.BASEPOINT) for k in (2, 3, 4)]
    for p in bases:
        assert pedersen.base_table(p, hr.compress(p)) == ("table", p)
    assert list(pedersen._tables) == [hr.compress(p) for p in bases[1:]]


def test_torch_pedersen_tables_threads_share_one_bounded_cache(monkeypatch):
    """More threads than cores, switching often, over more bases than the
    cache holds: every lookup gets its own base's whole table and the cache
    never passes its bound."""
    monkeypatch.setattr(pedersen, "_tables", {})
    monkeypatch.setattr(pedersen, "_TABLES_MAX", 4)

    def build(point):
        time.sleep(0)  # hand the interpreter to another thread mid-build
        return ("table", point)

    monkeypatch.setattr(hr, "fixed_base_table", build)
    bases = [(k, 1, 1, k) for k in range(6)]  # stand-ins: the fake builder reads nothing of them
    keys = [bytes([k]) * 32 for k in range(6)]
    threads, rounds = 16, 1000
    wrong, sizes = [], []

    def work(t):
        for i in range(rounds):
            k = (t + i) % len(bases)
            if pedersen.base_table(bases[k], keys[k]) != ("table", bases[k]):
                wrong.append(k)
            sizes.append(len(pedersen._tables))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert wrong == [] and len(sizes) == threads * rounds and max(sizes) <= 4
    assert all(pedersen._tables[key] == ("table", bases[keys.index(key)]) for key in pedersen._tables)


@pytest.mark.parametrize("scalar", [L - 1, L, 2**253 - 1, 2**256 - 1, "random"],
                         ids=["l-1", "l", "2^253-1", "2^256-1", "random"])
def test_torch_pedersen_table_covers_every_digit(scalar):
    """Every byte of a scalar below 2^256, after its reduction mod l, has
    its entry, and the entries are the row's multiples of the base."""
    if scalar == "random":
        scalar = _det("digits")
    base = tbp.create_pedersen_gens_with_extension_degree(tbp.ExtensionDegree(1)).g_base_vec[0]
    table = pedersen.base_table(base, hr.compress(base))
    assert len(table) == hr.FIXED_WINDOWS and all(len(row) == 256 and row[0] is None for row in table)
    digits = (scalar % L).to_bytes(32, "little")
    for w, digit in enumerate(digits):
        if digit:
            y_plus_x, y_minus_x, t2d = table[w][digit]
            x = (y_plus_x - y_minus_x) * pow(2, -1, hr.P) % hr.P
            y = (y_plus_x + y_minus_x) * pow(2, -1, hr.P) % hr.P
            assert t2d == 2 * hr.D * x * y % hr.P
            assert hr.point_equal((x, y, 1, x * y % hr.P), hr.point_mul(digit << (8 * w), base))
    _same(hr.fixed_mul_add(hr.IDENTITY, scalar, table), hr.point_mul(scalar, base))
