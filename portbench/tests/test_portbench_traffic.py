"""The traffic generator: the same seed gives the same inputs, and blocks
and calls have the shapes and shares their mix states."""

import json
import os
from collections import Counter

import pytest

from portbench.harness import inputs
from portbench.tests.tiny import ROOT

SEED = 2**31 + 11


def _load(kind, name):
    with open(os.path.join(ROOT, "portbench", kind, f"{name}.json")) as f:
        return json.load(f)


def test_portbench_blocks_repeat_and_keep_their_shares():
    mix = _load("traffic", "sync")
    blocks = [inputs.block(SEED, mix, n) for n in range(64)]
    assert blocks == [inputs.block(SEED, mix, n) for n in range(64)]
    assert blocks != [inputs.block(SEED + 1, mix, n) for n in range(64)]
    for n, b in enumerate(blocks):
        assert len(b.proofs) == sum(s["count"] for s in mix["block"]) == 256
        assert len(set(b.proofs)) == len(b.proofs)  # without replacement
        shares = Counter(g for g, _ in b.proofs)
        assert shares == {s["group"]: s["count"] for s in mix["block"]}
        assert all(i < mix["pool"][g]["count"] for g, i in b.proofs)


def test_portbench_sync_refuses_every_place_of_a_call_in_turn():
    mix = _load("traffic", "sync")
    per_call, every = mix["blocks_per_call"], mix["tamper_every"]
    assert (per_call, every) == (8, 4)
    for seed in (SEED, SEED + 1):
        places = []
        for call in range(2 * per_call * every):
            tampered = [n % per_call for n in range(call * per_call, (call + 1) * per_call)
                        if inputs.block(seed, mix, n).tampered is not None]
            assert tampered == ([inputs.tampered_place(seed, mix, call)] if call % every == every - 1 else [])
            places += tampered
        # each run of per_call refused calls refuses every place once
        assert sorted(places[:per_call]) == sorted(places[per_call:]) == list(range(per_call))
    assert [inputs.tampered_place(SEED, mix, c) for c in range(3, 64, 4)] != [
        inputs.tampered_place(SEED + 1, mix, c) for c in range(3, 64, 4)]


@pytest.mark.parametrize("traffic,config", [("payout", "tari_m1"), ("prove_m4", "agg")])
def test_portbench_calls_repeat_and_keep_their_shapes(traffic, config):
    mix, cfg = _load("traffic", traffic), _load("configs", config)
    calls = [inputs.call_outputs(SEED, mix, cfg, n) for n in range(3)]
    assert calls == [inputs.call_outputs(SEED, mix, cfg, n) for n in range(3)]
    assert calls[0] != inputs.call_outputs(SEED + 1, mix, cfg, 0)
    promises = []
    for outs in calls:
        assert len(outs) == mix["outputs_per_call"]
        for o in outs:
            assert len(o.values) == len(o.promises) == len(o.blindings) == mix["m"]
            assert all(len(b) == cfg["extension_degree"] for b in o.blindings)
            assert all(0 <= p <= v < 2**64 for p, v in zip(o.promises, o.values))
            assert (o.nonce is not None) == mix["seed_nonce"]
            promises += o.promises
    commitments = len(promises)
    assert sum(p != 0 for p in promises) == pytest.approx(commitments / 8, abs=2)
    values = [v for outs in calls for o in outs for v in o.values]
    assert max(values) > 2**60  # values span the 64-bit range


def test_portbench_pool_repeats_and_is_distinct():
    mix, cfg = _load("traffic", "sync"), _load("configs", "tari_m1")
    pool = inputs.pool_outputs(SEED, mix, cfg)
    assert pool == inputs.pool_outputs(SEED, mix, cfg)
    assert [len(g) for g in pool] == [1024]
    assert all(len(o.values) == 1 and o.nonce is not None for o in pool[0])
    assert len({(tuple(o.values), o.nonce) for o in pool[0]}) == 1024


def test_portbench_tamper_moves_one_scalar_and_stays_canonical():
    proof = bytes(range(200)) + bytes(200)
    for field, degree in (("r1", 1), ("r1", 5), ("s1", 1), ("d1", 5)):
        out = inputs.tamper(proof, degree, field)
        diff = [i for i in range(len(proof)) if out[i] != proof[i]]
        offset = {"d1": 1, "r1": 1 + 32 * degree + 96, "s1": 1 + 32 * degree + 128}[field]
        assert diff and offset <= min(diff) and max(diff) < offset + 32
        value = int.from_bytes(out[offset: offset + 32], "little")
        assert value == (int.from_bytes(proof[offset: offset + 32], "little") + 1) % inputs.L < inputs.L


def test_portbench_huge_seed_is_accepted():
    mix = _load("traffic", "sync")
    assert inputs.block(2**33 + 5, mix, 0) == inputs.block(2**33 + 5, mix, 0)
