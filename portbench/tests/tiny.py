"""A copy of the benchmark at tiny sizes, for runs on the CPU: the same
BENCHMARK.json, metric readers and cells, with 8-bit ranges, pools of a
few proofs, short blocks and calls."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY = {
    "sync": {"pool": [{"m": 1, "count": 16, "prove_batch": 8}], "block": [{"group": 0, "count": 8}],
             "blocks_per_call": 2, "tamper_every": 1, "decode_every": 2, "reference_chunk": 8},
    "payout": {"outputs_per_call": 4, "proof_sample": 4},
    "prove_m4": {"outputs_per_call": 2, "proof_sample": 3},
}


def tiny_root(path: str) -> str:
    """Write the tiny copy under `path` and return it."""
    os.makedirs(os.path.join(path, "portbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "portbench", "traffic"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    metrics = os.path.join(path, "portbench", "metrics")
    if not os.path.exists(metrics):
        shutil.copytree(os.path.join(ROOT, "portbench", "metrics"), metrics)
    for name in os.listdir(os.path.join(ROOT, "portbench", "configs")):
        with open(os.path.join(ROOT, "portbench", "configs", name)) as f:
            config = json.load(f)
        config["bits"] = 8
        with open(os.path.join(path, "portbench", "configs", name), "w") as f:
            json.dump(config, f)
    for name in os.listdir(os.path.join(ROOT, "portbench", "traffic")):
        with open(os.path.join(ROOT, "portbench", "traffic", name)) as f:
            traffic = json.load(f)
        traffic.update(TINY[name[: -len(".json")]])
        with open(os.path.join(path, "portbench", "traffic", name), "w") as f:
            json.dump(traffic, f)
    return path
