"""Runs of the harness on the CPU at tiny sizes (`--device cpu`, which
skips the look for a card and runs the kernels' plain versions): the
result's last line and its keys, the host line before it, the numbers
compared on standard error, and `correct` false under the control and
under each fault the cells can have."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import inputs
from portbench.tests.tiny import ROOT, TINY, tiny_root

RUN = os.path.join(ROOT, "portbench", "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def run(root, workload, seed, seconds, trace=0, fault=None):
    cmd = [sys.executable, RUN, "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace), "--device", "cpu", "--root", root]
    if fault:
        cmd += ["--fault", fault]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), proc.stderr.strip().splitlines()


def _seed(place, late=False):
    """A seed whose first call is refused in its block at `place`, the
    tampered proof in that block's second half where `late`."""
    with open(os.path.join(ROOT, "portbench", "traffic", "sync.json")) as f:
        mix = dict(json.load(f), **TINY["sync"])
    size = sum(s["count"] for s in mix["block"])
    for s in range(2**31, 2**31 + 400):
        b = inputs.block(s, mix, place)
        if inputs.tampered_place(s, mix, 0) == place and (not late or b.tampered >= size // 2):
            return s
    raise AssertionError("no such seed")


@pytest.mark.parametrize("workload,trace", [("tari_m1.sync", 1), ("tari_m1.sync", 0), ("tari_m1.payout", 1),
                                            ("agg.prove_m4", 0)])
def test_portbench_dry_run_reaches_the_last_line(tiny, workload, trace):
    hostline, result, err = run(tiny, workload, 2**31 + 3, 1, trace)
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu"
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        kind = "verify" if "sync" in workload else "prove"
        assert f"device_idle_pct.{kind}" in result["metrics"]
    else:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    # the host line: conditions and window counters
    assert {"host", "window", "counts", "spans"} <= set(hostline)
    assert {"cpu_s", "wall_s", "voluntary_switches", "involuntary_switches", "gc_passes", "gc_s"} <= set(
        hostline["window"])
    assert hostline["host"]["threads"] == 1 and hostline["host"]["torch_threads"] == 1
    # standard error ends with each number compared beside its limit
    checks = [line.split() for line in err[-len(result["checks"]):]]
    assert [(c[1], int(c[2]), int(c[4])) for c in checks] == [
        (k, v["value"], v["limit"]) for k, v in result["checks"].items()]


def test_portbench_no_card_no_result(tiny):
    proc = subprocess.run([sys.executable, RUN, "--workload", "tari_m1.sync", "--seed", "1", "--seconds", "1",
                           "--trace", "0", "--root", tiny], capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_portbench_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: the run fails."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, str(tmp_path / "portbench" / "run.py"), "--workload", "tari_m1.sync",
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                          capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("fault,place", [("accept_all", 0), ("half_batch", 0), ("half_batch", 1), ("half_block", 0),
                                         ("half_block", 1), ("stale_state", 0), ("stale_state", 1),
                                         ("altered_answer", 1)])
def test_portbench_verify_faults_come_out_not_correct(tiny, fault, place):
    _, result, _ = run(tiny, "tari_m1.sync", _seed(place, late=fault == "half_block"), 1, fault=fault)
    assert result["correct"] is False and result["checks"]["verdicts_wrong"]["value"] >= 1


@pytest.mark.parametrize("fault", ["null_rng", "half_batch", "stale_state", "altered_answer"])
def test_portbench_prove_faults_come_out_not_correct(tiny, fault):
    _, result, _ = run(tiny, "tari_m1.payout", 2**31 + 5, 3 if fault == "stale_state" else 1, fault=fault)
    assert result["correct"] is False and result["checks"]["proofs_wrong"]["value"] >= 1
