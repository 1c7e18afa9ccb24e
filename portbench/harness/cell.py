"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result's lines.

The cell, its configuration and its traffic mix are found by name from
BENCHMARK.json (configs' `file`, portbench/traffic/<traffic>.json), each
metric's reader at portbench/metrics/<metric>.py; a later cell or metric
is files and entries, never an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

from . import check, entries, faults, host, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "bulletproofs_plus_tpu")
LIMITS = {"verdicts_wrong": 0, "decode_wrong": 0, "proofs_wrong": 0, "commitments_wrong": 0}


def load(root: str, workload: str):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def reported(bench: dict, cell: dict, traced: bool) -> list:
    """The metrics a run of `cell` prints: its end-to-end metrics untraced,
    its per-layer ones traced."""
    e2e = [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in names else [])]


def reader(root: str, name: str):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def run(args, t_start: float, root: str, conditions: dict) -> int:
    import torch

    host.fix_torch(conditions)
    bench, cell, config, traffic = load(root, args.workload)
    if args.device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    traced = bool(args.trace)
    spans = entries.Spans(traced)
    entry = entries.ENTRIES[traffic["entry"]](args.seed, config, traffic, args.device, spans)
    entry.setup()
    if args.fault:
        faults.apply(entry, args.fault)
    if args.device == "cuda":
        torch.cuda.synchronize()
    host.settle()
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
        prof = profile(activities=activities)
        prof.__enter__()
    with host.Window() as window:
        if traced:
            span = record_function(trace.WINDOW)
            span.__enter__()
        t0, t0_epoch = time.perf_counter(), time.time()
        steps = []
        while True:
            entry.step()
            steps.append(time.perf_counter() - t0)
            if steps[-1] >= args.seconds:
                break
        if args.device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if traced:
            span.__exit__(None, None, None)
    if traced:
        prof.__exit__(None, None, None)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())} if args.device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    reduced = None
    if traced:
        reduced = trace.reduce(*trace.events(prof))
        prof = None
        device["busy_s"], device["window_s"] = reduced["busy_s"], reduced["window_s"]

    workers = max(1, min(8, conditions["cpus_allowed"]))
    cpus = sorted(conditions.get("all_cpus", []))
    compare = check.verify_checks if isinstance(entry, entries.VerifyStream) else check.prove_checks
    t_check = time.perf_counter()
    compared = compare(entry, workers, cpus)
    check_s = time.perf_counter() - t_check

    record = SimpleNamespace(setup_s=setup_s, window_s=window_s, counts=dict(entry.counts), spans=spans.times,
                             trace=reduced, least_s=entry.least_s,
                             kind="verify" if isinstance(entry, entries.VerifyStream) else "prove")
    metrics = {}
    for m in reported(bench, cell, traced):
        value = reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not traced:
            print(f"portbench: end-to-end metric {m['name']} read nothing", file=sys.stderr)
            return 4

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 5
    attempted = entry.counts.get("blocks", entry.counts["calls"])
    failed = sum(compared.values())
    correct = all(compared[k] <= LIMITS[k] for k in compared) and attempted > 0
    print(json.dumps({
        "host": conditions, "window": window.counters, "setup_s": setup_s, "window_s": window_s,
        "counts": entry.counts, "spans": {k: [len(v), sum(v)] for k, v in spans.times.items()},
        "trace_events": reduced["device_events"] if reduced else None, "fault": args.fault,
        "check_s": check_s, "step_ends_s": steps, "window_start_epoch": t0_epoch,
    }), flush=True)
    for k, v in compared.items():
        print(f"check {k} {v} limit {LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if reduced:
        result["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in compared.items()}
    print(json.dumps(result), flush=True)
    return 0
