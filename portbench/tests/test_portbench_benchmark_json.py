"""BENCHMARK.json against its required form: names, units, keys, and
the files each entry is found by."""

import json
import os
import re

from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_portbench_top_level_keys_and_command():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_portbench_names_and_units_use_the_allowed_characters():
    bench = _bench()
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] == 1 and w["config"] in names
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= set(cells)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_portbench_bounds_and_layer_metrics_name_what_they_move():
    bench = _bench()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for w in bench["workloads"]:  # every cell reports setup_s, another end-to-end metric, a per-layer metric
        own = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in own and len(own) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
