"""BENCHMARK.json against the contract's form, and every file it names
found by name."""
import json
import os
import re

import pytest

from lpbench.spec import BENCH_DIR, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = Spec()
B = SPEC.bench


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert len(B["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_and_units(group, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for k in ("why", "layer", "source"):
        if k in entry and group != "end_to_end" and k != "source":
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    for k in entry.get("reduced", []):
        assert NAME.match(k)


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_bounds():
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_files_found_by_name(cell):
    w = SPEC.cell(cell)
    assert w["chips"] == 1
    cfg, raw = SPEC.config(w["config"])
    assert json.loads(raw)["source"]
    traffic = SPEC.traffic(w["traffic"])
    assert os.path.isfile(os.path.join(BENCH_DIR, "kinds",
                                       f"{traffic['kind']}.py"))
    limits = SPEC.limits(cell)
    assert all(v >= 0 for v in limits.values())
    e2e = [m["name"] for m in SPEC.metrics(cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = SPEC.metrics(cell, True)
    assert per_layer
    for m in SPEC.metrics(cell, False) + per_layer:
        assert callable(SPEC.reader(m["name"]))
    for m in per_layer:
        assert m["moves"] in e2e


def test_config_files_under_paths():
    for c in B["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    assert os.path.isdir(BENCH_DIR)
