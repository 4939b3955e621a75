"""BENCHMARK.json and the files it names, found by name:
``configs/<config>.json`` (through the entry's ``file``),
``traffic/<traffic>.json``, ``metrics/<metric>.py`` (a ``read(run)``
that returns a number or None) and ``limits/<cell>.json`` (the limit of
each number the correctness check compares)."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str):
        """(the configuration dict, its file's bytes)."""
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"]), "rb") as f:
                    raw = f.read()
                return dict(json.loads(raw), name=name), raw
        raise KeyError(f"no configuration named {name!r}")

    @staticmethod
    def traffic(name: str) -> dict:
        with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
            return json.load(f)

    @staticmethod
    def limits(cell: str) -> dict:
        with open(os.path.join(BENCH_DIR, "limits", f"{cell}.json")) as f:
            return json.load(f)

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metric entries: its end-to-end metrics, or with
        ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    @staticmethod
    def reader(metric: str):
        path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
        sp = importlib.util.spec_from_file_location(
            "metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        return mod.read
