"""The readings that a cell's correctness limits are set from, in one
process: the program against the reference on many seeds (the lower
readings), the control (the reference one step below the configuration's
precision) and the planted faults on a few (the upper readings). Each
reading goes through the same check as a run's (``kinds/<kind>.py``'s
``check``); one host build serves every seed.

    python benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3

Prints one JSON line per reading and a summary of each number's largest
sound reading and smallest control and fault readings.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))


def main(argv=None, device=None, overrides=None, spec=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    args = ap.parse_args(argv)

    from lpbench import cells
    from lpbench import data as data_mod
    from lpbench.spec import Spec

    spec = spec or Spec()
    cell = spec.cell(args.workload)
    cfg, raw = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
        raw = json.dumps(cfg, sort_keys=True).encode()
    cfg["_data"] = data_mod.graph_data(cfg, raw)
    run = cells.Run(cell["name"], cfg, traffic, device or "cuda")
    t0 = time.time()
    summary = {}

    def emit(kind, seed, nums):
        print(json.dumps({"kind": kind, "seed": seed, "t": time.time() - t0,
                          **nums}), flush=True)
        for k, v in nums.items():
            s = summary.setdefault(k, {})
            if kind == "sound":
                s["lower"] = max(s.get("lower", 0.0), v)
            elif kind != "setup":
                s[kind] = min(s.get(kind, float("inf")), v)

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    cells.kind_module(run.kind).calibrate(run, seeds, args.controls, emit)
    print(json.dumps({"kind": "summary", **summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
