"""The benchmark of lpformer_tpu_torch: one run of one cell on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in BENCHMARK.json once: set-up (the graph from the
configuration's data seed, the program's host build, weights and traffic
from ``--seed``), a window of ``--seconds`` seconds (with ``--trace 1``
under the profiler), then the check of the window's outputs against the
plain reference. The last line of standard output is the result as JSON;
the numbers the check compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(BENCH_DIR, ".cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(BENCH_DIR, ".cache", "triton"))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

FORBIDDEN = {"jax", "jaxlib", "flax", "lpformer_tpu"}
GIB = 1024 ** 3


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def result_line(spec, run, trace: bool, limits: dict) -> dict:
    metrics = {}
    for m in spec.metrics(run.cell, trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in run.checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and run.failed == 0
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (__import__("torch").cuda.get_device_name(0)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": run.units, "failed": run.failed,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.gaps[:10]}
    out["checks"] = checks
    return out


def main(argv=None, device=None, spec=None, overrides=None, faults=(),
         precision=None):
    """One run; returns the result dict. ``device``, ``spec``,
    ``overrides`` (merged into the configuration and the traffic) and
    ``faults`` serve the harness's own tests, which run it on the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from lpbench import cells
    from lpbench import data as data_mod
    from lpbench.spec import Spec

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("no CUDA device: this benchmark measures the card",
                  file=sys.stderr)
            sys.exit(2)
        device = "cuda"
        torch.cuda.set_device(0)
    spec = spec or Spec()
    cell = spec.cell(args.workload)
    cfg, raw = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
        raw = json.dumps(cfg, sort_keys=True).encode()
    cfg["_data"] = data_mod.graph_data(cfg, raw)
    run = cells.Run(cell["name"], cfg, traffic, device)
    cells.run_cell(run, args.seed, args.seconds, bool(args.trace), faults,
                   precision, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        sys.exit(3)
    out = result_line(spec, run, bool(args.trace), limits)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return out


if __name__ == "__main__":
    res = main()
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
