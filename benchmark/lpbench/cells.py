"""One run of one cell: what every kind of traffic shares. A traffic file's
``kind`` names a module ``kinds/<kind>.py``, found by name, with

  * ``run(run, seed, seconds, trace, faults, precision, t_start)``: set-up,
    the measured window, the traced readings and the check; returns the
    compared numbers;
  * ``calibrate(run, seeds, controls, emit)``: the readings the limits are
    set from, on many seeds in one process, through the same check;
  * ``FAULTS``: the faults the check's own tests plant in the timed path.

A new kind of traffic is a new file there.
"""
from __future__ import annotations

import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the control's precision: the reference one step below the configuration's
CONTROL = {"float32": "tfloat32", "bfloat16": "float8_e4m3fn"}


class Run:
    """What one run read: the numbers the metric readers take."""

    def __init__(self, cell, cfg, traffic, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.kind = traffic["kind"]
        self.device = torch.device(device)
        self.setup_s = self.host_build_s = self.window_s = 0.0
        self.units = 0              # steps or sweeps in the window
        self.links = 0              # links through them
        self.failed = 0
        self.peak_bytes = 0
        self.trace = None           # Trace, with --trace 1
        self.pe_calls = []          # (keys shape, w1 shape, kb, nv, bwd)
        self.spans = {}             # seconds, by name
        self.slots = {}             # mean valid context slots a link
        self.num_entries = 0        # entries of the normalised adjacency
        self.checks = {}            # compared number, by name


def kind_module(kind: str):
    """``kinds/<kind>.py``, loaded by name."""
    path = os.path.join(BENCH_DIR, "kinds", f"{kind}.py")
    mod = sys.modules.get(f"kind_{kind}")
    if mod is None:
        sp = importlib.util.spec_from_file_location(f"kind_{kind}", path)
        mod = importlib.util.module_from_spec(sp)
        sys.modules[sp.name] = mod
        sp.loader.exec_module(mod)
    return mod


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def event_s(fn, dev, reps=3):
    """Median seconds of ``reps`` timings of ``fn`` after one warm call:
    CUDA events on the card, the host clock elsewhere."""
    fn()
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) / 1e3)
        else:
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
    return statistics.median(out)


def free(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_graph(cfg, dev):
    """The reference's derivation of the configuration's raw graph, before
    any PPR rows."""
    from reference.graph import RefGraph
    data = cfg["_data"]
    return RefGraph(data["edges"], data["x"], cfg["num_nodes"],
                    cfg["adj_cap"], cfg["ppr_cap"], dev)


def ppr_gap(rows: dict, indptr, indices, vals) -> float:
    """Largest difference between the reference's PPR rows ``rows``
    ({node: (ids, vals)}) and the same rows of a CSR matrix (an entry
    absent on one side reads 0)."""
    worst = 0.0
    for s, (ids, v) in rows.items():
        lo, hi = indptr[s], indptr[s + 1]
        pid = np.asarray(indices[lo:hi])
        pv = np.asarray(vals[lo:hi])
        allid = np.union1d(ids, pid)
        a = np.zeros(len(allid))
        b = np.zeros(len(allid))
        a[np.searchsorted(allid, ids)] = v
        b[np.searchsorted(allid, pid)] = pv
        if len(allid):
            worst = max(worst, float(np.abs(a - b).max()))
    return worst


def timed(run: Run, name: str, fn, *a, **k):
    """``fn(*a, **k)``, its host seconds kept as the span ``name``."""
    t = time.perf_counter()
    out = fn(*a, **k)
    run.spans[name] = run.spans.get(name, 0.0) + time.perf_counter() - t
    return out


def run_cell(run: Run, seed: int, seconds: float, trace: bool,
             faults=(), precision: str = None,
             t_start: float = None) -> Run:
    """Run the cell once; ``precision`` other than the configuration's
    ``matmul_dtype`` puts the reference at that precision (the control) in
    the program's place for the check; ``faults`` plants faults in the
    program's path."""
    t_start = time.perf_counter() if t_start is None else t_start
    precision = precision or run.cfg["matmul_dtype"]
    nums = kind_module(run.kind).run(run, seed, seconds, trace,
                                     tuple(faults), precision, t_start)
    after = time.perf_counter() - t_start - run.setup_s - run.window_s
    spans = ", ".join(f"{k} {v:.1f} s" for k, v in run.spans.items()
                      if k.startswith("check"))
    print(f"[run] set-up {run.setup_s:.1f} s, window {run.window_s:.1f} s, "
          f"after it {after:.1f} s (traced readings and the check"
          f"{': ' + spans if spans else ''})", file=sys.stderr)
    run.checks = nums
    return run
