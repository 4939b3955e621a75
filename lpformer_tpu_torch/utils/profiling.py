"""Profiling and roofline accounting (counterpart of
``lpformer_tpu/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` trace of the block (the CPU,
    and the card where there is one), written as a Chrome trace
    ``logdir/trace.json`` (chrome://tracing, Perfetto);
  * ``StepTimer``: a stage timer with EMA smoothing, timed by CUDA events
    on the card and by the host clock on the CPU;
  * ``*_roofline`` and ``roofline_report``: achieved FLOP/s and bytes/s of
    the hot stages against the H100 peaks of ``utils/measure.py``.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile

from lpformer_tpu_torch.utils import measure


@contextlib.contextmanager
def trace(logdir: str = "lpformer_trace"):
    """Profile the block; yields the ``torch.profiler.profile`` object
    (its ``key_averages()`` hold the per-op times) and writes
    ``logdir/trace.json`` at the end. ``logdir`` is relative to the
    working directory unless absolute."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """EMA stage timer: timer.tick('stage') ... timer.tock('stage') returns
    the stage's seconds. With ``device`` on CUDA the stage is timed by
    CUDA events (``tock`` waits for the stage's work on the card);
    otherwise by the host clock."""

    def __init__(self, alpha: float = 0.1, device=None):
        self.alpha = alpha
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._start: Dict[str, object] = {}
        self.ema: Dict[str, float] = {}

    def tick(self, name: str):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._start[name] = e
        else:
            self._start[name] = time.perf_counter()

    def tock(self, name: str) -> float:
        start = self._start.pop(name)
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - start
        prev = self.ema.get(name)
        self.ema[name] = dt if prev is None else (
            self.alpha * dt + (1 - self.alpha) * prev)
        return dt

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v * 1e3:.1f}ms" for k, v in sorted(self.ema.items()))


@dataclass
class RooflineEstimate:
    flops: float
    bytes: float
    seconds: float
    # H100 SXM peaks (utils/measure.py): f32 FMA units, HBM3
    peak_flops: float = measure.F32_FLOPS
    peak_bw: float = measure.HBM_BYTES_PER_S

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds

    @property
    def achieved_bw(self) -> float:
        return self.bytes / self.seconds

    @property
    def flops_util(self) -> float:
        return self.achieved_flops / self.peak_flops

    @property
    def bw_util(self) -> float:
        return self.achieved_bw / self.peak_bw

    @property
    def bound(self) -> str:
        return "compute" if (
            self.flops / self.peak_flops > self.bytes / self.peak_bw
        ) else "memory"


def spmm_roofline(
    num_edges: int, feat_dim: int, seconds: float, dtype_bytes: int = 4
) -> RooflineEstimate:
    """gather + multiply-add per edge per feature."""
    flops = 2.0 * num_edges * feat_dim
    bytes_ = num_edges * (feat_dim * 2 * dtype_bytes + 8)  # x row, out, idx
    return RooflineEstimate(flops=flops, bytes=bytes_, seconds=seconds)


def attention_roofline(
    batch: int, context: int, dim: int, heads: int, seconds: float,
    dtype_bytes: int = 4,
) -> RooflineEstimate:
    """lin_r (2d -> H*d) + score + weighted sum per (link, context node)."""
    per_entry = 2 * (2 * dim) * (heads * dim) + 6 * heads * dim
    flops = float(batch) * context * per_entry
    bytes_ = float(batch) * context * (2 * dim) * dtype_bytes
    return RooflineEstimate(flops=flops, bytes=bytes_, seconds=seconds)


def context_roofline(
    batch: int, adj_cap: int, ppr_cap: int, seconds: float
) -> RooflineEstimate:
    """Compare-all membership of each link's source rows against its
    target rows, plus the row gathers."""
    flops = 2.0 * batch * (ppr_cap * ppr_cap + adj_cap * adj_cap)
    bytes_ = 2.0 * batch * (adj_cap * 4 + ppr_cap * 8)
    return RooflineEstimate(flops=flops, bytes=bytes_, seconds=seconds)


def train_step_roofline(
    batch: int, num_edges: int, num_nodes: int, dim: int, c_total: int,
    gnn_layers: int, seconds: float, fwd_passes: int = 2,
    bwd_mult: float = 3.0,
) -> RooflineEstimate:
    """Analytic FLOP / byte lower bound of one training step: GCN (SpMM +
    dense), per-link attention, the PPR-PE MLPs and the head MLPs.
    ``fwd_passes=2`` is the reference's positive + negative forward;
    ``bwd_mult=3`` counts the forward, the activation and the weight
    gradients."""
    spmm = 2.0 * num_edges * dim * gnn_layers
    gcn_dense = 2.0 * num_nodes * dim * dim * gnn_layers
    att = batch * c_total * (2 * (2 * dim) * dim + 8.0 * dim)
    pe = batch * c_total * 2 * 2.0 * (2 * dim + dim * dim)
    heads = batch * 3 * 2.0 * 2 * dim * dim
    flops = (spmm + gcn_dense + att + pe + heads) * fwd_passes * bwd_mult
    bytes_ = (
        num_edges * (dim * 2 * 4 + 8) * gnn_layers
        + num_nodes * dim * 4 * 2
        + batch * c_total * (2 * dim) * 4
    ) * fwd_passes * 2.0
    return RooflineEstimate(flops=flops, bytes=bytes_, seconds=seconds)


def roofline_report(est: RooflineEstimate, name: str) -> str:
    return (
        f"[{name}] {est.seconds*1e3:.2f}ms  "
        f"{est.achieved_flops/1e12:.2f} TFLOP/s ({est.flops_util:.1%})  "
        f"{est.achieved_bw/1e9:.1f} GB/s ({est.bw_util:.1%})  "
        f"{est.bound}-bound"
    )
