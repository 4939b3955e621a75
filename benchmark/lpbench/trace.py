"""The traced window: torch.profiler over the window, reduced to the
device's busy time (the union of the device operations' intervals), each
kernel's time, and the longest idle gaps
named by the host operation that ran through them."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


class Trace:
    def __init__(self):
        self.prof = None
        self.kernels = {}          # name -> (seconds, count)
        self.busy_s = 0.0
        self.gaps = []             # [name, seconds], longest first

    @contextlib.contextmanager
    def window(self, device):
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        self.prof = prof

    def reduce(self, top_gaps: int = 10):
        """Read the profiler's raw events (the parsed event tree costs
        about a minute a million events; these a second)."""
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.duration_ns(), e.name()))
            elif e.duration_ns() > 0:
                host.append((e.start_ns(), e.duration_ns(), e.name()))
        for _, dur, name in dev:
            s, c = self.kernels.get(name, (0.0, 0))
            self.kernels[name] = (s + dur / 1e9, c + 1)
        if not dev:
            return self
        iv = np.array(sorted((t, t + d) for t, d, _ in dev), dtype=np.float64)
        ends = np.maximum.accumulate(iv[:, 1])
        gap = iv[1:, 0] - ends[:-1]
        # the union of the device's busy intervals
        self.busy_s = float(ends[-1] - iv[0, 0] - np.clip(gap, 0, None).sum()
                            ) / 1e9
        idx = np.argsort(-gap)[:top_gaps]
        hs = np.array([t for t, _, _ in host], np.float64)
        hd = np.array([d for _, d, _ in host], np.float64)
        for i in idx:
            if gap[i] <= 0:
                break
            mid = ends[i] + gap[i] / 2
            over = np.nonzero((hs <= mid) & (hs + hd > mid))[0]
            name = ("(no host op)" if len(over) == 0 else
                    host[over[np.argmin(hd[over])]][2])
            self.gaps.append([name, float(gap[i]) / 1e9])
        return self

    def kernel_s(self, patterns) -> tuple:
        """(seconds, launches) of the kernels whose names hold any of
        ``patterns``."""
        s = c = 0
        for name, (t, n) in self.kernels.items():
            if any(p in name for p in patterns):
                s, c = s + t, c + n
        return s, c

    def top_ops(self, k: int = 10):
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, t] for name, (t, _) in rows]
