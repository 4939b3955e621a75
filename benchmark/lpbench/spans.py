"""Per-layer readings from the program's own spans and counters
(``lpformer_tpu_torch/utils/profiling.py``).

A traced window's device kernels are charged to the innermost program span
whose host interval holds the kernel's launch: the runtime call that
launched it, found through its correlation id. The device's idle time
inside given spans is their host intervals less the union of the device's
busy intervals. Against a program that records no spans or counters every
reading is None."""
from __future__ import annotations

import numpy as np


def program_snapshot():
    """The program's spans, intervals and counters, or None where the
    program has no such record."""
    try:
        from lpformer_tpu_torch.utils import profiling
        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


class Attribution:
    """One traced window's kernels charged to the program's spans.

    ``intervals``: [(path, start ns, end ns)] of the program's spans,
    stamped on the profiler's host clock; ``launches``: {correlation id:
    launch ns} of the runtime calls; ``device``: [(correlation id, start
    ns, end ns)] of the device's operations; ``window``: (first, last) ns
    of the profiler's events."""

    def __init__(self, intervals, launches, device, window):
        t_lo, t_hi = window
        # the spans of this window (a process may hold earlier windows')
        self.intervals = sorted((iv for iv in intervals
                                 if iv[2] >= t_lo and iv[1] <= t_hi),
                                key=lambda iv: (iv[1], -iv[2]))
        self.charged = {}          # innermost span path -> device ns
        order = sorted((launches.get(c, -1), t1 - t0)
                       for c, t0, t1 in device)
        stack, j = [], 0
        for t, dur in order:
            while j < len(self.intervals) and self.intervals[j][1] <= t:
                stack.append(self.intervals[j])
                j += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            path = stack[-1][0] if stack and t >= 0 else ""
            self.charged[path] = self.charged.get(path, 0) + dur
        # the device's busy union, as disjoint sorted intervals
        iv = np.array(sorted((t0, t1) for _, t0, t1 in device), np.float64)
        ends = np.maximum.accumulate(iv[:, 1])
        first = np.nonzero(np.r_[True, iv[1:, 0] > ends[:-1]])[0]
        self.busy_lo = iv[first, 0]
        self.busy_hi = ends[np.r_[first[1:] - 1, len(ends) - 1]]
        self._busy_cum = np.r_[0.0, np.cumsum(self.busy_hi - self.busy_lo)]

    def device_s(self, name: str) -> float:
        """Device seconds charged to the spans named ``name`` and to the
        spans nested in them."""
        return sum(ns for path, ns in self.charged.items()
                   if name in path.split("/")) / 1e9

    def _busy_before(self, t):
        """Busy ns of the device before each time ``t``."""
        t = np.asarray(t, np.float64)
        i = np.searchsorted(self.busy_lo, t, side="right") - 1
        k = np.maximum(i, 0)
        inside = np.clip(t - self.busy_lo[k], 0,
                         self.busy_hi[k] - self.busy_lo[k])
        return np.where(i >= 0, self._busy_cum[k] + inside, 0.0)

    def idle_s(self, names) -> float:
        """The device's idle seconds inside the union of the spans named
        in ``names``."""
        sel = sorted((t0, t1) for path, t0, t1 in self.intervals
                     if path.rsplit("/", 1)[-1] in names)
        if not sel:
            return 0.0
        lo, hi = [], []
        for t0, t1 in sel:
            if hi and t0 <= hi[-1]:
                hi[-1] = max(hi[-1], t1)
            else:
                lo.append(t0)
                hi.append(t1)
        lo, hi = np.array(lo, np.float64), np.array(hi, np.float64)
        busy = self._busy_before(hi) - self._busy_before(lo)
        return float((hi - lo - busy).sum()) / 1e9


def attribution(run):
    """The traced window's Attribution (computed once a run), or None
    without a trace, without device operations, or against a program
    that records no span intervals."""
    if run.trace is None or run.trace.prof is None:
        return None
    cached = getattr(run, "program_spans", None)
    if cached is not None and cached[0] is run.trace:
        return cached[1]
    out = None
    snap = program_snapshot()
    if snap is not None and snap["intervals"]:
        launches, device, window = _kineto(run.trace.prof)
        if device:
            out = Attribution(snap["intervals"], launches, device, window)
    run.program_spans = (run.trace, out)
    return out


def _kineto(prof):
    """({correlation id: start ns} of the CUDA API calls (``cu*``),
    [(correlation id, start ns, end ns)] of the device's operations,
    (first, last) ns of all events) of a profiler's raw events. Device
    mirrors of user annotations are no operations of the device."""
    from torch.autograd import DeviceType
    launches, device = {}, []
    lo, hi = float("inf"), float("-inf")
    for e in prof.profiler.kineto_results.events():
        lo, hi = min(lo, e.start_ns()), max(hi, e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                t = e.start_ns()
                device.append((e.correlation_id(), t, t + e.duration_ns()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    return launches, device, (lo, hi)


def per_sweep_ms(run, seconds: float):
    """``seconds`` of the window as milliseconds a unit of its work: an
    evaluation sweep, or a training step."""
    return 1e3 * seconds / run.units if run.units else None


def span_host_s(name: str):
    """Host seconds of every span named ``name`` in the process, or None
    where the program recorded none."""
    snap = program_snapshot()
    if snap is None:
        return None
    got = [s for path, (_, s) in snap["spans"].items()
           if path.rsplit("/", 1)[-1] == name]
    return sum(got) if got else None


def counter(name: str):
    snap = program_snapshot()
    return None if snap is None else snap["counters"].get(name)
