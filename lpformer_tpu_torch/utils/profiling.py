"""Tracing: spans and counters at the program's layer boundaries, and a
Chrome-trace exporter.

  * ``span(name)``: a context manager around one layer's work. It always
    adds its host duration to an in-memory table keyed by its path (the
    enclosing spans' names and its own, joined by ``/``), as a count and
    total nanoseconds: one entry per path, so the table stays small. While
    a torch profiler is active it also lands in the profiler's trace as a
    host event named ``name`` (beside the operators and the device
    kernels they launch), and records its interval, stamped with
    ``time.time_ns()``: the Unix-epoch clock of the profiler's host
    events;
  * ``count(name, value)``: a counter that accumulates only while a torch
    profiler is active. A tensor value is summed and accumulated on its
    device, with no synchronisation; with no profiler a call launches
    nothing;
  * ``padded(real)`` / ``real_rows(x)``: a caller that pads a batch names
    its real rows, so that a counter taken deeper down leaves the padding
    out;
  * ``snapshot()`` / ``reset()``: read / clear the spans and counters;
  * ``trace(logdir)``: a ``torch.profiler`` trace of the block (the CPU,
    and the card where there is one), written as a Chrome trace
    ``logdir/trace.json`` (chrome://tracing, Perfetto); it shows the
    spans.

The switch is the profiler itself (``trace`` here, or any
``torch.profiler.profile``): nothing else turns the spans' trace events
or the counters on. The span stack is one for the process: a span opened
on autograd's device thread, while the host thread waits inside a
``backward`` span, nests under it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

# True while a torch profiler records (the autograd profiler's own flag)
active = torch._C._autograd._profiler_enabled
# A host event in the profiler's trace. Not ``torch.profiler.
# record_function``: its user scope is mirrored on the device's timeline
# as an event of the card covering the span's kernels and the gaps between
# them, which a reading of the device's events would take for a kernel.
_HostEvent = torch._C._profiler._RecordFunctionFast

_stack: List[str] = []                         # open spans' paths
_totals: Dict[str, list] = {}                  # path -> [count, ns]
_intervals: List[Tuple[str, int, int]] = []    # (path, start, end) ns
_counters: Dict[str, object] = {}              # name -> int or tensor
_real: List[int] = []                          # real rows of padded batches


class span:
    """``with span("model.context"): ...``: see the module docstring."""

    __slots__ = ("name", "path", "event", "stamp", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.path = (_stack[-1] + "/" + self.name) if _stack else self.name
        _stack.append(self.path)
        self.event = None
        if active():
            self.stamp = time.time_ns()
            self.event = _HostEvent(self.name)
            self.event.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.event is not None:
            self.event.__exit__(*exc)
            _intervals.append((self.path, self.stamp, time.time_ns()))
        _stack.pop()
        entry = _totals.get(self.path)
        if entry is None:
            _totals[self.path] = [1, dt]
        else:
            entry[0] += 1
            entry[1] += dt
        return False


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor whose elements are summed on its
    device) to the counter ``name``, while a profiler is active."""
    if not active():
        return
    if isinstance(value, torch.Tensor):
        value = value.sum()
    prev = _counters.get(name)
    _counters[name] = value if prev is None else prev + value


class padded:
    """``with padded(real): ...``: the batch in work holds ``real`` real
    rows ahead of its padding (``real_rows``)."""

    __slots__ = ("real",)

    def __init__(self, real: int):
        self.real = real

    def __enter__(self):
        _real.append(self.real)
        return self

    def __exit__(self, *exc):
        _real.pop()
        return False


def real_rows(x):
    """``x`` less the padded rows that the innermost ``padded`` block
    names (all of ``x`` outside one)."""
    return x[:_real[-1]] if _real else x


def snapshot() -> dict:
    """{"spans": {path: (count, host seconds)}, "intervals": [(path,
    start ns, end ns)] of the spans closed under a profiler, "counters":
    {name: number}}. Reading a device counter waits for its device."""
    return {
        "spans": {p: (c, ns / 1e9) for p, (c, ns) in _totals.items()},
        "intervals": list(_intervals),
        "counters": {k: (v.item() if isinstance(v, torch.Tensor) else v)
                     for k, v in _counters.items()},
    }


def reset() -> None:
    """Clear the spans' totals and intervals and the counters (spans open
    now still close into the table)."""
    _totals.clear()
    _intervals.clear()
    _counters.clear()


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
