"""The device's idle time a sweep inside the evaluation harness's host
work: the program's ``eval.neg_edges``, ``eval.stage``, ``eval.fetch``
and ``eval.metric`` spans less the device's busy intervals
(lpbench/spans.py), over the window's sweeps."""
from lpbench import spans

SPANS = ("eval.neg_edges", "eval.stage", "eval.fetch", "eval.metric")


def read(run):
    a = spans.attribution(run)
    return None if a is None else spans.per_sweep_ms(run, a.idle_s(SPANS))
