"""Device time of context extraction a training step: the window's kernels
charged to the program's ``model.context`` span (both halves' tables;
lpbench/spans.py), over the window's steps."""
from lpbench import spans


def read(run):
    a = spans.attribution(run)
    return None if a is None else spans.per_sweep_ms(
        run, a.device_s("model.context"))
