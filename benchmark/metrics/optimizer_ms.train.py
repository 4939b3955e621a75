"""Device time of the optimizer a training step: the window's kernels
charged to the program's ``train.optimizer`` span (the clipped fused Adam
update; lpbench/spans.py), over the window's steps."""
from lpbench import spans


def read(run):
    a = spans.attribution(run)
    return None if a is None else spans.per_sweep_ms(
        run, a.device_s("train.optimizer"))
