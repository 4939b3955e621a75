"""Device time of the backward a training step: the window's kernels
charged to the program's ``train.backward`` span and the spans nested in it
(the pairwise block's recompute under remat among them; lpbench/spans.py),
over the window's steps."""
from lpbench import spans


def read(run):
    a = spans.attribution(run)
    return None if a is None else spans.per_sweep_ms(
        run, a.device_s("train.backward"))
