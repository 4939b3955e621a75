"""Device time of the context keys a sweep: the window's kernels charged
to the program's ``model.keys`` span (the key projection and the gather
into the [B, C, O] table; lpbench/spans.py), over the window's sweeps."""
from lpbench import spans


def read(run):
    a = spans.attribution(run)
    return None if a is None else spans.per_sweep_ms(
        run, a.device_s("model.keys"))
