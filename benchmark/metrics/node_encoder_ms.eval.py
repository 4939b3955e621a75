"""Device time of the node encoder a sweep: the window's kernels charged
to the program's ``model.propagate`` span (lpbench/spans.py), over the
window's sweeps."""
from lpbench import spans


def read(run):
    a = spans.attribution(run)
    return None if a is None else spans.per_sweep_ms(
        run, a.device_s("model.propagate"))
