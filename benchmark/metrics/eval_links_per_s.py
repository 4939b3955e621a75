"""Links scored by whole evaluation sweeps (each with its propagation and
its MRR) over the window's whole time."""


def read(run):
    if run.kind != "citation2_sweep" or run.window_s <= 0:
        return None
    return run.links / run.window_s
