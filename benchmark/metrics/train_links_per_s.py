"""Positive training links through whole training steps (propagation,
both halves' forwards, loss, backward, clipped Adam) over the window's
whole time, its one synchronisation included."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.links / run.window_s
