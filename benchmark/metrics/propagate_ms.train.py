"""CUDA events around one training-mode propagation's forward and
backward (the node encoder), on the window's graph and parameters, after
the window: the median of three after one warm call."""


def read(run):
    if run.device.type != "cuda":
        return None
    s = run.spans.get("propagate_train_s")
    return None if s is None else 1e3 * s
