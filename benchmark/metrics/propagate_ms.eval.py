"""CUDA events around one eval-mode propagation (the node encoder), after
the window: the median of three after one warm call."""


def read(run):
    if run.device.type != "cuda":
        return None
    s = run.spans.get("propagate_eval_s")
    return None if s is None else 1e3 * s
