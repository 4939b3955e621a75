"""1 - busy / wall over the traced window: busy is the union of the
device operations' intervals in the profiler's trace, so the profiler's
own host overhead counts as idle (an upper bound)."""


def read(run):
    if run.trace is None or run.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
