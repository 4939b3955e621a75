"""Valid context candidates that the table's budget dropped, a training
step: the program's counter ``context.dropped_slots`` (both halves, real
rows), which counts only under the profiler, over the window's steps."""
from lpbench import spans


def read(run):
    if run.trace is None or not run.units:
        return None
    dropped = spans.counter("context.dropped_slots")
    return None if dropped is None else dropped / run.units
