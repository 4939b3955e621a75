"""Valid context slots over the slots of the context tables extracted in
the traced window's training steps (both halves): the program's counters
``context.valid_slots`` and ``context.table_slots``, which count only
under the profiler."""
from lpbench import spans


def read(run):
    if run.trace is None:
        return None
    valid = spans.counter("context.valid_slots")
    table = spans.counter("context.table_slots")
    return None if valid is None or not table else 100.0 * valid / table
