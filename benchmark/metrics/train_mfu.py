"""The whole training step's share of the card's peak: the least time of
the step's model work (lpbench/work.py, from the configuration's shapes,
the adjacency's entries and the mean valid context slots the reference
counts on a seeded batch) over the window's time per step."""
from lpbench import work


def read(run):
    if run.device.type != "cuda":
        return None
    if run.kind != "train" or not run.units or "pos" not in run.slots:
        return None
    least = work.train_step_least_s(run.cfg, run.num_entries,
                                    run.slots["pos"], run.slots["neg"])
    return 100.0 * least / (run.window_s / run.units)
