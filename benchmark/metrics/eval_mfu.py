"""The whole evaluation sweep's share of the card's peak: the least time
of one propagation and the scored links' forward (lpbench/work.py) over
the window's time per sweep."""
from lpbench import work


def read(run):
    if run.device.type != "cuda":
        return None
    if (run.kind != "citation2_sweep" or not run.units
            or "eval" not in run.slots):
        return None
    links = run.links // run.units
    least = work.eval_sweep_least_s(run.cfg, run.num_entries, links,
                                    run.slots["eval"])
    return 100.0 * least / (run.window_s / run.units)
