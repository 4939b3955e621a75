"""Tiny sizes of the cells for CPU tests: the configurations' shapes cut
to a few hundred nodes, the traffic to a few dozen positives. Every cell of
BENCHMARK.json runs with its own limits."""
import copy

from lpbench.spec import Spec

TINY = {"config": {"num_nodes": 400, "num_train_edges": 4000, "feat_dim": 12,
                   "dim": 16, "batch_size": 256, "test_batch_size": 256,
                   "adj_cap": 16, "ppr_cap": 32, "budget_combined": 24,
                   "eps": 1e-3},
        "traffic": {"positives_per_split": 32, "negatives_per_positive": 20,
                    "positives_checked": 32, "ppr_rows_checked": 16,
                    "ppr_hubs_checked": 4}}

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.bench["workloads"]]


def tiny(**config):
    out = copy.deepcopy(TINY)
    out["config"].update(config)
    return out


def run_tiny(cell, seed=3_000_000_019, trace=0, faults=(), precision=None,
             **config):
    import run as bench_run
    return bench_run.main(
        ["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
         "--trace", str(trace)], device="cpu", spec=SPEC,
        overrides=tiny(**config), faults=faults, precision=precision)
