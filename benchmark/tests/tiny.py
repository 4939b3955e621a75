"""Tiny sizes of the cells for CPU tests: the configurations' shapes cut
to a few hundred nodes, the traffic to a few dozen positives. Besides the
cells of BENCHMARK.json, the tests run a training cell on the
citation2-like configuration (``tiny.train``), so that the training kind
stays tested while no training cell is benchmarked."""
import copy

from lpbench.spec import Spec

TINY = {"config": {"num_nodes": 400, "num_train_edges": 4000, "feat_dim": 12,
                   "dim": 16, "batch_size": 256, "test_batch_size": 256,
                   "adj_cap": 16, "ppr_cap": 32, "budget_combined": 24,
                   "eps": 1e-3},
        "traffic": {"positives_per_split": 32, "negatives_per_positive": 20,
                    "positives_checked": 32, "ppr_rows_checked": 16,
                    "ppr_hubs_checked": 4}}

TRAIN_CELL = "tiny.train"
# the training check's limits at float32 products on the CPU
TRAIN_LIMITS = {"loss_gap": 4e-4, "grad_gap": 1.2e-2, "delta_gap": 3e-2,
                "ppr_gap": 0.0}


class TinySpec(Spec):
    """BENCHMARK.json with the test-only training cell and its metrics."""

    def __init__(self):
        super().__init__()
        b = self.bench = copy.deepcopy(self.bench)
        b["workloads"].append({"name": TRAIN_CELL, "config": "citation2-like",
                               "traffic": "train", "chips": 1})
        b["end_to_end"].append({"name": "train_links_per_s",
                                "unit": "links/s", "workloads": [TRAIN_CELL]})
        for name in ("train_mfu", "propagate_ms.train", "device_idle.train",
                     "pe_attention_fwd_roofline.train",
                     "pe_attention_bwd_roofline.train"):
            b["per_layer"].append({"name": name, "unit": "%",
                                   "moves": "train_links_per_s",
                                   "workloads": [TRAIN_CELL]})

    def limits(self, cell):
        return dict(TRAIN_LIMITS) if cell == TRAIN_CELL else super().limits(
            cell)


SPEC = TinySpec()
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
