"""Run-results logger with the reference's semantics (counterpart of
``lpformer_tpu/utils/logger.py``).

Mirrors the reference Logger (reference: src/util/utils.py:80-152): per-run
lists of (train, valid, test) tuples per eval, best-epoch selection by
valid, test-at-best-valid reporting, mean +- std over runs (x100).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


class ResultsLogger:
    def __init__(self, runs: int):
        self.results: List[List[Tuple[float, float, float]]] = [
            [] for _ in range(runs)
        ]

    def add_result(self, run: int, result: Tuple[float, float, float]):
        assert len(result) == 3
        assert 0 <= run < len(self.results)
        self.results[run].append(tuple(float(x) for x in result))

    def best_valid(self, run: int) -> float:
        r = np.asarray(self.results[run])
        return float(r[:, 1].max()) if len(r) else 0.0

    def print_statistics(self, verbose: bool = True):
        """Print and return (mean_list, var_list) for (train@best,
        best_valid, test@best) x100 over the runs, as the reference
        (:103-152); ``verbose=False`` only returns them (the ranks of a
        mesh other than rank 0)."""
        import builtins

        print = builtins.print if verbose else (lambda *a, **k: None)
        best_results = []
        for r in self.results:
            if not r:
                continue
            r = 100 * np.asarray(r)
            valid_at = r[:, 1].argmax()
            best_results.append(
                (r[:, 0].max(), r[:, 1].max(), r[valid_at, 0], r[valid_at, 2]))
        if not best_results:
            print("No eval results recorded.")
            return [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        best = np.asarray(best_results)

        def std(a):    # ddof=1, torch.std's default (the reference's)
            return float(np.std(a, ddof=1)) if len(a) > 1 else 0.0

        print(f"Highest Valid: {best[:, 1].mean():.2f} ± {std(best[:, 1]):.2f}")
        print(f"   Final Test: {best[:, 3].mean():.2f} ± {std(best[:, 3]):.2f}")
        mean_list = [round(float(best[:, i].mean()), 2) for i in (0, 1, 3)]
        var_list = [round(std(best[:, i]), 2) for i in (0, 1, 3)]
        return mean_list, var_list
