"""Link-prediction metrics with OGB Evaluator semantics (counterpart of
``lpformer_tpu/evalx/metrics.py``).

  * Hits@K (ogb ``eval_hits``): fraction of positives scored strictly
    above the K-th highest negative score; 1.0 with fewer than K negatives.
  * MRR: rank = 0.5 * (optimistic + pessimistic) + 1 over a negative set
    per positive, or one shared set (reference: src/train/evaluation.py:
    23-50), so ties with a negative count half.
  * AUC / AP without sklearn (reference: evaluation.py:93-104).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def evaluate_hits_single(
    pos_pred: torch.Tensor, neg_pred: torch.Tensor, k: int,
    neg_sorted: bool = False,
) -> float:
    """Hits@K against one shared negative set; ``neg_sorted`` when
    ``neg_pred`` is already ascending (sorted once for every K)."""
    if neg_pred.shape[0] < k:
        return 1.0
    kth = neg_pred[-k] if neg_sorted else torch.sort(neg_pred).values[-k]
    return float((pos_pred > kth).float().mean())


def evaluate_hits(
    pos_pred: torch.Tensor, neg_pred: torch.Tensor, k_list: Sequence[int]
) -> Dict[str, float]:
    """(reference: evaluation.py:7-18)"""
    neg_sorted = torch.sort(neg_pred).values
    return {f"Hits@{k}": evaluate_hits_single(pos_pred, neg_sorted, k,
                                              neg_sorted=True)
            for k in k_list}


def mrr_ranks(pos_pred: torch.Tensor, neg_pred: torch.Tensor) -> torch.Tensor:
    """Rank of each positive against its own negatives, pos [P], neg
    [P, K] (reference: evaluation.py:29-37)."""
    pos = pos_pred.reshape(-1, 1)
    optimistic = (neg_pred >= pos).sum(1)
    pessimistic = (neg_pred > pos).sum(1)
    return 0.5 * (optimistic + pessimistic).float() + 1.0


def mrr_ranks_shared(
    pos_pred: torch.Tensor, neg_sorted: torch.Tensor
) -> torch.Tensor:
    """Rank of each positive against one shared negative set (sorted
    ascending): #neg >= p and #neg > p are searchsorted counts."""
    k = neg_sorted.shape[0]
    optimistic = k - torch.searchsorted(neg_sorted, pos_pred, side="left")
    pessimistic = k - torch.searchsorted(neg_sorted, pos_pred, side="right")
    return 0.5 * (optimistic + pessimistic).float() + 1.0


def evaluate_mrr(pos_pred: torch.Tensor,
                 neg_pred: torch.Tensor) -> Dict[str, float]:
    """Hits@10/50/100 and MRR against per-positive negatives [P, K]
    (reference: evaluation.py:23-50)."""
    ranks = mrr_ranks(pos_pred, neg_pred)
    out = {f"Hits@{k}": float((ranks <= k).float().mean())
           for k in (10, 50, 100)}
    out["MRR"] = float((1.0 / ranks).mean())
    return out


def sample_level_hits(pos_pred: torch.Tensor,
                      neg_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-sample hit indicators against shared negatives [K] or
    per-positive ones [P, K] (reference: evaluation.py:53-71)."""
    if neg_pred.dim() == 1:
        ranks = mrr_ranks_shared(pos_pred, torch.sort(neg_pred).values)
    else:
        ranks = mrr_ranks(pos_pred, neg_pred)
    return {f"Hits@{k}": (ranks <= k).float() for k in (20, 50, 100)}


def get_metric_score(
    pos_train_pred: torch.Tensor,
    pos_val_pred: torch.Tensor,
    neg_val_pred: torch.Tensor,
    pos_test_pred: torch.Tensor,
    neg_test_pred: torch.Tensor,
    k_list: Sequence[int] = (100,),
    with_mrr: bool = False,
) -> Dict[str, tuple]:
    """Shared-negative evaluation (reference: evaluation.py:108-127).
    Returns {metric: (train, valid, test)}; train positives are scored
    against the validation negatives, as in the reference (:114,122)."""
    neg_val_sorted = torch.sort(neg_val_pred).values
    neg_test_sorted = torch.sort(neg_test_pred).values
    runs = ((pos_train_pred, neg_val_sorted), (pos_val_pred, neg_val_sorted),
            (pos_test_pred, neg_test_sorted))
    result = {
        f"Hits@{k}": tuple(evaluate_hits_single(p, n, k, neg_sorted=True)
                           for p, n in runs)
        for k in k_list
    }
    if with_mrr:
        result["MRR"] = tuple(
            float((1.0 / mrr_ranks_shared(p, n)).mean()) for p, n in runs)
    return result


def get_metric_score_citation2(
    pos_train_pred: torch.Tensor,
    pos_val_pred: torch.Tensor,
    neg_val_pred: torch.Tensor,
    pos_test_pred: torch.Tensor,
    neg_test_pred: torch.Tensor,
) -> Dict[str, tuple]:
    """Per-positive-negative MRR (reference: evaluation.py:130-148),
    negatives [P, K]; train positives against the validation negatives."""
    return {"MRR": (evaluate_mrr(pos_train_pred, neg_val_pred)["MRR"],
                    evaluate_mrr(pos_val_pred, neg_val_pred)["MRR"],
                    evaluate_mrr(pos_test_pred, neg_test_pred)["MRR"])}


def evaluate_auc(val_pred, val_true) -> Dict[str, float]:
    """ROC-AUC (rank statistic, ties at their average rank) and average
    precision, in float64 numpy, each rounded to 4 places (reference:
    evaluation.py:93-104). Takes tensors or arrays."""
    pred = np.asarray(torch.as_tensor(val_pred).detach().cpu(), np.float64)
    true = np.asarray(torch.as_tensor(val_true).detach().cpu(), np.float64)
    true_sorted = true[np.argsort(-pred, kind="stable")]
    p = true.sum()
    n_ = len(true) - p
    if p == 0 or n_ == 0:
        return {"AUC": 0.0, "AP": 0.0}
    ranks = np.empty(len(pred))
    sorted_asc = np.argsort(pred, kind="stable")
    _, inv, cnts = np.unique(pred[sorted_asc], return_inverse=True,
                             return_counts=True)
    cum = np.cumsum(cnts)
    ranks[sorted_asc] = ((cum - cnts + cum + 1) / 2.0)[inv]
    auc = (ranks[true == 1].sum() - p * (p + 1) / 2) / (p * n_)
    precision = np.cumsum(true_sorted) / np.arange(1, len(true_sorted) + 1)
    ap = (precision * true_sorted).sum() / p
    return {"AUC": round(float(auc), 4), "AP": round(float(ap), 4)}
