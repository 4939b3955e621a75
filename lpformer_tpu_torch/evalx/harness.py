"""Evaluation harness (counterpart of ``lpformer_tpu/evalx/harness.py``).

  * ``test_standard``: the reference's test() (src/train/testing.py:
    124-173), with the HeaRT per-positive negatives (:96-121);
  * ``test_citation2``: propagate once, then each positive's source
    against its [K] negative targets (:14-74), including the reference's
    quirk of reporting the valid predictions as the train ones (:70).

The node encodings are propagated ONCE and reused for every batch, and
every batch has the same shape (the last one padded). The JAX package
scores groups of eight batches in one launch (a TPU dispatch measure);
here each batch is one call, with the same scores. ``sharded=`` (a
``parallel.eval.ShardedEvalContext``) scores over a mesh of ranks: every
rank runs the same sweep and gets every score.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from lpformer_tpu_torch.data.dataset import LinkPredDataset
from lpformer_tpu_torch.evalx import metrics
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.utils import profiling


def make_score_fn(cfg: LPFormerConfig) -> Callable:
    """(params, graph, X_node, src, tgt) -> link probabilities [B]."""

    def fn(params, graph, X_node, src, tgt):
        h = lt.forward(params, cfg, graph, src, tgt, X_node=X_node)
        return lt.score_links(params, cfg, h)

    return fn


def _resolve_eval_fns(cfg: LPFormerConfig, ds: LinkPredDataset, sharded):
    """(score_fn, prop, graph_train, graph_test): the single-device
    callables, or the mesh's from a ShardedEvalContext (the same
    signatures, so the sweeps below are shared)."""
    if sharded is None:
        return (make_score_fn(cfg),
                lambda params, g: lt.propagate(params, cfg, g),
                ds.graph, ds.graph_test)
    return sharded.score, sharded.prop, sharded.sg, sharded.sg_test


@torch.no_grad()
def score_edges(
    score_fn, params, graph, X_node, edges: np.ndarray, batch_size: int,
) -> np.ndarray:
    """Score [M, 2] edges in batches of ``batch_size``, the last padded
    with (0, 0) pairs whose scores are dropped. The batches are queued on
    the device and fetched once at the end."""
    m = len(edges)
    if m == 0:
        return np.zeros((0,), np.float32)
    dev = X_node.device
    outs = []
    for lo in range(0, m, batch_size):
        with profiling.span("eval.stage"):
            chunk = np.asarray(edges[lo:lo + batch_size])
            if len(chunk) < batch_size:
                pad = np.zeros((batch_size - len(chunk), 2), chunk.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            t = torch.as_tensor(chunk, dtype=torch.int64).to(dev)
        with profiling.padded(min(batch_size, m - lo)):
            outs.append(score_fn(params, graph, X_node, t[:, 0], t[:, 1]))
    with profiling.span("eval.fetch"):
        return torch.cat(outs).cpu().numpy()[:m]


@torch.no_grad()
def test_standard(
    params,
    cfg: LPFormerConfig,
    ds: LinkPredDataset,
    batch_size: int = 32768,
    k_list: Sequence[int] = (20, 50, 100),
    heart: bool = False,
    with_mrr: bool = None,
    sharded=None,
) -> Dict[str, tuple]:
    """Reference test(): {metric: (train, valid, test)} with Hits@K for
    ``k_list`` and MRR when ``with_mrr`` (default: the dataset's metric
    is MRR). With ``heart`` the negatives are per positive, [P, K, 2],
    and the result is the per-positive MRR alone. ``sharded``: a
    ShardedEvalContext, to score over its mesh."""
    with profiling.span("eval.sweep"):
        score_fn, prop, g_train, g_test = _resolve_eval_fns(cfg, ds, sharded)
        X_train = prop(params, g_train)
        X_test = X_train if g_test is g_train else prop(params, g_test)

        def sc(edges, test_set=False):
            g = g_test if test_set else g_train
            X = X_test if test_set else X_train
            return torch.as_tensor(
                score_edges(score_fn, params, g, X, edges, batch_size))

        pos_train = sc(ds.train_pos_val)
        pos_valid = sc(ds.valid_pos)
        pos_test = sc(ds.test_pos, test_set=True)
        if heart:
            def heart_neg(neg, test_set):
                p, k, _ = neg.shape
                return sc(np.asarray(neg).reshape(p * k, 2),
                          test_set=test_set).reshape(p, k)

            neg_valid = heart_neg(ds.valid_neg, False)
            neg_test = heart_neg(ds.test_neg, True)
            with profiling.span("eval.metric"):
                return metrics.get_metric_score_citation2(
                    pos_train, pos_valid, neg_valid, pos_test, neg_test)
        neg_valid = sc(ds.valid_neg)
        neg_test = sc(ds.test_neg, test_set=True)
        if with_mrr is None:
            with_mrr = ds.metric == "MRR"
        with profiling.span("eval.metric"):
            return metrics.get_metric_score(
                pos_train, pos_valid, neg_valid, pos_test, neg_test,
                k_list=k_list, with_mrr=with_mrr,
            )


@torch.no_grad()
def test_citation2(
    params,
    cfg: LPFormerConfig,
    ds: LinkPredDataset,
    batch_size: int = 32768,
    sharded=None,
) -> Dict[str, tuple]:
    """Reference test_citation2 (testing.py:50-74): the negatives are
    [P, K] target ids, each scored against its positive's source.
    ``sharded``: a ShardedEvalContext, to score over its mesh."""
    with profiling.span("eval.sweep"):
        score_fn, prop, g_train, g_test = _resolve_eval_fns(cfg, ds, sharded)
        X = prop(params, g_train)
        X_test = X if g_test is g_train else prop(params, g_test)

        def sc(edges, test_set=False):
            g = g_test if test_set else g_train
            return torch.as_tensor(score_edges(
                score_fn, params, g, X_test if test_set else X, edges,
                batch_size))

        def neg_scores(pos, neg_targets, test_set):
            p, k = neg_targets.shape
            with profiling.span("eval.neg_edges"):
                edges = np.stack([np.repeat(np.asarray(pos)[:, 0], k),
                                  np.asarray(neg_targets).reshape(-1)],
                                 axis=1)
            return sc(edges, test_set=test_set).reshape(p, k)

        neg_valid = neg_scores(ds.valid_pos, ds.valid_neg, False)
        pos_valid = sc(ds.valid_pos)
        pos_test = sc(ds.test_pos, test_set=True)
        neg_test = neg_scores(ds.test_pos, ds.test_neg, True)
        # the reference's quirk (testing.py:70): the train predictions are
        # the valid ones
        with profiling.span("eval.metric"):
            return metrics.get_metric_score_citation2(
                pos_valid, pos_valid, neg_valid, pos_test, neg_test)
