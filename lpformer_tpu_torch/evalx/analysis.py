"""Result analysis (counterpart of ``lpformer_tpu/evalx/analysis.py``):
Hits binned by each test link's common-neighbour count, and the per-link
attention weights behind ``--dump-att``.

The reference ships an abandoned version of the binned evaluation
(src/train/eval.py: ``test_by_metric`` holds bare ``...`` placeholders
and nothing imports it); this is the working equivalent.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from lpformer_tpu_torch.data.dataset import LinkPredDataset
from lpformer_tpu_torch.evalx import harness, metrics
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.ops.context import ContextConfig, extract_context


def _links(edges: np.ndarray, device):
    t = torch.as_tensor(np.asarray(edges), dtype=torch.int64).to(device)
    return t[:, 0], t[:, 1]


@torch.no_grad()
def compute_edge_cn(
    ds: LinkPredDataset,
    edges: np.ndarray,
    batch_size: int = 8192,
    test_set: bool = True,
) -> np.ndarray:
    """Common-neighbour count per edge [M] float32, from the context
    extraction's exact counts (a cn-only table of budget 1: the counts
    do not depend on the budgets)."""
    g = ds.graph_test if test_set else ds.graph
    cfg = ContextConfig(mask_mode="cn", budget_cn=1, budget_onehop=1,
                        budget_non1hop=1)
    out = np.empty(len(edges), np.float32)
    for lo in range(0, len(edges), batch_size):
        hi = min(lo + batch_size, len(edges))
        src, tgt = _links(edges[lo:hi], g.x.device)
        ctx = extract_context(g.adj_rows, g.ppr_rows, src, tgt, cfg)
        out[lo:hi] = ctx.counts[:, 0].cpu().numpy()
    return out


@torch.no_grad()
def test_by_cn_bins(
    params,
    cfg,
    ds: LinkPredDataset,
    batch_size: int = 32768,
    bins: Sequence[float] = (0, 1, 2, 5, 10, float("inf")),
    k: int = 100,
) -> Dict[str, Dict[str, float]]:
    """Hits@k of the test positives in each CN bin [lo, hi) against the
    shared test negatives (sorted once), on the test graph; bins without
    a positive are left out."""
    score_fn = harness.make_score_fn(cfg)
    g = ds.graph_test
    X = lt.propagate(params, cfg, g)
    pos = harness.score_edges(score_fn, params, g, X, np.asarray(ds.test_pos),
                              batch_size)
    neg = harness.score_edges(score_fn, params, g, X, np.asarray(ds.test_neg),
                              batch_size)
    cn = compute_edge_cn(ds, np.asarray(ds.test_pos))

    out = {}
    neg_sorted = torch.sort(torch.as_tensor(neg)).values
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (cn >= lo) & (cn < hi)
        if m.sum() == 0:
            continue
        hit = metrics.evaluate_hits_single(torch.as_tensor(pos[m]),
                                           neg_sorted, k, neg_sorted=True)
        out[f"cn[{lo},{hi})"] = {"n": int(m.sum()), f"Hits@{k}": hit}
    return out


@torch.no_grad()
def attention_weights(
    params,
    cfg,
    ds: LinkPredDataset,
    edges: np.ndarray,
    test_set: bool = False,
):
    """Per-link attention weights over the context nodes, the ``--dump-att``
    affordance (reference: src/run.py:193, layers.py:69-75), through the
    dense route (``return_weights``). Returns numpy (ids [B, C], valid
    [B, C], alpha [B, C] averaged over the heads); alpha is exactly 0 on
    invalid slots and sums to 1 over a link's valid ones."""
    g = ds.graph_test if test_set else ds.graph
    X = lt.propagate(params, cfg, g)
    src, tgt = _links(edges, g.x.device)
    ctx = extract_context(g.adj_rows, g.ppr_rows, src, tgt, cfg.context)
    _, alpha = lt.calc_pairwise(params, cfg, X, src, tgt, ctx,
                                return_weights=True)
    return (ctx.ids.cpu().numpy(), ctx.valid.cpu().numpy(),
            alpha.mean(dim=-1).cpu().numpy())
