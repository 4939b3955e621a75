"""Synthetic graphs (counterpart of ``lpformer_tpu/data/synthetic.py``).

Power-law random graphs with the statistics that matter for LPFormer
(degree spread, PPR sparsity). The numpy ``default_rng`` draws are the JAX
package's, in the same order, so a seed gives the same splits and features
in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.data.dataset import LinkPredDataset, build_graph_bundle
from lpformer_tpu_torch.graph import ppr as ppr_mod
from lpformer_tpu_torch.ops import masking


def random_edges(
    rng: np.random.Generator,
    num_nodes: int,
    num_edges: int,
    power: float = 0.8,
) -> np.ndarray:
    """[M, 2] directed edges without self loops (duplicates allowed, like
    the OGB splits), endpoints drawn with weight rank^-power."""
    w = (np.arange(1, num_nodes + 1) ** -power).astype(np.float64)
    p = w / w.sum()
    src = rng.choice(num_nodes, size=num_edges * 2, p=p)
    dst = rng.choice(num_nodes, size=num_edges * 2, p=p)
    ok = src != dst
    e = np.stack([src[ok], dst[ok]], axis=1)[:num_edges]
    while len(e) < num_edges:  # top up if too many self loops
        extra = random_edges(rng, num_nodes, num_edges - len(e), power)
        e = np.concatenate([e, extra], axis=0)
    return e.astype(np.int64)


def synthetic_dataset(
    seed: int = 0,
    num_nodes: int = 200,
    num_train: int = 600,
    num_eval: int = 60,
    feat_dim: int = 16,
    alpha: float = 0.15,
    eps: float = 1e-3,
    adj_cap: Optional[int] = None,
    ppr_cap: Optional[int] = None,
    metric: str = "MRR",
    power: float = 0.8,
    ppr_method: str = "native",
    device=None,
) -> LinkPredDataset:
    """The power-law synthetic dataset; the adjacency is the symmetrized
    train positives (reference read_datasets.py:85-95)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    train_pos = random_edges(rng, num_nodes, num_train, power)
    valid_pos = random_edges(rng, num_nodes, num_eval, power)
    test_pos = random_edges(rng, num_nodes, num_eval, power)
    valid_neg = random_edges(rng, num_nodes, num_eval)
    test_neg = random_edges(rng, num_nodes, num_eval)
    x = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)

    src, dst = train_pos[:, 0], train_pos[:, 1]
    ppr_csr = ppr_mod.ppr_push_csr(
        np.concatenate([src, dst]), np.concatenate([dst, src]),
        num_nodes, alpha, eps, method=ppr_method,
    )
    uniq, _ = masking.train_edge_info(src, dst, num_nodes)
    graph = build_graph_bundle(
        x, src, dst, None, num_nodes, ppr_csr,
        adj_cap=adj_cap, ppr_cap=ppr_cap, mask_uniq_keys=uniq, device=dev,
    )
    idx = rng.permutation(len(train_pos))[: len(valid_pos)]
    return LinkPredDataset(
        name=f"synthetic-{num_nodes}",
        num_nodes=num_nodes,
        graph=graph,
        graph_test=graph,
        train_pos=train_pos,
        train_pos_val=train_pos[idx],
        valid_pos=valid_pos,
        valid_neg=valid_neg,
        test_pos=test_pos,
        test_neg=test_neg,
        metric=metric,
    )
