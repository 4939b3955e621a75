"""Synthetic graphs (counterpart of ``lpformer_tpu/data/synthetic.py``).

Power-law random graphs with the statistics that matter for LPFormer
(degree spread, PPR sparsity), and a planted-partition variant whose links
are learnable from their context (``sbm_edges``). The numpy
``default_rng`` draws are the JAX package's, in the same order, so a seed
gives the same splits and features in both packages.
"""
from __future__ import annotations

import os
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


def sbm_edges(
    rng: np.random.Generator,
    num_nodes: int,
    num_edges: int,
    communities: int,
    intra_frac: float = 0.85,
    power: float = 1.2,
) -> np.ndarray:
    """[M, 2] planted-partition edges: with probability ``intra_frac``
    both endpoints come from one community (round-robin assignment
    ``node % communities``), else from the power-law endpoint
    distribution (the heavy-tail overlay that makes hub nodes). Intra
    pairs share many common neighbours, so link structure is learnable,
    which the pure power-law generator lacks."""
    k = communities
    sizes = np.array([(num_nodes - c - 1) // k + 1 for c in range(k)])
    out = []
    need = num_edges
    while need > 0:
        batch = need * 2
        intra = rng.random(batch) < intra_frac
        c = rng.integers(0, k, batch)
        j1 = (rng.random(batch) * sizes[c]).astype(np.int64)
        j2 = (rng.random(batch) * sizes[c]).astype(np.int64)
        e_in = np.stack([c + k * j1, c + k * j2], axis=1)
        e_out = random_edges(rng, num_nodes, batch, power)
        e = np.where(intra[:, None], e_in, e_out[: len(e_in)])
        e = e[e[:, 0] != e[:, 1]][:need]
        out.append(e)
        need -= len(e)
    return np.concatenate(out, axis=0).astype(np.int64)


def synthetic_dataset(
    seed: int = 0,
    num_nodes: int = 200,
    num_train: int = 600,
    num_eval: int = 60,
    feat_dim: int = 16,
    alpha: float = 0.15,
    eps: float = 1e-3,
    heart: bool = False,
    heart_negs: int = 8,
    adj_cap: Optional[int] = None,
    ppr_cap: Optional[int] = None,
    metric: str = "MRR",
    power: float = 0.8,
    mask_input: bool = False,
    communities: int = 0,
    intra_frac: float = 0.85,
    ppr_cache_dir: Optional[str] = None,
    ppr_method: str = "native",
    device=None,
) -> LinkPredDataset:
    """The power-law synthetic dataset; the adjacency is the symmetrized
    train positives (reference read_datasets.py:85-95). With ``heart``
    every eval positive gets its own ``heart_negs`` negatives, [P, K, 2];
    ``mask_input`` builds the propagation layout that batch-masked
    weights re-weight (``build_graph_bundle``). ``communities > 0``
    draws the positives (train and eval) from ``sbm_edges``, the
    negatives staying uniform. ``ppr_cache_dir`` caches the PPR matrix
    under a key of everything it depends on (``graph/ppr.get_ppr``), in
    the JAX package's layout, so either package reads the other's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if communities > 0:
        def pos_edges(m):
            return sbm_edges(rng, num_nodes, m, communities, intra_frac,
                             power)
    else:
        def pos_edges(m):
            return random_edges(rng, num_nodes, m, power)
    train_pos = pos_edges(num_train)
    valid_pos = pos_edges(num_eval)
    test_pos = pos_edges(num_eval)
    if heart:
        valid_neg = random_edges(rng, num_nodes, num_eval * heart_negs)
        valid_neg = valid_neg.reshape(num_eval, heart_negs, 2)
        test_neg = random_edges(rng, num_nodes, num_eval * heart_negs)
        test_neg = test_neg.reshape(num_eval, heart_negs, 2)
    else:
        valid_neg = random_edges(rng, num_nodes, num_eval)
        test_neg = random_edges(rng, num_nodes, num_eval)
    x = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)

    src, dst = train_pos[:, 0], train_pos[:, 1]
    sym_src, sym_dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if ppr_cache_dir is not None:
        # the edge list is a function of these parameters; alpha and eps
        # are in the cached file's name
        key = f"synthetic-s{seed}-n{num_nodes}-e{num_train}"
        if power != 0.8:
            key += f"-p{power}"
        if communities > 0:
            key += f"-k{communities}-i{intra_frac}"
        ppr_csr = ppr_mod.get_ppr(
            key, sym_src, sym_dst, num_nodes, alpha, eps,
            cache_dir=os.path.join(ppr_cache_dir, key), method=ppr_method,
        )
    else:
        ppr_csr = ppr_mod.ppr_push_csr(sym_src, sym_dst, num_nodes, alpha,
                                       eps, method=ppr_method)
    uniq, _ = masking.train_edge_info(src, dst, num_nodes)
    graph = build_graph_bundle(
        x, src, dst, None, num_nodes, ppr_csr,
        adj_cap=adj_cap, ppr_cap=ppr_cap, mask_uniq_keys=uniq,
        mask_input=mask_input, device=dev,
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
        heart=heart,
    )
