"""Planetoid / HeaRT fixed-split reader (counterpart of
``lpformer_tpu/data/planetoid.py``).

Mirrors reference read_data_planetoid (reference:
src/util/read_datasets.py:153-254): TSV edge lists
``{train,valid,test}_{pos,neg}.txt``, a ``gnn_feature`` torch file with
``entity_embedding``, the undirected adjacency of the train edges, PPR
with alpha=0.15, and optional HeaRT per-positive negatives from ``.npy``
files of shape [P, K, 2].
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.data.dataset import LinkPredDataset, build_graph_bundle
from lpformer_tpu_torch.graph import ppr as ppr_mod
from lpformer_tpu_torch.ops import masking


def _read_pairs(path: str, skip_self_loops: bool = True) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            sub, obj = line.strip().split("\t")
            sub, obj = int(sub), int(obj)
            if skip_self_loops and sub == obj:
                continue
            out.append((sub, obj))
    return np.asarray(out, dtype=np.int64)


def read_data_planetoid(
    data_name: str,
    data_dir: str = "dataset",
    heart_dir: Optional[str] = None,
    eps: float = 1e-4,
    alpha: float = 0.15,
    heart: bool = False,
    seed: int = 42,
    adj_cap: Optional[int] = None,
    ppr_cap: Optional[int] = None,
    cache_dir: Optional[str] = None,
    mask_input: bool = False,
    device=None,
) -> LinkPredDataset:
    """The dataset, its graph bundle on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    d = os.path.join(data_dir, data_name)
    # node count = number of distinct nodes across pos splits (:159-182)
    train_pos = _read_pairs(os.path.join(d, "train_pos.txt"))
    valid_pos = _read_pairs(os.path.join(d, "valid_pos.txt"))
    test_pos = _read_pairs(os.path.join(d, "test_pos.txt"))
    node_set = set()
    for arr in (train_pos, valid_pos, test_pos):
        node_set.update(arr.reshape(-1).tolist())
    num_nodes = len(node_set)
    valid_neg = _read_pairs(
        os.path.join(d, "valid_neg.txt"), skip_self_loops=False
    )
    test_neg = _read_pairs(
        os.path.join(d, "test_neg.txt"), skip_self_loops=False
    )

    feats = torch.load(
        os.path.join(d, "gnn_feature"), map_location="cpu",
        weights_only=False,
    )["entity_embedding"].numpy().astype(np.float32)

    # undirected edge_index from train pos (:197-198)
    src = np.concatenate([train_pos[:, 0], train_pos[:, 1]])
    dst = np.concatenate([train_pos[:, 1], train_pos[:, 0]])

    ppr_csr = ppr_mod.get_ppr(
        data_name, src, dst, num_nodes, alpha, eps, False,
        cache_dir=cache_dir,
    )
    uniq, _ = masking.train_edge_info(
        train_pos[:, 0], train_pos[:, 1], num_nodes
    )
    graph = build_graph_bundle(
        feats, src, dst, None, num_nodes, ppr_csr,
        adj_cap=adj_cap, ppr_cap=ppr_cap,
        mask_uniq_keys=uniq, mask_input=mask_input, device=dev,
    )

    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(train_pos))[: len(valid_pos)]

    if heart:
        hd = os.path.join(heart_dir or os.path.join(data_dir, "heart"),
                          data_name)
        valid_neg = np.load(os.path.join(hd, "heart_valid_samples.npy"))
        test_neg = np.load(os.path.join(hd, "heart_test_samples.npy"))

    return LinkPredDataset(
        name=data_name,
        num_nodes=num_nodes,
        graph=graph,
        graph_test=graph,
        train_pos=train_pos,
        train_pos_val=train_pos[idx],
        valid_pos=valid_pos,
        valid_neg=valid_neg,
        test_pos=test_pos,
        test_neg=test_neg,
        metric="MRR",
        heart=heart,
    )
