"""Dataset container and graph-bundle assembly (counterpart of
``lpformer_tpu/data/dataset.py``).

``LinkPredDataset`` plays the role of the reference's ``data`` dict
(reference: src/util/read_datasets.py:24-26): splits as host arrays, plus
one :class:`GraphBundle` per adjacency variant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.graph import preprocess as pp
from lpformer_tpu_torch.graph.containers import (
    BucketedELL,
    CSRGraph,
    GraphBundle,
    PaddedRows,
)
from lpformer_tpu_torch.ops import masking

# At this size the JAX package switches propagation to the tiled
# BlockedBELL / BlockedCOO layouts, which the port does not have yet.
BLOCKED_MIN_NODES = 262_144


def _csr_entry_keys(csr: CSRGraph) -> np.ndarray:
    deg = csr.indptr[1:] - csr.indptr[:-1]
    rows = np.repeat(np.arange(csr.num_nodes, dtype=np.int64), deg)
    return rows * csr.num_nodes + csr.indices.astype(np.int64)


def _cross_lookup(adj_csr: CSRGraph, ppr_csr: CSRGraph) -> tuple:
    """Host precompute of the pair-independent lookups:
      * per adjacency entry (u, v): ppr(u, v), 0.0 if absent;
      * per PPR entry (u, v): whether v is in N(u)."""
    adj_keys = _csr_entry_keys(adj_csr)
    ppr_keys = _csr_entry_keys(ppr_csr)
    pos = np.searchsorted(ppr_keys, adj_keys)
    pos_c = np.clip(pos, 0, max(len(ppr_keys) - 1, 0))
    found = (ppr_keys[pos_c] == adj_keys if len(ppr_keys)
             else np.zeros_like(adj_keys, bool))
    adj_selfppr = np.where(found, ppr_csr.weights[pos_c], 0.0).astype(np.float32)
    pos2 = np.searchsorted(adj_keys, ppr_keys)
    pos2_c = np.clip(pos2, 0, max(len(adj_keys) - 1, 0))
    ppr_in_adj = (adj_keys[pos2_c] == ppr_keys if len(adj_keys)
                  else np.zeros_like(ppr_keys, bool))
    return adj_selfppr, ppr_in_adj


def build_graph_bundle(
    x: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_w: Optional[np.ndarray],
    num_nodes: int,
    ppr_csr: CSRGraph,
    adj_cap: Optional[int] = None,
    ppr_cap: Optional[int] = None,
    mask_uniq_keys: Optional[np.ndarray] = None,
    device=None,
) -> GraphBundle:
    """Assemble the graph state from the raw edge_index on ``device``:
      * the weighted symmetric adjacency for propagation, dst-sorted, with
        its static GCN normalisation and BucketedELL layout
        (reference adj_t, read_datasets.py:85-92);
      * the binarized padded rows for context extraction, valued with the
        self-PPR ppr(u, v) (adj_mask, :95);
      * padded PPR rows from ``ppr_csr``, flagged where v is in N(u).
    With ``mask_uniq_keys`` (the sorted unique train-edge keys of
    ``masking.train_edge_info``) the adjacency rows carry each entry's
    train-edge rank, which batch masking in training reads.
    """
    if num_nodes >= BLOCKED_MIN_NODES:
        raise NotImplementedError(
            f"{num_nodes} nodes needs the BlockedBELL/BlockedCOO propagation "
            f"layouts (>= {BLOCKED_MIN_NODES} nodes), not yet ported"
        )
    dev = resolve_device(device)
    s, d, w = pp.symmetrize(edge_src, edge_dst, edge_w, num_nodes)
    ps_, pd_, pw_ = pp.sort_by_dst(
        s.astype(np.int32), d.astype(np.int32), w, num_nodes
    )
    adj_csr = pp.edges_to_csr(s, d, w, num_nodes, coalesce=False)
    entry_ranks = (None if mask_uniq_keys is None
                   else masking.edge_ranks_for_csr(adj_csr, mask_uniq_keys))
    adj_selfppr, ppr_in_adj = _cross_lookup(adj_csr, ppr_csr)
    adj_bin = pp.binarize_csr(adj_csr)
    # adjacency row values = self-PPR: on cap overflow the rows keep the
    # highest-self-PPR neighbours
    adj_bin = CSRGraph(
        indptr=adj_bin.indptr, indices=adj_bin.indices,
        weights=adj_selfppr, num_nodes=num_nodes,
    )
    adj_rows = PaddedRows.from_csr(adj_bin, cap=adj_cap,
                                   entry_ranks=entry_ranks)
    ppr_rows = PaddedRows.from_csr(ppr_csr, cap=ppr_cap,
                                   entry_flags=ppr_in_adj)
    deg = pp.out_degrees(np.asarray(edge_src, np.int64), num_nodes)
    # static GCN norm D^-1/2 (A + I) D^-1/2 (PyG gcn_norm, fill 1.0)
    deg_w = np.zeros(num_nodes, np.float64)
    np.add.at(deg_w, pd_, pw_)
    deg_w += 1.0
    dinv = 1.0 / np.sqrt(deg_w)
    w_norm = (dinv[ps_] * pw_ * dinv[pd_]).astype(np.float32)
    w_diag = (dinv * dinv).astype(np.float32)
    ell = BucketedELL.from_sorted_coo(ps_, pd_, num_nodes, w_norm=w_norm)
    return GraphBundle(
        x=np.asarray(x, np.float32),
        edge_src=ps_.astype(np.int32),
        edge_dst=pd_.astype(np.int32),
        edge_w=pw_.astype(np.float32),
        adj_rows=adj_rows,
        ppr_rows=ppr_rows,
        degree=deg.astype(np.float32),
        num_nodes=num_nodes,
        num_edges=int(len(ps_)),
        ell=ell,
        w_norm=w_norm,
        w_diag=w_diag,
    ).to(dev)


@dataclasses.dataclass
class LinkPredDataset:
    name: str
    num_nodes: int
    graph: GraphBundle               # train-time adjacency/PPR
    graph_test: GraphBundle          # eval adjacency/PPR (may be the same)
    train_pos: np.ndarray            # [M, 2]
    train_pos_val: np.ndarray        # [V, 2] random train subset
                                     # (reference read_datasets.py:70-71)
    valid_pos: np.ndarray
    valid_neg: np.ndarray            # [Vn, 2]
    test_pos: np.ndarray
    test_neg: np.ndarray
    metric: str = "MRR"              # reference run.py:102-120
    # masking precompute (reference train_model.py:38-45 semantics)
    mask_uniq_keys: Optional[np.ndarray] = None
    mask_mult: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.mask_uniq_keys is None:
            self.mask_uniq_keys, self.mask_mult = masking.train_edge_info(
                self.train_pos[:, 0], self.train_pos[:, 1], self.num_nodes
            )

    @property
    def mask_mult_device(self) -> torch.Tensor:
        """Train-edge multiplicities as an int32 tensor on the graph's
        device, for ``masking.batch_mask_ranks``."""
        return torch.as_tensor(self.mask_mult, dtype=torch.int32).to(
            self.graph.x.device)
