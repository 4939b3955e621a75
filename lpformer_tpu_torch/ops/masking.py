"""Per-batch positive-edge masking in edge-rank space (counterpart of
``lpformer_tpu/ops/masking.py``).

The reference rebuilds a sparse adjacency every batch after dropping the
batch's positive edges (reference: src/train/train_model.py:38-45). Here
the adjacency is static and masking happens in rank space:

  * host: every undirected train edge gets a rank, its index in the sorted
    unique canonical keys (min*N+max, int64 on the host only); every
    padded-adjacency entry carries its rank (``PaddedRows.ranks``);
  * device, per batch: each batch edge's rank is looked up in the padded
    row of one endpoint, and the mask is a boolean bitmap over ranks [U];
    an entry is masked when ``bitmap[rank]`` is set.

Multiplicities keep the reference's semantics: ogbl-collab repeats an edge
once per collaboration year, and an undirected edge leaves the support only
when every one of its instances is in the batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lpformer_tpu_torch.graph.containers import CSRGraph, PaddedRows
from lpformer_tpu_torch.ops.search import row_lookup

# distinct from the -1 "no rank" padding
_NOT_FOUND = -2


def train_edge_info(
    train_src: np.ndarray, train_dst: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique canonical keys min*N+max (int64) of the train
    positives, and their multiplicities (int32): ogbl-collab repeats an
    edge once per collaboration year, and the reference masks an edge only
    when every instance is in the batch (train_model.py:38-45)."""
    lo = np.minimum(train_src, train_dst).astype(np.int64)
    hi = np.maximum(train_src, train_dst).astype(np.int64)
    keys = lo * num_nodes + hi
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq.astype(np.int64), counts.astype(np.int32)


def edge_ranks_for_entries(
    src: np.ndarray, dst: np.ndarray, uniq_keys: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Host: int32 rank per (src, dst) entry; -1 where not a train edge."""
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    keys = lo * num_nodes + hi
    pos = np.searchsorted(uniq_keys, keys)
    pos_c = np.clip(pos, 0, max(len(uniq_keys) - 1, 0))
    found = (uniq_keys[pos_c] == keys if len(uniq_keys)
             else np.zeros_like(keys, bool))
    return np.where(found, pos_c, -1).astype(np.int32)


def edge_ranks_for_csr(csr: CSRGraph, uniq_keys: np.ndarray) -> np.ndarray:
    """Host: ranks aligned with the CSR's entry order."""
    deg = csr.indptr[1:] - csr.indptr[:-1]
    src = np.repeat(np.arange(csr.num_nodes, dtype=np.int64), deg)
    return edge_ranks_for_entries(src, csr.indices, uniq_keys, csr.num_nodes)


def link_edge_ranks(
    adj_nbrs_s: torch.Tensor,   # [B, A] src adjacency rows
    adj_ranks_s: torch.Tensor,  # [B, A] their edge ranks
    tgt: torch.Tensor,          # [B]
    adj_nbrs_t: torch.Tensor,   # [B, A] tgt adjacency rows
    adj_ranks_t: torch.Tensor,  # [B, A]
    src: torch.Tensor,          # [B]
) -> torch.Tensor:
    """int32 rank of each batch edge (src, tgt), from either direction's
    padded row: with a per-row cap a high-degree endpoint may have dropped
    the entry, but it survives in the other row unless both endpoints
    overflow their caps. -2 when not found."""
    _, rank_f = row_lookup(adj_nbrs_s, adj_ranks_s, tgt[:, None], _NOT_FOUND)
    _, rank_b = row_lookup(adj_nbrs_t, adj_ranks_t, src[:, None], _NOT_FOUND)
    return torch.where(rank_f[:, 0] >= 0, rank_f[:, 0], rank_b[:, 0])


def bitmap_from_link_ranks(
    rank: torch.Tensor,
    multiplicities: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The [U] masked-rank bitmap: a rank is masked iff the batch holds at
    least as many instances of the edge as its train multiplicity.
    ``weight``: optional [B] per-link weights; zero-weight entries (the
    padding of a ragged last batch) are not counted."""
    u = multiplicities.shape[0]
    rank_c = rank.clamp(0, max(u - 1, 0)).long()
    ones = (rank >= 0).to(torch.int32)
    if weight is not None:
        ones = ones * (weight > 0).to(torch.int32)
    counts = torch.zeros(u, dtype=torch.int32, device=rank.device)
    counts.index_add_(0, rank_c, ones)
    return counts >= multiplicities


def batch_mask_ranks(
    adj_rows: PaddedRows,
    src: torch.Tensor,
    tgt: torch.Tensor,
    multiplicities: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean bitmap [U] over edge ranks, True = masked for this batch."""
    if adj_rows.ranks is None:
        raise ValueError("batch masking needs adjacency rows with ranks "
                         "(build_graph_bundle(mask_uniq_keys=...))")
    src, tgt = src.long(), tgt.long()
    rank = link_edge_ranks(
        adj_rows.nbrs[src], adj_rows.ranks[src], tgt,
        adj_rows.nbrs[tgt], adj_rows.ranks[tgt], src,
    )
    return bitmap_from_link_ranks(rank, multiplicities, weight)


def rank_is_masked(
    mask_bitmap: torch.Tensor, entry_ranks: torch.Tensor
) -> torch.Tensor:
    """Membership of entry ranks (int32, -1 = not a train edge) in the
    masked set; shape-preserving. A plain gather ``bitmap[rank]``: the JAX
    package's [U/128, 128] lane view is a TPU gather workaround with the
    same semantics."""
    u = mask_bitmap.shape[0]
    if u == 0:
        return torch.zeros(entry_ranks.shape, dtype=torch.bool,
                           device=entry_ranks.device)
    rc = entry_ranks.clamp(0, u - 1).long()
    return mask_bitmap[rc] & (entry_ranks >= 0)


def mask_edge_weights(
    mask_bitmap: torch.Tensor,
    edge_ranks: torch.Tensor,
    edge_w: torch.Tensor,
) -> torch.Tensor:
    """The propagation weights with the batch's masked train edges set to
    0, for ``mask_input`` (reference: src/train/train_model.py:47-57; the
    reference builds that adjacency unweighted, so pass binarized
    weights). ``edge_ranks`` [E] int32, -1 where no train edge (never
    masked)."""
    hit = rank_is_masked(mask_bitmap, edge_ranks)
    return torch.where(hit, torch.zeros_like(edge_w), edge_w)
