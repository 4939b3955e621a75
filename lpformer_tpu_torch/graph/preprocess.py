"""Host-side graph preprocessing in numpy (counterpart of
``lpformer_tpu/graph/preprocess.py``, whose arrays it reproduces exactly).

The reference builds adj_t / adj_mask / degrees with torch_sparse and PyG
(reference: src/util/read_datasets.py:85-118).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from lpformer_tpu_torch.graph.containers import CSRGraph


def coalesce_edges(
    src: np.ndarray,
    dst: np.ndarray,
    w: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    reduce: str = "add",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by (src, dst) and merge duplicate edges with ``reduce`` in
    {"add", "max", "min"} (torch_sparse coalesce defaults to add)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if w is None:
        w = np.ones(src.shape[0], dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)

    key = src * num_nodes + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    uniq_mask = np.ones(len(key), dtype=bool)
    uniq_mask[1:] = key[1:] != key[:-1]
    seg_id = np.cumsum(uniq_mask) - 1
    n_uniq = int(seg_id[-1]) + 1 if len(key) else 0
    if reduce == "add":
        wout = np.zeros(n_uniq, dtype=np.float64)
        np.add.at(wout, seg_id, w)
        wout = wout.astype(np.float32)
    elif reduce == "max":
        wout = np.full(n_uniq, -np.inf, dtype=np.float32)
        np.maximum.at(wout, seg_id, w)
    elif reduce == "min":
        wout = np.full(n_uniq, np.inf, dtype=np.float32)
        np.minimum.at(wout, seg_id, w)
    else:
        raise ValueError(f"unknown reduce: {reduce}")
    return src[uniq_mask], dst[uniq_mask], wout


def symmetrize(
    src: np.ndarray,
    dst: np.ndarray,
    w: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    reduce: str = "add",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A <- A + A^T, duplicates merged by ``reduce`` (torch_sparse
    ``to_symmetric``, reference: src/util/read_datasets.py:89-92)."""
    if w is None:
        w = np.ones(len(src), dtype=np.float32)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    ww = np.concatenate([w, w])
    return coalesce_edges(s, d, ww, num_nodes=num_nodes, reduce=reduce)


def edges_to_csr(
    src: np.ndarray,
    dst: np.ndarray,
    w: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    coalesce: bool = True,
    reduce: str = "add",
) -> CSRGraph:
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if coalesce:
        src, dst, w = coalesce_edges(src, dst, w, num_nodes, reduce=reduce)
    elif w is None:
        w = np.ones(len(src), dtype=np.float32)
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(
        indptr=indptr,
        indices=dst.astype(np.int32),
        weights=w.astype(np.float32),
        num_nodes=num_nodes,
    )


def binarize_csr(csr: CSRGraph) -> CSRGraph:
    """0/1 weights: the reference's ``adj_mask.coalesce().bool().int()``
    (reference: src/util/read_datasets.py:95)."""
    return CSRGraph(
        indptr=csr.indptr,
        indices=csr.indices,
        weights=np.ones_like(csr.weights),
        num_nodes=csr.num_nodes,
    )


def gcn_norm_edges(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    num_nodes: int,
    add_self_loops: bool = True,
    fill_value: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric GCN normalisation D^-1/2 (A [+ I]) D^-1/2, PyG's
    ``gcn_norm`` (reference: src/models/other_models.py:35): self loops
    filled with ``fill_value``, degrees the dst-row sums of the weights
    with the self loop. Returns the (src, dst, w_norm) COO, the self loops
    appended at the end."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float32)
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
        w = np.concatenate(
            [w, np.full(num_nodes, fill_value, dtype=np.float32)])
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, dst, w)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
    w_norm = (dinv[src] * w * dinv[dst]).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w_norm


def sort_by_dst(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort COO by (dst, src), the layout the dst-bucketed SpMM is built on."""
    key = dst.astype(np.int64) * num_nodes + src.astype(np.int64)
    order = np.argsort(key, kind="stable")
    return src[order], dst[order], w[order]


def out_degrees(src: np.ndarray, num_nodes: int) -> np.ndarray:
    """degree(edge_index[0]) (reference: src/util/read_datasets.py:116)."""
    return np.bincount(src, minlength=num_nodes).astype(np.float32)
