"""Personalized PageRank precompute (counterpart of
``lpformer_tpu/graph/ppr.py``).

Andersen push per source node with the stopping rule
``r[v] >= alpha * eps * deg(v)`` (reference: src/util/calc_ppr_scores.py:
103-270). Two implementations with the same semantics:

  * ``method="native"`` (the default): the multithreaded C++ push of
    ``native/ppr_push.cpp``, compiled with g++ into the port's build
    directory at first use and loaded with ctypes. A failed build raises:
    the pure-Python push takes minutes on a collab-size graph, so it is
    never a silent fallback. (``native/``'s own Makefile is not run: it
    writes the tracked ``native/libppr_push.so``.)
  * ``method="numpy"``: the pure-Python push, for tests and tiny graphs.

``get_ppr`` caches the matrix on disk in the JAX package's layout and npz
keys, so a cache written by either package is read by the other.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from lpformer_tpu_torch.graph.containers import CSRGraph
from lpformer_tpu_torch.graph.preprocess import edges_to_csr
from lpformer_tpu_torch.utils.build import build_shared

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "ppr_push.cpp",
)
# the flags of native/Makefile, so both packages compute the same values
_GXX = ["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-march=native",
        "-shared"]
_LIB = None


def build_native() -> str:
    """Compile the push library (cached by source hash); return its path."""
    return build_shared("ppr_push", [_SOURCE], _GXX)[0]


def _load_native():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_native())
        lib.ppr_push_run.restype = ctypes.c_int64
        lib.ppr_push_run.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.ppr_push_collect.restype = None
        lib.ppr_push_collect.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    return _LIB


def _push_numpy(
    indptr: np.ndarray,
    indices: np.ndarray,
    out_degree: np.ndarray,
    alpha: float,
    eps: float,
) -> Tuple[list, list]:
    """Pure-Python push, step for step the reference algorithm
    (reference: src/util/calc_ppr_scores.py:160-192)."""
    alpha_eps = alpha * eps
    n = len(out_degree)
    js, vals = [], []
    for inode in range(n):
        p: dict = {inode: 0.0}
        r = {inode: alpha}
        q = [inode]
        while q:
            unode = q.pop()
            res = r.get(unode, 0.0)
            p[unode] = p.get(unode, 0.0) + res
            r[unode] = 0.0
            du = out_degree[unode]
            if du == 0:
                continue
            _val = (1 - alpha) * res / du
            for vnode in indices[indptr[unode]:indptr[unode + 1]]:
                vnode = int(vnode)
                r[vnode] = r.get(vnode, 0.0) + _val
                if r[vnode] >= alpha_eps * out_degree[vnode]:
                    if vnode not in q:
                        q.append(vnode)
        js.append(list(p.keys()))
        vals.append(list(p.values()))
    return js, vals


def ppr_push_csr(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    num_nodes: int,
    alpha: float = 0.15,
    eps: float = 1e-4,
    num_threads: int = 0,
    method: str = "native",
) -> CSRGraph:
    """Approximate PPR matrix (rows = sources) as a CSR over all nodes,
    each row sorted by node id."""
    adj = edges_to_csr(
        edge_src, edge_dst, None, num_nodes, coalesce=True, reduce="max"
    )
    indptr = np.ascontiguousarray(adj.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj.indices, dtype=np.int32)
    out_degree = np.ascontiguousarray(indptr[1:] - indptr[:-1], dtype=np.int64)

    if method == "native":
        lib = _load_native()
        nnz = lib.ppr_push_run(
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_degree.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            float(alpha), float(eps), num_nodes, num_threads,
        )
        out_indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        out_indices = np.zeros(max(nnz, 1), dtype=np.int32)
        out_vals = np.zeros(max(nnz, 1), dtype=np.float32)
        lib.ppr_push_collect(
            out_indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        out_indices, out_vals = out_indices[:nnz], out_vals[:nnz]
    elif method == "numpy":
        js, vals = _push_numpy(
            indptr, indices, out_degree.astype(np.float64), alpha, eps
        )
        out_indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        out_indptr[1:] = np.cumsum([len(j) for j in js])
        out_indices = np.concatenate([np.asarray(j, np.int32) for j in js])
        out_vals = np.concatenate([np.asarray(v, np.float32) for v in vals])
    else:
        raise ValueError(f"unknown PPR method: {method}")

    # sort each row by node id (the padded-row layout wants sorted rows;
    # the reference coalesces to the same order, calc_ppr_scores.py:239)
    row_src = np.repeat(
        np.arange(num_nodes, dtype=np.int64), out_indptr[1:] - out_indptr[:-1]
    )
    key = row_src * num_nodes + out_indices.astype(np.int64)
    order = np.argsort(key, kind="stable")
    return CSRGraph(
        indptr=out_indptr,
        indices=out_indices[order],
        weights=out_vals[order],
        num_nodes=num_nodes,
    )


def get_ppr(
    dataset: str,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    num_nodes: int,
    alpha: float = 0.15,
    eps: float = 1e-4,
    is_val: bool = False,
    cache_dir: Optional[str] = None,
    method: str = "native",
) -> CSRGraph:
    """Load the PPR matrix from the cache, or compute and cache it.

    The cache layout mirrors the reference's
    (``node_subsets/ppr/{dataset}/sparse_adj-{alpha}_eps-{eps}[_val]``,
    reference: src/util/calc_ppr_scores.py:249-267, relative to the
    working directory unless ``cache_dir`` is given) as an npz of
    ``indptr``, ``indices``, ``weights`` and ``num_nodes``.
    """
    if cache_dir is None:
        cache_dir = os.path.join("node_subsets", "ppr", dataset)
    os.makedirs(cache_dir, exist_ok=True)
    alpha_str = str(alpha).replace(".", "")
    eps_str = str(eps).replace(".", "")
    suffix = "_val" if is_val else ""
    path = os.path.join(
        cache_dir, f"sparse_adj-{alpha_str}_eps-{eps_str}{suffix}.npz"
    )
    if os.path.isfile(path):
        with np.load(path) as z:
            return CSRGraph(
                indptr=z["indptr"],
                indices=z["indices"],
                weights=z["weights"],
                num_nodes=int(z["num_nodes"]),
            )
    csr = ppr_push_csr(edge_src, edge_dst, num_nodes, alpha, eps,
                       method=method)
    np.savez_compressed(
        path,
        indptr=csr.indptr,
        indices=csr.indices,
        weights=csr.weights,
        num_nodes=np.int64(num_nodes),
    )
    return csr
