"""What LPFormer's data pipeline derives from the raw train edges, in plain
PyTorch on the reference's device:

  * the symmetric adjacency A + A^T with duplicate edges summed, and its
    GCN normalisation D^-1/2 (A + I) D^-1/2 as one sparse matrix;
  * per node, its distinct neighbours valued with the self-PPR ppr(u, v),
    kept to the ``adj_cap`` largest values (ties to the smaller id) and
    sorted by id, padded with the id N;
  * per node, its PPR support kept to the ``ppr_cap`` largest values
    (ties to the smaller id), sorted by id, each entry flagged when it is
    a neighbour of the node;
  * every undirected train edge's multiplicity, for the batch masking.

The PPR rows are the reference's own push (``push``) for the nodes whose
links are checked, or a whole matrix given to ``use_ppr``.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import ppr as ref_ppr


def _capped_rows(rows, ids, vals, n, cap, extra=None):
    """[n, cap] rows from entries sorted by (row, id): each row keeps its
    ``cap`` largest values, ties to the smaller id, re-sorted by id, padded
    with id n and value 0 (and ``extra`` False)."""
    dev = ids.device
    order = torch.sort(-vals, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    r = rows[order]
    counts = torch.bincount(rows, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(len(r), device=dev) - start[r]
    keep = pos < cap
    o, r, pos = order[keep], r[keep], pos[keep]
    out_ids = torch.full((n, cap), n, dtype=torch.int64, device=dev)
    out_vals = torch.zeros((n, cap), dtype=torch.float32, device=dev)
    out_ids[r, pos] = ids[o]
    out_vals[r, pos] = vals[o]
    srt = torch.sort(out_ids, dim=1)
    res = [srt.values, out_vals.gather(1, srt.indices)]
    if extra is not None:
        out_x = torch.zeros((n, cap), dtype=torch.bool, device=dev)
        out_x[r, pos] = extra[o]
        res.append(out_x.gather(1, srt.indices))
    return res


def lookup_sorted(keys, table_keys, table_vals, default=0.0):
    """Values of ``keys`` in the sorted ``table_keys``, ``default`` where
    absent; and the found mask."""
    pos = torch.searchsorted(table_keys, keys).clamp(max=len(table_keys) - 1)
    found = table_keys[pos] == keys
    return torch.where(found, table_vals[pos],
                       torch.as_tensor(default, dtype=table_vals.dtype,
                                       device=keys.device)), found


class RefGraph:
    """The derived graph of ``edges`` [M, 2] (directed train edges,
    duplicates allowed) and features ``x`` [N, F]. Its PPR tables come from
    ``use_ppr``, which takes the rows of some nodes; only links between
    those nodes can be scored."""

    def __init__(self, edges: np.ndarray, x: np.ndarray, num_nodes: int,
                 adj_cap: int, ppr_cap: int, device):
        n = self.n = num_nodes
        self.adj_cap, self.ppr_cap = adj_cap, ppr_cap
        dev = self.device = torch.device(device)
        e = torch.as_tensor(np.asarray(edges), dtype=torch.int64, device=dev)
        self.x = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                 device=dev)
        s = torch.cat([e[:, 0], e[:, 1]])
        d = torch.cat([e[:, 1], e[:, 0]])
        key, mult = torch.unique(s * n + d, return_counts=True)
        del s, d
        au, av = key // n, key % n
        self.adj_keys = key
        # the distinct neighbours as CSR, for the push
        keys = key.cpu().numpy()
        self.nbr_indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(keys // n, minlength=n),
                  out=self.nbr_indptr[1:])
        self.nbr_indices = keys % n
        # GCN normalisation over the summed weights plus a unit self loop
        deg = torch.zeros(n, dtype=torch.float64, device=dev)
        deg.index_add_(0, av, mult.double())
        dinv = (deg + 1.0).rsqrt()
        w = (dinv[au] * mult.double() * dinv[av]).float()
        loop = torch.arange(n, device=dev)
        self.a_hat = torch.sparse_coo_tensor(
            torch.stack([torch.cat([av, loop]), torch.cat([au, loop])]),
            torch.cat([w, (dinv * dinv).float()]), (n, n),
            check_invariants=False).coalesce()
        # the undirected train edges and their multiplicities
        lo = torch.minimum(e[:, 0], e[:, 1])
        hi = torch.maximum(e[:, 0], e[:, 1])
        self.train_keys, self.train_mult = torch.unique(lo * n + hi,
                                                        return_counts=True)
        self.have = torch.zeros(n, dtype=torch.bool, device=dev)

    def push(self, nodes, alpha: float, eps: float,
             dtype=np.float64) -> dict:
        """The reference's own PPR rows of ``nodes``: {node: (ids, vals)}."""
        return ref_ppr.push_rows(self.nbr_indptr, self.nbr_indices, nodes,
                                 alpha, eps, dtype)

    def use_ppr(self, indptr, indices, vals, nodes=None):
        """Take the PPR matrix as CSR arrays (rows sorted by id), holding
        the rows of ``nodes`` (every node when None): derive the capped
        neighbour and PPR rows of those nodes."""
        n, dev, key = self.n, self.device, self.adj_keys
        au, av = key // n, key % n
        ip = torch.as_tensor(np.asarray(indptr), dtype=torch.int64,
                             device=dev)
        pid = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                              device=dev)
        pval = torch.as_tensor(np.asarray(vals), dtype=torch.float32,
                               device=dev)
        prow = torch.repeat_interleave(torch.arange(n, device=dev),
                                       ip[1:] - ip[:-1])
        pkey = prow * n + pid
        self_ppr, _ = lookup_sorted(key, pkey, pval)
        _, in_adj = lookup_sorted(pkey, key, torch.zeros_like(key))
        self.adj_nbrs, self.adj_vals = _capped_rows(au, av, self_ppr, n,
                                                    self.adj_cap)
        self.ppr_nbrs, self.ppr_vals, self.ppr_flags = _capped_rows(
            prow, pid, pval, n, self.ppr_cap, extra=in_adj)
        self.have = torch.zeros(n, dtype=torch.bool, device=dev)
        self.have[torch.as_tensor(np.arange(n) if nodes is None
                                  else np.asarray(nodes, np.int64),
                                  device=dev)] = True

    def use_rows(self, rows: dict):
        """Take the PPR rows ``rows`` ({node: (ids, vals)}, as ``push``
        gives them) and no others."""
        self.use_ppr(*rows_csr(rows, self.n), nodes=sorted(rows))

    def canonical(self, u, v):
        return torch.minimum(u, v) * self.n + torch.maximum(u, v)


def rows_csr(rows: dict, n: int):
    """CSR arrays (indptr, indices, vals) of {node: (ids sorted, vals)};
    absent nodes have empty rows."""
    counts = np.zeros(n, np.int64)
    nodes = sorted(rows)
    counts[nodes] = [len(rows[u][0]) for u in nodes]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cat = lambda j, dt: (np.concatenate([rows[u][j] for u in nodes])  # noqa: E731
                         if nodes else np.zeros(0, dt))
    return indptr, cat(0, np.int64), cat(1, np.float32)
