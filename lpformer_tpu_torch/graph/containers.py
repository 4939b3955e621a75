"""Static graph containers (counterpart of
``lpformer_tpu/graph/containers.py``).

  * ``CSRGraph``     host CSR in numpy, the preprocessing currency.
  * ``PaddedRows``   [N, K] padded per-row neighbour lists, sorted, pad = N,
                     with optional per-entry values and flags.
  * ``BucketedELL``  the dst-sorted propagation adjacency in power-of-two
                     degree tiers, for the scatter-free SpMM.
  * ``GraphBundle``  everything a forward pass needs, as tensors.

Every container is built on the host in numpy with the same rules as the
JAX package (so the arrays are equal, element for element), then moved to
a device with ``.to(device)``. The big-graph layouts ``BlockedCOO`` and
``BlockedBELL`` are not ported yet (``data/dataset.py`` refuses graphs
that would need them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _to(x, device):
    return None if x is None else torch.as_tensor(x).to(device)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Host-side CSR adjacency, rows sorted by column id."""

    indptr: np.ndarray   # [N+1] int64
    indices: np.ndarray  # [nnz] int32, sorted within each row
    weights: np.ndarray  # [nnz] float32
    num_nodes: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


@dataclasses.dataclass(frozen=True)
class PaddedRows:
    """[N, K] padded per-row neighbour lists, sorted ascending, pad = N.

    The pad id equals ``num_nodes``, so sorted order holds (all real ids
    are < N). ``vals`` are 0.0 and ``flags`` False at pads. ``ranks`` carry
    each entry's undirected-train-edge rank (``ops/masking.py``), -1 at
    pads and at entries that are no train edge.
    """

    nbrs: torch.Tensor             # [N, K] int32
    vals: torch.Tensor             # [N, K] float32
    counts: torch.Tensor           # [N] int32 row lengths (<= K)
    flags: Optional[torch.Tensor]  # [N, K] bool
    cap: int
    num_nodes: int
    ranks: Optional[torch.Tensor] = None  # [N, K] int32

    @staticmethod
    def from_csr(
        csr: CSRGraph,
        cap: Optional[int] = None,
        entry_flags: Optional[np.ndarray] = None,
        entry_ranks: Optional[np.ndarray] = None,
    ) -> "PaddedRows":
        """Rows longer than ``cap`` keep the ``cap`` entries with the largest
        weights (ties -> smaller node id), then are re-sorted by id.
        ``entry_flags`` and ``entry_ranks`` are aligned with the CSR entries
        and carried into the padded layout. Returns numpy-backed rows;
        call :meth:`to` to move them."""
        n = csr.num_nodes
        deg = csr.indptr[1:] - csr.indptr[:-1]
        max_deg = int(deg.max()) if n > 0 and len(deg) else 0
        k = max(max_deg if cap is None else int(cap), 1)
        nbrs = np.full((n, k), n, dtype=np.int32)
        vals = np.zeros((n, k), dtype=np.float32)
        flg = None if entry_flags is None else np.zeros((n, k), dtype=bool)
        rks = (None if entry_ranks is None
               else np.full((n, k), -1, dtype=np.int32))
        counts = np.minimum(deg, k).astype(np.int32)

        # order each row's entries by descending weight so a cap keeps the
        # top-k, scatter into [N, k], then re-sort rows by id (pads last)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        if max_deg > k:
            order = np.lexsort((-csr.weights, rows))
        else:
            order = np.arange(csr.nnz, dtype=np.int64)
        r_sorted = rows[order]
        pos_in_row = np.arange(csr.nnz, dtype=np.int64) - np.repeat(
            csr.indptr[:-1], deg
        )
        keep = pos_in_row < k
        rk, pk, ok = r_sorted[keep], pos_in_row[keep], order[keep]
        nbrs[rk, pk] = csr.indices[ok]
        vals[rk, pk] = csr.weights[ok]
        if flg is not None:
            flg[rk, pk] = entry_flags[ok]
        if rks is not None:
            rks[rk, pk] = entry_ranks[ok]
        if max_deg > k:
            resort = np.argsort(nbrs, axis=1, kind="stable")
            nbrs = np.take_along_axis(nbrs, resort, axis=1)
            vals = np.take_along_axis(vals, resort, axis=1)
            if flg is not None:
                flg = np.take_along_axis(flg, resort, axis=1)
            if rks is not None:
                rks = np.take_along_axis(rks, resort, axis=1)
        return PaddedRows(
            nbrs=nbrs, vals=vals, counts=counts,
            flags=flg, cap=k, num_nodes=n, ranks=rks,
        )

    def to(self, device) -> "PaddedRows":
        return dataclasses.replace(
            self,
            nbrs=_to(self.nbrs, device), vals=_to(self.vals, device),
            counts=_to(self.counts, device), flags=_to(self.flags, device),
            ranks=_to(self.ranks, device),
        )


@dataclasses.dataclass(frozen=True)
class BucketedELL:
    """Degree-bucketed ELL: destination rows grouped into power-of-two
    degree tiers; tier t is a dense [Nb_t, cap_t] slot grid (cap_t = 2^t,
    the last tier the exact max degree). Every edge lands in exactly one
    slot, so the SpMM is row gathers and sums with no scatter. Per-tier
    outputs are concatenated and un-permuted by one [N]-row gather
    (``outmap``; degree-0 rows map to an appended zeros row). The slots'
    edge ids of the JAX layout, which re-weight a batch-masked graph in
    training, come with the training slice."""

    nbs: Tuple               # per tier: [Nb_t, cap_t] int32 src ids, pad 0
    w_slots: Optional[Tuple]  # per tier: [Nb_t, cap_t] f32 static norm
    outmap: object           # [N] int32
    caps: Tuple
    num_nodes: int
    num_edges: int

    @staticmethod
    def from_sorted_coo(
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        num_nodes: int,
        w_norm: Optional[np.ndarray] = None,
    ) -> Optional["BucketedELL"]:
        """Build from a (dst, src)-sorted COO edge list; ``w_norm`` attaches
        the static slot weights. None for an empty graph."""
        e = len(edge_dst)
        if e == 0 or num_nodes == 0:
            return None
        edge_src = np.asarray(edge_src)
        edge_dst = np.asarray(edge_dst)
        deg = np.bincount(edge_dst, minlength=num_nodes)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        pos = np.arange(e, dtype=np.int64) - indptr[edge_dst]
        max_deg = int(deg.max())
        caps_all = []
        c = 1
        while c < max_deg:
            caps_all.append(c)
            c *= 2
        caps_all.append(max_deg)
        caps_all = sorted(set(caps_all))
        tier_of = np.searchsorted(caps_all, deg)  # deg <= caps_all[t]
        tier_of_edge = tier_of[edge_dst]
        w_ext = (
            None if w_norm is None
            else np.concatenate(
                [np.asarray(w_norm, np.float32), np.zeros(1, np.float32)])
        )
        nbs, w_slots, caps = [], [], []
        outmap = np.full(num_nodes, -1, np.int64)
        offset = 0
        for t, cap in enumerate(caps_all):
            rows = np.nonzero((deg > 0) & (tier_of == t))[0]
            if len(rows) == 0:
                continue
            nb_rows = len(rows)
            # tier rows padded to a multiple of 8, as in the reference
            # layout (keeps the arrays equal to the JAX package's)
            n_pad = nb_rows + ((-nb_rows) % 8)
            nb = np.zeros((n_pad, cap), np.int32)
            se = np.full((n_pad, cap), e, np.int64)
            em = np.nonzero(tier_of_edge == t)[0]
            rowpos = np.empty(num_nodes, np.int64)
            rowpos[rows] = np.arange(nb_rows)
            r = rowpos[edge_dst[em]]
            p = pos[em]
            nb[r, p] = edge_src[em]
            se[r, p] = em
            outmap[rows] = offset + np.arange(nb_rows)
            offset += n_pad
            nbs.append(nb)
            if w_ext is not None:
                w_slots.append(w_ext[se])
            caps.append(int(cap))
        outmap[deg == 0] = offset  # zeros row appended by the op
        return BucketedELL(
            nbs=tuple(nbs),
            w_slots=tuple(w_slots) if w_ext is not None else None,
            outmap=outmap.astype(np.int32),
            caps=tuple(caps),
            num_nodes=num_nodes,
            num_edges=e,
        )

    def to(self, device) -> "BucketedELL":
        return dataclasses.replace(
            self,
            nbs=tuple(_to(a, device) for a in self.nbs),
            w_slots=(None if self.w_slots is None
                     else tuple(_to(a, device) for a in self.w_slots)),
            outmap=_to(self.outmap, device),
        )


@dataclasses.dataclass(frozen=True)
class GraphBundle:
    """Device-side graph state for one adjacency variant (the reference's
    ``data`` dict entries, src/util/read_datasets.py:85-129):
      adj_t    -> (edge_src, edge_dst, edge_w), COO sorted by (dst, src)
      adj_mask -> adj_rows (binarized padded rows with self-PPR values)
      ppr      -> ppr_rows (padded PPR rows)
      degree   -> degree
    """

    x: torch.Tensor                    # [N, F] float32
    edge_src: torch.Tensor             # [E] int32
    edge_dst: torch.Tensor             # [E] int32
    edge_w: torch.Tensor               # [E] float32
    adj_rows: PaddedRows
    ppr_rows: PaddedRows
    degree: torch.Tensor               # [N] float32
    num_nodes: int
    num_edges: int
    ell: Optional[BucketedELL]
    w_norm: torch.Tensor               # [E] float32 static GCN norm
    w_diag: torch.Tensor               # [N] float32 self-loop coefficient

    def to(self, device) -> "GraphBundle":
        return dataclasses.replace(
            self,
            x=_to(self.x, device), edge_src=_to(self.edge_src, device),
            edge_dst=_to(self.edge_dst, device),
            edge_w=_to(self.edge_w, device),
            adj_rows=self.adj_rows.to(device),
            ppr_rows=self.ppr_rows.to(device),
            degree=_to(self.degree, device),
            ell=None if self.ell is None else self.ell.to(device),
            w_norm=_to(self.w_norm, device), w_diag=_to(self.w_diag, device),
        )
