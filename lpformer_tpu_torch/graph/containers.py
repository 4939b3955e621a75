"""Static graph containers (counterpart of
``lpformer_tpu/graph/containers.py``).

  * ``CSRGraph``     host CSR in numpy, the preprocessing currency.
  * ``PaddedRows``   [N, K] padded per-row neighbour lists, sorted, pad = N,
                     with optional per-entry values and flags.
  * ``ELLAdjacency`` the dst-sorted propagation adjacency as one [N, cap]
                     slot grid plus an overflow COO, for ``spmm_ell``.
  * ``BucketedELL``  the dst-sorted propagation adjacency in power-of-two
                     degree tiers, for the scatter-free SpMM.
  * ``BlockedCOO``   the edge list tiled by (dst block, src block), for
                     ``spmm_blocked`` on big node tables.
  * ``BlockedBELL``  a BucketedELL per (dst block, src block) tile, the
                     big-graph layout of ``spmm_bbell``.
  * ``GraphBundle``  everything a forward pass needs, as tensors.

Every container is built on the host in numpy with the same rules as the
JAX package (so the arrays are equal, element for element), then moved to
a device with ``.to(device)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _to(x, device):
    return None if x is None else torch.as_tensor(x).to(device)


def _tuple_to(xs, device):
    return None if xs is None else tuple(_to(a, device) for a in xs)


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
class ELLAdjacency:
    """Hybrid ELL + overflow-COO layout of the dst-sorted propagation
    adjacency, for ``ops/spmm.py:spmm_ell``. Each destination row keeps
    its first ``cap`` in-edges in a dense [N, cap] slot grid (``nb`` =
    source ids, pad 0; ``slot_edge`` = index into the dst-sorted edge
    array, pad ``num_edges``, which reads weight 0.0 from the extended
    weight vector). In-edges past ``cap`` stay a COO remainder that the
    SpMM gathers and scatter-adds. ``cap`` is the cost model's of the
    reference layout (``from_sorted_coo``)."""

    nb: object            # [N, cap] int32 source ids, pad 0
    slot_edge: object     # [N, cap] int32 edge index, pad num_edges
    ov_src: object        # [E_ov] int32 (dst-sorted remainder)
    ov_dst: object        # [E_ov] int32
    ov_edge: object       # [E_ov] int32 edge index
    cap: int
    num_nodes: int
    num_edges: int
    w_slots: Optional[object] = None  # [N, cap] f32 static norm, pad 0.0
    ov_w: Optional[object] = None     # [E_ov] f32

    # relative cost of an overflow edge (scatter-add) against an ELL slot
    # (gather + multiply-add), the reference layout's constant
    _OVERFLOW_COST = 6.5

    def with_weights(self, w_norm: np.ndarray) -> "ELLAdjacency":
        """Attach static slot-laid-out weights (host, numpy)."""
        w_ext = np.concatenate(
            [np.asarray(w_norm, np.float32), np.zeros(1, np.float32)])
        return dataclasses.replace(
            self, w_slots=w_ext[np.asarray(self.slot_edge)],
            ov_w=w_ext[np.asarray(self.ov_edge)])

    @staticmethod
    def from_sorted_coo(
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        num_nodes: int,
        max_cap: int = 128,
    ) -> Optional["ELLAdjacency"]:
        """Build from a (dst, src)-sorted COO edge list; None when the cost
        model prefers the pure-COO path (cap 0)."""
        e = len(edge_dst)
        if e == 0 or num_nodes == 0:
            return None
        deg = np.bincount(edge_dst, minlength=num_nodes)
        cmax = int(min(deg.max(), max_cap))
        # overflow(c) = sum_v max(deg_v - c, 0) = sum_{i > c} t[i], where
        # t[i] = #nodes with degree >= i
        hist = np.bincount(deg)
        t = np.cumsum(hist[::-1])[::-1]
        suf = np.concatenate([np.cumsum(t[::-1])[::-1], [0.0]])
        over = suf[1:cmax + 2]
        cost = (num_nodes * np.arange(cmax + 1)
                + ELLAdjacency._OVERFLOW_COST * over)
        cap = int(np.argmin(cost))
        if cap == 0:
            return None
        indptr = np.concatenate([[0], np.cumsum(deg)])
        pos = np.arange(e, dtype=np.int64) - indptr[edge_dst]
        main = pos < cap
        nb = np.zeros((num_nodes, cap), np.int32)
        slot_edge = np.full((num_nodes, cap), e, np.int32)
        nb[edge_dst[main], pos[main]] = edge_src[main]
        slot_edge[edge_dst[main], pos[main]] = np.nonzero(main)[0]
        ov = np.nonzero(~main)[0].astype(np.int32)
        return ELLAdjacency(
            nb=nb, slot_edge=slot_edge,
            ov_src=np.asarray(edge_src)[ov].astype(np.int32),
            ov_dst=np.asarray(edge_dst)[ov].astype(np.int32),
            ov_edge=ov, cap=cap, num_nodes=num_nodes, num_edges=e,
        )

    def to(self, device) -> "ELLAdjacency":
        return dataclasses.replace(
            self, nb=_to(self.nb, device),
            slot_edge=_to(self.slot_edge, device),
            ov_src=_to(self.ov_src, device), ov_dst=_to(self.ov_dst, device),
            ov_edge=_to(self.ov_edge, device),
            w_slots=_to(self.w_slots, device), ov_w=_to(self.ov_w, device),
        )


@dataclasses.dataclass(frozen=True)
class BucketedELL:
    """Degree-bucketed ELL: destination rows grouped into power-of-two
    degree tiers; tier t is a dense [Nb_t, cap_t] slot grid (cap_t = 2^t,
    the last tier the exact max degree). Every edge lands in exactly one
    slot, so the SpMM is row gathers and sums with no scatter. Per-tier
    outputs are concatenated and un-permuted by one [N]-row gather
    (``outmap``; degree-0 rows map to an appended zeros row).
    ``slot_edges`` holds each slot's index into the dst-sorted edge list,
    which re-weights a batch-masked graph (``mask_input``)."""

    nbs: Tuple               # per tier: [Nb_t, cap_t] int32 src ids, pad 0
    slot_edges: Optional[Tuple]  # per tier: [Nb_t, cap_t] int32, pad E
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
        with_edge_ids: bool = True,
    ) -> Optional["BucketedELL"]:
        """Build from a (dst, src)-sorted COO edge list; ``w_norm`` attaches
        the static slot weights, ``with_edge_ids`` the slots' edge ids
        (``with_edge_ids=False`` where only the static weights are ever
        used, as in the BlockedBELL tiles). None for an empty graph."""
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
        nbs, slot_edges, w_slots, caps = [], [], [], []
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
            if with_edge_ids:
                slot_edges.append(se.astype(np.int32))
            if w_ext is not None:
                w_slots.append(w_ext[se])
            caps.append(int(cap))
        outmap[deg == 0] = offset  # zeros row appended by the op
        return BucketedELL(
            nbs=tuple(nbs),
            slot_edges=tuple(slot_edges) if with_edge_ids else None,
            w_slots=tuple(w_slots) if w_ext is not None else None,
            outmap=outmap.astype(np.int32),
            caps=tuple(caps),
            num_nodes=num_nodes,
            num_edges=e,
        )

    @property
    def slot_total(self) -> int:
        return sum(nb.shape[0] * nb.shape[1] for nb in self.nbs)

    def to(self, device) -> "BucketedELL":
        return dataclasses.replace(
            self,
            nbs=_tuple_to(self.nbs, device),
            slot_edges=_tuple_to(self.slot_edges, device),
            w_slots=_tuple_to(self.w_slots, device),
            outmap=_to(self.outmap, device),
        )


@dataclasses.dataclass(frozen=True)
class BlockedCOO:
    """(dst block x src block)-tiled COO for large node tables: every
    neighbour gather of a tile addresses one ``block``-row slice of x.
    Per-tile arrays in tile order ``t = jj * kb + ii`` (jj = dst block,
    ii = src block), dst-sorted within each tile and padded to a multiple
    of ``pad_to`` (pad: weight 0, dst_local = block, a dummy segment row,
    src_local = 0, edge id E). ``te`` holds each slot's edge index, so a
    batch-masked graph re-weights the tiles; ``tw`` the static weights."""

    sl: Tuple             # per tile: [E_t] int32 src - ii * block
    dl: Tuple             # per tile: [E_t] int32 dst - jj * block (pad block)
    tw: Optional[Tuple]   # per tile: [E_t] f32 static normalised weights
    te: Optional[Tuple]   # per tile: [E_t] int32 edge index (pad E)
    block: int
    kb: int
    num_nodes: int
    num_edges: int

    @staticmethod
    def from_coo(
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        num_nodes: int,
        w_norm: Optional[np.ndarray] = None,
        block: int = 131072,
        pad_to: int = 1024,
        with_edge_ids: bool = True,
    ) -> Optional["BlockedCOO"]:
        e = len(edge_dst)
        if e == 0 or num_nodes == 0:
            return None
        src = np.asarray(edge_src, np.int64)
        dst = np.asarray(edge_dst, np.int64)
        kb = -(-num_nodes // block)
        jb = dst // block
        ib = src // block
        order = np.lexsort((dst, ib, jb))
        s, d = src[order], dst[order]
        key = jb[order] * kb + ib[order]
        bounds = np.searchsorted(key, np.arange(kb * kb + 1))
        w = None if w_norm is None else np.asarray(w_norm, np.float32)[order]
        sl, dl, tw, te = [], [], [], []
        for t in range(kb * kb):
            lo, hi = int(bounds[t]), int(bounds[t + 1])
            ii, jj = t % kb, t // kb
            s_t = (s[lo:hi] - ii * block).astype(np.int32)
            d_t = (d[lo:hi] - jj * block).astype(np.int32)
            w_t = None if w is None else w[lo:hi]
            e_t = order[lo:hi].astype(np.int32)
            m = hi - lo
            p = (-m) % pad_to if m else pad_to
            if p:
                s_t = np.concatenate([s_t, np.zeros(p, np.int32)])
                d_t = np.concatenate([d_t, np.full(p, block, np.int32)])
                if w_t is not None:
                    w_t = np.concatenate([w_t, np.zeros(p, np.float32)])
                e_t = np.concatenate([e_t, np.full(p, e, np.int32)])
            sl.append(s_t)
            dl.append(d_t)
            if w_t is not None:
                tw.append(w_t)
            if with_edge_ids:
                te.append(e_t)
        return BlockedCOO(
            sl=tuple(sl), dl=tuple(dl),
            tw=tuple(tw) if w is not None else None,
            te=tuple(te) if with_edge_ids else None,
            block=block, kb=kb, num_nodes=num_nodes, num_edges=e,
        )

    @property
    def slot_total(self) -> int:
        return sum(int(a.shape[0]) for a in self.sl)

    def to(self, device) -> "BlockedCOO":
        return dataclasses.replace(
            self, sl=_tuple_to(self.sl, device), dl=_tuple_to(self.dl, device),
            tw=_tuple_to(self.tw, device), te=_tuple_to(self.te, device))


@dataclasses.dataclass(frozen=True)
class BlockedBELL:
    """(dst block x src block)-tiled degree-bucketed ELL, the big-graph
    layout: every tile is a small BucketedELL whose rows are dst-local and
    whose slot ids are src-local, so a tile's sweep gathers from one
    ``block``-row slice of x, and a dst block's tiles add elementwise. No
    scatter anywhere. Static weights only (the slots' prelaid GCN norm):
    a batch-masked graph re-weights through BlockedCOO instead."""

    tiles: Tuple          # kb * kb entries in order jj * kb + ii:
                          # BucketedELL or None for an empty tile
    block: int
    kb: int
    num_nodes: int
    num_edges: int

    @staticmethod
    def from_coo(
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        num_nodes: int,
        w_norm: np.ndarray,
        block: int = 131072,
    ) -> Optional["BlockedBELL"]:
        """Build from a (dst, src)-sorted COO with static normalised
        weights; None for an empty graph or a single block (kb <= 1)."""
        e = len(edge_dst)
        if e == 0 or num_nodes == 0:
            return None
        kb = -(-num_nodes // block)
        if kb <= 1:
            return None
        src = np.asarray(edge_src)
        dst = np.asarray(edge_dst)
        w = np.asarray(w_norm, np.float32)
        sb = src // block
        db = dst // block
        tiles = []
        for jj in range(kb):
            rows_jj = min(block, num_nodes - jj * block)
            mj = db == jj
            for ii in range(kb):
                m = mj & (sb == ii)
                if not m.any():
                    tiles.append(None)
                    continue
                # masking a dst-sorted list keeps it dst-sorted
                tiles.append(BucketedELL.from_sorted_coo(
                    (src[m] - ii * block).astype(np.int32),
                    (dst[m] - jj * block).astype(np.int32),
                    rows_jj, w_norm=w[m], with_edge_ids=False,
                ))
        return BlockedBELL(tiles=tuple(tiles), block=block, kb=kb,
                           num_nodes=num_nodes, num_edges=e)

    @property
    def slot_total(self) -> int:
        return sum(t.slot_total for t in self.tiles if t is not None)

    def to(self, device) -> "BlockedBELL":
        return dataclasses.replace(
            self, tiles=tuple(None if t is None else t.to(device)
                              for t in self.tiles))


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
    # the big-graph layouts, preferred over ``ell`` when present: the
    # (dst block x src block)-tiled BucketedELL (static norm), and the
    # tiled COO (static ``tw`` or re-weighted through ``te``)
    blk: Optional[BlockedCOO] = None
    bbell: Optional[BlockedBELL] = None
    # [E] int32 train-edge rank of each propagation edge, -1 where none:
    # what ``mask_input`` masks the propagation weights by
    edge_rank: Optional[torch.Tensor] = None

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
            blk=None if self.blk is None else self.blk.to(device),
            bbell=None if self.bbell is None else self.bbell.to(device),
            w_norm=_to(self.w_norm, device), w_diag=_to(self.w_diag, device),
            edge_rank=_to(self.edge_rank, device),
        )
