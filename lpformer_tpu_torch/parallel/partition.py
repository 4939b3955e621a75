"""Host-side graph partitioning for the (data x graph) mesh (counterpart of
``lpformer_tpu/parallel/partition.py``).

Propagation state: edges are partitioned by destination row into
``graph`` shards (each rank aggregates into its own node-row shard), and
each shard's edge list is further split over the ``data`` axis so the
SpMM work uses the whole mesh; the partial sums meet in a psum over
``data``. Every block is padded to one length with zero-weight edges.

Context state (the padded adjacency and PPR rows, the memory giant at
citation2 scale): row-sharded over the FULL flattened (data, graph) mesh,
so each rank holds N / ndev rows and fetches its links' rows from their
owners each batch (``collectives.fetch_rows``): the tables are never
whole on one rank.

``partition_graph`` returns the full host arrays (numpy), bit for bit the
JAX package's; ``place_sharded_graph`` puts on the rank's device only the
blocks its mesh position owns, as ``sharded_graph_specs`` describes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lpformer_tpu_torch.graph.containers import GraphBundle


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Static sharded graph state. From ``partition_graph`` every array is
    whole (numpy, on the host); after ``place_sharded_graph`` each holds
    this rank's blocks, a tensor on its device.

    Propagation (sharded over 'graph', split over 'data'):
      x:              [N_pad, F]    node features (row-sharded over 'graph')
      edge_src:       [G, D, E_blk] global source ids per block
      edge_dst_local: [G, D, E_blk] destination row LOCAL to the graph shard
                                    (pad rows_per_shard)
      edge_w:         [G, D, E_blk] normalised weights (0 = padding)
      diag:           [N_pad]       normalised self-loop coefficients
      edge_rank:      [G, D, E_blk] int32 train-edge rank per edge (pad -1;
                                    only under mask_input)
      edge_bin:       [G, D, E_blk] f32 binarised weight (only under
                                    mask_input: the masked propagation
                                    adjacency is unweighted, reference
                                    train_model.py:51-53)

    Context extraction (row-sharded over the flattened mesh; row block k
    of ndev belongs to the rank of linear index k):
      adj_nbrs [Nc_pad, A] int32, adj_vals f32, adj_ranks int32 (or None),
      ppr_nbrs [Nc_pad, P] int32, ppr_vals f32, ppr_flags bool (or None);
      pad rows hold the pad id num_nodes, 0.0, rank -1, False.
    """

    x: object
    edge_src: object
    edge_dst_local: object
    edge_w: object
    diag: object
    edge_rank: Optional[object]
    edge_bin: Optional[object]
    adj_nbrs: object
    adj_vals: Optional[object]
    adj_ranks: Optional[object]
    ppr_nbrs: object
    ppr_vals: object
    ppr_flags: Optional[object]
    num_nodes: int
    num_nodes_padded: int
    rows_per_shard: int
    ctx_rows_per_shard: int
    adj_cap: int
    ppr_cap: int
    g: int
    d: int


def _np(t):
    if t is None:
        return None
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _pad_rows(arr, n_pad: int, fill):
    if arr is None:
        return None
    a = _np(arr)
    if a.shape[0] == n_pad:
        return a
    out = np.full((n_pad, a.shape[1]), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def partition_graph(
    bundle: GraphBundle, g: int, d: int, pad_multiple: int = 8,
    mask_input: bool = False,
) -> ShardedGraph:
    """Partition a GraphBundle for a (data=d, graph=g) mesh, on the host.
    ``mask_input=True`` also blocks out each edge's train rank and
    binarised weight, so the sharded step can rebuild the batch-masked,
    renormalised propagation adjacency."""
    n = bundle.num_nodes
    src = _np(bundle.edge_src)
    dst = _np(bundle.edge_dst)
    w = _np(bundle.edge_w)

    # normalised weights and diag, once (gcn_norm semantics)
    deg = np.zeros(n, np.float64)
    np.add.at(deg, dst, w)
    deg = deg + 1.0
    dinv = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
    w_norm = (dinv[src] * w * dinv[dst]).astype(np.float32)
    diag = (dinv * dinv).astype(np.float32)

    rows_per = -(-n // (g * pad_multiple)) * pad_multiple
    n_pad = rows_per * g

    x = _np(bundle.x)
    x_pad = np.zeros((n_pad, x.shape[1]), x.dtype)
    x_pad[:n] = x
    diag_pad = np.zeros(n_pad, np.float32)
    diag_pad[:n] = diag

    rank = None
    if mask_input:
        rank = _np(bundle.edge_rank)
        if rank is None or rank.shape != src.shape:
            raise ValueError("mask_input partitioning needs "
                             "bundle.edge_rank")
    shard_of = dst // rows_per
    blocks = []
    for i in range(g):
        m = shard_of == i
        bs, bd, bw = src[m], dst[m] - i * rows_per, w_norm[m]
        br = rank[m] if mask_input else None
        bb = (w[m] > 0).astype(np.float32) if mask_input else None
        # a contiguous split over the data axis (keeps dst order)
        cuts = np.linspace(0, len(bs), d + 1).astype(np.int64)
        blocks.append([
            tuple(None if a is None else a[cuts[j]:cuts[j + 1]]
                  for a in (bs, bd, bw, br, bb))
            for j in range(d)])
    e_blk = max(max((len(b[0]) for row in blocks for b in row), default=1),
                1)
    es = np.zeros((g, d, e_blk), np.int32)
    # dst pad rows_per (one past the last local row): keeps the blocks
    # monotonic, and the step's aggregation drops that row
    ed = np.full((g, d, e_blk), rows_per, np.int32)
    ew = np.zeros((g, d, e_blk), np.float32)
    # rank pad -1 is never masked (its bin weight is 0 anyway)
    er = np.full((g, d, e_blk), -1, np.int32) if mask_input else None
    eb = np.zeros((g, d, e_blk), np.float32) if mask_input else None
    for i in range(g):
        for j in range(d):
            bs, bd, bw, br, bb = blocks[i][j]
            m = len(bs)
            es[i, j, :m] = bs
            ed[i, j, :m] = bd
            ew[i, j, :m] = bw
            if mask_input:
                er[i, j, :m] = br
                eb[i, j, :m] = bb

    # context rows, sharded over all ndev = g * d ranks
    ndev = g * d
    ctx_rows_per = -(-n // (ndev * pad_multiple)) * pad_multiple
    nc_pad = ctx_rows_per * ndev
    adj, ppr = bundle.adj_rows, bundle.ppr_rows
    return ShardedGraph(
        x=x_pad, edge_src=es, edge_dst_local=ed, edge_w=ew, diag=diag_pad,
        edge_rank=er, edge_bin=eb,
        adj_nbrs=_pad_rows(adj.nbrs, nc_pad, n),
        adj_vals=_pad_rows(adj.vals, nc_pad, 0.0),
        adj_ranks=_pad_rows(adj.ranks, nc_pad, -1),
        ppr_nbrs=_pad_rows(ppr.nbrs, nc_pad, n),
        ppr_vals=_pad_rows(ppr.vals, nc_pad, 0.0),
        ppr_flags=_pad_rows(ppr.flags, nc_pad, False),
        num_nodes=n, num_nodes_padded=n_pad, rows_per_shard=rows_per,
        ctx_rows_per_shard=ctx_rows_per, adj_cap=adj.cap, ppr_cap=ppr.cap,
        g=g, d=d,
    )


def sharded_graph_specs() -> dict:
    """Which mesh axis shards each dimension of each array field (None:
    not sharded; a tuple of axes: the flattened data-major mesh), the
    JAX package's PartitionSpecs as data."""
    edge = ("graph", "data", None)
    ctx = (("data", "graph"), None)
    return {"x": ("graph", None), "edge_src": edge, "edge_dst_local": edge,
            "edge_w": edge, "diag": ("graph",), "edge_rank": edge,
            "edge_bin": edge, "adj_nbrs": ctx, "adj_vals": ctx,
            "adj_ranks": ctx, "ppr_nbrs": ctx, "ppr_vals": ctx,
            "ppr_flags": ctx}


def local_block(arr: np.ndarray, spec, mesh) -> np.ndarray:
    """The block of ``arr`` that ``mesh``'s rank owns under ``spec``."""
    index = {"data": mesh.data_index, "graph": mesh.graph_index}
    size = {"data": mesh.data, "graph": mesh.graph}
    sl = []
    for dim, axes in enumerate(spec):
        if axes is None:
            sl.append(slice(None))
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        k, n = 0, 1
        for a in axes:               # row-major over the named axes
            k, n = k * size[a] + index[a], n * size[a]
        per = arr.shape[dim] // n
        sl.append(slice(k * per, (k + 1) * per))
    return arr[tuple(sl)]


def place_sharded_graph(sg: ShardedGraph, mesh) -> ShardedGraph:
    """This rank's blocks of every array, as tensors on its device."""
    specs = sharded_graph_specs()

    def put(name):
        arr = getattr(sg, name)
        if arr is None:
            return None
        block = np.ascontiguousarray(local_block(arr, specs[name], mesh))
        return torch.from_numpy(block).to(mesh.device)

    return dataclasses.replace(sg, **{f: put(f) for f in specs})
