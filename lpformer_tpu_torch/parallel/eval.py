"""Sharded evaluation context (counterpart of
``lpformer_tpu/parallel/eval.py``): what the eval harnesses need to score
over a mesh of ranks instead of one device.

The reference's eval flows are single-device loops (reference:
src/train/testing.py:14-121); here the same harness code
(:mod:`lpformer_tpu_torch.evalx.harness`) runs unchanged on every rank,
with the propagate / score callables swapped for the mesh's ones (X_full
is still propagated once per adjacency variant and reused for every
batch)."""
from __future__ import annotations

from typing import Optional

from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.parallel.partition import (
    ShardedGraph, partition_graph, place_sharded_graph,
)
from lpformer_tpu_torch.parallel.sharded_step import (
    make_sharded_propagate, make_sharded_score_with_X,
)


class ShardedEvalContext:
    """The partitioned graph variants and the mesh's propagate / score
    callables: ``prop(params, sg) -> X_full``; ``score(params, sg, X,
    src, tgt) -> scores``, the harness's single-device signatures with a
    ShardedGraph for the graph."""

    def __init__(
        self,
        cfg: LPFormerConfig,
        mesh,
        ds,
        sg_train: Optional[ShardedGraph] = None,
        context_parallel: bool = False,
    ):
        d, g = mesh.data, mesh.graph
        self.mesh = mesh
        self.ndev = d * g
        self.link_dev = d if context_parallel else d * g
        self.sg = (sg_train if sg_train is not None else
                   place_sharded_graph(partition_graph(ds.graph, g=g, d=d),
                                       mesh))
        if ds.graph_test is ds.graph:
            self.sg_test = self.sg
        else:
            self.sg_test = place_sharded_graph(
                partition_graph(ds.graph_test, g=g, d=d), mesh)
        self.prop = make_sharded_propagate(cfg, mesh, ds.num_nodes,
                                           self.sg.rows_per_shard)
        self.score, self.score_group = make_sharded_score_with_X(
            cfg, mesh, ds.num_nodes, self.sg.ctx_rows_per_shard,
            context_parallel=context_parallel)
