"""The (data x graph) mesh over the ranks (counterpart of
``lpformer_tpu/parallel/mesh.py``).

Two logical axes, as in the JAX package:
  * ``data``: link-batch sharding (the loss is a mean over independent
    links, reference train_model.py:61-70);
  * ``graph``: node/edge partitioning of the GCN encoder: each rank owns a
    row shard of the node features and the edges that aggregate into it.

Rank r sits at (data_index, graph_index) = (r // G, r % G), so its linear
index data_index * G + graph_index (the JAX package's flattened
data-major device order, sharded_step.py:62) is its rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from lpformer_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    graph: int
    data_index: int
    graph_index: int
    device: torch.device
    data_group: object     # the ranks of this rank's graph index
    graph_group: object    # the ranks of this rank's data index
    world_group: object    # every rank of the mesh

    @property
    def ndev(self) -> int:
        return self.data * self.graph

    @property
    def linear_index(self) -> int:
        return self.data_index * self.graph + self.graph_index


def make_mesh(data: Optional[int] = None, graph: int = 1,
              device=None) -> Mesh:
    """This rank's place in a data x graph mesh of every rank of the
    process group. ``data`` None takes world size // graph. A 1 x 1 mesh
    in a process without a group makes one of this process alone.
    ``device``: the rank's device (default: the one
    ``distributed.initialize`` gave it). Every rank makes the same groups
    in the same order, once per mesh shape: a later call of the same
    shape (the trainer's, then the eval's, and every run of ``--runs``)
    reuses them, so communicators do not pile up."""
    if not dist.is_initialized():
        if (data or 1) * graph != 1:
            raise ValueError(
                f"mesh {data}x{graph} needs {(data or 1) * graph} ranks; "
                "connect them first (parallel/distributed.py)")
        distributed.init_single(distributed.rank_device(device))
    n = dist.get_world_size()
    if data is None:
        data = n // graph
    if data * graph != n:
        raise ValueError(f"mesh {data}x{graph} != {n} ranks")
    di, gi = divmod(dist.get_rank(), graph)
    groups = distributed.MESH_GROUPS.get((data, graph))
    if groups is None:
        data_group = graph_group = None
        for j in range(graph):          # a data axis per graph index
            grp = dist.new_group([i * graph + j for i in range(data)])
            if j == gi:
                data_group = grp
        for i in range(data):           # a graph axis per data index
            grp = dist.new_group([i * graph + j for j in range(graph)])
            if i == di:
                graph_group = grp
        groups = (data_group, graph_group, dist.new_group(list(range(n))))
        distributed.MESH_GROUPS[(data, graph)] = groups
    dev = (torch.device(device) if device is not None
           else distributed.rank_device())
    return Mesh(data, graph, di, gi, dev, *groups)
