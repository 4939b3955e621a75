from lpformer_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from lpformer_tpu_torch.parallel.partition import (  # noqa: F401
    ShardedGraph,
    partition_graph,
    place_sharded_graph,
    sharded_graph_specs,
)
from lpformer_tpu_torch.parallel.sharded_step import (  # noqa: F401
    make_sharded_loss,
    make_sharded_propagate,
    make_sharded_score,
    make_sharded_score_with_X,
    make_sharded_train_step,
)
