"""Child process of tests/test_torch_multihost.py: one rank of the port's
mesh, brought up with the explicit flags.

Usage: python torch_multihost_child.py <process_id> <num_processes> <port>

The ranks form a (1, num_processes) mesh over gloo on the CPU (with one
process, a 1 x 1 mesh: the single-process run) and take two sharded
training steps of one batch, dropout off; prints the two losses.
"""
import sys

import torch

from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.parallel import (
    distributed, make_mesh, make_sharded_train_step, partition_graph,
    place_sharded_graph,
)
from lpformer_tpu_torch.train import optim
from lpformer_tpu_torch.train.step import TrainState

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
assert distributed.initialize(coordinator=f"127.0.0.1:{port}",
                              num_processes=nproc, process_id=pid,
                              device="cpu")
assert distributed.process_count() == nproc
assert distributed.is_coordinator() == (pid == 0)

ds = synthetic_dataset(seed=0, num_nodes=96, num_train=320, num_eval=32,
                       feat_dim=12, device="cpu")
cfg = LPFormerConfig(dim=16, gnn_layers=2, budget_cn=24, budget_onehop=48,
                     budget_non1hop=48, dropout=0.0, gnn_drop=0.0,
                     att_drop=0.0, feat_drop=0.0, pred_drop=0.0)
params = lt.init_lpformer(torch.Generator().manual_seed(3), cfg, 12,
                          device="cpu")
for p in optim.tree_leaves(params):
    p.requires_grad_(True)
mesh = make_mesh(data=1, graph=nproc, device="cpu")
sg = place_sharded_graph(partition_graph(ds.graph, g=nproc, d=1), mesh)
opt = optim.make_optimizer(1e-3, steps_per_epoch=10)
step = make_sharded_train_step(cfg, opt, mesh, ds.num_nodes,
                               sg.rows_per_shard, sg.ctx_rows_per_shard)
state = TrainState(params, opt.init(params), 0)
links = torch.as_tensor(ds.train_pos[:32])
w = torch.ones(32)
losses = []
for _ in range(2):
    state, loss = step(state, sg, ds.mask_mult_device, links[:, 0],
                       links[:, 1], w, 7)
    losses.append(float(loss))
print(f"MULTIHOST_LOSS {pid} {losses[0]!r} {losses[1]!r}", flush=True)
distributed.shutdown()
