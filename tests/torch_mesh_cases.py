"""Cases that each rank of a gloo pool runs for tests/test_torch_parallel.py,
tests/test_torch_context_parallel.py and tests/test_torch_multihost.py.

Imports no JAX: the ranks are spawned processes of the port alone. The
test spawns a pool with ``parallel.distributed.spawn_local(run_cases, n,
(spec,), device="cpu")`` and gets each rank's {case name: result} of
numpy values. ``spec`` holds the dataset's keywords, the configs'
keywords, the parameters (numpy, the JAX package's init through
``from_jax_params``), one batch (src, tgt, neg, w) and the cases, each a
dict with a ``kind`` (a function below), a ``name`` and its arguments.
"""
import numpy as np
import torch

from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.evalx import harness
from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.parallel import (
    make_mesh, make_sharded_loss, make_sharded_score,
    make_sharded_train_step,
    partition_graph, place_sharded_graph,
)
from lpformer_tpu_torch.parallel import collectives as col
from lpformer_tpu_torch.parallel import sharded_step as ss
from lpformer_tpu_torch.parallel.eval import ShardedEvalContext
from lpformer_tpu_torch.train import optim
from lpformer_tpu_torch.train.step import TrainState
from lpformer_tpu_torch.utils.params import from_jax_params


def _np_tree(tree):
    return [x.detach().numpy().copy() for x in optim.tree_leaves(tree)]


def _params(spec):
    p = from_jax_params(spec["params"], device="cpu")
    for x in optim.tree_leaves(p):
        x.requires_grad_(True)
    return p


def _batch(spec):
    return tuple(torch.as_tensor(spec[k]) for k in ("src", "tgt", "neg", "w"))


def _mesh_graph(ds, d, g, mask_input=False):
    mesh = make_mesh(d, g, device="cpu")
    sg = place_sharded_graph(
        partition_graph(ds.graph, g=g, d=d, mask_input=mask_input), mesh)
    return mesh, sg


def case_fetch(ds, spec, c):
    """The row fetch of random ids [24] on each rank, and the local
    tables' row counts."""
    mesh, sg = _mesh_graph(ds, *c["mesh"])
    ids = torch.as_tensor(np.random.default_rng(
        10 + mesh.linear_index).integers(0, ds.num_nodes, 24))
    rows = ss._gather_link_rows(sg, ids, mesh, with_ranks=True)
    return dict(ids=ids.numpy(), rows={f: getattr(rows, f).numpy()
                                       for f in ss._CTX},
                local_rows=[getattr(sg, f).shape[0] for f in ss._CTX],
                ctx_rows_per=sg.ctx_rows_per_shard)


def case_loss(ds, spec, c):
    """The sharded loss and the global gradient (seed None: no dropout)."""
    cfg = LPFormerConfig(**spec["cfgs"][c["cfg"]])
    kw = c.get("kw", {})
    mesh, sg = _mesh_graph(ds, *c["mesh"], kw.get("mask_input", False))
    params = _params(spec)
    src, tgt, neg, w = _batch(spec)
    loss_fn = make_sharded_loss(cfg, mesh, ds.num_nodes, sg.rows_per_shard,
                                sg.ctx_rows_per_shard, **kw)
    loss, grads = ss.value_and_grad(loss_fn, mesh, params, sg,
                                    ds.mask_mult_device, src, tgt, w, neg[0],
                                    neg[1], w, None)
    return dict(loss=float(loss), grads=_np_tree(grads))


def case_loss_seeded(ds, spec, c):
    """The sharded loss with the config's dropouts, twice with one seed."""
    cfg = LPFormerConfig(**spec["cfgs"][c["cfg"]])
    mesh, sg = _mesh_graph(ds, *c["mesh"])
    params = _params(spec)
    src, tgt, neg, w = _batch(spec)
    loss_fn = make_sharded_loss(cfg, mesh, ds.num_nodes, sg.rows_per_shard,
                                sg.ctx_rows_per_shard, **c.get("kw", {}))
    with torch.no_grad():
        return [float(loss_fn(params, sg, ds.mask_mult_device, src, tgt, w,
                              neg[0], neg[1], w, 5)) for _ in range(2)]


def case_encoder_dropout(ds, spec, c):
    """X_full of the sharded propagation with feature and GCN dropout, the
    encoder's generator on the graph index alone."""
    cfg = LPFormerConfig(**spec["cfgs"][c["cfg"]])
    mesh, sg = _mesh_graph(ds, *c["mesh"])
    params = _params(spec)
    with torch.no_grad():
        X = ss._propagate_sharded(
            params, cfg, mesh, sg, sg.edge_w[0, 0], sg.diag,
            ss._gen("cpu", 5, 0, mesh.graph_index), True)
    return dict(X=X.numpy(), graph_index=mesh.graph_index)


def _steps(ds, spec, c, steps_per_call=1):
    cfg = LPFormerConfig(**spec["cfgs"][c["cfg"]])
    kw = c.get("kw", {})
    mesh, sg = _mesh_graph(ds, *c["mesh"])
    params = _params(spec)
    opt = optim.make_optimizer(5e-3, steps_per_epoch=10)
    state = TrainState(params, opt.init(params), 0)
    step = make_sharded_train_step(cfg, opt, mesh, ds.num_nodes,
                                   sg.rows_per_shard, sg.ctx_rows_per_shard,
                                   steps_per_call=steps_per_call, **kw)
    return state, step, sg, ds.mask_mult_device


def case_descend(ds, spec, c):
    """Four steps on the same batch with the preset's dropouts."""
    state, step, sg, mult = _steps(ds, spec, c)
    src, tgt, _, w = _batch(spec)
    losses = []
    for _ in range(4):
        state, loss = step(state, sg, mult, src, tgt, w, 7)
        losses.append(float(loss))
    return dict(losses=losses, params=_np_tree(state.params))


def case_multi_step(ds, spec, c):
    """steps_per_call 3 over two live steps and a dead one, against two
    single steps."""
    tp = ds.train_pos
    b = len(spec["src"])
    srcs = torch.as_tensor(tp[:3 * b, 0].reshape(3, b))
    tgts = torch.as_tensor(tp[:3 * b, 1].reshape(3, b))
    ws = torch.ones(3, b)
    state, step, sg, mult = _steps(ds, spec, c)
    seq = []
    for i in range(2):
        state, loss = step(state, sg, mult, srcs[i], tgts[i], ws[i], 7)
        seq.append(float(loss))
    state2, step3, sg, mult = _steps(ds, spec, c, steps_per_call=3)
    state2, losses = step3(state2, sg, mult, srcs, tgts, ws,
                           np.asarray([1.0, 1.0, 0.0]), 7)
    return dict(seq=seq, multi=losses.numpy(), steps=(state.step,
                                                      state2.step),
                params=(_np_tree(state.params), _np_tree(state2.params)))


def case_eval(ds, spec, c):
    """The sharded scorer on the batch and score_group on two batches,
    against the single-device scores, and test_standard both ways."""
    cfg = LPFormerConfig(**spec["cfgs"][c["cfg"]])
    mesh = make_mesh(*c["mesh"], device="cpu")
    ctx = ShardedEvalContext(cfg, mesh, ds, context_parallel=c.get(
        "kw", {}).get("context_parallel", False))
    params = _params(spec)
    src, tgt, _, _ = _batch(spec)
    with torch.no_grad():
        X = ctx.prop(params, ctx.sg)
        got = ctx.score(params, ctx.sg, X, src, tgt)
        one_call = make_sharded_score(cfg, mesh, ds.num_nodes,
                                      ctx.sg.rows_per_shard,
                                      ctx.sg.ctx_rows_per_shard)(
            params, ctx.sg, src, tgt)
        group = ctx.score_group(params, ctx.sg, X, torch.stack([src, tgt]),
                                torch.stack([tgt, src]))
        h = lt.forward(params, cfg, ds.graph, src, tgt)
        want = lt.score_links(params, cfg, h)
        h2 = lt.forward(params, cfg, ds.graph, tgt, src)
        want2 = lt.score_links(params, cfg, h2)
    kw = dict(batch_size=len(spec["src"]), with_mrr=True)
    return dict(
        got=got.numpy(), want=want.numpy(), group=group.numpy(),
        one_call=one_call.numpy(),
        want_group=np.stack([want.numpy(), want2.numpy()]),
        metrics=harness.test_standard(params, cfg, ds, sharded=ctx, **kw),
        want_metrics=harness.test_standard(params, cfg, ds, **kw))


def case_train_loop(ds, spec, c):
    """train_loop over the mesh for two epochs, every step's loss."""
    from lpformer_tpu_torch.train import trainer
    from lpformer_tpu_torch.utils.logger import ResultsLogger

    cfg = LPFormerConfig(**spec["cfgs"][c["cfg"]])
    args = trainer.TrainArgs(**c["args"])
    loggers = {k: ResultsLogger(1)
               for k in ("Hits@20", "Hits@50", "Hits@100", "MRR")}
    losses = []
    best = trainer.train_loop(args, cfg, ds, loggers, 0,
                              step_losses=losses)
    return dict(best=best, losses=[np.asarray(x.cpu()) for x in losses],
                results=loggers["MRR"].results)


def case_collectives(ds, spec, c):
    """all_gather / psum with their backward, on the world group: the
    gradient of sum_r (w_r * op(x_r)) for per-rank weights w_r."""
    mesh = make_mesh(*c["mesh"], device="cpu")
    r = mesh.linear_index
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    x.requires_grad_(True)
    wt = torch.full((2 * mesh.ndev, 3), float(r + 1))
    (col.all_gather(x, mesh.world_group) * wt).sum().backward()
    g_gather = x.grad.numpy().copy()
    x.grad = None
    (col.psum(x, mesh.world_group) * (r + 1)).sum().backward()
    return dict(gather=col.all_gather_nograd(x.detach(), mesh.world_group
                                             ).numpy(),
                g_gather=g_gather, g_psum=x.grad.numpy(),
                pmax=col.pmax(x * (1 if r % 2 else -1), mesh.world_group
                              ).numpy())


def case_backend_route(ds, spec, c):
    """The collectives and a sharded loss with the sums taken by the
    backend's own all-reduce and reduce-scatter (the route NCCL groups
    take), here run on gloo."""
    real = col._nccl
    col._nccl = lambda group: True
    try:
        out = case_collectives(ds, spec, c)
        mesh = make_mesh(*c["mesh"], device="cpu")
        x = torch.arange(8 * mesh.ndev, dtype=torch.float32).reshape(
            -1, 2) * (mesh.linear_index + 1)
        out["reduce_scatter"] = col.reduce_scatter(
            x, mesh.world_group).numpy()
        out["loss"] = case_loss(ds, spec, dict(c, cfg="classic"))
    finally:
        col._nccl = real
    return out


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


def run_cases(rank, spec):
    ds = synthetic_dataset(**spec["data"], device="cpu")
    out = {}
    for c in spec["cases"]:
        out[c["name"]] = CASES[c["kind"]](ds, spec, c)
    return out
