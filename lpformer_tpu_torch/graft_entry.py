"""Run checks of the single-device forward and of the mesh (counterpart
of ``__graft_entry__.py``).

entry() -> (fn, example_args): the flagship model's forward and link
scores on a batch of 64 train links of a tiny synthetic graph (the JAX
entry's ``_tiny_setup`` shapes: 256 nodes, 900 train edges, 32 features,
dim 32, 2 GCN layers, the classic table of 32 | 64 | 64), on the card
unless ``device`` says otherwise. ``fn(*example_args)`` gives [64]
probabilities.

dryrun_multichip(n) spawns n ranks on this host (one card each, or the
``device`` and ``backend`` given: ``device="cuda:0", backend="gloo"``
puts every rank on one card) and runs, at the same tiny shapes, one
sharded training step on a 2-D (data x graph) mesh, a context-parallel
step where the budgets divide, and ``_dryrun_matrix``: for every
power-of-two (d, g) with d * g = n, the sharded loss in the plain,
context-parallel and mask_input variants, each equal to the port's own
single-device loss. Rank 0 prints the lines the JAX dryrun prints.
"""
from __future__ import annotations

import torch


def _tiny_setup(num_nodes=256, num_train=900, feat_dim=32, dim=32,
                device=None, mask_input=False, **cfg_kw):
    from lpformer_tpu_torch.data.synthetic import synthetic_dataset
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.models.config import LPFormerConfig

    ds = synthetic_dataset(
        seed=0,
        num_nodes=num_nodes,
        num_train=num_train,
        num_eval=64,
        feat_dim=feat_dim,
        eps=1e-3,
        mask_input=mask_input,
        device=device,
    )
    cfg = LPFormerConfig(
        dim=dim,
        gnn_layers=2,
        budget_cn=32,
        budget_onehop=64,
        budget_non1hop=64,
        **cfg_kw,
    )
    params = lt.init_lpformer(torch.Generator().manual_seed(0), cfg,
                              in_dim=feat_dim, device=ds.graph.x.device)
    return ds, cfg, params


def entry(device=None):
    """Single-device check: forward + score on a link batch."""
    from lpformer_tpu_torch.models import link_transformer as lt

    ds, cfg, params = _tiny_setup(device=device)

    @torch.no_grad()
    def fn(params, graph, src, tgt):
        h = lt.forward(params, cfg, graph, src, tgt)
        return lt.score_links(params, cfg, h)

    links = torch.as_tensor(ds.train_pos[:64]).to(ds.graph.x.device)
    return fn, (params, ds.graph, links[:, 0], links[:, 1])


def _cp_ok(cfg, g: int) -> bool:
    return g > 1 and all(b % g == 0 for b in (
        cfg.budget_cn, cfg.budget_onehop, cfg.budget_non1hop))


def _dryrun_rank(rank: int, n_devices: int) -> list:
    from lpformer_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_train_step, partition_graph,
        place_sharded_graph,
    )
    from lpformer_tpu_torch.train import optim
    from lpformer_tpu_torch.train.step import TrainState

    dev = distributed.rank_device()
    ds, cfg, params = _tiny_setup(device=dev)
    # a 2-D mesh, data x graph (1-D when n is prime)
    g = next((c for c in (4, 2) if n_devices % c == 0 and n_devices > c), 1)
    d = n_devices // g
    mesh = make_mesh(data=d, graph=g)
    sg = place_sharded_graph(partition_graph(ds.graph, g=g, d=d), mesh)
    batch = d * g * 8
    links = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    w = torch.ones(batch, device=dev)
    opt = optim.make_optimizer(1e-3, steps_per_epoch=1)
    losses = []
    for cp in ((False, True) if _cp_ok(cfg, g) else (False,)):
        p = optim.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                           params)
        step = make_sharded_train_step(
            cfg, opt, mesh, ds.num_nodes, sg.rows_per_shard,
            sg.ctx_rows_per_shard, context_parallel=cp)
        _, loss = step(TrainState(p, opt.init(p), 0), sg,
                       ds.mask_mult_device, links[:, 0], links[:, 1], w, 0)
        losses.append(float(loss))
    lines = [f"dryrun_multichip ok: mesh=(data={d}, graph={g}), "
             f"loss={losses[0]:.4f}"
             + (f", cp_loss={losses[1]:.4f}" if len(losses) > 1 else "")]
    lines += _dryrun_matrix(n_devices)
    if rank == 0:
        print("\n".join(lines), flush=True)
    return lines


def _dryrun_matrix(n_devices: int) -> list:
    """On each rank of n: every power-of-two (d, g) mesh with d * g = n,
    the sharded loss of a dropout-free config in the plain,
    context-parallel (where the budgets divide) and mask_input variants,
    each equal to the port's single-device loss within 2e-4; returns the
    JAX dryrun's lines."""
    from lpformer_tpu_torch.ops import masking
    from lpformer_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_loss, partition_graph,
        place_sharded_graph,
    )
    from lpformer_tpu_torch.train.step import loss_fn as single_loss_fn

    dev = distributed.rank_device()
    ds, cfg, params = _tiny_setup(device=dev, mask_input=True, dropout=0.0,
                                  gnn_drop=0.0,
                                  att_drop=0.0, feat_drop=0.0,
                                  pred_drop=0.0)
    shapes = [(d, n_devices // d) for d in (2 ** i for i in range(
        n_devices.bit_length())) if n_devices % d == 0]
    batch = 16 * n_devices
    links = torch.as_tensor(ds.train_pos[:batch]).to(dev)
    src, tgt = links[:, 0], links[:, 1]
    neg = torch.randint(0, ds.num_nodes, (2, batch),
                        generator=torch.Generator().manual_seed(7)).to(dev)
    w = torch.ones(batch, device=dev)
    mult = ds.mask_mult_device
    with torch.no_grad():
        mask_ranks = masking.batch_mask_ranks(ds.graph.adj_rows, src, tgt,
                                              mult, weight=w)
        want = float(single_loss_fn(params, cfg, ds.graph, src, tgt, neg[0],
                                    neg[1], w, mask_ranks, None))
        prop_w = masking.mask_edge_weights(
            mask_ranks, ds.graph.edge_rank, (ds.graph.edge_w > 0).float())
        want_mi = float(single_loss_fn(params, cfg, ds.graph, src, tgt,
                                       neg[0], neg[1], w, mask_ranks, None,
                                       prop_w, True))
    lines, done = [], []
    for d, g in shapes:
        mesh = make_mesh(data=d, graph=g)
        sg = place_sharded_graph(
            partition_graph(ds.graph, g=g, d=d, mask_input=True), mesh)
        variants = [("plain", {}, want)]
        if _cp_ok(cfg, g):
            variants.append(("cp", dict(context_parallel=True), want))
        variants.append(("mask_input", dict(mask_input=True), want_mi))
        for name, kw, ref in variants:
            loss = make_sharded_loss(cfg, mesh, ds.num_nodes,
                                     sg.rows_per_shard,
                                     sg.ctx_rows_per_shard, **kw)
            with torch.no_grad():
                got = float(loss(params, sg, mult, src, tgt, w, neg[0],
                                 neg[1], w))
            if not abs(got - ref) < 2e-4:
                raise AssertionError(f"mesh=({d},{g}) {name}: sharded {got} "
                                     f"!= single {ref}")
        tags = "+".join(v[0] for v in variants)
        done.append(f"({d},{g}):{tags}")
        lines.append(f"dryrun matrix ok: mesh=(data={d}, graph={g}) "
                     f"variants={tags} loss={want:.4f} "
                     f"mask_input_loss={want_mi:.4f}")
    lines.append("dryrun matrix complete: " + " ".join(done))
    return lines


def dryrun_multichip(n_devices: int, device=None, backend=None) -> list:
    """The mesh check on ``n_devices`` ranks of this host (module
    docstring); returns rank 0's lines."""
    from lpformer_tpu_torch.parallel import distributed

    return distributed.spawn_local(_dryrun_rank, n_devices, (n_devices,),
                                   device=device, backend=backend)[0]


if __name__ == "__main__":
    fn, args = entry()
    print("entry:", tuple(fn(*args).shape))
