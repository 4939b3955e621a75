"""The training step, propagation and scoring over a (data x graph) mesh of
ranks (counterpart of ``lpformer_tpu/parallel/sharded_step.py``).

Each rank runs the code below on its own shards; ``collectives.py``
carries the exchanges, with the gradients ``shard_map`` gives the JAX
package:

  * GCN encoder: node features row-sharded over 'graph'. Per layer each
    rank transforms its row shard, all-gathers the transformed shard over
    'graph', aggregates its edge block (a COO gather and ``index_add``,
    the JAX package's segment_sum), and psums the partial rows over
    'data', so the SpMM work is split over the whole mesh.
  * Context state (padded adjacency / PPR rows): row-sharded over the
    whole mesh; each batch, every rank fetches its links' endpoint rows
    from their owners (``collectives.fetch_rows``), then runs the
    context extraction (ops/context.extract_context_rows) locally.
  * Links: the (pos + neg) batch is sharded over both axes (over 'data'
    only under context parallelism, where each link's context axis is
    sharded over 'graph', parallel/context_parallel.py); the extraction
    and the attention (``calc_pairwise``, the fused kernels on the card)
    run locally against the all-gathered node encodings.
  * Batch-positive masking: each rank finds its links' edge ranks in the
    fetched rows; the ranks (ints) are all-gathered so every rank builds
    the same global masked-rank bitmap, the single-device semantics.
  * Loss: the counts of the loss's means are summed over the link ranks
    (constants); each rank's loss is its links' share of the global loss
    (divided by the ranks that hold the same links), so the shares add up
    to it. After the backward, the parameter gradients are summed over
    the mesh once, and every rank runs the same optimizer update: the
    parameters stay replicated.

Entry points take the GLOBAL link arrays, the same on every rank (the
batch order and the negatives are seeded alike), and each rank takes its
shard. Randomness: every rank's generators derive from one seed and the
step (``_fold``). The encoder's depend on the graph index only, so the
dropped activations agree along 'data', whose partial sums meet; the
links' on the rank, or under context parallelism on the data index only,
so the ranks of a link's context slices draw alike.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lpformer_tpu_torch.models import link_transformer as lt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.nn import core as nn
from lpformer_tpu_torch.ops import masking
from lpformer_tpu_torch.ops.context import LinkRows, extract_context_rows
from lpformer_tpu_torch.ops.gather import gather_rows
from lpformer_tpu_torch.parallel import collectives as col
from lpformer_tpu_torch.parallel.partition import ShardedGraph
from lpformer_tpu_torch.train import optim
from lpformer_tpu_torch.train.step import TrainState

_CTX = ("adj_nbrs", "adj_vals", "adj_ranks", "ppr_nbrs", "ppr_vals",
        "ppr_flags")


def _fold(seed: int, *path: int) -> int:
    """A 63-bit seed from ``seed`` and the ints of ``path`` (JAX's
    fold_in)."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _gen(device, seed: Optional[int], *path: int):
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(_fold(seed, *path))


def _link_shard(mesh, context_parallel: bool):
    """(group, this rank's shard index, shard count) of the link batch."""
    if context_parallel:
        return mesh.data_group, mesh.data_index, mesh.data
    return mesh.world_group, mesh.linear_index, mesh.ndev


def _shard(t: torch.Tensor, k: int, n: int) -> torch.Tensor:
    if t.shape[0] % n:
        raise ValueError(f"a batch of {t.shape[0]} links does not divide "
                         f"over {n} link-sharding ranks")
    per = t.shape[0] // n
    return t[k * per:(k + 1) * per]


def _gather_link_rows(sg: ShardedGraph, ids, mesh, with_ranks: bool
                      ) -> LinkRows:
    """LinkRows for this rank's endpoint ids [R], fetched from the ranks
    that own them."""
    tables = [getattr(sg, f) for f in _CTX]
    if not with_ranks:
        tables[2] = None
    got = col.fetch_rows(ids, tables, sg.ctx_rows_per_shard,
                         mesh.world_group)
    return LinkRows(*got)


def _split(rows: LinkRows, b: int):
    """The rows of a [src | tgt] id list as (rows of src, rows of tgt)."""
    def take(sl):
        return LinkRows(*(None if a is None else a[sl] for a in (
            getattr(rows, f) for f in _CTX)))

    return take(slice(0, b)), take(slice(b, 2 * b))


def _aggregate(msg: torch.Tensor, ed: torch.Tensor, rows_per: int):
    """sum of msg rows into their local rows ed (the pad row rows_per is
    dropped)."""
    out = torch.zeros((rows_per + 1,) + msg.shape[1:], dtype=msg.dtype,
                      device=msg.device)
    return out.index_add(0, ed, msg)[:rows_per]


class _BlockSpmm(torch.autograd.Function):
    """This rank's edge block of A y over the graph axis: the all-gather
    of the row shards (in ``gather_dtype``, bf16 traffic under
    mm_dtype), then sum_e ew[e] * y[es[e]] into the local rows ed[e], in
    f32. The backward is the same operator's transpose with the
    single-device SpMM's roundings (ops/spmm.py): the cotangent's rows
    gathered in ``gather_dtype``, every sum in f32, then a reduce-scatter
    over 'graph'. (Autograd through the forward would sum the bf16
    gathers' cotangents in bf16, as the JAX package's sharded transpose
    does.)"""

    @staticmethod
    def forward(ctx, y_shard, es, ed, ew, rows_per, group, gather_dtype):
        ctx.save_for_backward(es, ed, ew)
        ctx.shape, ctx.group, ctx.gather_dtype = (
            y_shard.shape, group, gather_dtype)
        y_comm = (y_shard if gather_dtype is None
                  else y_shard.to(gather_dtype))
        y_full = col.all_gather_nograd(y_comm, group)
        return _aggregate(y_full[es].to(y_shard.dtype) * ew[:, None], ed,
                          rows_per)

    @staticmethod
    def backward(ctx, ct):
        es, ed, ew = ctx.saved_tensors
        ct = torch.cat([ct, ct.new_zeros((1, ct.shape[1]))])  # pad row
        rows = ct if ctx.gather_dtype is None else ct.to(ctx.gather_dtype)
        n_full = ctx.shape[0] * dist.get_world_size(ctx.group)
        d_full = torch.zeros((n_full, ct.shape[1]), dtype=ct.dtype,
                             device=ct.device).index_add_(
            0, es, rows[ed].to(ct.dtype) * ew[:, None])
        return (col.reduce_scatter(d_full, ctx.group), None, None, None,
                None, None, None)


def _gcn_sharded(params, cfg: LPFormerConfig, mesh, x_shard, es, ed, ew,
                 diag_shard, rows_per: int, gen, train: bool):
    """The GCN over this rank's row shard: per layer, the row transform,
    the all-gather over 'graph', this rank's edge block, the psum over
    'data' (bf16 gather traffic under mm_dtype, f32 sums)."""
    lns = params.get("lns")
    x = x_shard
    for i, conv in enumerate(params["convs"]):
        y_shard = nn.matmul(x, conv["w"], cfg.mm_dtype)
        part = _BlockSpmm.apply(y_shard, es, ed, ew, rows_per,
                                mesh.graph_group, cfg.mm_dtype)
        xi = col.psum(part, mesh.data_group) + diag_shard[:, None] * y_shard
        xi = xi + conv["bias"]
        if lns is not None:
            xi = nn.layer_norm_apply(lns[i], xi)
        xi = nn.dropout(gen, xi, cfg.gnn_drop, train)
        if cfg.relu:
            xi = torch.relu(xi)
        if cfg.residual and x.shape[-1] == xi.shape[-1]:
            x = x + xi
        else:
            x = xi
    return x


def _propagate_sharded(params, cfg, mesh, sg: ShardedGraph, ew, diag_sh,
                       gen, train: bool):
    """X_full [N, dim] on every rank: feature dropout, the sharded GCN
    over the edge weights ``ew`` and self-loop ``diag_sh``, the final
    LayerNorm, then the all-gather of the row shards over 'graph'."""
    es = sg.edge_src[0, 0].long()
    ed = sg.edge_dst_local[0, 0].long()
    feats = nn.dropout(gen, sg.x, cfg.feat_drop, train)
    X_shard = _gcn_sharded(params["node_encoder"], cfg, mesh, feats, es, ed,
                           ew, diag_sh, sg.rows_per_shard, gen, train)
    X_shard = nn.layer_norm_apply(params["gnn_norm"], X_shard)
    return col.all_gather(X_shard, mesh.graph_group)[:sg.num_nodes]


def _masked_norm(sg: ShardedGraph, mesh, mask_ranks):
    """mask_input: this rank's block weights and self-loops of the
    batch-masked, renormalised, UNWEIGHTED adjacency. The masked degrees
    need every block of the row shard (split over 'data': a sum), the
    source side of the norm other shards' rows (an all-gather of the
    [rows] inverse roots over 'graph')."""
    rows_per = sg.rows_per_shard
    es = sg.edge_src[0, 0].long()
    ed = sg.edge_dst_local[0, 0].long()
    wm = masking.mask_edge_weights(mask_ranks, sg.edge_rank[0, 0],
                                   sg.edge_bin[0, 0])
    deg = col.all_reduce(_aggregate(wm, ed, rows_per), mesh.data_group) + 1.0
    dinv_sh = torch.rsqrt(deg)                    # deg >= 1 always
    dinv_full = col.all_gather_nograd(dinv_sh, mesh.graph_group)
    ed_c = ed.clamp(max=rows_per - 1)             # pad slots: wm == 0
    return dinv_full[es] * wm * dinv_sh[ed_c], dinv_sh * dinv_sh


def _link_scores(params, cfg, mesh, X_full, src, tgt, ctx, gen, train,
                 context_parallel: bool):
    """sigmoid(score head) of [elementwise || pairwise] for this rank's
    links, over their extracted context tables."""
    p = nn.cast_matmul_weights(params, cfg.mm_dtype)
    elementwise = nn.mlp_apply(
        p["elementwise_lin"],
        gather_rows(X_full, src) * gather_rows(X_full, tgt),
        mm_dtype=cfg.mm_dtype)
    if context_parallel:
        from lpformer_tpu_torch.parallel.context_parallel import (
            cp_calc_pairwise)

        pairwise = cp_calc_pairwise(p, cfg, X_full, src, tgt, ctx, mesh,
                                    gen=gen, train=train)
    else:
        pairwise, _ = lt.calc_pairwise(p, cfg, X_full, src, tgt, ctx,
                                       gen=gen, train=train)
    h = torch.cat([elementwise, pairwise], dim=-1)
    return lt.score_links(params, cfg, h, gen=gen, train=train)


def make_sharded_loss(
    cfg: LPFormerConfig, mesh, num_nodes: int, rows_per: int,
    ctx_rows_per: int, train: bool = True, context_parallel: bool = False,
    mask_input: bool = False,
):
    """Returns loss(params, sg, mult, psrc, ptgt, pw, nsrc, ntgt, nw,
    seed=None): the GLOBAL link arrays in, the global loss out (its value
    on every rank), whose gradient on each rank is that rank's share
    (sum the parameter gradients over the mesh: ``value_and_grad``).
    ``seed`` None draws no dropout.

    ``context_parallel``: links sharded over 'data' only, each link's
    context axis over 'graph' (parallel/context_parallel.py).
    ``mask_input``: the positive half propagates over the batch-masked,
    renormalised, unweighted adjacency and the negative half over the
    standard one (two propagations, the single-device semantics); needs
    ``partition_graph(..., mask_input=True)``."""
    if context_parallel:
        from lpformer_tpu_torch.parallel.context_parallel import (
            check_cp_budgets)

        check_cp_budgets(cfg, mesh.graph)
    link_group, link_k, link_n = _link_shard(mesh, context_parallel)
    replicas = mesh.ndev // link_n       # ranks that hold the same links

    def loss_fn(params, sg: ShardedGraph, mult, psrc, ptgt, pw, nsrc, ntgt,
                nw, seed: Optional[int] = None):
        if mask_input and sg.edge_rank is None:
            raise ValueError("the mask_input sharded loss needs "
                             "partition_graph(mask_input=True) blocks")
        psrc, ptgt, pw = (_shard(t, link_k, link_n) for t in (psrc, ptgt, pw))
        nsrc, ntgt, nw = (_shard(t, link_k, link_n) for t in (nsrc, ntgt, nw))
        dev = mesh.device
        seed_t = seed if train else None
        enc = (mesh.graph_index,)
        links = ((mesh.data_index,) if context_parallel
                 else (mesh.data_index, mesh.graph_index))

        # context rows of this rank's links, from their owners
        bl = psrc.shape[0]
        ps_rows, pt_rows = _split(_gather_link_rows(
            sg, torch.cat([psrc, ptgt]), mesh, with_ranks=True), bl)
        ns_rows, nt_rows = _split(_gather_link_rows(
            sg, torch.cat([nsrc, ntgt]), mesh, with_ranks=False),
            nsrc.shape[0])

        # the global batch mask (the reference masks ALL batch positives)
        rank_loc = masking.link_edge_ranks(
            ps_rows.adj_nbrs, ps_rows.adj_ranks, ptgt,
            pt_rows.adj_nbrs, pt_rows.adj_ranks, psrc)
        mask_ranks = masking.bitmap_from_link_ranks(
            col.all_gather_nograd(rank_loc, link_group), mult,
            col.all_gather_nograd(pw, link_group))

        if mask_input:
            wm_norm, diag_m = _masked_norm(sg, mesh, mask_ranks)
            X_pos = _propagate_sharded(params, cfg, mesh, sg, wm_norm,
                                       diag_m, _gen(dev, seed_t, 0, *enc, 7),
                                       train)
            X_neg = _propagate_sharded(params, cfg, mesh, sg,
                                       sg.edge_w[0, 0], sg.diag,
                                       _gen(dev, seed_t, 0, *enc, 8), train)
        else:
            X_pos = X_neg = _propagate_sharded(
                params, cfg, mesh, sg, sg.edge_w[0, 0], sg.diag,
                _gen(dev, seed_t, 0, *enc), train)

        def scores(X_full, src, tgt, rows_s, rows_t, ranks, tag):
            gen = _gen(dev, seed_t, 1, *links, tag)
            ctx = extract_context_rows(rows_s, rows_t, cfg.context,
                                       num_nodes, mask_ranks=ranks, gen=gen,
                                       train=train)
            return _link_scores(params, cfg, mesh, X_full, src, tgt, ctx,
                                gen, train, context_parallel)

        pos_out = scores(X_pos, psrc, ptgt, ps_rows, pt_rows, mask_ranks, 10)
        neg_out = scores(X_neg, nsrc, ntgt, ns_rows, nt_rows, None, 11)
        # the means' counts over every link: constants
        cnt = col.all_reduce(torch.stack([pw.sum(), nw.sum()]), link_group)
        share = (-(torch.log(pos_out + 1e-6) * pw).sum() / cnt[0].clamp_min(1.0)
                 - (torch.log(1.0 - neg_out + 1e-6) * nw).sum()
                 / cnt[1].clamp_min(1.0)) / replicas
        total = col.all_reduce(share.detach(), mesh.world_group)
        # the value is exactly total (x - x == 0), the gradient share's
        return total + (share - share.detach())

    return loss_fn


def value_and_grad(loss_fn, mesh, params, *args):
    """(the loss, the global gradient tree): this rank's backward, then
    one all-reduce (sum) of every parameter gradient over the mesh."""
    leaves = optim.tree_leaves(params)
    loss = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    flat = col.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                          mesh.world_group)
    parts = torch.split(flat, [g.numel() for g in grads])
    by_leaf = {id(p): g.reshape(p.shape) for p, g in zip(leaves, parts)}
    return loss.detach(), optim.tree_map(lambda p: by_leaf[id(p)], params)


def make_sharded_propagate(cfg: LPFormerConfig, mesh, num_nodes: int,
                           rows_per: int):
    """Eval-mode propagation: (params, sg) -> X_full [N, dim] on every rank
    (the propagate-once eval flows, reference testing.py:50-74)."""

    @torch.no_grad()
    def prop(params, sg: ShardedGraph):
        return _propagate_sharded(params, cfg, mesh, sg, sg.edge_w[0, 0],
                                  sg.diag, None, False)

    return prop


def make_sharded_score_with_X(
    cfg: LPFormerConfig, mesh, num_nodes: int, ctx_rows_per: int,
    context_parallel: bool = False,
):
    """Scorers over a propagated X_full: ``(score, score_group)``,
      score(params, sg, X_full, src, tgt) -> [B] on every rank,
      score_group(params, sg, X_full, srcs, tgts) -> [K, B], K batches.
    The links are sharded over the mesh (over 'data' only with
    ``context_parallel``), their rows fetched from their owners, and
    every rank's scores all-gathered; eval semantics (no masking, no
    dropout)."""
    if context_parallel:
        from lpformer_tpu_torch.parallel.context_parallel import (
            check_cp_budgets)

        check_cp_budgets(cfg, mesh.graph)
    link_group, link_k, link_n = _link_shard(mesh, context_parallel)

    @torch.no_grad()
    def score(params, sg: ShardedGraph, X_full, src, tgt):
        s, t = _shard(src, link_k, link_n), _shard(tgt, link_k, link_n)
        rows_s, rows_t = _split(_gather_link_rows(
            sg, torch.cat([s, t]), mesh, with_ranks=False), s.shape[0])
        ctx = extract_context_rows(rows_s, rows_t, cfg.context, num_nodes)
        out = _link_scores(params, cfg, mesh, X_full, s, t, ctx, None, False,
                           context_parallel)
        return col.all_gather_nograd(out, link_group)

    def score_group(params, sg: ShardedGraph, X_full, srcs, tgts):
        return torch.stack([score(params, sg, X_full, s, t)
                            for s, t in zip(srcs, tgts)])

    return score, score_group


def make_sharded_score(cfg: LPFormerConfig, mesh, num_nodes: int,
                       rows_per: int, ctx_rows_per: int):
    """One-call scorer (params, sg, src, tgt) -> [B]: propagates each
    call (sweeps propagate once: make_sharded_propagate +
    make_sharded_score_with_X)."""
    prop = make_sharded_propagate(cfg, mesh, num_nodes, rows_per)
    score_x, _ = make_sharded_score_with_X(cfg, mesh, num_nodes, ctx_rows_per)

    def score(params, sg: ShardedGraph, src, tgt):
        return score_x(params, sg, prop(params, sg), src, tgt)

    return score


def make_sharded_train_step(
    cfg: LPFormerConfig, optimizer: optim.GradientTransformation, mesh,
    num_nodes: int, rows_per: int, ctx_rows_per: int, num_negative: int = 1,
    context_parallel: bool = False, steps_per_call: int = 1,
    mask_input: bool = False,
):
    """The step (state, sg, mult, src, tgt, w, seed) -> (state, loss), the
    global batch [B] in on every rank. Each step folds ``state.step`` into
    ``seed``; the negatives [2, B * num_negative] come from a generator
    seeded alike on every rank, and each rank takes its shard.

    ``steps_per_call`` = K > 1 returns (state, sg, mult, srcs, tgts, ws,
    live, seed) -> (state, losses [K]): the step for each live step, and a
    dead step (live == 0) changes nothing and reads loss 0."""
    loss_fn = make_sharded_loss(cfg, mesh, num_nodes, rows_per, ctx_rows_per,
                                train=True, context_parallel=context_parallel,
                                mask_input=mask_input)

    def step(state: TrainState, sg, mult, src, tgt, w, seed: int):
        s = _fold(seed, state.step)
        b = src.shape[0]
        neg = torch.randint(0, num_nodes, (2, b * num_negative),
                            generator=_gen(src.device, s, 0),
                            device=src.device, dtype=src.dtype)
        nw = w.repeat_interleave(num_negative)
        loss, grads = value_and_grad(loss_fn, mesh, state.params, sg, mult,
                                     src, tgt, w, neg[0], neg[1], nw,
                                     _fold(s, 1))
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        optim.apply_updates(state.params, updates)
        return TrainState(state.params, opt_state, state.step + 1), loss

    if steps_per_call <= 1:
        return step

    def multi_step(state: TrainState, sg, mult, srcs, tgts, ws, live, seed):
        losses = []
        for k in range(steps_per_call):
            if live[k] > 0:
                state, loss = step(state, sg, mult, srcs[k], tgts[k], ws[k],
                                   seed)
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=srcs.device)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step
