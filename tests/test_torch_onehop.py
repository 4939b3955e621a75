"""The port's ``1-hop`` mode (thresh_non1hop 1), the mode of LPFormer's
ogbl-ddi run, against the benchmark's plain reference of it
(``benchmark/reference/onehop.py``), at a tiny size on the CPU: the
combined context tables and structure counts, eval scores, and one
training step's loss and clipped gradient, on seeded random weights; and
the rule that sizes ``budget_combined`` (the largest candidate count of
any node pair) against the graph, so that no slot is dropped."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)

from lpbench import data as data_mod  # noqa: E402
from lpbench import program  # noqa: E402
from reference import onehop, params_onehop  # noqa: E402
from reference.graph import RefGraph  # noqa: E402
from reference.params import leaves  # noqa: E402

from lpformer_tpu_torch.graph import ppr as ppr_mod  # noqa: E402
from lpformer_tpu_torch.models import link_transformer as lt  # noqa: E402
from lpformer_tpu_torch.ops import masking  # noqa: E402
from lpformer_tpu_torch.ops.context import extract_context  # noqa: E402

N, M, F, B = 64, 256, 12, 32
BASE = dict(dim=16, gnn_layers=2, num_heads=1, trans_layers=1,
            pred_layers=2, residual=False, dropout=0.0, gnn_drop=0.0,
            att_drop=0.0, feat_drop=0.0, pred_drop=0.0, thresh_cn=0.0,
            thresh_1hop=1e-2, thresh_non1hop=1.0, matmul_dtype="float32",
            batch_size=B, test_batch_size=64, lr=5e-3, num_nodes=N,
            alpha=0.15, eps=1e-4, name="onehop-tiny")
WEIGHT_SEED = 11

# Tolerances. Both sides compute in float32 with TF32 off, in different
# orders (the port's fused op folds the PE's last linear into W_r and sums
# its softmax by tiles; the reference multiplies per slot): their gaps are
# a few float32 ulps of each quantity.
SCORE_ATOL = 1e-6     # a probability near 0.5: ulp 6e-8, some 16 ulps
LOSS_RTOL = 1e-6      # the batch's mean log-likelihood, ~1.4: 10 ulps
GRAD_RTOL = 1e-4      # a leaf's clipped gradient, against its own largest
                      # element: f32 sums over up to B x budget slots


def candidate_bound(edges, n, ppr, cfg):
    """The largest number of context candidates that pass the thresholds
    for any node pair (a self pair included), unmasked and unsubsampled,
    from the dense A^2 and PPR: the CNs (thresh_cn 0 passes every one)
    plus the neighbours of one endpoint alone whose PPR from both
    endpoints reaches thresh_1hop."""
    assert cfg["thresh_cn"] == 0.0
    a = np.zeros((n, n), bool)
    a[edges[:, 0], edges[:, 1]] = a[edges[:, 1], edges[:, 0]] = True
    p = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), np.diff(ppr.indptr))
    p[rows, ppr.indices] = ppr.weights
    hi = p >= np.float32(cfg["thresh_1hop"])
    cn = a.astype(np.int64) @ a.T.astype(np.int64)
    one = (a & hi).astype(np.int64) @ (hi & ~a).T.astype(np.int64)
    return int((cn + one + one.T).max())


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    edges = data_mod.random_edges(rng, N, M, 0.2)
    x = rng.standard_normal((N, F)).astype(np.float32)
    ppr = ppr_mod.ppr_push_csr(np.concatenate([edges[:, 0], edges[:, 1]]),
                               np.concatenate([edges[:, 1], edges[:, 0]]), N,
                               BASE["alpha"], BASE["eps"])
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    k = np.unique(lo * N + hi)
    deg = np.bincount(np.concatenate([k // N, k % N]), minlength=N)
    cfg = dict(BASE, adj_cap=int(deg.max()),
               ppr_cap=int(np.diff(ppr.indptr).max()))
    cfg["budget_combined"] = candidate_bound(edges, N, ppr, cfg)
    data = {"edges": edges, "x": x}
    graph, ppr, mask, _ = program.build_graph(cfg, data, "cpu")
    g = RefGraph(edges, x, N, cfg["adj_cap"], cfg["ppr_cap"], "cpu")
    g.use_ppr(ppr.indptr, ppr.indices, ppr.weights)
    return dataclasses.make_dataclass(
        "World", ["cfg", "edges", "graph", "mask", "g", "ppr"])(
        cfg, edges, graph, mask, g, ppr)


def _all_pairs():
    u, v = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return torch.as_tensor(u.reshape(-1)), torch.as_tensor(v.reshape(-1))


def _batch(world):
    e = torch.as_tensor(world.edges[:B])
    return e[:, 0], e[:, 1], torch.ones(B)


def test_budget_rule_leaves_no_pair_overflowing(world):
    """The rule's budget holds every candidate of every pair, and no less
    would: on all N^2 pairs no slot is dropped and the fullest table is
    full. Both classes have candidates, so both encoders are exercised."""
    cfg = program.model_config(world.cfg)
    assert cfg.mask_mode == "1-hop"
    src, tgt = _all_pairs()
    ctx = extract_context(world.graph.adj_rows, world.graph.ppr_rows, src,
                          tgt, cfg.context)
    assert int(ctx.overflow.sum()) == 0
    assert int(ctx.valid.sum(1).max()) == cfg.budget_combined
    assert int(ctx.counts[:, 1].sum()) > 0 and int(ctx.counts[:, 0].sum()) > 0


def _compare_tables(ctx, ref):
    ids, cls, ps, pt, valid, counts = ref
    assert torch.equal(ctx.valid, valid)
    for got, want in ((ctx.ids, ids), (ctx.cls, cls), (ctx.src_ppr, ps),
                      (ctx.tgt_ppr, pt)):
        assert torch.equal(got[valid].long(), want[valid].long()) if \
            got.dtype != torch.float32 else torch.equal(got[valid],
                                                        want[valid])
    # the mode's three counts: cn, 1-hop, cn + 1-hop
    assert torch.equal(ctx.counts[:, [0, 1, 3]], counts)


@pytest.mark.parametrize("att_drop", [0.0, 0.5])
def test_context_tables_and_counts_match_reference(world, att_drop):
    """Eval mode over every pair, and train mode (the batch's positives
    masked, candidates subsampled from one generator in the same order)
    on a batch: the same slots, ids, classes, PPR values and counts,
    exactly."""
    c = dict(world.cfg, att_drop=att_drop)
    cfg = program.model_config(c)
    model = onehop.Model(c, world.g, "float32")
    src, tgt = _all_pairs()
    _compare_tables(extract_context(world.graph.adj_rows,
                                    world.graph.ppr_rows, src, tgt,
                                    cfg.context), model.context(src, tgt))
    src, tgt, w = _batch(world)
    mult = torch.as_tensor(world.mask[1], dtype=torch.int32)
    ranks = masking.batch_mask_ranks(world.graph.adj_rows, src, tgt, mult,
                                     weight=w)
    ctx = extract_context(world.graph.adj_rows, world.graph.ppr_rows, src,
                          tgt, cfg.context, mask_ranks=ranks,
                          gen=torch.Generator().manual_seed(5), train=True)
    ref = model.context(src, tgt, model.batch_keys(src, tgt, w),
                        torch.Generator().manual_seed(5))
    _compare_tables(ctx, ref)


def _weights(cfg):
    return params_onehop.make_weights(cfg, F, WEIGHT_SEED, "cpu")


def _eval_gap(world, precision):
    cfg = world.cfg
    P = _weights(cfg)
    mc = program.model_config(cfg)
    src, tgt = _all_pairs()
    X = lt.propagate(P, mc, world.graph)
    with torch.no_grad():
        got = lt.score_links(P, mc, lt.forward(P, mc, world.graph, src, tgt,
                                               X_node=X))
        model = onehop.Model(cfg, world.g, precision)
        want = model.score(P, model.propagate(P), src, tgt)
    return float((got - want).abs().max())


def _train_gaps(world, precision, att_drop):
    """One training step of the port against the reference's: (loss gap
    relative to the loss, worst leaf's clipped-gradient gap relative to
    the leaf's largest element)."""
    cfg = dict(world.cfg, att_drop=att_drop)
    step, opt = program.train_step(cfg, 8)
    state = program.train_state(_weights(cfg), opt)
    src, tgt, w = _batch(world)
    mult = torch.as_tensor(world.mask[1], dtype=torch.int32)
    state, loss = step(state, world.graph, mult, None, src, tgt, w,
                       torch.Generator().manual_seed(7))
    m1 = program.first_moment(state) / (1.0 - 0.9)
    P = params_onehop.clone(_weights(cfg), True)
    ref = onehop.train_steps(onehop.Model(cfg, world.g, precision), P,
                             [(src, tgt, w)], cfg["lr"], 7, "cpu")
    grads = torch.split(m1, [x.numel() for _, x in leaves(P)])
    worst = max(float((a.reshape(b.shape) - b).abs().max())
                / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads, ref["grad1"]) if b.abs().max() > 0)
    assert all(float(a.abs().max()) == 0.0
               for a, b in zip(grads, ref["grad1"]) if b.abs().max() == 0)
    return abs(float(loss) - ref["losses"][0]) / ref["losses"][0], worst


def test_eval_scores_match_reference(world):
    assert _eval_gap(world, "float32") <= SCORE_ATOL


@pytest.mark.parametrize("att_drop", [0.0, 0.5])
def test_train_step_matches_reference(world, att_drop):
    loss_gap, grad_gap = _train_gaps(world, "float32", att_drop)
    assert loss_gap <= LOSS_RTOL
    assert grad_gap <= GRAD_RTOL


def test_tf32_rounding_fails_the_tolerances(world):
    """The reference with its products' inputs rounded to TF32 (the
    control one step below float32) in the program's place: the scores
    and the gradient pass their tolerances no longer."""
    assert _eval_gap(world, "tfloat32") > SCORE_ATOL
    loss_gap, grad_gap = _train_gaps(world, "tfloat32", 0.0)
    assert loss_gap > LOSS_RTOL or grad_gap > GRAD_RTOL
